// Filter-build kernels: the k-mer passes of building a Bloom filter from
// reads or genomes (ntCard's histogram, ntStat's count-min counting and
// threshold insertion, ntedit_make_genome_bf) on an H100.
//
// They replace the JAX package's XLA programs
// ntedit_tpu/core/bfbuild.py::DeviceFilterBuilder._count_fn and _insert_fn
// (with scatter_or_words and _mix_pair), and the host numpy passes it runs
// instead for the histogram (valid_canonical_hashes inside count_histogram),
// the counting filter (--cbf) and the plain and genome filters
// (KmerCountingBloomFilter8.insert_hashes, KmerBloomFilter.insert_hashes).
// The input is one batch of separator-joined records as ASCII: a window is
// valid when its k bytes are all ACGTacgt (the 0x00 separator, N and IUPAC
// bytes make it invalid), and only valid windows are hashed into anything.
// For a valid window with canonical ntHash2 value can, hash j is
// h_0 = can, h_j = extended(can, j ^ (k * MULTISEED)) (NTM64, _mix_pair).
//
// The histogram's pass writes, per batch, the canonical hashes of the
// valid windows, compacted and in window order (ntedit_tpu/core/bfbuild.py
// valid_canonical_hashes), and with a sample slice s > 0 only those whose
// mixed key (splitmix64's finalizer, ops/build_kernel.py sample_key) has
// its top s bits clear, beside the count of all valid windows (F1):
//
//   kmer_valid_count_kernel<kSample> counts each block's emitted windows and
//       its valid windows (validity alone when s = 0, no hashing);
//   the wrapper's torch.cumsum of the emitted counts gives each block its
//       offset (the wrapper reads the totals only after the emit form, to
//       size the view it returns, so the card does not wait between forms);
//   kmer_valid_hashes_kernel hashes the block's tile again, each thread
//       staging its emitted hashes in its own 32 slots of shared memory
//       (slot (r + t) & 31 for its r-th, so that the lanes of a warp store
//       and load on distinct banks), and each warp then writes its lanes'
//       runs one after the other, consecutive lanes on consecutive
//       addresses: a warp's store covers 256 contiguous bytes, where the
//       dense kernel this replaces stored 8 B at a 256-B stride per lane.
//
// The count pass adds one, saturating at 255, to counter h_j mod slots for
// every valid window and every j < hash_num (btllib's counting filter; two
// j landing on one slot count twice, as np.unique(return_counts) of the
// host's [n, m] hashes does).  The counter table (hundreds of MB) is far
// larger than the 50 MB L2, and one increment straight into it costs two
// dependent DRAM round trips (a load, then a CAS on the aligned 32-bit word
// that holds the byte: CUDA has no 8-bit atomic).  So the pass first bins
// the increments by slice of 2^S counters, then applies them slice by
// slice, while those counters stay in L2:
//
//   kmer_partition_kernel<false> counts, per round of a block's 8192
//       windows, the increments of each slice (slot >> S) in shared memory
//       and writes the round's column of a [slices x columns] count matrix
//       (a round is as many windows as fill the block's stage);
//   the wrapper's inclusive scan of that matrix (slice-major, so slice s's
//       bucket is contiguous and the buckets lie in slice order) gives
//       every (slice, column) its exact range: no bucket has a fixed
//       capacity, so a batch whose increments all land in one slot (a
//       poly-A read set) is binned like any other;
//   kmer_partition_kernel<true> hashes the same windows again, stages each
//       slot's 32-bit offset in its slice (slot & (2^S - 1)) in shared
//       memory, sorted by slice (a cursor per slice, from a block scan of
//       the round's column), and writes each slice's run to its range,
//       consecutive lanes on consecutive addresses;
//   kmer_count_apply_kernel walks the entries in bucket order: its blocks
//       start in index order, so the card works on one or two slices at a
//       time, and each entry gets the saturating CAS on a word that is now
//       in L2.  Saturation is monotone, so the order of the increments does
//       not change the result.  A thread keeps kApplyPerThread entries in
//       flight: their loads, then their first CAS attempts, back to back.
//
// On an H100 (PERF.md section 6) slices of 2^25 counters
// (32 MiB) were the fastest of 2^22 to 2^26: at 2^26 a slice no longer
// stays in L2 and the apply slows by a third.  The staging keeps the
// partition's time about flat in the number of slices; its 4-byte writes
// straight to the buckets cost more the more slices a warp's lanes hit.
// The apply makes two L2 operations per increment (the load that seeds
// the CAS, then the CAS), where the random-atomic floor makes one.
//
// The modulo is exact for any slot count (fastmod); the XLA program reduced
// the low 32 bits only, which folds tables above 2^32 slots (ROADMAP.md
// section 3).  The slice id is 64-bit and the offset 32-bit, so S <= 32;
// the wrapper raises S until the table has at most kMaxSlices slices.
//
// The insert pass sets a valid window's bits when cutoff <= 1, or when the
// minimum of its hash_num counters is at least cutoff (count-min: a k-mer is
// never undercounted), which holds exactly when each of the counters is.
// Within one pass the cutoff does not change, so kmer_solid_bits_kernel
// first packs bit s = counters[s] >= cutoff into little-endian 32-bit words
// (one streaming read of the table), and kmer_insert_kernel reads the bit
// of each h_j mod slots instead of its byte: a 32-byte sector then covers
// 256 slots instead of 32, and the bitmap (1/8 of the table) is about the
// size of the L2.  It then ORs the window's bits:
//   blocked - one atomicOr of the mask of hash_num 5-bit offsets, bits
//             wbits + 5j of can, into word can & (words - 1);
//   plain   - hash_num atomicOrs at bit h_j mod bits, little-endian within
//             the uint32 words, which are the bytes of the btllib filter.
// OR does not depend on order, so the result is bit-exact; the XLA program
// sorted and scanned its scatter because XLA has no scatter-OR.  The
// atomics' results are unused, so they compile to fire-and-forget RED.
//
// Bound.  The hashes pass streams: 1 B of ASCII in and 8 B per emitted
// window out; it hashes every window once (twice with s > 0), and the
// rolling hash's 64-bit arithmetic costs about as much as those bytes.
// The count and insert passes make one random access per (window, j); what
// bounds them is the rate at which the memory serves random sectors, not
// bytes per second, and the design moves those accesses from DRAM to L2.
// All window kernels keep the gate kernel's front end (nthash.cuh): a thread
// owns 32 consecutive windows, a block of 256 threads holds its 8192-window
// tile in shared memory, and the hash rolls.  Every index is 64-bit.
//
// atomic_floor_kernel is a measuring stick and not on any path: as many
// random 32-bit atomics into a table as the apply kernel makes, with as many
// in flight per thread, and nothing else.

#include "nthash.cuh"

namespace {

using namespace nth;

constexpr int kCounterBatch = 4;     // bitmap reads of one window in flight (insert)
constexpr int kMaxSlices = 1024;     // slices of a count table (shared arrays per block)
constexpr int kStage = 6144;         // entries a partition block stages per round (24 KB)
constexpr int kApplyPerThread = 8;   // entries a thread of the apply kernel keeps in flight
constexpr int kApplyChunk = kThreads * kApplyPerThread;  // entries per apply block

struct Tables {
	uint64_t roll_f[16], roll_r[16], seed_f[4], seed_r[4];
	uint8_t cls[256];
};

// The block's roll tables and ASCII tile; every thread of the block calls it.
__device__ __forceinline__ void prologue(Tables& tb, uint8_t* tile, const uint8_t* seq, int k,
                                         unsigned t)
{
	fill_roll_tables(tb.roll_f, tb.roll_r, tb.seed_f, tb.seed_r, tb.cls, k, t);
	load_tile(tile, seq + (uint64_t)blockIdx.x * kTile, k, t);
	__syncthreads();
}

// The rolling hash of a thread's windows: ``first`` hashes window 0 from
// its k bytes, ``roll`` steps from window j - 1 to window j.
struct Roller {
	uint64_t fh = 0, rh = 0;
	int bad = 0;  // bytes of the window that are not ACGTacgt

	__device__ __forceinline__ void first(const Tables& tb, const uint8_t* row, int k)
	{
		for (int i = 0; i < k; ++i) {
			const unsigned c = tile_byte(row, i);
			fh = srol1(fh) ^ tb.seed_f[code_of(c)];
			rh = srol1(rh) ^ tb.seed_r[code_of(tile_byte(row, k - 1 - i))];
			bad += tb.cls[c] != 0;
		}
	}

	__device__ __forceinline__ void roll(const Tables& tb, const uint8_t* row, int k, int j)
	{
		const unsigned c_out = row[j - 1], c_in = tile_byte(row, j - 1 + k);
		const unsigned x = code_of(c_out) * 4 + code_of(c_in);
		fh = srol1(fh) ^ tb.roll_f[x];
		rh = sror1(rh ^ tb.roll_r[x]);
		bad += (int)(tb.cls[c_in] != 0) - (int)(tb.cls[c_out] != 0);
	}

	__device__ __forceinline__ bool ok() const { return bad == 0; }
	__device__ __forceinline__ uint64_t can() const { return fh < rh ? fh : rh; }
};

// Calls fn(j, can, ok) for each window j < heads of the thread's 32, in
// order: ok when its k bytes are all ACGTacgt (can is then its canonical
// hash).  Returns the ok bits.
template <typename Fn>
__device__ __forceinline__ uint32_t each_window(const Tables& tb, const uint8_t* row, int k,
                                                int heads, Fn&& fn)
{
	Roller r;
	r.first(tb, row, k);
	uint32_t bits = 0;
	for (int j = 0; j < heads; ++j) {
		if (j > 0)
			r.roll(tb, row, k, j);
		bits |= (uint32_t)r.ok() << j;
		fn(j, r.can(), r.ok());
	}
	return bits;
}

// hash j of a canonical hash; kmul = k * MULTISEED
__device__ __forceinline__ uint64_t hash_j(uint64_t can, int j, uint64_t kmul)
{
	return j ? extended(can, (uint64_t)j ^ kmul) : can;
}

// The thread's word index and its number of windows below n; -1 when the
// thread has none.
__device__ __forceinline__ int thread_heads(uint64_t n, uint64_t n_words, uint64_t& word)
{
	word = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
	if (word >= n_words)
		return -1;
	const uint64_t left = n - word * kHeads;
	return left < kHeads ? (int)left : kHeads;
}

// The ok bits of a thread's windows (all k bytes ACGTacgt), without hashing.
__device__ __forceinline__ uint32_t valid_bits(const Tables& tb, const uint8_t* row, int k, int heads)
{
	int bad = 0;
	for (int i = 0; i < k; ++i)
		bad += tb.cls[tile_byte(row, i)] != 0;
	uint32_t bits = bad == 0;
	for (int j = 1; j < heads; ++j) {
		bad += (int)(tb.cls[tile_byte(row, j - 1 + k)] != 0) - (int)(tb.cls[row[j - 1]] != 0);
		bits |= (uint32_t)(bad == 0) << j;
	}
	return bits;
}

// Whether a hash lies in the histogram's sample slice s (s = 0: every
// hash): the top s bits of its mixed key are clear.  uint64 arithmetic:
// the multiplies wrap and the shifts are logical.  0 <= s <= 64.
__device__ __forceinline__ bool in_sample(uint64_t h, int s)
{
	if (s == 0)
		return true;
	uint64_t x = h * 0x9E3779B97F4A7C15ULL;
	x ^= x >> 29;
	x *= 0xBF58476D1CE4E5B9ULL;
	x ^= x >> 32;
	return (x >> (64 - s)) == 0;
}

// The sum of v over the block, in thread 0; every thread calls it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warp_sum, unsigned t)
{
#pragma unroll
	for (int d = 16; d > 0; d >>= 1)
		v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
	if ((t & 31) == 0)
		warp_sum[t >> 5] = v;
	__syncthreads();
	uint32_t sum = 0;
	if (t == 0)
		for (int w = 0; w < kThreads / 32; ++w)
			sum += warp_sum[w];
	return sum;
}

// The count form: block b's emitted windows (valid, in sample slice s)
// into counts[b] and its valid windows into counts[gridDim.x + b].
template <bool kSample>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_valid_count_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int s,
                        int32_t* __restrict__ counts, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ Tables tb;
	__shared__ uint32_t warp_sum[2][kThreads / 32];
	const unsigned t = threadIdx.x;
	prologue(tb, tile, seq, k, t);
	uint64_t word;
	const int heads = thread_heads(n, n_words, word);  // -1: no windows, but the barriers
	const uint8_t* row = tile + t * kRowStride;
	uint32_t valid = 0, emit = 0;
	if (heads > 0) {
		if (kSample)
			valid = each_window(tb, row, k, heads, [&](int j, uint64_t can, bool ok) {
				emit |= (uint32_t)(ok && in_sample(can, s)) << j;
			});
		else
			valid = emit = valid_bits(tb, row, k, heads);
	}
	const uint32_t e = block_sum(__popc(emit), warp_sum[0], t);
	const uint32_t v = block_sum(__popc(valid), warp_sum[1], t);
	if (t == 0) {
		counts[blockIdx.x] = (int32_t)e;
		counts[gridDim.x + blockIdx.x] = (int32_t)v;
	}
}

constexpr int kStageBytes = kTile * 8;  // the emit form's dynamic shared memory

// The emit form: the canonical hashes of block b's windows that are valid
// and in sample slice s, in window order, at out[ends[b] - (its count)]
// (``ends`` the inclusive scan of the count form's counts[0, blocks)).
__global__ void __launch_bounds__(kThreads, 2)
kmer_valid_hashes_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int s,
                         const int64_t* __restrict__ ends, uint64_t* __restrict__ out,
                         uint64_t n_words)
{
	extern __shared__ __align__(16) uint64_t stage[];  // kTile: thread t's in [32 t, 32 t + 32)
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ Tables tb;
	__shared__ uint32_t warp_sum[kThreads / 32];
	const unsigned t = threadIdx.x, lane = t & 31, w = t >> 5;
	prologue(tb, tile, seq, k, t);
	uint64_t word;
	const int heads = thread_heads(n, n_words, word);
	const uint8_t* row = tile + t * kRowStride;
	uint64_t* mine = stage + t * kHeads;
	uint32_t c = 0;  // the thread's emitted windows
	if (heads > 0)
		each_window(tb, row, k, heads, [&](int, uint64_t can, bool ok) {
			if (ok && in_sample(can, s)) {
				mine[(c + t) & 31] = can;  // swizzled: the warp's lanes on distinct banks
				++c;
			}
		});
	uint32_t x = c;  // inclusive scan over the warp
#pragma unroll
	for (int d = 1; d < 32; d <<= 1) {
		const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
		if (lane >= (unsigned)d)
			x += y;
	}
	if (lane == 31)
		warp_sum[w] = x;
	__syncthreads();
	uint64_t base = blockIdx.x ? (uint64_t)ends[blockIdx.x - 1] : 0;
	for (unsigned v = 0; v < w; ++v)
		base += warp_sum[v];
	const uint32_t before = x - c;
	// the warp writes its lanes' runs in lane order: lane l takes element l
	for (int src = 0; src < 32; ++src) {
		const uint32_t cs = __shfl_sync(0xFFFFFFFFu, c, src);
		const uint32_t at = __shfl_sync(0xFFFFFFFFu, before, src);
		const unsigned ts = (w << 5) + src;
		if (lane < cs)
			out[base + at + lane] = stage[ts * kHeads + ((lane + ts) & 31)];
	}
}

// Windows a thread takes per round of the partition at ``hash_num``: a
// round's entries (kThreads * windows * hash_num) fit the stage.
__host__ __device__ __forceinline__ int round_windows(int hash_num)
{
	return kStage / (kThreads * hash_num);
}

// local[s] = the sum of counts[s' * columns + col] over s' < s (a block's
// exclusive scan over the slices); every thread of the block calls it.
__device__ __forceinline__ void scan_slices(const int32_t* counts, uint64_t columns, uint64_t col,
                                            int n_slices, uint32_t* local, uint32_t* warp_sum,
                                            unsigned t)
{
	constexpr int kPer = kMaxSlices / kThreads;
	uint32_t v[kPer], sum = 0;
#pragma unroll
	for (int i = 0; i < kPer; ++i) {
		const int s = t * kPer + i;
		v[i] = s < n_slices ? (uint32_t)counts[(uint64_t)s * columns + col] : 0;
		sum += v[i];
	}
	uint32_t x = sum;  // inclusive scan over the warp
#pragma unroll
	for (int d = 1; d < 32; d <<= 1) {
		const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
		if ((t & 31) >= (unsigned)d)
			x += y;
	}
	if ((t & 31) == 31)
		warp_sum[t >> 5] = x;
	__syncthreads();
	uint32_t before = x - sum;
	for (unsigned w = 0; w < (t >> 5); ++w)
		before += warp_sum[w];
#pragma unroll
	for (int i = 0; i < kPer; ++i) {
		const int s = t * kPer + i;
		if (s < n_slices)
			local[s] = before;
		before += v[i];
	}
	__syncthreads();
}

// The partition of the count pass.  Block b takes its 8192 windows in
// rounds: in round r each thread takes its windows [r * W, (r + 1) * W)
// (W = round_windows(hash_num)), so column b * rounds + r of the
// [slices x columns] count matrix ``counts`` (slice-major) holds the
// round's increments per slice, and ``ends`` is its inclusive scan:
// (slice s, column c)'s range of ``entries`` starts at ends[s * columns + c]
// - counts[s * columns + c].  kScatter false counts; kScatter true stages
// the round's offsets in shared memory by slice (a cursor per slice) and
// then writes each slice's run out, consecutive lanes on consecutive
// addresses.
template <bool kScatter>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_partition_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int hash_num,
                      uint64_t slots, uint64_t magic, int slice_bits, int n_slices,
                      int32_t* __restrict__ counts, const int64_t* __restrict__ ends,
                      uint32_t* __restrict__ entries, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ Tables tb;
	__shared__ uint32_t fill[kMaxSlices];                  // the round's entries per slice so far
	__shared__ uint32_t local[kScatter ? kMaxSlices : 1];  // where each slice's run starts in stage
	__shared__ uint32_t stage[kScatter ? kStage : 1];
	__shared__ uint32_t warp_sum[kThreads / 32];
	const unsigned t = threadIdx.x;
	const int per_round = round_windows(hash_num);
	const int rounds = (kHeads + per_round - 1) / per_round;
	const uint64_t columns = (uint64_t)gridDim.x * rounds;
	for (int s = t; s < n_slices; s += kThreads)
		fill[s] = 0;
	prologue(tb, tile, seq, k, t);
	uint64_t word;
	const int heads = thread_heads(n, n_words, word);  // -1: no windows, but every barrier
	const uint64_t kmul = (uint64_t)k * kMultiSeed;
	const uint64_t in_slice = (1ULL << slice_bits) - 1;
	const uint8_t* row = tile + t * kRowStride;
	Roller r;
	for (int round = 0; round < rounds; ++round) {
		const uint64_t col = (uint64_t)blockIdx.x * rounds + round;
		if (kScatter)
			scan_slices(counts, columns, col, n_slices, local, warp_sum, t);
		const int hi = min((round + 1) * per_round, heads);
		for (int j = round * per_round; j < hi; ++j) {
			if (j == 0)
				r.first(tb, row, k);
			else
				r.roll(tb, row, k, j);
			if (!r.ok())
				continue;
			const uint64_t can = r.can();
			for (int h = 0; h < hash_num; ++h) {
				const uint64_t slot = fastmod(hash_j(can, h, kmul), slots, magic);
				const uint32_t s = (uint32_t)(slot >> slice_bits);
				if (kScatter)
					stage[local[s] + atomicAdd(&fill[s], 1u)] = (uint32_t)(slot & in_slice);
				else
					atomicAdd(&fill[s], 1u);
			}
		}
		__syncthreads();
		if (kScatter) {  // warp w writes the runs of slices w, w + 8, ...
			for (int s = t >> 5; s < n_slices; s += kThreads / 32) {
				const uint64_t c = (uint64_t)s * columns + col;
				const uint64_t at = (uint64_t)(ends[c] - counts[c]);
				for (uint32_t i = t & 31; i < fill[s]; i += 32)
					entries[at + i] = stage[local[s] + i];
			}
		} else {
			for (int s = t; s < n_slices; s += kThreads)
				counts[(uint64_t)s * columns + col] = (int32_t)fill[s];
		}
		__syncthreads();
		for (int s = t; s < n_slices; s += kThreads)
			fill[s] = 0;
		__syncthreads();
	}
}

// where slice s's bucket starts in ``entries``
__device__ __forceinline__ uint64_t bucket_start(const int32_t* counts, const int64_t* ends,
                                                 uint64_t columns, int s)
{
	const uint64_t c = (uint64_t)s * columns;
	return (uint64_t)(ends[c] - counts[c]);
}

// Applies the binned increments: entry i of slice s's bucket raises
// counter (s << slice_bits) | entries[i], saturating at 255.  Block b takes
// entries [b * kApplyChunk, (b + 1) * kApplyChunk) of all the buckets in
// slice order; blocks past the last entry return.
__global__ void __launch_bounds__(kThreads)
kmer_count_apply_kernel(const uint32_t* __restrict__ entries, const int32_t* __restrict__ counts,
                        const int64_t* __restrict__ ends, uint64_t columns, int n_slices,
                        int slice_bits, uint32_t* __restrict__ counters)
{
	__shared__ int first_slice;
	const uint64_t total = (uint64_t)ends[(uint64_t)n_slices * columns - 1];
	const uint64_t first = (uint64_t)blockIdx.x * kApplyChunk;
	if (first >= total)
		return;  // the whole block
	if (threadIdx.x == 0) {  // the last slice whose bucket starts at or before ``first``
		int lo = 0, hi = n_slices - 1;
		while (lo < hi) {
			const int mid = (lo + hi + 1) / 2;
			if (bucket_start(counts, ends, columns, mid) <= first)
				lo = mid;
			else
				hi = mid - 1;
		}
		first_slice = lo;
	}
	__syncthreads();
	int s = first_slice;
	uint64_t next = s + 1 < n_slices ? bucket_start(counts, ends, columns, s + 1) : ~0ULL;
	uint32_t* word[kApplyPerThread];
	uint32_t shift[kApplyPerThread], old[kApplyPerThread], seen[kApplyPerThread];
	bool live[kApplyPerThread];
#pragma unroll
	for (int u = 0; u < kApplyPerThread; ++u) {
		const uint64_t i = first + threadIdx.x + (uint64_t)u * kThreads;
		live[u] = i < total;
		word[u] = counters;
		shift[u] = 0;
		if (live[u]) {
			while (i >= next) {  // entries rise with u: the slice only moves forward
				++s;
				next = s + 1 < n_slices ? bucket_start(counts, ends, columns, s + 1) : ~0ULL;
			}
			const uint64_t slot = ((uint64_t)s << slice_bits) | entries[i];
			word[u] = counters + (slot >> 2);
			shift[u] = (uint32_t)(slot & 3) * 8;
		}
	}
#pragma unroll
	for (int u = 0; u < kApplyPerThread; ++u)
		old[u] = live[u] ? __ldcg(word[u]) : 0xFFFFFFFFu;  // L2; a stale value costs one more CAS
#pragma unroll
	for (int u = 0; u < kApplyPerThread; ++u) {
		live[u] = ((old[u] >> shift[u]) & 0xFFu) != 0xFFu;
		seen[u] = live[u] ? atomicCAS(word[u], old[u], old[u] + (1u << shift[u])) : old[u];
	}
#pragma unroll
	for (int u = 0; u < kApplyPerThread; ++u) {
		if (!live[u])
			continue;
		uint32_t cur = old[u], got = seen[u];
		while (got != cur) {  // another thread changed the word first
			cur = got;
			if (((cur >> shift[u]) & 0xFFu) == 0xFFu)
				break;
			got = atomicCAS(word[u], cur, cur + (1u << shift[u]));
		}
	}
}

// bit s of ``out`` (little-endian uint32 words) = counters[s] >= cutoff for
// s < slots, 0 past them.  Thread g reads the 16 counters [16 g, 16 g + 16)
// (one 16-byte load where the table allows), and lanes 2m and 2m + 1 join
// their halves into output word m of the warp.
__global__ void __launch_bounds__(kThreads)
kmer_solid_bits_kernel(const uint32_t* __restrict__ counters, uint64_t slots, int cutoff,
                       int aligned16, uint32_t* __restrict__ out, uint64_t n_out)
{
	const uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
	const uint64_t n_cwords = (slots + 3) / 4;  // the table's 32-bit words
	uint32_t v[4] = {0, 0, 0, 0};
	if (aligned16 && 4 * g + 3 < n_cwords) {
		const uint4 q = __ldg(reinterpret_cast<const uint4*>(counters) + g);
		v[0] = q.x;
		v[1] = q.y;
		v[2] = q.z;
		v[3] = q.w;
	} else {
#pragma unroll
		for (int q = 0; q < 4; ++q)
			if (4 * g + q < n_cwords)
				v[q] = __ldg(counters + 4 * g + q);
	}
	uint32_t bits = 0;
#pragma unroll
	for (int b = 0; b < 16; ++b)
		bits |= (uint32_t)((int)((v[b >> 2] >> (8 * (b & 3))) & 0xFFu) >= cutoff) << b;
	const uint64_t lo = 16 * g;  // counters past ``slots`` are padding: their bits are 0
	bits &= lo >= slots ? 0u : (slots - lo >= 16 ? 0xFFFFu : (1u << (slots - lo)) - 1);
	bits <<= 16 * (threadIdx.x & 1);
	bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
	if (!(threadIdx.x & 1) && (g >> 1) < n_out)
		out[g >> 1] = bits;
}

template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_insert_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int hash_num,
                   const uint32_t* __restrict__ solid, uint64_t slots, uint64_t slots_magic,
                   uint32_t* __restrict__ words, uint64_t modulus, uint64_t magic, int wbits,
                   uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ Tables tb;
	prologue(tb, tile, seq, k, threadIdx.x);
	uint64_t word;
	const int heads = thread_heads(n, n_words, word);
	if (heads < 0)
		return;
	const uint64_t kmul = (uint64_t)k * kMultiSeed;
	const uint8_t* row = tile + threadIdx.x * kRowStride;
	each_window(tb, row, k, heads, [&](int, uint64_t can, bool ok) {
		if (!ok)
			return;
		if (solid) {  // every one of the window's slots must be solid
			uint32_t all = 1;
			for (int j0 = 0; j0 < hash_num; j0 += kCounterBatch) {
				uint32_t got[kCounterBatch], bit[kCounterBatch];
#pragma unroll
				for (int u = 0; u < kCounterBatch; ++u) {
					const int j = j0 + u;
					const uint64_t slot = fastmod(hash_j(can, j, kmul), slots, slots_magic);
					bit[u] = (uint32_t)slot & 31;
					got[u] = load_if(solid + (slot >> 5), j < hash_num, ~0u);
				}
#pragma unroll
				for (int u = 0; u < kCounterBatch; ++u)
					all &= got[u] >> bit[u];
			}
			if (!(all & 1))
				return;
		}
		if (L == kBlocked) {
			uint32_t mask = 0;
			for (int j = 0; j < hash_num; ++j)
				mask |= 1u << ((can >> (wbits + 5 * j)) & 31);
			atomicOr(words + (can & (modulus - 1)), mask);
		} else {
			for (int j = 0; j < hash_num; ++j) {
				const uint64_t bit = fastmod(hash_j(can, j, kmul), modulus, magic);
				atomicOr(words + (bit >> 5), 1u << (bit & 31));
			}
		}
	});
}

__device__ __forceinline__ uint64_t mix64(uint64_t c)
{
	uint64_t z = (c + 1) * 0x9E3779B97F4A7C15ULL;  // splitmix64, as gate_kernel.cu's floor
	z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
	z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
	return z ^ (z >> 31);
}

// Thread tid of ``threads`` makes the ops c in [ops * tid / threads,
// ops * (tid + 1) / threads): atomicAdd(table[mix64(c) mod size], 1), with
// kApplyPerThread in flight, and writes the sum of what they returned.
__global__ void __launch_bounds__(kThreads)
atomic_floor_kernel(uint32_t* __restrict__ table, uint64_t size, uint64_t magic, uint64_t ops,
                    uint64_t threads, uint32_t* __restrict__ out)
{
	const uint64_t tid = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
	if (tid >= threads)
		return;
	const uint64_t lo = ops * tid / threads, hi = ops * (tid + 1) / threads;
	uint32_t acc = 0;
	for (uint64_t c = lo; c < hi; c += kApplyPerThread) {
		uint32_t got[kApplyPerThread];
#pragma unroll
		for (int u = 0; u < kApplyPerThread; ++u)
			got[u] = c + u < hi ? atomicAdd(table + fastmod(mix64(c + u), size, magic), 1u) : 0;
#pragma unroll
		for (int u = 0; u < kApplyPerThread; ++u)
			acc += got[u];
	}
	out[tid] = acc;
}

bool args_ok(uint64_t n, int k) { return n > 0 && k >= 1 && k <= kHalo + 1; }

bool sample_ok(int s) { return s >= 0 && s <= 64; }

// Lets the emit form take its stage (above the 48 KB of static shared
// memory); once per process.  cudaSuccess or the error.
int emit_smem_ok()
{
	static const cudaError_t err = cudaFuncSetAttribute(
	    kmer_valid_hashes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
	return (int)err;
}

}  // namespace

extern "C" {

// ``seq`` (16-byte aligned) must hold ceil(n / 8192) * 8192 + 1024
// readable bytes, of which the first n + k - 1 are the batch.  Each entry
// point launches on ``stream`` and returns cudaGetLastError() after each
// launch (0 on success).

// The count form of the histogram's hashes over windows [0, n), in
// ceil(n / 8192) blocks: ``counts`` (int32, 2 per block) gets each block's
// windows that are valid and in sample slice ``s`` (0: all valid), then
// each block's valid windows.
int ntb_kmer_valid_count(const void* seq, uint64_t n, int k, int s, void* counts, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || !sample_ok(s))
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const auto* q = static_cast<const uint8_t*>(seq);
	auto* c = static_cast<int32_t*>(counts);
	auto st = static_cast<cudaStream_t>(stream);
	if (s)
		kmer_valid_count_kernel<true><<<blocks_for(n_words), kThreads, 0, st>>>(q, n, k, s, c, n_words);
	else
		kmer_valid_count_kernel<false><<<blocks_for(n_words), kThreads, 0, st>>>(q, n, k, s, c, n_words);
	return (int)cudaGetLastError();
}

// The emit form: the hashes the count form counted, in window order, into
// ``out`` (uint64); ``ends`` (int64, one per block) is the inclusive scan
// of the count form's first half.
int ntb_kmer_valid_hashes(const void* seq, uint64_t n, int k, int s, const void* ends, void* out,
                          void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || !sample_ok(s))
		return (int)cudaErrorInvalidValue;
	if (const int err = emit_smem_ok())
		return err;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	kmer_valid_hashes_kernel<<<blocks_for(n_words), kThreads, kStageBytes,
	                           static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint8_t*>(seq), n, k, s, static_cast<const int64_t*>(ends),
	    static_cast<uint64_t*>(out), n_words);
	return (int)cudaGetLastError();
}

// One form of the partition of the valid windows of [0, n), in blocks of
// 8192 windows (ceil(n / 8192) of them), each in ntb_partition_rounds
// rounds: ``scatter`` 0 writes the [n_slices x blocks * rounds] int32
// ``counts``; ``scatter`` 1 reads it
// and ``ends`` (its inclusive scan, int64) and writes each increment's
// offset in its slice (uint32) into ``entries``.  ``magic`` =
// mod_magic(slots); slot h mod slots lies in slice slot >> slice_bits, of
// which the table has n_slices <= kMaxSlices.
int ntb_kmer_partition(const void* seq, uint64_t n, int k, int hash_num, uint64_t slots,
                       uint64_t magic, int slice_bits, int n_slices, void* counts,
                       const void* ends, void* entries, int scatter, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || hash_num < 1 || hash_num > kStage / kThreads || slots == 0 ||
	    slice_bits < 2 || slice_bits > 32 ||
	    n_slices < 1 || n_slices > kMaxSlices || ((slots - 1) >> slice_bits) >= (uint64_t)n_slices)
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const auto* s = static_cast<const uint8_t*>(seq);
	auto* c = static_cast<int32_t*>(counts);
	const auto* e = static_cast<const int64_t*>(ends);
	auto* out = static_cast<uint32_t*>(entries);
	auto st = static_cast<cudaStream_t>(stream);
	if (scatter)
		kmer_partition_kernel<true><<<blocks_for(n_words), kThreads, 0, st>>>(
		    s, n, k, hash_num, slots, magic, slice_bits, n_slices, c, e, out, n_words);
	else
		kmer_partition_kernel<false><<<blocks_for(n_words), kThreads, 0, st>>>(
		    s, n, k, hash_num, slots, magic, slice_bits, n_slices, c, e, out, n_words);
	return (int)cudaGetLastError();
}

// Entries a block of the apply kernel takes.
int ntb_apply_chunk() { return kApplyChunk; }

// Rounds of a partition block at ``hash_num`` (its columns of the count
// matrix); 0 when hash_num is out of range.
int ntb_partition_rounds(int hash_num)
{
	if (hash_num < 1 || hash_num > kStage / kThreads)
		return 0;
	const int w = round_windows(hash_num);
	return (kHeads + w - 1) / w;
}

// The binned increments of a partition of ``columns`` columns into
// ``counters`` (4-byte aligned, padded to whole words).  ``max_entries``
// bounds the entries (hash_num times the batch's windows): the launch
// covers that many, and blocks past the scan's total return.
int ntb_kmer_count_apply(const void* entries, const void* counts, const void* ends,
                         uint64_t columns, int n_slices, int slice_bits, uint64_t max_entries,
                         void* counters, void* stream)
{
	if (max_entries == 0)
		return 0;
	if (columns == 0 || n_slices < 1 || n_slices > kMaxSlices || slice_bits < 2 || slice_bits > 32)
		return (int)cudaErrorInvalidValue;
	const uint64_t grid = (max_entries + kApplyChunk - 1) / kApplyChunk;
	if (grid > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	kmer_count_apply_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint32_t*>(entries), static_cast<const int32_t*>(counts),
	    static_cast<const int64_t*>(ends), columns, n_slices, slice_bits,
	    static_cast<uint32_t*>(counters));
	return (int)cudaGetLastError();
}

// The solid bits of ``slots`` counters (4-byte aligned, padded to whole
// words) at ``cutoff`` into ceil(slots / 32) words ``out``.
int ntb_kmer_solid_bits(const void* counters, uint64_t slots, int cutoff, void* out, void* stream)
{
	if (slots == 0)
		return 0;
	const uint64_t n_out = (slots + 31) / 32;
	const uint64_t threads = 2 * n_out;
	if ((threads + kThreads - 1) / kThreads > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	const int aligned16 = (reinterpret_cast<uintptr_t>(counters) & 15) == 0;
	kmer_solid_bits_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint32_t*>(counters), slots, cutoff, aligned16,
	    static_cast<uint32_t*>(out), n_out);
	return (int)cudaGetLastError();
}

// Threshold insertion of the valid windows of [0, n) into ``words``:
// ``layout`` 1 (blocked: ``modulus`` = words, a power of two, ``wbits`` its
// log2) or 0 (plain: ``modulus`` = bits, ``magic`` = mod_magic(bits)).
// With ``solid`` (the solid bits of ``slots`` counters, ``slots_magic`` =
// mod_magic(slots)) a window needs the bits of its ``hash_num`` slots all
// set; with ``solid`` null every valid window goes in.
int ntb_kmer_insert(const void* seq, uint64_t n, int k, int hash_num, const void* solid,
                    uint64_t slots, uint64_t slots_magic, void* words, uint64_t modulus,
                    uint64_t magic, int wbits, int layout, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || hash_num < 1 || modulus == 0 || (solid && slots == 0))
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const auto* s = static_cast<const uint8_t*>(seq);
	const auto* b = static_cast<const uint32_t*>(solid);
	auto* w = static_cast<uint32_t*>(words);
	auto st = static_cast<cudaStream_t>(stream);
	const unsigned blocks = blocks_for(n_words);
	if (layout == kBlocked) {
		if (wbits < 0 || wbits + 5 * hash_num > 64)
			return (int)cudaErrorInvalidValue;
		kmer_insert_kernel<kBlocked><<<blocks, kThreads, 0, st>>>(
		    s, n, k, hash_num, b, slots, slots_magic, w, modulus, magic, wbits, n_words);
	} else if (layout == kPlain) {
		kmer_insert_kernel<kPlain><<<blocks, kThreads, 0, st>>>(
		    s, n, k, hash_num, b, slots, slots_magic, w, modulus, magic, wbits, n_words);
	} else {
		return (int)cudaErrorInvalidValue;
	}
	return (int)cudaGetLastError();
}

// The atomic floor: ``threads`` threads make ``ops`` random atomicAdds of 1
// into ``table`` (``size`` uint32 words, ``magic`` = mod_magic(size));
// ``out`` gets each thread's sum of the old values.
int ntb_atomic_floor(void* table, uint64_t size, uint64_t magic, uint64_t ops, uint64_t threads,
                     void* out, void* stream)
{
	if (threads == 0 || size == 0 || (threads + kThreads - 1) / kThreads > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	atomic_floor_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<uint32_t*>(table), size, magic, ops, threads, static_cast<uint32_t*>(out));
	return (int)cudaGetLastError();
}

// Resident blocks per SM: which = 0 hashes emit form, 1 partition count,
// 2 partition scatter, 3 apply, 4 solid bits, 5 insert plain, 6 insert
// blocked, 7 the atomic floor, 8 and 9 the hashes count form without and
// with sampling.  Negative on error.
int ntb_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0:
		err = static_cast<cudaError_t>(emit_smem_ok());
		if (err == cudaSuccess)
			err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_valid_hashes_kernel, kThreads,
			                                                    kStageBytes);
		break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_partition_kernel<false>, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_partition_kernel<true>, kThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_count_apply_kernel, kThreads, 0); break;
	case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_solid_bits_kernel, kThreads, 0); break;
	case 5: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_insert_kernel<kPlain>, kThreads, 0); break;
	case 6: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_insert_kernel<kBlocked>, kThreads, 0); break;
	case 7: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, atomic_floor_kernel, kThreads, 0); break;
	case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_valid_count_kernel<false>, kThreads, 0); break;
	case 9: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_valid_count_kernel<true>, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* ntb_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ntb_tile_heads() { return kTile; }
int ntb_halo_bytes() { return kHalo; }
int ntb_max_slices() { return kMaxSlices; }

}  // extern "C"
