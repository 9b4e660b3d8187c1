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
// kmer_hashes_kernel writes can for every window (0 for an invalid one)
// and a validity word per 32 windows, little-endian as the gate words.
//
// kmer_count_kernel adds one, saturating at 255, to counter h_j mod slots
// for every valid window and every j < hash_num (btllib's counting filter;
// two j landing on one slot count twice, as np.unique(return_counts) of the
// host's [n, m] hashes does).  CUDA has no 8-bit atomic: the byte is raised
// by an atomicCAS loop on the aligned 32-bit word that holds it, and the
// loop stops at 255, so the counter table is padded to a multiple of 4
// bytes.  Saturation is monotone, so the order of the increments does not
// change the result.  The modulo is exact for any slot count (fastmod); the
// XLA program reduced the low 32 bits only, which folds tables above 2^32
// slots (ROADMAP.md section 3).
//
// kmer_insert_kernel sets a valid window's bits when cutoff <= 1, or when
// the minimum of its hash_num counters is at least cutoff (count-min: a
// k-mer is never undercounted):
//   blocked - one atomicOr of the mask of hash_num 5-bit offsets, bits
//             wbits + 5j of can, into word can & (words - 1);
//   plain   - hash_num atomicOrs at bit h_j mod bits, little-endian within
//             the uint32 words, which are the bytes of the btllib filter.
// OR does not depend on order, so the result is bit-exact; the XLA program
// sorted and scanned its scatter because XLA has no scatter-OR.  The
// atomics' results are unused, so they compile to fire-and-forget RED.
//
// Bound.  The hashes pass streams: 1 B of ASCII in and 8 B per window out.
// The count and insert passes make one random read-modify-write per
// (window, j) in a table far larger than the L2 (counters: hundreds of MB
// at bacterial scale), so like the gate kernel they are held by the rate at
// which the memory serves random 32-byte sectors, here as L2 atomics, not by
// bytes per second.  The design keeps the gate kernel's front end
// (nthash.cuh): a thread owns 32 consecutive windows, a block of 256 threads
// holds its 8192-window tile in shared memory, the hash rolls, and the
// insert pass sends its counter reads for up to four hashes together as
// predicated loads.  Every index is 64-bit.

#include "nthash.cuh"

namespace {

using namespace nth;

constexpr int kCounterBatch = 4;  // counter reads of one window in flight (insert)

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

// Calls fn(j, can, ok) for each window j < heads of the thread's 32, in
// order: ok when its k bytes are all ACGTacgt (can is then its canonical
// hash).  Returns the ok bits.
template <typename Fn>
__device__ __forceinline__ uint32_t each_window(const Tables& tb, const uint8_t* row, int k,
                                                int heads, Fn&& fn)
{
	uint64_t fh = 0, rh = 0;
	int bad = 0;
	for (int i = 0; i < k; ++i) {
		const unsigned c = tile_byte(row, i);
		fh = srol1(fh) ^ tb.seed_f[code_of(c)];
		rh = srol1(rh) ^ tb.seed_r[code_of(tile_byte(row, k - 1 - i))];
		bad += tb.cls[c] != 0;
	}
	uint32_t bits = 0;
	for (int j = 0; j < heads; ++j) {
		if (j > 0) {
			const unsigned c_out = row[j - 1], c_in = tile_byte(row, j - 1 + k);
			const unsigned x = code_of(c_out) * 4 + code_of(c_in);
			fh = srol1(fh) ^ tb.roll_f[x];
			rh = sror1(rh ^ tb.roll_r[x]);
			bad += (int)(tb.cls[c_in] != 0) - (int)(tb.cls[c_out] != 0);
		}
		const bool ok = bad == 0;
		bits |= (uint32_t)ok << j;
		fn(j, fh < rh ? fh : rh, ok);
	}
	return bits;
}

// hash j of a canonical hash; kmul = k * MULTISEED
__device__ __forceinline__ uint64_t hash_j(uint64_t can, int j, uint64_t kmul)
{
	return j ? extended(can, (uint64_t)j ^ kmul) : can;
}

// counters[slot] = min(counters[slot] + 1, 255), counters as aligned words
__device__ __forceinline__ void saturating_inc(uint32_t* words, uint64_t slot)
{
	uint32_t* w = words + (slot >> 2);
	const unsigned shift = (unsigned)(slot & 3) * 8;
	uint32_t old = *w;  // a stale value only costs one more CAS
	while (((old >> shift) & 0xFFu) != 0xFFu) {
		const uint32_t seen = atomicCAS(w, old, old + (1u << shift));
		if (seen == old)
			return;
		old = seen;
	}
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_hashes_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, uint64_t* __restrict__ hashes,
                   uint32_t* __restrict__ valid, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ Tables tb;
	prologue(tb, tile, seq, k, threadIdx.x);
	uint64_t word;
	const int heads = thread_heads(n, n_words, word);
	if (heads < 0)
		return;
	uint64_t* out = hashes + word * kHeads;
	const uint8_t* row = tile + threadIdx.x * kRowStride;
	const uint32_t bits = each_window(tb, row, k, heads, [&](int j, uint64_t can, bool ok) {
		out[j] = ok ? can : 0;
	});
	valid[word] = bits;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_count_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int hash_num,
                  uint32_t* __restrict__ counters, uint64_t slots, uint64_t magic, uint64_t n_words)
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
		for (int j = 0; j < hash_num; ++j)
			saturating_inc(counters, fastmod(hash_j(can, j, kmul), slots, magic));
	});
}

template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmer_insert_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k, int hash_num,
                   const uint8_t* __restrict__ counters, uint64_t slots, uint64_t slots_magic,
                   int cutoff, uint32_t* __restrict__ words, uint64_t modulus, uint64_t magic,
                   int wbits, uint64_t n_words)
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
		if (cutoff > 1) {
			uint32_t low = 255;
			for (int j0 = 0; j0 < hash_num; j0 += kCounterBatch) {
				uint32_t got[kCounterBatch];
#pragma unroll
				for (int u = 0; u < kCounterBatch; ++u) {
					const int j = j0 + u;
					const uint64_t slot = fastmod(hash_j(can, j, kmul), slots, slots_magic);
					got[u] = load_if(counters + slot, j < hash_num, 255);
				}
#pragma unroll
				for (int u = 0; u < kCounterBatch; ++u)
					low = got[u] < low ? got[u] : low;
			}
			if (low < (uint32_t)cutoff)
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

bool args_ok(uint64_t n, int k) { return n > 0 && k >= 1 && k <= kHalo + 1; }

}  // namespace

extern "C" {

// ``seq`` (16-byte aligned) must hold ceil(n / 8192) * 8192 + 1024
// readable bytes, of which the first n + k - 1 are the batch.  Each entry
// point launches on ``stream`` and returns cudaGetLastError() after the
// launch (0 on success).

// Canonical hash of windows [0, n) into ``hashes`` (n uint64, 0 where
// invalid) and their validity into ``valid`` (ceil(n / 32) words).
int ntb_kmer_hashes(const void* seq, uint64_t n, int k, void* hashes, void* valid, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k))
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	kmer_hashes_kernel<<<blocks_for(n_words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint8_t*>(seq), n, k, static_cast<uint64_t*>(hashes),
	    static_cast<uint32_t*>(valid), n_words);
	return (int)cudaGetLastError();
}

// Count-min increments of the valid windows of [0, n) into ``counters``
// (``slots`` counters, the array padded to a multiple of 4 bytes and
// 4-byte aligned); ``magic`` = mod_magic(slots).
int ntb_kmer_count(const void* seq, uint64_t n, int k, int hash_num, void* counters, uint64_t slots,
                   uint64_t magic, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || hash_num < 1 || slots == 0)
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	kmer_count_kernel<<<blocks_for(n_words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint8_t*>(seq), n, k, hash_num, static_cast<uint32_t*>(counters), slots,
	    magic, n_words);
	return (int)cudaGetLastError();
}

// Threshold insertion of the valid windows of [0, n) into ``words``:
// ``layout`` 1 (blocked: ``modulus`` = words, a power of two, ``wbits`` its
// log2) or 0 (plain: ``modulus`` = bits, ``magic`` = mod_magic(bits)).
// With ``cutoff`` > 1 a window needs its ``hash_num`` counters (``slots``
// of them, ``slots_magic`` = mod_magic(slots)) all at least ``cutoff``;
// otherwise ``counters`` is not read.
int ntb_kmer_insert(const void* seq, uint64_t n, int k, int hash_num, const void* counters,
                    uint64_t slots, uint64_t slots_magic, int cutoff, void* words,
                    uint64_t modulus, uint64_t magic, int wbits, int layout, void* stream)
{
	if (n == 0)
		return 0;
	if (!args_ok(n, k) || hash_num < 1 || modulus == 0 || (cutoff > 1 && slots == 0))
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const auto* s = static_cast<const uint8_t*>(seq);
	const auto* c = static_cast<const uint8_t*>(counters);
	auto* w = static_cast<uint32_t*>(words);
	auto st = static_cast<cudaStream_t>(stream);
	const unsigned blocks = blocks_for(n_words);
	if (layout == kBlocked) {
		if (wbits < 0 || wbits + 5 * hash_num > 64)
			return (int)cudaErrorInvalidValue;
		kmer_insert_kernel<kBlocked><<<blocks, kThreads, 0, st>>>(
		    s, n, k, hash_num, c, slots, slots_magic, cutoff, w, modulus, magic, wbits, n_words);
	} else if (layout == kPlain) {
		kmer_insert_kernel<kPlain><<<blocks, kThreads, 0, st>>>(
		    s, n, k, hash_num, c, slots, slots_magic, cutoff, w, modulus, magic, wbits, n_words);
	} else {
		return (int)cudaErrorInvalidValue;
	}
	return (int)cudaGetLastError();
}

// Resident blocks per SM: which = 0 hashes, 1 count, 2 insert plain,
// 3 insert blocked.  Negative on error.
int ntb_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_hashes_kernel, kThreads, 0); break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_count_kernel, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_insert_kernel<kPlain>, kThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kmer_insert_kernel<kBlocked>, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* ntb_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ntb_tile_heads() { return kTile; }
int ntb_halo_bytes() { return kHalo; }

}  // extern "C"
