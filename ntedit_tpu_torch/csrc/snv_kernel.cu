// SNV and polish site kernels: the device side of SNV mode (-s 1) and of
// polish mode's optional probe results, on an H100.
//
// In SNV mode every head enters the engine's fix path, but a head can only
// yield a record or an edit when some alternate base's k-mer, the window
// with its last base replaced, is in the filter.  Two kernels take that
// work from the host:
//
// snv_cand_words_kernel (and the binned pass below) replaces the JAX
// package's XLA program
// ntedit_tpu/engine/flag.py::_snv_cand_words_from_codes (and its ASCII form
// snv_candidates_chunk) together with the host pass that patched its result
// (_exception_hints, _apply_exceptions).  For every head h of a chunk, with
// tail byte t = seq[h + k - 1]:
//
//   cand(h) = valid(h) & (has_iupac(h) | OR over b in ACGT, b != fold(t):
//             contains(canonical(fh ^ seed(t) ^ seed(b),
//                                rh ^ srol^(k-1)(cseed(t)) ^ srol^(k-1)(cseed(b)))))
//
// packed 32 heads per little-endian uint32.  valid and has_iupac are the
// gate kernel's: every byte accepted; some byte accepted but not ACGTacgt.
//
// site_rows_kernel<L, false> replaces _snv_site_data_from_codes and the row
// validity of its caller snv_site_data.  For every candidate head h it
// writes the six bytes the host engine consumes instead of probing
// (native/repair.cpp, fix_site):
//
//   row[0]   bit 0 = row valid; bit 1 + c = contains(window at h with its
//            last base replaced by "ACGT"[c]), all four c
//   row[1]   check_there: over kk in [0, k) with kk % jump == 0, the
//            pristine windows at heads h + 1 + kk that are present
//   row[2+c] the same count with position h + k - 1 replaced by "ACGT"[c]
//            (kk = k - 1 starts past it: the pristine window)
//
// counts saturated at 255.  A row is valid when h <= n - k - 1 and every
// byte of [h, h + 2k), all that those windows read, is ACGTacgt; an invalid
// row is six zeros and the engine probes live.
//
// site_rows_kernel<L, true> replaces the polish form of that program,
// _polish_site_data_from_codes, and the row assembly of its caller
// iter_polish_site_chunks.  It takes a chunk's sorted gate heads and writes
// one row per gate, so the rows go back parallel to the gates:
//
//   row[0]   bit 5 = "device-exact gate": the window [h, h + k) holds no
//            accepted IUPAC byte (so the gate is the filter's own verdict,
//            not a forced one) and the engine may skip its re-probe;
//            bits 0-4 as above, at a cluster start with a valid row
//   row[1]   check_missing = strides - check_there: the absent stride
//            windows, the engine's attempt gate
//   row[2+c] the verify counts as above
//
// A cluster start is a gate whose predecessor in the list is not h - 1 (the
// list's first gate included: a row is exact, so an extra one is safe).
// Later gates of a cluster are re-evaluated against edited content by the
// engine and carry bit 5 alone.
//
// cand_masks_kernel replaces _polish_cand_planes_from_codes with its
// gather _gather_cand_masks.  For every gate head h (int64) it writes one
// byte: bit c = contains(window at h with its last base set to "ACGT"[c]),
// all four c, the draft's own base included; 0xFF when [h, h + k) holds a
// byte that is not ACGTacgt (no information: the engine probes live).  The
// XLA program computed four bit planes over every head and gathered at the
// gates; the kernel computes at the gates only.
//
// Bound.  All but the binned pass are bound as the gate kernel is: by the
// rate at which the DRAM serves random 32-byte sectors of a filter far larger than the L2
// (about 30 G probes/s, PERF.md), not by bytes per second and not by the
// hashing.  The candidate pass makes three probes per live head (blocked;
// plain: up to hash_num each, stopping at the first clear bit), beside
// 1 B of ASCII read and 1/8 B written per head.  The site pass makes about
// 4 + 5 ceil(k / jump) probes per row, on a few thousand candidates or
// cluster starts per million heads: its work is small, and what it saves is
// on the host.  The mask pass makes four probes per gate.
//
// The binned candidate pass computes the candidate kernel's words with a
// blocked filter, where a group of chunks makes many probes per filter
// sector.  The candidate kernel's probes are random 32-byte DRAM sectors
// (about 30 G/s on an H100 whatever the loads in flight: PERF.md), and a
// 2^22-head chunk makes 12.6 M of them into a 256 MiB filter's 8.4 M
// sectors.  So snv_cand_bin_kernel keeps the candidate kernel's hashing,
// stores the forced bits into the words, and bins each due probe (12 B:
// the alternate's canonical hash, from which the probe kernel takes the
// word and the mask, and its head, a 32-bit offset in the group: the
// head cannot be re-derived from the hash, and hashing it again from the
// ASCII would read k random bytes per probe) by the slice of 2^slice_bits
// words its word lies in, with the count pass's partition scheme
// (build_kernel.cu): a counting form per round of 4 heads a thread, a
// torch.cumsum of the [slices x columns] count matrix (exact ranges
// whatever the skew: a poly-A contig's probes share three words), and a
// scattering form that stages the round's entries in shared memory by
// slice and writes each slice's run coalesced.  snv_cand_probe_kernel then
// walks the entries in slice order: the slice's words stay in L2 while its
// probes run, at about 100 G random probes/s, and a present probe ORs its head's bit into the words.  The
// front end stores the forced bits before the probe kernel ORs into the
// same words; the scattering form must not store them again.  OR does not
// depend on order, so the words are bit-exact.
//
// Whether it pays depends on the density of the group's probes on the
// filter (utils/snv_sweep.py, PERF.md): on an H100 at 700 W it won or
// tied at every group of 1.31 probes per sector and above (1.38-1.41x on
// the 30 Mbp contig at 256 MiB) and lost at 0.67 and below (by up to
// 1.47x at 4 GiB), so the wrapper's rule (ops/snv_kernel.py binned) takes
// it where a group makes at least 1 probe per sector, and the candidate
// kernel elsewhere.  Slices of 2^22 words (16 MiB), raised until the
// filter has at most 64, were the fastest from 256 MiB to 4 GiB.
//
// The plain layout keeps the candidate kernel: its probes stop at the
// first clear bit of up to hash_num, and a plain filter for a contig of a
// few Mbp (snv_plain's 17.8 MB) is L2-sized already.
//
// Design.  The candidate kernel has the gate kernel's shape (nthash.cuh):
// one thread owns 32 consecutive heads and writes their word, a block of
// 256 threads holds its 8192-head tile in shared memory, the window hash
// rolls.  The changelast hashes of a head are XORs of its window hash with
// two 4-entry tables (seed(c) and srol^(k-1)(cseed(c)) by 2-bit code), so
// the thread probes only the three alternates that matter (the XLA program
// probed four and masked one) and sends the probes of one or two heads
// together as predicated loads.
//
// The site kernel gives one warp to each head of its list.  Its work items
// are the head itself (the four pre-check probes) and the ceil(k / jump)
// stride windows (five probes each: pristine and four alternates, one of
// which repeats the pristine word; one probe past the site); lane l takes
// items l, l + 32, ...  A lane hashes its window directly from the ASCII in
// global memory (k steps; the 2k bytes of a head are shared by its lanes
// through the L1), derives the alternates' hashes by XOR with the rotated
// seed difference (srol is a bit permutation, so XOR-linear), and sends its
// five probes together.  The counts meet in a shuffle reduction and lane 0
// writes the row.  In the polish form most gates are no cluster start: their
// warp reads k bytes for bit 5 and leaves.
//
// The mask kernel gives one thread to each gate: it hashes the window from
// the ASCII (gates cluster, so neighbouring threads read neighbouring bytes
// through the L1) and sends its four probes together.
//
// There are no caps and no overflow path: a list is as long as it is.
// Every index is 64-bit, grids are sized in 64 bits and checked.

#include "nthash.cuh"

namespace {

using namespace nth;

// heads hashed before their probes go out: two for blocked (six loads in
// flight); one for plain, whose probe rounds need more registers.  Under
// the cap that keeps four blocks resident (64 registers) the plain form
// spills either way, 52 bytes with two heads and 64 with one; its time is
// within 1.1x of its probe floor (PERF.md), so the spills are left alone.
constexpr int kSnvHeadsBlocked = 2;
constexpr int kSnvHeadsPlain = 1;
constexpr int kAlts = 3;                    // alternates probed per head
constexpr int kSiteThreads = 128;           // site kernel: 4 warps, one head each
constexpr int kMaskProbes = 4;              // mask kernel: the four bases at the site
constexpr int kMaxCandSlices = 256;         // binned candidate pass: filter slices (one per thread)
constexpr int kCandRoundHeads = 4;          // its front end: heads a thread takes per round
constexpr int kCandRounds = kHeads / kCandRoundHeads;
constexpr int kCandStage = kThreads * kCandRoundHeads * kAlts;  // probes a block stages per round
constexpr int kCandStageBytes = kCandStage * 12;                // dynamic shared memory
static_assert(kMaxCandSlices <= kThreads, "the slice scan takes one slice per thread");
static_assert(kCandRoundHeads % 2 == 0 && kHeads % kCandRoundHeads == 0, "whole head batches");
constexpr int kProbePerThread = 4;          // its probe kernel: entries a thread keeps in flight
constexpr int kProbeChunk = kThreads * kProbePerThread;  // entries per probe block
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The candidate pass's shared tables: the roll tables, the seeds, the
// last base's share of rh by 2-bit code, the byte classes.
struct CandTables {
	uint64_t roll_f[16], roll_r[16], seed_f[4], seed_r[4], last_r[4];
	uint8_t cls[256];
};

// The block's tables and ASCII tile; every thread of the block calls it.
__device__ __forceinline__ void cand_prologue(CandTables& tb, uint8_t* tile, const uint8_t* seq,
                                              int k, unsigned t)
{
	fill_roll_tables(tb.roll_f, tb.roll_r, tb.seed_f, tb.seed_r, tb.cls, k, t);
	if (t < 4)
		tb.last_r[t] = srol(rev_seed(t), k - 1);  // the last base's share of rh
	load_tile(tile, seq + (uint64_t)blockIdx.x * kTile, k, t);
	__syncthreads();
}

// The candidate pass's rolling window over a thread's 32 heads, shared by
// the candidate kernel and the binned front end, cut at batch boundaries
// so that the front end can run it in rounds.  ``first``
// hashes head 0's window from its k bytes; ``batch`` rolls to heads b0 ..
// b0 + kH - 1 and gives can[i * kAlts + a], the canonical hash of head
// b0 + i with its last base replaced by alternate a, bit i * kAlts + a of
// ``live`` set where that probe is due (a valid head below ``heads`` with
// no IUPAC byte), bit i of ``forced`` set for a valid head with an IUPAC
// byte.  Batches come in order.
struct CandRoller {
	uint64_t fh = 0, rh = 0;
	int bad = 0, iupac = 0;

	__device__ __forceinline__ void first(const CandTables& tb, const uint8_t* row, int k)
	{
		// fh over bytes 0..k-1, rh over k-1..0
		for (int i = 0; i < k; ++i) {
			const unsigned c = tile_byte(row, i);
			fh = srol1(fh) ^ tb.seed_f[code_of(c)];
			rh = srol1(rh) ^ tb.seed_r[code_of(tile_byte(row, k - 1 - i))];
			bad += tb.cls[c] & 1;
			iupac += tb.cls[c] >> 1;
		}
	}

	template <int kH>
	__device__ __forceinline__ void batch(const CandTables& tb, const uint8_t* row, int k, int heads,
	                                      int b0, uint64_t (&can)[kH * kAlts], uint32_t& live,
	                                      uint32_t& forced)
	{
		live = forced = 0;
#pragma unroll
		for (int i = 0; i < kH; ++i) {
			const int j = b0 + i;
			const unsigned c_last = tile_byte(row, j - 1 + k);
			if (j > 0) {
				const unsigned c_out = row[j - 1];
				const unsigned x = code_of(c_out) * 4 + code_of(c_last);
				fh = srol1(fh) ^ tb.roll_f[x];
				rh = sror1(rh ^ tb.roll_r[x]);
				bad += (tb.cls[c_last] & 1) - (tb.cls[c_out] & 1);
				iupac += (tb.cls[c_last] >> 1) - (tb.cls[c_out] >> 1);
			}
			// changelast: take the last base's seeds out, put an alternate's in
			const unsigned ct = code_of(c_last);
			const uint64_t fx = fh ^ tb.seed_f[ct], rx = rh ^ tb.last_r[ct];
#pragma unroll
			for (int a = 0; a < kAlts; ++a) {
				const unsigned cb = (ct + 1 + a) & 3;
				const uint64_t fb = fx ^ tb.seed_f[cb], rb = rx ^ tb.last_r[cb];
				can[i * kAlts + a] = fb < rb ? fb : rb;
			}
			const bool ok = j < heads && bad == 0;
			const bool force = iupac != 0;
			live |= (ok && !force ? 7u : 0u) << (i * kAlts);
			forced |= (uint32_t)(ok && force) << i;
		}
	}
};

template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
snv_cand_words_kernel(const uint8_t* __restrict__ seq, uint64_t n, Filter f,
                      uint32_t* __restrict__ out, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ CandTables tb;

	constexpr int kSnvHeads = L == kPlain ? kSnvHeadsPlain : kSnvHeadsBlocked;
	const unsigned t = threadIdx.x;
	cand_prologue(tb, tile, seq, f.k, t);

	const uint64_t word = (uint64_t)blockIdx.x * kThreads + t;
	if (word >= n_words)
		return;
	const uint64_t left = n - word * kHeads;
	const int heads = left < kHeads ? (int)left : kHeads;  // heads of this word below n
	const uint8_t* row = tile + t * kRowStride;
	CandRoller r;
	r.first(tb, row, f.k);

	uint32_t bits = 0;
#pragma unroll
	for (int b0 = 0; b0 < kHeads; b0 += kSnvHeads) {
		uint64_t can[kSnvHeads * kAlts];
		uint32_t live, forced;
		r.batch<kSnvHeads>(tb, row, f.k, heads, b0, can, live, forced);
		const uint32_t present = live & ~probe_batch<L, kSnvHeads * kAlts>(can, live, f);
#pragma unroll
		for (int i = 0; i < kSnvHeads; ++i)
			bits |= (((forced >> i) & 1) | (uint32_t)(((present >> (i * kAlts)) & 7u) != 0))
			        << (b0 + i);
	}
	out[word] = bits;
}

// The binned form's scratch: the count matrix of probes per (slice,
// column), slice-major, so a slice's bucket is contiguous and the buckets
// lie in slice order; column b * kCandRounds + r holds round r of block b
// (in round r a thread takes its heads [r * W, (r + 1) * W), W =
// kCandRoundHeads); its inclusive scan; and the entries: each probe's
// canonical hash and its head (relative to the launch's first).
struct CandBins {
	int slice_bits;       // a slice holds 2^slice_bits words
	int n_slices;
	int32_t* counts;      // [n_slices x gridDim.x * kCandRounds]
	const int64_t* ends;  // its inclusive scan
	uint64_t* can;
	uint32_t* head;
};

// local[s] = the sum of counts[s' * columns + col] over s' < s, for s <
// n_slices <= kThreads (a block's exclusive scan over the slices); every
// thread of the block calls it.
__device__ __forceinline__ void scan_slices(const int32_t* counts, uint64_t columns, uint64_t col,
                                            int n_slices, uint32_t* local, uint32_t* warp_sum,
                                            unsigned t)
{
	const uint32_t v = (int)t < n_slices ? (uint32_t)counts[(uint64_t)t * columns + col] : 0;
	uint32_t x = v;  // inclusive scan over the warp
#pragma unroll
	for (int d = 1; d < 32; d <<= 1) {
		const uint32_t y = __shfl_up_sync(kFullWarp, x, d);
		if ((t & 31) >= (unsigned)d)
			x += y;
	}
	if ((t & 31) == 31)
		warp_sum[t >> 5] = x;
	__syncthreads();
	uint32_t before = x - v;
	for (unsigned w = 0; w < (t >> 5); ++w)
		before += warp_sum[w];
	if ((int)t < n_slices)
		local[t] = before;
	__syncthreads();
}

// The binned candidate pass's front end (blocked layout): the candidate
// kernel's hashing, in kCandRounds rounds of kCandRoundHeads heads a
// thread; every due probe goes into the bucket of the slice its word lies
// in.  kScatter false writes the forced bits into ``out`` (the probe
// kernel ORs the present ones in later) and, per round, the block's probes
// per slice; kScatter true hashes the same heads again, stages each
// round's probes in shared memory sorted by slice (a cursor per slice,
// from a block scan of the round's column) and writes each slice's run to
// its range, consecutive lanes on consecutive addresses.
template <bool kScatter>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
snv_cand_bin_kernel(const uint8_t* __restrict__ seq, uint64_t n, Filter f,
                    uint32_t* __restrict__ out, uint64_t n_words, CandBins bins)
{
	extern __shared__ __align__(16) uint64_t stage_can[];  // kCandStage, then kCandStage heads
	uint32_t* stage_head = reinterpret_cast<uint32_t*>(stage_can + kCandStage);
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ CandTables tb;
	__shared__ uint32_t fill[kMaxCandSlices];   // the round's probes per slice so far
	__shared__ uint32_t local[kMaxCandSlices];  // where each slice's run starts in the stage
	__shared__ uint32_t warp_sum[kThreads / 32];
	const unsigned t = threadIdx.x;
	const uint64_t columns = (uint64_t)gridDim.x * kCandRounds;
	for (int s = t; s < bins.n_slices; s += kThreads)
		fill[s] = 0;
	cand_prologue(tb, tile, seq, f.k, t);  // its barrier covers fill

	const uint64_t word = (uint64_t)blockIdx.x * kThreads + t;
	const uint64_t left = word < n_words ? n - word * kHeads : 0;
	const int heads = left < kHeads ? (int)left : kHeads;  // 0: no heads, but every barrier
	const uint8_t* row = tile + t * kRowStride;
	const uint64_t word_mask = f.modulus - 1;
	CandRoller r;
	if (heads > 0)
		r.first(tb, row, f.k);
	uint32_t forced_bits = 0;
	for (int round = 0; round < kCandRounds; ++round) {
		const uint64_t col = (uint64_t)blockIdx.x * kCandRounds + round;
		if (kScatter)
			scan_slices(bins.counts, columns, col, bins.n_slices, local, warp_sum, t);
		for (int b0 = round * kCandRoundHeads; heads > 0 && b0 < (round + 1) * kCandRoundHeads;
		     b0 += kSnvHeadsBlocked) {
			uint64_t can[kSnvHeadsBlocked * kAlts];
			uint32_t live, forced;
			r.batch<kSnvHeadsBlocked>(tb, row, f.k, heads, b0, can, live, forced);
			forced_bits |= forced << b0;
#pragma unroll
			for (int p = 0; p < kSnvHeadsBlocked * kAlts; ++p) {
				if (!((live >> p) & 1))
					continue;
				const uint32_t s = (uint32_t)((can[p] & word_mask) >> bins.slice_bits);
				const uint32_t at = atomicAdd(&fill[s], 1u);
				if (kScatter) {
					stage_can[local[s] + at] = can[p];
					stage_head[local[s] + at] = (uint32_t)(word * kHeads) + (uint32_t)(b0 + p / kAlts);
				}
			}
		}
		__syncthreads();
		if (kScatter) {  // warp w writes the runs of slices w, w + 8, ...
			for (int s = t >> 5; s < bins.n_slices; s += kThreads / 32) {
				const uint64_t c = (uint64_t)s * columns + col;
				const uint64_t at = (uint64_t)(bins.ends[c] - bins.counts[c]);
				for (uint32_t i = t & 31; i < fill[s]; i += 32) {
					__stcs(bins.can + at + i, stage_can[local[s] + i]);  // read once, by the probes
					__stcs(bins.head + at + i, stage_head[local[s] + i]);
				}
			}
		} else {
			for (int s = t; s < bins.n_slices; s += kThreads)
				bins.counts[(uint64_t)s * columns + col] = (int32_t)fill[s];
		}
		__syncthreads();
		for (int s = t; s < bins.n_slices; s += kThreads)
			fill[s] = 0;
		__syncthreads();
	}
	if (!kScatter && word < n_words)
		out[word] = forced_bits;
}

// The binned pass's probes: block b takes entries [b * kProbeChunk,
// (b + 1) * kProbeChunk) of the buckets, in slice order (blocks start in
// index order, so the card works on one or two slices at a time and their
// words stay in L2); a present probe ORs its head's bit into ``out``.
// OR does not depend on order, so the words are exact; the forced bits the
// front end stored are ORed into, never overwritten.
__global__ void __launch_bounds__(kThreads)
snv_cand_probe_kernel(const uint64_t* __restrict__ can, const uint32_t* __restrict__ head,
                      const int64_t* __restrict__ total_at, Filter f, uint32_t* __restrict__ out)
{
	const uint64_t total = (uint64_t)*total_at;
	const uint64_t first = (uint64_t)blockIdx.x * kProbeChunk;
	if (first >= total)
		return;  // the whole block
	const uint32_t* words = static_cast<const uint32_t*>(f.table);
	uint32_t got[kProbePerThread], want[kProbePerThread], h[kProbePerThread];
	uint32_t live = 0;
#pragma unroll
	for (int u = 0; u < kProbePerThread; ++u) {
		const uint64_t i = first + (uint64_t)u * kThreads + threadIdx.x;
		const bool ok = i < total;
		const uint64_t c = ok ? __ldcs(can + i) : 0;
		h[u] = ok ? __ldcs(head + i) : 0;
		uint32_t mask = 0;
		for (int j = 0; j < f.hash_num; ++j)
			mask |= 1u << ((c >> (f.wbits + 5 * j)) & 31);
		want[u] = mask;
		got[u] = load_if(words + (c & (f.modulus - 1)), ok, 0);
		live |= (uint32_t)ok << u;
	}
#pragma unroll
	for (int u = 0; u < kProbePerThread; ++u)
		if (((live >> u) & 1) && (got[u] & want[u]) == want[u])
			atomicOr(out + (h[u] >> 5), 1u << (h[u] & 31));
}

// code of "ACGT"[c]: A 0, C 1, G 3, T 2
__device__ __forceinline__ unsigned code_of_base(int c) { return c == 2 ? 3u : (c == 3 ? 2u : (unsigned)c); }

template <int L, bool Polish>
__global__ void __launch_bounds__(kSiteThreads)
site_rows_kernel(const uint8_t* __restrict__ seq, uint64_t n, const int64_t* __restrict__ heads,
                 uint64_t n_heads, Filter f, int jump, uint8_t* __restrict__ rows)
{
	const uint64_t g = ((uint64_t)blockIdx.x * kSiteThreads + threadIdx.x) >> 5;
	const int lane = threadIdx.x & 31;
	if (g >= n_heads)
		return;  // whole warps leave together
	const int k = f.k;
	const int64_t h = heads[g];
	uint8_t* row = rows + 6 * g;

	// polish: bit 5 when [h, h + k) holds ACGTacgt only (a gate's window
	// holds no unaccepted byte, so this is "no accepted IUPAC byte")
	uint32_t exact = 0;
	if (Polish && h >= 0 && (uint64_t)h < n) {
		int other = 0;
		for (int i = lane; i < k; i += 32)
			other |= byte_class(seq[h + i]) != 0;
		exact = __any_sync(kFullWarp, other) ? 0u : 32u;
	}
	// valid: the scan of k windows past h fits below n, over ACGTacgt only;
	// polish: and h starts a cluster
	bool ok = h >= 0 && (uint64_t)h + (uint64_t)k + 1 <= n;
	if (Polish)
		ok = ok && (g == 0 || heads[g - 1] != h - 1);
	if (ok) {
		int bad = 0;
		for (int i = lane; i < 2 * k; i += 32)
			bad |= byte_class(seq[h + i]) != 0;
		ok = !__any_sync(kFullWarp, bad);
	}
	if (!ok) {
		if (lane < 6)
			row[lane] = lane == 0 ? (uint8_t)exact : 0;
		return;
	}

	const unsigned cd = code_of(seq[h + k - 1]);  // the draft's base at the site
	const int strides = (k + jump - 1) / jump;
	uint32_t pre = 0, there = 0, ver[4] = {0, 0, 0, 0};
	for (int item = lane; item <= strides; item += 32) {
		// item 0: the window at h; item 1 + s: the window at h + 1 + s * jump
		const int off = item == 0 ? 0 : 1 + (item - 1) * jump;
		const uint8_t* p = seq + h + off;
		uint64_t fh = 0, rh = 0;
		for (int i = 0; i < k; ++i) {
			fh = srol1(fh) ^ fwd_seed(code_of(p[i]));
			rh = srol1(rh) ^ rev_seed(code_of(p[k - 1 - i]));
		}
		// the site lies at index pos of this window (past it when pos < 0)
		const int pos = k - 1 - off;
		uint64_t can[5];
		can[0] = fh < rh ? fh : rh;
#pragma unroll
		for (int c = 0; c < 4; ++c) {
			uint64_t fb = fh, rb = rh;
			if (pos >= 0) {
				const unsigned cb = code_of_base(c);
				fb ^= srol(fwd_seed(cd) ^ fwd_seed(cb), k - 1 - pos);
				rb ^= srol(rev_seed(cd) ^ rev_seed(cb), pos);
			}
			can[1 + c] = fb < rb ? fb : rb;
		}
		// past the site the five hashes are one: probe it once; at the head
		// itself only the four pre-checks are asked for
		const uint32_t live = pos < 0 ? 1u : (item == 0 ? 0x1Eu : 0x1Fu);
		uint32_t present = live & ~probe_batch<L, 5>(can, live, f);
		if (pos < 0)
			present *= 0x1Fu;
		if (item == 0) {
			pre = present >> 1;
		} else {
			there += present & 1;
#pragma unroll
			for (int c = 0; c < 4; ++c)
				ver[c] += (present >> (1 + c)) & 1;
		}
	}
#pragma unroll
	for (int d = 16; d > 0; d >>= 1) {
		pre |= __shfl_xor_sync(kFullWarp, pre, d);
		there += __shfl_xor_sync(kFullWarp, there, d);
#pragma unroll
		for (int c = 0; c < 4; ++c)
			ver[c] += __shfl_xor_sync(kFullWarp, ver[c], d);
	}
	if (lane == 0) {
		const uint32_t second = Polish ? (uint32_t)strides - there : there;
		row[0] = (uint8_t)(exact | 1u | (pre << 1));
		row[1] = (uint8_t)(second < 255 ? second : 255);
#pragma unroll
		for (int c = 0; c < 4; ++c)
			row[2 + c] = (uint8_t)(ver[c] < 255 ? ver[c] : 255);
	}
}

template <int L>
__global__ void __launch_bounds__(kThreads)
cand_masks_kernel(const uint8_t* __restrict__ seq, uint64_t n, const int64_t* __restrict__ gates,
                  uint64_t n_gates, Filter f, uint8_t* __restrict__ masks)
{
	const uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
	if (g >= n_gates)
		return;
	const int k = f.k;
	const int64_t h = gates[g];
	bool ok = h >= 0 && (uint64_t)h < n;
	uint64_t fh = 0, rh = 0;
	if (ok) {
		const uint8_t* p = seq + h;
		for (int i = 0; i < k; ++i) {
			const unsigned c = p[i];
			ok = ok && byte_class(c) == 0;
			fh = srol1(fh) ^ fwd_seed(code_of(c));
			rh = srol1(rh) ^ rev_seed(code_of(p[k - 1 - i]));
		}
	}
	if (!ok) {
		masks[g] = 0xFF;
		return;
	}
	// changelast: take the last base's seeds out, put each base's in
	const unsigned cd = code_of(seq[h + k - 1]);
	const uint64_t fx = fh ^ fwd_seed(cd), rx = rh ^ srol(rev_seed(cd), k - 1);
	uint64_t can[kMaskProbes];
#pragma unroll
	for (int c = 0; c < kMaskProbes; ++c) {
		const unsigned cb = code_of_base(c);
		const uint64_t fb = fx ^ fwd_seed(cb), rb = rx ^ srol(rev_seed(cb), k - 1);
		can[c] = fb < rb ? fb : rb;
	}
	masks[g] = (uint8_t)(0xFu & ~probe_batch<L, kMaskProbes>(can, 0xFu, f));
}

bool filter_ok(int k, int hash_num, uint64_t modulus)
{
	return k >= 1 && k <= kHalo + 1 && hash_num >= 1 && modulus != 0;
}

// Lets the scattering front end take its stage (above the 48 KB of shared
// memory a block gets without asking); once per process.
int stage_smem_ok()
{
	static const cudaError_t err = cudaFuncSetAttribute(
	    snv_cand_bin_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kCandStageBytes);
	return (int)err;
}

}  // namespace

extern "C" {

// Candidate words for heads [0, n) of ``seq`` on ``stream``.  ``seq`` must
// hold ceil(n / 8192) * 8192 + 1024 readable bytes and be 16-byte aligned;
// ``out`` holds ceil(n / 32) words.  ``layout`` is 0 (plain, ``magic`` =
// mod_magic(modulus)) or 1 (blocked).  Returns cudaGetLastError() after the
// launch (0 on success).
int nts_cand_words(const void* seq, uint64_t n, int k, const void* table, uint64_t modulus,
                   uint64_t magic, int wbits, int layout, int hash_num, void* out, void* stream)
{
	if (n == 0)
		return 0;
	if (!filter_ok(k, hash_num, modulus))
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const Filter f{table, modulus, magic, wbits, hash_num, k, 1};
	const auto* s = static_cast<const uint8_t*>(seq);
	auto* o = static_cast<uint32_t*>(out);
	auto st = static_cast<cudaStream_t>(stream);
	const unsigned blocks = blocks_for(n_words);
	if (layout == kPlain)
		snv_cand_words_kernel<kPlain><<<blocks, kThreads, 0, st>>>(s, n, f, o, n_words);
	else if (layout == kBlocked)
		snv_cand_words_kernel<kBlocked><<<blocks, kThreads, 0, st>>>(s, n, f, o, n_words);
	else
		return (int)cudaErrorInvalidValue;
	return (int)cudaGetLastError();
}

// The binned candidate pass's front end for heads [0, n) of ``seq`` (as
// nts_cand_words; n < 2^32) and a blocked filter of ``modulus`` words
// (2^wbits), in ceil(n / 8192) blocks of nts_cand_rounds() rounds:
// ``scatter`` 0 writes the forced bits into ``out`` (ceil(n / 32) words)
// and the [n_slices x blocks * rounds] int32 ``counts`` of probes per
// (slice of 2^slice_bits words, column);
// ``scatter`` 1 reads them and ``ends`` (their inclusive scan, int64) and
// writes each probe's hash (uint64) and head (uint32) into ``can`` and
// ``head``, slice by slice.
int nts_cand_bin(const void* seq, uint64_t n, int k, const void* table, uint64_t modulus, int wbits,
                 int hash_num, int slice_bits, int n_slices, void* counts, const void* ends,
                 void* can, void* head, void* out, int scatter, void* stream)
{
	if (n == 0)
		return 0;
	if (!filter_ok(k, hash_num, modulus) || n > 0xFFFFFFFFULL || wbits < 0 || wbits > 31 ||
	    modulus != (1ULL << wbits) || wbits + 5 * hash_num > 64 || slice_bits < 0 ||
	    n_slices < 1 || n_slices > kMaxCandSlices || ((modulus - 1) >> slice_bits) >= (uint64_t)n_slices)
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const Filter f{table, modulus, 0, wbits, hash_num, k, 1};
	const CandBins b{slice_bits, n_slices, static_cast<int32_t*>(counts),
	                 static_cast<const int64_t*>(ends), static_cast<uint64_t*>(can),
	                 static_cast<uint32_t*>(head)};
	const auto* q = static_cast<const uint8_t*>(seq);
	auto* o = static_cast<uint32_t*>(out);
	auto st = static_cast<cudaStream_t>(stream);
	if (scatter) {
		if (const int err = stage_smem_ok())
			return err;
		snv_cand_bin_kernel<true><<<blocks_for(n_words), kThreads, kCandStageBytes, st>>>(
		    q, n, f, o, n_words, b);
	} else {
		snv_cand_bin_kernel<false><<<blocks_for(n_words), kThreads, 0, st>>>(q, n, f, o, n_words, b);
	}
	return (int)cudaGetLastError();
}

// The binned pass's probes: the entries ``can`` and ``head`` that the
// front end wrote, *total_at of them (the last element of its ``ends``, on
// the card), probed in a blocked filter of ``modulus`` = 2^wbits words;
// each present one ORs its head's bit into ``out``.  ``max_entries``
// bounds the total: the launch covers that many.
int nts_cand_probe(const void* can, const void* head, const void* total_at, uint64_t max_entries,
                   const void* table, uint64_t modulus, int wbits, int hash_num, void* out,
                   void* stream)
{
	if (max_entries == 0)
		return 0;
	if (hash_num < 1 || wbits < 0 || wbits > 31 || modulus != (1ULL << wbits) ||
	    wbits + 5 * hash_num > 64)
		return (int)cudaErrorInvalidValue;
	const uint64_t grid = (max_entries + kProbeChunk - 1) / kProbeChunk;
	if (grid > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	const Filter f{table, modulus, 0, wbits, hash_num, 0, 1};
	snv_cand_probe_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint64_t*>(can), static_cast<const uint32_t*>(head),
	    static_cast<const int64_t*>(total_at), f, static_cast<uint32_t*>(out));
	return (int)cudaGetLastError();
}

// Site rows of the ``n_heads`` heads ``heads`` (sorted int64) of a contig
// of ``n`` heads, whose n + k - 1 bytes lie at ``seq``; ``rows`` holds
// 6 * n_heads bytes.  ``polish`` 0: SNV candidates; 1: a chunk's gates,
// one row each (the polish form).  ``jump`` >= 1.
int nts_site_rows(const void* seq, uint64_t n, int k, const void* heads, uint64_t n_heads,
                  const void* table, uint64_t modulus, uint64_t magic, int wbits, int layout,
                  int hash_num, int jump, int polish, void* rows, void* stream)
{
	if (n_heads == 0)
		return 0;
	if (!filter_ok(k, hash_num, modulus) || jump < 1)
		return (int)cudaErrorInvalidValue;
	const Filter f{table, modulus, magic, wbits, hash_num, k, 1};
	const auto* s = static_cast<const uint8_t*>(seq);
	const auto* c = static_cast<const int64_t*>(heads);
	auto* r = static_cast<uint8_t*>(rows);
	auto st = static_cast<cudaStream_t>(stream);
	if (n_heads > (0xFFFFFFFFFFFFFFFFULL - kSiteThreads) / 32)
		return (int)cudaErrorInvalidValue;
	const uint64_t blocks = (n_heads * 32 + kSiteThreads - 1) / kSiteThreads;
	if (blocks > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	const unsigned b = (unsigned)blocks;
	if (layout == kPlain && !polish)
		site_rows_kernel<kPlain, false><<<b, kSiteThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else if (layout == kBlocked && !polish)
		site_rows_kernel<kBlocked, false><<<b, kSiteThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else if (layout == kPlain)
		site_rows_kernel<kPlain, true><<<b, kSiteThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else if (layout == kBlocked)
		site_rows_kernel<kBlocked, true><<<b, kSiteThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else
		return (int)cudaErrorInvalidValue;
	return (int)cudaGetLastError();
}

// Candidate masks of the ``n_gates`` gate heads ``gates`` (int64) of a
// contig of ``n`` heads, whose n + k - 1 bytes lie at ``seq``; ``masks``
// holds n_gates bytes.
int nts_cand_masks(const void* seq, uint64_t n, int k, const void* gates, uint64_t n_gates,
                   const void* table, uint64_t modulus, uint64_t magic, int wbits, int layout,
                   int hash_num, void* masks, void* stream)
{
	if (n_gates == 0)
		return 0;
	if (!filter_ok(k, hash_num, modulus))
		return (int)cudaErrorInvalidValue;
	const Filter f{table, modulus, magic, wbits, hash_num, k, 1};
	const auto* s = static_cast<const uint8_t*>(seq);
	const auto* g = static_cast<const int64_t*>(gates);
	auto* m = static_cast<uint8_t*>(masks);
	auto st = static_cast<cudaStream_t>(stream);
	const uint64_t blocks = n_gates / kThreads + (n_gates % kThreads != 0);
	if (blocks > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	if (layout == kPlain)
		cand_masks_kernel<kPlain><<<(unsigned)blocks, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else if (layout == kBlocked)
		cand_masks_kernel<kBlocked><<<(unsigned)blocks, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else
		return (int)cudaErrorInvalidValue;
	return (int)cudaGetLastError();
}

// Resident blocks per SM: which = 0, 1 for the candidate kernel's plain and
// blocked forms, 2, 3 for the site kernel's, 4, 5 for its polish form's,
// 6, 7 for the mask kernel's, 8, 9 for the binned front end's counting and
// scattering forms, 10 for its probe kernel.  Negative on error.
int nts_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_words_kernel<kPlain>, kThreads, 0); break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_words_kernel<kBlocked>, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kPlain, false>, kSiteThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kBlocked, false>, kSiteThreads, 0); break;
	case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kPlain, true>, kSiteThreads, 0); break;
	case 5: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kBlocked, true>, kSiteThreads, 0); break;
	case 6: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kPlain>, kThreads, 0); break;
	case 7: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kBlocked>, kThreads, 0); break;
	case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_bin_kernel<false>, kThreads, 0); break;
	case 9:
		err = static_cast<cudaError_t>(stage_smem_ok());
		if (err == cudaSuccess)
			err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_bin_kernel<true>, kThreads,
			                                                    kCandStageBytes);
		break;
	case 10: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_probe_kernel, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* nts_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nts_cand_batch(int layout) { return kAlts * (layout == kPlain ? kSnvHeadsPlain : kSnvHeadsBlocked); }
int nts_mask_batch() { return kMaskProbes; }
int nts_max_cand_slices() { return kMaxCandSlices; }
int nts_cand_rounds() { return kCandRounds; }
int nts_probe_chunk() { return kProbeChunk; }
int nts_tile_heads() { return kTile; }
int nts_halo_bytes() { return kHalo; }

}  // extern "C"
