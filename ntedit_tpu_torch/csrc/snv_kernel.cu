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
// site_rows_kernel<L> replaces _snv_site_data_from_codes and the row
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
// row is six zeros and the engine probes live.  The function needs 37 probes
// a row at k = 25, jump 3: the four pre-checks, four per stride window that
// holds the site (pristine and three alternates; the draft's base takes the
// pristine result) and one past it (kk = k - 1, when jump divides k - 1).
//
// polish_rows_kernel<L> replaces the polish form of that program,
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
// cand_masks_kernel<L, Gated> replaces _polish_cand_planes_from_codes with
// its gather _gather_cand_masks.  For every gate head h (int64) it writes
// one byte: bit c = contains(window at h with its last base set to
// "ACGT"[c]), all four c, the draft's own base included; 0xFF when [h, h +
// k) holds a byte that is not ACGTacgt (no information: the engine probes
// live).  The XLA program computed four bit planes over every head and
// gathered at the gates; the kernel computes at the gates only.  Gated
// (every caller on a path): the heads are absence gates of this filter, so
// at an ACGTacgt window the draft's own base, the window's own k-mer, is
// absent and its bit is 0 without a probe (the engine reads only the
// alternates' bits, native/repair.cpp fix_site).
//
// Bound.  All but the binned pass are bound as the gate kernel is: by the
// rate at which the DRAM serves random 32-byte sectors of a filter far larger than the L2
// (about 30 G probes/s, PERF.md), not by bytes per second and not by the
// hashing.  The candidate pass makes three probes per live head (blocked;
// plain: up to hash_num each, stopping at the first clear bit), beside
// 1 B of ASCII read and 1/8 B written per head.  The site pass makes
// 4 + 4 ceil(k / jump) probes per valid row (three fewer when jump
// divides k - 1: the window past the site is probed once), 37 at k = 25 and jump
// 3, on a few thousand candidates or cluster starts per million heads; its
// bytes (the head list, the rows, 2k bytes a row) are a tenth of what its
// random probes cost, so its floor is those probes from its own threads.
// The mask pass makes three probes per informative gate (four ungated).
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
// The site row kernel gives a row to kRowLanes = 4 adjacent lanes, each a
// contiguous run of the row's window items (item 0 the head, item 1 + s
// stride s): against 1, 2 and 8 lanes on the SNV path's lists of 20 k
// and 188 k rows (utils/site_sweep.py, chip_smoke.py; PERF.md) 4 was the
// fastest at both.  A lane hashes its first item from its k bytes and rolls on
// through the rest: one pass over [h, h + 2k) for a whole row, 2k roll
// steps where hashing each window from scratch took k (ceil(k / jump) +
// 1), with the roll tables of the gate kernel extended by an empty "byte
// leaving" for the first k steps.  Its bytes come as aligned 16-byte
// vectors, each read once, and validity
// (every byte ACGTacgt) is taken from the same bytes as they are rolled in.
// The alternates' hashes are XORs of the window's hash with the rotated
// seed difference at the site (srol is a bit permutation, so XOR-linear).
// A window's probes go out as it is emitted, two windows a batch (eight
// predicated loads; plain: one window, whose hash_num rounds take more
// registers), each predicated on every byte read so far being ACGTacgt: a
// row whose first window holds another byte makes no probe.  Counts stay
// in registers (the four verify counts 16 bits apart in one 64-bit word)
// and the row goes out as one 6-byte store after log2(lanes) shuffles.
// There is no per-row array, so any k up to kHalo + 1 works.
//
// The polish row kernel is one launch.  A block takes kPolishGates gates,
// two a thread: each thread checks its gates' windows four bytes at a time
// (the vectors of [h, h + k), or of [h, h + 2k) where a row may start, go
// out together), writes bit 5 and zeros, and lists each cluster start with
// a valid row (about 4% of gates on the main path, some 20 a block) in
// shared memory.  Then the block's threads share out its listed rows, up
// to 8 lanes a row (polish_lanes: within 3% of a cap of 4 with a blocked
// filter, 6% faster with a plain one), with the SNV form's routine.  A
// first design launched a gate kernel that appended the starts to a
// global list and a row kernel that read its length on the card: on an
// H100, 0.039 ms a chunk against 0.027 for this one (PERF.md).
//
// The mask kernel gives one thread to each gate: it hashes its window from
// the ASCII in one forward pass (gates cluster, so neighbouring threads
// read neighbouring bytes through the L1) and sends its three probes
// together (four ungated).  A block that staged its run's span in shared
// memory first, each 16-byte vector read once, was slower on an H100:
// 0.1014 ms against 0.0960 on the 30 Mbp contig's gates, in 20 of 20
// rounds (utils/mask_sweep.py, PERF.md).
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
constexpr int kRowThreads = 128;            // SNV site row kernel: threads per block
constexpr int kRowLanes = 4;                // its lanes a row (measured: PERF.md)
constexpr int kSiteWindowsBlocked = 2;      // window items whose probes go out together
constexpr int kSiteWindowsPlain = 1;        // (plain: hash_num rounds, more registers)
constexpr int kPolishThreads = 256;         // polish row kernel: threads per block
constexpr int kPolishGates = 2 * kPolishThreads;  // gates a polish block takes
constexpr int kMaxPolishLanes = 8;          // lanes a polish row at most
constexpr uint32_t kExactGate = 32;         // polish rows: flags bit 5
constexpr int kMaskProbes = 4;              // mask kernel: the four bases at the site
constexpr int kMaskProbesGated = 3;         // at an absence gate: the three alternates
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

// index in "ACGT" of a 2-bit code: the inverse of code_of_base
__device__ __forceinline__ unsigned base_of_code(unsigned x) { return x ^ (x >> 1); }

// ---------------------------------------------------------------------------
// Site rows: a thread (or 2 or 4 adjacent lanes) per row, one rolled pass
// over the row's bytes [h, h + 2k).
// ---------------------------------------------------------------------------

// The row kernel's roll tables: x = 4 * out + in by 2-bit code, out 4 = no
// byte leaving (the first k steps of a pass build its first window):
// fh' = srol1(fh) ^ roll_f[x], rh' = sror1(rh ^ roll_r[x]).
struct SiteTables {
	uint64_t roll_f[20], roll_r[20];
};

__device__ __forceinline__ void fill_site_tables(SiteTables& tb, int k, unsigned t)
{
	if (t < 20) {
		const unsigned o = t >> 2, i = t & 3;
		tb.roll_f[t] = (o < 4 ? srol(fwd_seed(o), k) : 0) ^ fwd_seed(i);
		tb.roll_r[t] = (o < 4 ? rev_seed(o) : 0) ^ srol(rev_seed(i), k);
	}
}

__device__ __forceinline__ uint4 load16(const uint8_t* p)  // p 16-byte aligned
{
	return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, unsigned i)
{
	const unsigned w = (i & 8) ? ((i & 4) ? v.w : v.z) : ((i & 4) ? v.y : v.x);
	return (w >> ((i & 3) * 8)) & 0xFF;
}

// A stream of bytes taken in address order, read as aligned 16-byte vectors,
// each once.  A 16-byte block that holds a byte of an allocation lies in
// its page, so the bytes of a block past either end are safe to read (and
// are never used).
struct Bytes {
	uintptr_t at = ~(uintptr_t)0;  // the block in v
	uint4 v;

	__device__ __forceinline__ unsigned get(const uint8_t* p)
	{
		const uintptr_t a = (uintptr_t)p & ~(uintptr_t)15;
		if (a != at) {
			at = a;
			v = load16(reinterpret_cast<const uint8_t*>(a));
		}
		return byte_of(v, (unsigned)((uintptr_t)p & 15));
	}
};

__device__ __forceinline__ bool is_acgt(unsigned c)
{
	const unsigned fold = c & 0xDF;  // bits 1, 3, 7, 20: A, C, G, T - 64
	return (fold & 0xE0) == 0x40 && ((0x0010008Au >> (fold & 31)) & 1);
}

// bytes j of a word (0 <= j < 4) with lo <= j < hi, as a byte mask
__device__ __forceinline__ uint32_t byte_mask(int64_t lo, int64_t hi)
{
	const int a = (int)(lo < 0 ? 0 : (lo > 4 ? 4 : lo)), b = (int)(hi < 0 ? 0 : (hi > 4 ? 4 : hi));
	return (uint32_t)(((1ULL << (8 * b)) - 1) & ~((1ULL << (8 * a)) - 1));
}

// index of the first byte of [p, p + len) that is not ACGTacgt (len when
// none), checked four bytes at a time; the 16-byte vectors go out four at
// a time before any is checked
__device__ uint32_t first_other(const uint8_t* p, uint32_t len)
{
	constexpr int kVecs = 4;
	const uintptr_t a0 = (uintptr_t)p, a1 = a0 + len;
	for (uintptr_t a = a0 & ~(uintptr_t)15; a < a1; a += 16 * kVecs) {
		uint4 v[kVecs];
#pragma unroll
		for (int u = 0; u < kVecs; ++u)
			v[u] = a + 16 * u < a1 ? load16(reinterpret_cast<const uint8_t*>(a + 16 * u))
			                       : make_uint4(0x41414141u, 0x41414141u, 0x41414141u, 0x41414141u);
#pragma unroll
		for (int u = 0; u < kVecs; ++u) {
			const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
			for (int j = 0; j < 4; ++j) {
				const uint32_t f = w[j] & 0xDFDFDFDFu;
				const uint32_t eq = __vcmpeq4(f, 0x41414141u) | __vcmpeq4(f, 0x43434343u) |
				                    __vcmpeq4(f, 0x47474747u) | __vcmpeq4(f, 0x54545454u);
				const uintptr_t b = a + 16 * u + 4 * j;
				const uint32_t bad = ~eq & byte_mask((int64_t)(a0 - b), (int64_t)(a1 - b));
				if (bad)
					return (uint32_t)(b - a0) + (__ffs(bad) - 1) / 8;
			}
		}
	}
	return len;
}

// offset of window item i in a row: item 0 the head, item 1 + s stride s
__device__ __forceinline__ int window_offset(int i, int jump) { return i == 0 ? 0 : 1 + (i - 1) * jump; }

// srol(x, d) given dl = d % 33 and dh = d % 31
__device__ __forceinline__ uint64_t srol_by(uint64_t x, unsigned dl, unsigned dh)
{
	uint64_t lo = x & kLow33, hi = x >> 33;
	if (dl)
		lo = ((lo << dl) | (lo >> (33 - dl))) & kLow33;
	if (dh)
		hi = ((hi << dh) | (hi >> (31 - dh))) & 0x7FFFFFFFULL;
	return (hi << 33) | lo;
}

// A thread's share of a row, before the lanes of the row meet.  ``ver``
// holds the four verify counts by 2-bit code, 16 bits each.
struct RowPart {
	uint32_t pre = 0, there = 0;
	uint64_t ver = 0;
	bool ok = true;  // every byte this thread read is ACGTacgt
};

// Window items [i0, i1) of the row at p = seq + h: hash them in one roll,
// from the first item's k bytes on, and probe each as it comes, two items
// a batch (pristine and the three alternates at the site; the window past
// the site, pristine only; item 0's draft base is the pristine window).
// ``last``: also check the bytes up to 2k that no window reads.
template <int L>
__device__ __forceinline__ void row_part(const SiteTables& tb, const uint8_t* p, int k, int jump,
                                         int i0, int i1, bool last, const Filter& f, RowPart& rp)
{
	constexpr int kSiteWindows = L == kPlain ? kSiteWindowsPlain : kSiteWindowsBlocked;
	constexpr int kSiteBatch = 4 * kSiteWindows;  // pristine and three alternates per item
	if (i0 >= i1)
		return;
	const int q0 = window_offset(i0, jump);
	const unsigned cd = code_of(p[k - 1]);  // the draft's base at the site
	uint64_t dfw[3], drv[3];               // the alternates' seed differences
	unsigned shift[3], bit[3];
#pragma unroll
	for (int a = 0; a < 3; ++a) {
		const unsigned cb = (cd + 1 + a) & 3;
		dfw[a] = fwd_seed(cd) ^ fwd_seed(cb);
		drv[a] = rev_seed(cd) ^ rev_seed(cb);
		shift[a] = 16 * cb;
		bit[a] = base_of_code(cb);
	}
	int q = q0;  // the next byte the roll takes in
	uint64_t fh = 0, rh = 0;
	Bytes in, out;
	for (int i = i0; i < i1; i += kSiteWindows) {
		uint64_t can[kSiteBatch];
		uint32_t live = 0;
		int pos[kSiteWindows];
#pragma unroll
		for (int w = 0; w < kSiteWindows; ++w) {
			pos[w] = -1;
#pragma unroll
			for (int j = 0; j < 4; ++j)
				can[4 * w + j] = 0;
			if (i + w >= i1)
				continue;
			const int off = window_offset(i + w, jump);
			for (; q < off + k; ++q) {  // roll on to the window at off
				const unsigned c = in.get(p + q);
				rp.ok &= is_acgt(c);
				const unsigned o = q - k >= q0 ? code_of(out.get(p + q - k)) : 4u;
				const unsigned x = 4 * o + code_of(c);
				fh = srol1(fh) ^ tb.roll_f[x];
				rh = sror1(rh ^ tb.roll_r[x]);
			}
			pos[w] = k - 1 - off;  // the site's index in the window, past it when < 0
			can[4 * w] = fh < rh ? fh : rh;
			if (pos[w] >= 0) {
				const unsigned fl = (unsigned)off % 33, fr = (unsigned)off % 31;
				const unsigned rl = (unsigned)pos[w] % 33, rr = (unsigned)pos[w] % 31;
#pragma unroll
				for (int a = 0; a < 3; ++a) {
					const uint64_t fb = fh ^ srol_by(dfw[a], fl, fr), rb = rh ^ srol_by(drv[a], rl, rr);
					can[4 * w + 1 + a] = fb < rb ? fb : rb;
				}
			}
			live |= (rp.ok ? (pos[w] >= 0 ? 0xFu : 1u) : 0u) << (4 * w);
		}
		const uint32_t present = live & ~probe_batch<L, kSiteBatch>(can, live, f);
#pragma unroll
		for (int w = 0; w < kSiteWindows; ++w) {
			if (i + w >= i1)
				continue;
			const uint32_t r = present >> (4 * w);
			if (i + w == 0) {
				rp.pre = (r & 1) << base_of_code(cd);
#pragma unroll
				for (int a = 0; a < 3; ++a)
					rp.pre |= ((r >> (1 + a)) & 1) << bit[a];
			} else if (pos[w] >= 0) {
				rp.there += r & 1;
				rp.ver += (uint64_t)(r & 1) << (16 * cd);
#pragma unroll
				for (int a = 0; a < 3; ++a)
					rp.ver += (uint64_t)((r >> (1 + a)) & 1) << shift[a];
			} else {  // past the site: the four verify windows are the pristine one
				rp.there += r & 1;
				rp.ver += (uint64_t)(r & 1) * 0x0001000100010001ULL;
			}
		}
	}
	if (last)
		for (; q < 2 * k && rp.ok; ++q)
			rp.ok = is_acgt(in.get(p + q));
}

__device__ __forceinline__ void store_row(uint8_t* row, uint32_t b0, uint32_t b1, uint32_t b2,
                                          uint32_t b3, uint32_t b4, uint32_t b5)
{
	uint16_t* r = reinterpret_cast<uint16_t*>(row);  // rows are 2-byte aligned
	r[0] = (uint16_t)(b0 | (b1 << 8));
	r[1] = (uint16_t)(b2 | (b3 << 8));
	r[2] = (uint16_t)(b4 | (b5 << 8));
}

__device__ __forceinline__ uint32_t sat(uint32_t v) { return v < 255 ? v : 255; }

// The ``rt`` lanes of a row (``group`` of the warp) meet in log2(rt)
// shuffles and its first lane writes the row: polish with bit 5 (a polish
// row is only computed where [h, h + 2k) is ACGTacgt) and check_missing.
template <bool Polish>
__device__ __forceinline__ void finish_row(RowPart rp, int rt, unsigned group, int part, int items,
                                           uint8_t* row)
{
	for (int d = 1; d < rt; d <<= 1) {
		rp.ok = __shfl_xor_sync(group, (int)rp.ok, d) && rp.ok;
		rp.pre |= __shfl_xor_sync(group, rp.pre, d);
		rp.there += __shfl_xor_sync(group, rp.there, d);
		rp.ver += __shfl_xor_sync(group, rp.ver, d);
	}
	if (part != 0)
		return;
	const uint32_t exact = Polish ? kExactGate : 0u;
	if (!rp.ok) {
		store_row(row, exact, 0, 0, 0, 0, 0);
		return;
	}
	const uint32_t strides = (uint32_t)(items - 1);
	const uint32_t v[4] = {(uint32_t)(rp.ver & 0xFFFF), (uint32_t)((rp.ver >> 16) & 0xFFFF),
	                       (uint32_t)((rp.ver >> 32) & 0xFFFF), (uint32_t)(rp.ver >> 48)};
	store_row(row, exact | 1u | (rp.pre << 1), sat(Polish ? strides - rp.there : rp.there),
	          sat(v[0]), sat(v[1]), sat(v[3]), sat(v[2]));  // "ACGT": codes 0, 1, 3, 2
}

// lanes [rt * (l / rt), rt * (l / rt) + rt) of a warp
__device__ __forceinline__ unsigned lane_group(int rt)
{
	return ((1u << rt) - 1) << ((threadIdx.x & 31) & ~(unsigned)(rt - 1));
}

// The SNV rows: row r of the head list, n_rows of them, on kRowLanes
// adjacent lanes, each taking a contiguous run of the row's window items.
template <int L>
__global__ void __launch_bounds__(kRowThreads)
site_rows_kernel(const uint8_t* __restrict__ seq, uint64_t n, const int64_t* __restrict__ heads,
                 uint64_t n_rows, Filter f, int jump, uint8_t* __restrict__ rows)
{
	__shared__ SiteTables tb;
	fill_site_tables(tb, f.k, threadIdx.x);
	__syncthreads();

	const int k = f.k;
	constexpr int rt = kRowLanes;
	const uint64_t tid = (uint64_t)blockIdx.x * kRowThreads + threadIdx.x;
	const uint64_t r = tid / rt;
	if (r >= n_rows)
		return;  // a row's lanes leave together
	const int part = (int)(tid & (uint64_t)(rt - 1));
	const int items = (k - 1) / jump + 2;  // the head and the ceil(k / jump) strides
	const int64_t h = heads[r];
	RowPart rp;
	rp.ok = h >= 0 && (uint64_t)h + (uint64_t)k + 1 <= n;  // the k windows past h fit below n
	if (rp.ok)
		row_part<L>(tb, seq + h, k, jump, part * items / rt, (part + 1) * items / rt,
		            part == rt - 1, f, rp);
	finish_row<false>(rp, rt, lane_group(rt), part, items, rows + 6 * r);
}

// Lanes a polish row for a block's ``c`` rows: the most, up to
// kMaxPolishLanes, that the block's threads give every row at once.
__host__ __device__ __forceinline__ int polish_lanes(uint32_t c)
{
	int rt = kMaxPolishLanes;
	while (rt > 1 && (uint32_t)rt * c > kPolishThreads)
		rt >>= 1;
	return rt;
}

// The polish rows: block b takes gates [b * kPolishGates, (b + 1) *
// kPolishGates) of the sorted list, two a thread.  Each thread writes its
// gates' bit 5 (the window [h, h + k) holds ACGTacgt only) with zeros,
// unless the gate is a cluster start (the list's first or heads[g - 1] !=
// h - 1) with a valid row (h + k + 1 <= n, [h, h + 2k) ACGTacgt only): those
// go onto the block's list in shared memory.  Then the block's threads take
// its listed rows, polish_lanes(their count) lanes a row.
template <int L>
__global__ void __launch_bounds__(kPolishThreads)
polish_rows_kernel(const uint8_t* __restrict__ seq, uint64_t n, const int64_t* __restrict__ heads,
                   uint64_t n_gates, Filter f, int jump, uint8_t* __restrict__ rows)
{
	constexpr int kEach = kPolishGates / kPolishThreads;
	__shared__ SiteTables tb;
	__shared__ uint32_t n_starts;
	__shared__ uint32_t starts[kPolishGates];  // offsets of the listed gates in the block's
	const unsigned t = threadIdx.x;
	fill_site_tables(tb, f.k, t);
	if (t == 0)
		n_starts = 0;
	__syncthreads();

	const int k = f.k;
	const uint64_t g0 = (uint64_t)blockIdx.x * kPolishGates;
	int64_t h[kEach], before[kEach];
#pragma unroll
	for (int j = 0; j < kEach; ++j) {
		const uint64_t g = g0 + t + (uint64_t)j * kPolishThreads;
		h[j] = g < n_gates ? heads[g] : -1;
		before[j] = g < n_gates && g > 0 ? heads[g - 1] : -2;
	}
#pragma unroll
	for (int j = 0; j < kEach; ++j) {
		const uint64_t g = g0 + t + (uint64_t)j * kPolishThreads;
		if (g >= n_gates)
			continue;
		// one pass: [h, h + k) for bit 5, [h, h + 2k) where a row may start
		const bool inside = h[j] >= 0 && (uint64_t)h[j] < n;
		const bool first = inside && before[j] != h[j] - 1 && (uint64_t)h[j] + (uint64_t)k + 1 <= n;
		const uint32_t good = inside ? first_other(seq + h[j], (first ? 2 : 1) * k) : 0;
		if (first && good >= 2 * (uint32_t)k)
			starts[atomicAdd(&n_starts, 1u)] = t + j * kPolishThreads;
		else
			store_row(rows + 6 * g, good >= (uint32_t)k ? kExactGate : 0u, 0, 0, 0, 0, 0);
	}
	__syncthreads();

	const uint32_t c = n_starts;
	const int rt = polish_lanes(c);
	const int part = (int)(t & (unsigned)(rt - 1));
	const int items = (k - 1) / jump + 2;
	const int i0 = part * items / rt, i1 = (part + 1) * items / rt;
	for (uint32_t r = t / rt; r < c; r += kPolishThreads / rt) {
		const uint64_t g = g0 + starts[r];
		RowPart rp;  // a listed row is valid
		row_part<L>(tb, seq + heads[g], k, jump, i0, i1, part == rt - 1, f, rp);
		finish_row<true>(rp, rt, lane_group(rt), part, items, rows + 6 * g);
	}
}

// The mask kernel's tables: the forward seeds and the last base's share of
// rh (srol^(k-1) of the complement seed), by 2-bit code.  A window hashes
// forward in one pass: fh' = srol1(fh) ^ seed_f[x], rh' = sror1(rh) ^
// last_r[x] (sror1 undoes srol1, so byte j ends rotated by j).
struct MaskTables {
	uint64_t seed_f[4], last_r[4];
};

// The candidate masks, one thread a head.  Gated: the heads are absence
// gates of this filter, so the draft's own base is 0 with no probe (three
// probes a gate); otherwise all four bases are probed.  0xFF where [h, h +
// k) holds a byte that is not ACGTacgt, with no probe.
template <int L, bool Gated>
__global__ void __launch_bounds__(kThreads)
cand_masks_kernel(const uint8_t* __restrict__ seq, uint64_t n, const int64_t* __restrict__ gates,
                  uint64_t n_gates, Filter f, uint8_t* __restrict__ masks)
{
	constexpr int kProbes = Gated ? kMaskProbesGated : kMaskProbes;
	__shared__ MaskTables tb;
	const unsigned t = threadIdx.x;
	const int k = f.k;
	if (t < 4) {
		tb.seed_f[t] = fwd_seed(t);
		tb.last_r[t] = srol(rev_seed(t), k - 1);
	}
	__syncthreads();
	const uint64_t g = (uint64_t)blockIdx.x * kThreads + t;
	if (g >= n_gates)
		return;
	const int64_t h = gates[g];
	bool ok = h >= 0 && (uint64_t)h < n;
	const uint8_t* p = seq + h;
	uint64_t fh = 0, rh = 0;
	for (int i = 0; ok && i < k; ++i) {
		const unsigned c = p[i];
		ok = is_acgt(c);
		fh = srol1(fh) ^ tb.seed_f[code_of(c)];
		rh = sror1(rh) ^ tb.last_r[code_of(c)];
	}
	if (!ok) {
		masks[g] = 0xFF;
		return;
	}
	// changelast: take the draft's base out, put each probed base in
	const unsigned cd = code_of(p[k - 1]);
	const uint64_t fx = fh ^ tb.seed_f[cd], rx = rh ^ tb.last_r[cd];
	uint64_t can[kProbes];
	unsigned bit[kProbes];
#pragma unroll
	for (int a = 0; a < kProbes; ++a) {
		const unsigned cb = Gated ? (cd + 1 + a) & 3 : code_of_base(a);
		bit[a] = base_of_code(cb);
		const uint64_t fb = fx ^ tb.seed_f[cb], rb = rx ^ tb.last_r[cb];
		can[a] = fb < rb ? fb : rb;
	}
	const uint32_t fail = probe_batch<L, kProbes>(can, (1u << kProbes) - 1, f);
	uint32_t m = 0;
#pragma unroll
	for (int a = 0; a < kProbes; ++a)
		m |= ((~fail >> a) & 1u) << bit[a];
	masks[g] = (uint8_t)m;
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
// 6 * n_heads bytes, 2-byte aligned.  ``polish`` 0: SNV candidates; 1: a
// chunk's gates, one row each (the polish form).  ``jump`` >= 1.
int nts_site_rows(const void* seq, uint64_t n, int k, const void* heads, uint64_t n_heads,
                  const void* table, uint64_t modulus, uint64_t magic, int wbits, int layout,
                  int hash_num, int jump, int polish, void* rows, void* stream)
{
	if (n_heads == 0)
		return 0;
	if (!filter_ok(k, hash_num, modulus) || jump < 1 || (layout != kPlain && layout != kBlocked) ||
	    n_heads > (1ULL << 40))
		return (int)cudaErrorInvalidValue;
	const Filter f{table, modulus, magic, wbits, hash_num, k, 1};
	const auto* s = static_cast<const uint8_t*>(seq);
	const auto* c = static_cast<const int64_t*>(heads);
	auto* r = static_cast<uint8_t*>(rows);
	auto st = static_cast<cudaStream_t>(stream);
	const uint64_t blocks = polish ? (n_heads + kPolishGates - 1) / kPolishGates
	                               : (n_heads * kRowLanes + kRowThreads - 1) / kRowThreads;
	if (blocks > 0x7FFFFFFFULL)
		return (int)cudaErrorInvalidValue;
	const unsigned b = (unsigned)blocks;
	if (polish && layout == kPlain)
		polish_rows_kernel<kPlain><<<b, kPolishThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else if (polish)
		polish_rows_kernel<kBlocked><<<b, kPolishThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else if (layout == kPlain)
		site_rows_kernel<kPlain><<<b, kRowThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	else
		site_rows_kernel<kBlocked><<<b, kRowThreads, 0, st>>>(s, n, c, n_heads, f, jump, r);
	return (int)cudaGetLastError();
}

// The lanes a polish block gives each of its ``c`` rows.
int nts_polish_lanes(uint32_t c) { return polish_lanes(c); }

// Candidate masks of the ``n_gates`` heads ``gates`` (int64) of a contig
// of ``n`` heads, whose n + k - 1 bytes lie at ``seq``; ``masks`` holds
// n_gates bytes.  ``gated`` 1: the heads are absence gates of this filter
// (the draft's own base is 0, not probed); 0: any heads, all four bases
// probed.
int nts_cand_masks(const void* seq, uint64_t n, int k, const void* gates, uint64_t n_gates,
                   const void* table, uint64_t modulus, uint64_t magic, int wbits, int layout,
                   int hash_num, int gated, void* masks, void* stream)
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
	const unsigned b = (unsigned)blocks;
	if (layout == kPlain && gated)
		cand_masks_kernel<kPlain, true><<<b, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else if (layout == kPlain)
		cand_masks_kernel<kPlain, false><<<b, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else if (layout == kBlocked && gated)
		cand_masks_kernel<kBlocked, true><<<b, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else if (layout == kBlocked)
		cand_masks_kernel<kBlocked, false><<<b, kThreads, 0, st>>>(s, n, g, n_gates, f, m);
	else
		return (int)cudaErrorInvalidValue;
	return (int)cudaGetLastError();
}

// Resident blocks per SM: which = 0, 1 for the candidate kernel's plain and
// blocked forms, 2, 3 for the site kernel's, 4, 5 for its polish form's,
// 6, 7 for the mask kernel's four-probe forms, 8, 9 for the binned front
// end's counting and scattering forms, 10 for its probe kernel, 11, 12 for
// the mask kernel's gated forms.  Negative on error.
int nts_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_words_kernel<kPlain>, kThreads, 0); break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_words_kernel<kBlocked>, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kPlain>, kRowThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, site_rows_kernel<kBlocked>, kRowThreads, 0); break;
	case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, polish_rows_kernel<kPlain>, kPolishThreads, 0); break;
	case 5: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, polish_rows_kernel<kBlocked>, kPolishThreads, 0); break;
	case 6: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kPlain, false>, kThreads, 0); break;
	case 7: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kBlocked, false>, kThreads, 0); break;
	case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_bin_kernel<false>, kThreads, 0); break;
	case 9:
		err = static_cast<cudaError_t>(stage_smem_ok());
		if (err == cudaSuccess)
			err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_bin_kernel<true>, kThreads,
			                                                    kCandStageBytes);
		break;
	case 10: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, snv_cand_probe_kernel, kThreads, 0); break;
	case 11: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kPlain, true>, kThreads, 0); break;
	case 12: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand_masks_kernel<kBlocked, true>, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* nts_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nts_cand_batch(int layout) { return kAlts * (layout == kPlain ? kSnvHeadsPlain : kSnvHeadsBlocked); }
int nts_mask_batch(int gated) { return gated ? kMaskProbesGated : kMaskProbes; }
int nts_site_batch(int layout) { return 4 * (layout == kPlain ? kSiteWindowsPlain : kSiteWindowsBlocked); }
int nts_site_lanes() { return kRowLanes; }
int nts_polish_gates() { return kPolishGates; }
int nts_max_cand_slices() { return kMaxCandSlices; }
int nts_cand_rounds() { return kCandRounds; }
int nts_probe_chunk() { return kProbeChunk; }
int nts_tile_heads() { return kTile; }
int nts_halo_bytes() { return kHalo; }

}  // extern "C"
