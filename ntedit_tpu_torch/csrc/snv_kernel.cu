// SNV and polish site kernels: the device side of SNV mode (-s 1) and of
// polish mode's optional probe results, on an H100.
//
// In SNV mode every head enters the engine's fix path, but a head can only
// yield a record or an edit when some alternate base's k-mer, the window
// with its last base replaced, is in the filter.  Two kernels take that
// work from the host:
//
// snv_cand_words_kernel replaces the JAX package's XLA program
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
// Bound.  All are bound as the gate kernel is: by the rate at which the
// DRAM serves random 32-byte sectors of a filter far larger than the L2
// (about 30 G probes/s, PERF.md), not by bytes per second and not by the
// hashing.  The candidate pass makes three probes per live head (blocked;
// plain: up to hash_num each, stopping at the first clear bit), beside
// 1 B of ASCII read and 1/8 B written per head.  The site pass makes about
// 4 + 5 ceil(k / jump) probes per row, on a few thousand candidates or
// cluster starts per million heads: its work is small, and what it saves is
// on the host.  The mask pass makes four probes per gate.
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
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
snv_cand_words_kernel(const uint8_t* __restrict__ seq, uint64_t n, Filter f,
                      uint32_t* __restrict__ out, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ uint64_t roll_f[16], roll_r[16], seed_f[4], seed_r[4], last_r[4];
	__shared__ uint8_t cls[256];

	constexpr int kSnvHeads = L == kPlain ? kSnvHeadsPlain : kSnvHeadsBlocked;
	const int k = f.k;
	const unsigned t = threadIdx.x;
	fill_roll_tables(roll_f, roll_r, seed_f, seed_r, cls, k, t);
	if (t < 4)
		last_r[t] = srol(rev_seed(t), k - 1);  // the last base's share of rh
	load_tile(tile, seq + (uint64_t)blockIdx.x * kTile, k, t);
	__syncthreads();

	const uint64_t word = (uint64_t)blockIdx.x * kThreads + t;
	if (word >= n_words)
		return;
	const uint64_t left = n - word * kHeads;
	const int heads = left < kHeads ? (int)left : kHeads;  // heads of this word below n
	const uint8_t* row = tile + t * kRowStride;

	// the first window directly: fh over bytes 0..k-1, rh over k-1..0
	uint64_t fh = 0, rh = 0;
	int bad = 0, iupac = 0;
	for (int i = 0; i < k; ++i) {
		const unsigned c = tile_byte(row, i);
		fh = srol1(fh) ^ seed_f[code_of(c)];
		rh = srol1(rh) ^ seed_r[code_of(tile_byte(row, k - 1 - i))];
		bad += cls[c] & 1;
		iupac += cls[c] >> 1;
	}

	uint32_t bits = 0;
#pragma unroll
	for (int b0 = 0; b0 < kHeads; b0 += kSnvHeads) {
		uint64_t can[kSnvHeads * kAlts];
		uint32_t live = 0, forced = 0;
#pragma unroll
		for (int i = 0; i < kSnvHeads; ++i) {
			const int j = b0 + i;
			const unsigned c_last = tile_byte(row, j - 1 + k);
			if (j > 0) {
				const unsigned c_out = row[j - 1];
				const unsigned x = code_of(c_out) * 4 + code_of(c_last);
				fh = srol1(fh) ^ roll_f[x];
				rh = sror1(rh ^ roll_r[x]);
				bad += (cls[c_last] & 1) - (cls[c_out] & 1);
				iupac += (cls[c_last] >> 1) - (cls[c_out] >> 1);
			}
			// changelast: take the last base's seeds out, put an alternate's in
			const unsigned ct = code_of(c_last);
			const uint64_t fx = fh ^ seed_f[ct], rx = rh ^ last_r[ct];
#pragma unroll
			for (int a = 0; a < kAlts; ++a) {
				const unsigned cb = (ct + 1 + a) & 3;
				const uint64_t fb = fx ^ seed_f[cb], rb = rx ^ last_r[cb];
				can[i * kAlts + a] = fb < rb ? fb : rb;
			}
			const bool ok = j < heads && bad == 0;
			const bool force = iupac != 0;
			live |= (ok && !force ? 7u : 0u) << (i * kAlts);
			forced |= (uint32_t)(ok && force) << i;
		}
		const uint32_t present = live & ~probe_batch<L, kSnvHeads * kAlts>(can, live, f);
#pragma unroll
		for (int i = 0; i < kSnvHeads; ++i)
			bits |= (((forced >> i) & 1) | (uint32_t)(((present >> (i * kAlts)) & 7u) != 0))
			        << (b0 + i);
	}
	out[word] = bits;
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
// 6, 7 for the mask kernel's.  Negative on error.
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
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* nts_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nts_cand_batch(int layout) { return kAlts * (layout == kPlain ? kSnvHeadsPlain : kSnvHeadsBlocked); }
int nts_mask_batch() { return kMaskProbes; }
int nts_tile_heads() { return kTile; }
int nts_halo_bytes() { return kHalo; }

}  // extern "C"
