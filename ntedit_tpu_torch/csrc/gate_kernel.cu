// Gate kernel: the dense polish pass of one contig chunk on an H100.
//
// Replaces the JAX package's TPU gate pass: the Pallas kernel
// ntedit_tpu/ops/flag_kernel.py (_flag_prep_pallas, _make_kernel and its
// XLA epilogue _flag_gates_packed) and, on the main path, the XLA program
// ntedit_tpu/engine/flag.py::_gate_words_from_codes.  For every window head
// h of the chunk it computes, from the ASCII draft bytes:
//
//   * the ntHash2 forward and reverse window hashes and their canonical
//     minimum (core/nthash_ref.py);
//   * the Bloom probe, in one of three layouts (core/bloom.py):
//       blocked  - word can & (nw-1), mask of hash_num 5-bit fields above;
//       plain    - hash_num NTM64-extended hashes, each % bits, bit idx&31
//                  of little-endian word idx>>5;
//       counting - minimum of counters[h % cbytes] over the hashes;
//   * gate = valid & (snv | !present | low_count | has_iupac), where
//     valid = every byte of the window passes isAcceptedBase (case-folded)
//     and has_iupac = some byte is accepted but not ACGTacgt (the JAX
//     package force-hints those windows on the host instead);
//   * the pack of 32 gates into one little-endian uint32 word.
//
// Design.  One thread owns 32 consecutive heads and writes one word: it
// hashes its first window directly (k steps), then rolls the next 31
// (fh' = srol(fh) ^ srol^k(seed(out)) ^ seed(in),
//  rh' = sror(rh ^ cseed(out) ^ srol^k(cseed(in)))), keeping running counts of
// unaccepted and IUPAC bytes for the validity and IUPAC terms.  A block of
// 256 threads covers 8192 heads; it first copies its 8192 ASCII bytes plus
// a 1024-byte halo into shared memory with coalesced 16-byte loads, so
// k may be at most 1025.  Seeds and their srol^k rotations come from
// 256-entry tables in shared memory.  A window that is invalid, or whose
// gate is already forced (snv, IUPAC), is not probed.
//
// Bound.  Each probe is a random read from a filter far larger than the
// 50 MB L2, so it costs one 32-byte DRAM sector per probed word (blocked:
// one per valid head; plain and counting: up to hash_num).  Beside that
// the pass reads 1 B of ASCII per head and writes 1/8 B per head.  At
// 3.35 TB/s the blocked layout's floor is about 33 B per head.  What the
// design does about it: the gather sits in the kernel (no index or mask
// arrays go through device memory, unlike the TPU version), plain probes
// stop at the first clear bit, and many threads each keep a probe in
// flight to cover DRAM latency.  Faster forms (TMA, more loads in flight
// per thread) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 32;  // heads per block
constexpr int kHalo = 1024;           // bytes read past the tile

constexpr uint64_t kSeedA = 0x3C8BFBB395C60474ULL;
constexpr uint64_t kSeedC = 0x3193C18562A02B4CULL;
constexpr uint64_t kSeedG = 0x20323ED082572324ULL;
constexpr uint64_t kSeedT = 0x295549F54BE24456ULL;
constexpr uint64_t kMultiSeed = 0x90B45D39FB6DA1FAULL;
constexpr unsigned kMultiShift = 27;
constexpr uint64_t kLow33 = 0x1FFFFFFFFULL;
// bit (letter - 64) set for each letter of "ATGCRYSWKMBDHV" (isAcceptedBase)
constexpr uint32_t kAcceptedMask = 0x2dc299e;

enum Layout { kPlain = 0, kBlocked = 1, kCounting = 2 };

__device__ __forceinline__ uint64_t srol1(uint64_t x)
{
	uint64_t m = ((x & 0x8000000000000000ULL) >> 30) | ((x & 0x100000000ULL) >> 32);
	return ((x << 1) & 0xFFFFFFFDFFFFFFFFULL) | m;
}

// inverse of srol1: rotate the 33-bit low and 31-bit high parts right by one
__device__ __forceinline__ uint64_t sror1(uint64_t x)
{
	uint64_t lo = x & kLow33, hi = x >> 33;
	lo = (lo >> 1) | ((lo & 1) << 32);
	hi = (hi >> 1) | ((hi & 1) << 30);
	return (hi << 33) | lo;
}

__device__ uint64_t srol(uint64_t x, unsigned d)
{
	unsigned dl = d % 33, dh = d % 31;
	uint64_t lo = x & kLow33, hi = x >> 33;
	if (dl)
		lo = ((lo << dl) | (lo >> (33 - dl))) & kLow33;
	if (dh)
		hi = ((hi << dh) | (hi >> (31 - dh))) & 0x7FFFFFFFULL;
	return (hi << 33) | lo;
}

// forward seed: ACGT/acgt only (case-folded), 0 for every other byte
__device__ uint64_t seed_of(unsigned c)
{
	switch (c & 0xDF) {
	case 'A': return kSeedA;
	case 'C': return kSeedC;
	case 'G': return kSeedG;
	case 'T': return kSeedT;
	default: return 0;
	}
}

// complement seed: btllib's SEED_TAB[c & 7], IUPAC aliasing included
__device__ uint64_t cseed_of(unsigned c)
{
	switch (c & 7) {
	case 1: return kSeedT;
	case 3: return kSeedG;
	case 4: return kSeedA;
	case 7: return kSeedC;
	default: return 0;
	}
}

// bit 0: byte fails isAcceptedBase; bit 1: accepted but not ACGTacgt
__device__ uint8_t byte_class(unsigned c)
{
	unsigned fold = c & 0xDF;
	bool accepted = fold >= 65 && fold <= 90 && ((kAcceptedMask >> (fold - 64)) & 1);
	bool acgt = fold == 'A' || fold == 'C' || fold == 'G' || fold == 'T';
	return accepted ? (acgt ? 0 : 2) : 1;
}

__device__ __forceinline__ uint64_t extended(uint64_t can, int k, int j)
{
	if (j == 0)
		return can;
	uint64_t t = can * ((uint64_t)j ^ ((uint64_t)k * kMultiSeed));
	return t ^ (t >> kMultiShift);
}

// true when the k-mer with canonical hash ``can`` fails the filter's test:
// absent, or (counting) below min_threshold
__device__ bool fails_filter(uint64_t can, int k, const void* table, uint64_t modulus,
                             int wbits, int layout, int hash_num, int min_threshold)
{
	if (layout == kBlocked) {
		const uint32_t* words = static_cast<const uint32_t*>(table);
		uint32_t mask = 0;
		for (int j = 0; j < hash_num; ++j)
			mask |= 1u << ((can >> (wbits + 5 * j)) & 31);
		return (__ldg(words + (can & (modulus - 1))) & mask) != mask;
	}
	if (layout == kPlain) {
		const uint32_t* words = static_cast<const uint32_t*>(table);
		for (int j = 0; j < hash_num; ++j) {
			uint64_t idx = extended(can, k, j) % modulus;
			if (!((__ldg(words + (idx >> 5)) >> (idx & 31)) & 1))
				return true;
		}
		return false;
	}
	const uint8_t* counters = static_cast<const uint8_t*>(table);
	unsigned cnt = 255;
	for (int j = 0; j < hash_num; ++j) {
		unsigned got = __ldg(counters + extended(can, k, j) % modulus);
		cnt = got < cnt ? got : cnt;
	}
	return cnt == 0 || (min_threshold > 1 && cnt < (unsigned)min_threshold);
}

__global__ void __launch_bounds__(kThreads)
gate_words_kernel(const uint8_t* __restrict__ seq, uint64_t n, int k,
                  const void* __restrict__ table, uint64_t modulus, int wbits,
                  int layout, int hash_num, int snv, int min_threshold,
                  uint32_t* __restrict__ out, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kTile + kHalo];
	__shared__ uint64_t fseed[256], cseed[256], fseed_k[256], cseed_k[256];
	__shared__ uint8_t cls[256];

	const unsigned t = threadIdx.x;
	fseed[t] = seed_of(t);
	cseed[t] = cseed_of(t);
	fseed_k[t] = srol(fseed[t], k);
	cseed_k[t] = srol(cseed[t], k);
	cls[t] = byte_class(t);

	const uint64_t block_head = (uint64_t)blockIdx.x * kTile;
	const uint4* src = reinterpret_cast<const uint4*>(seq + block_head);
	uint4* dst = reinterpret_cast<uint4*>(tile);
	for (unsigned i = t; i < (kTile + kHalo) / 16; i += kThreads)
		dst[i] = src[i];
	__syncthreads();

	const uint64_t word = (uint64_t)blockIdx.x * kThreads + t;
	if (word >= n_words)
		return;
	const uint64_t head0 = word * 32;
	const uint8_t* s = tile + t * 32;

	uint64_t fh = 0, rh = 0;
	int bad = 0, iupac = 0;
	for (int i = 0; i < k; ++i) {
		unsigned c = s[i];
		fh = srol1(fh) ^ fseed[c];
		bad += cls[c] & 1;
		iupac += cls[c] >> 1;
	}
	for (int i = k - 1; i >= 0; --i)
		rh = srol1(rh) ^ cseed[s[i]];

	uint32_t bits = 0;
	for (int j = 0; j < 32 && head0 + j < n; ++j) {
		if (j > 0) {
			unsigned c_out = s[j - 1], c_in = s[j - 1 + k];
			fh = srol1(fh) ^ fseed_k[c_out] ^ fseed[c_in];
			rh = sror1(rh ^ cseed[c_out] ^ cseed_k[c_in]);
			bad += (cls[c_in] & 1) - (cls[c_out] & 1);
			iupac += (cls[c_in] >> 1) - (cls[c_out] >> 1);
		}
		if (bad)
			continue;
		bool gate = snv || iupac;
		if (!gate) {
			uint64_t can = fh < rh ? fh : rh;
			gate = fails_filter(can, k, table, modulus, wbits, layout, hash_num,
			                    min_threshold);
		}
		bits |= (uint32_t)gate << j;
	}
	out[word] = bits;
}

}  // namespace

extern "C" {

// Gate words for heads [0, n) of ``seq`` on ``stream``.  ``seq`` must hold
// ceil(n / 8192) * 8192 + 1024 readable bytes and be 16-byte aligned;
// ``out`` holds ceil(n / 32) words.  Returns cudaGetLastError() after the
// launch (0 on success).
int ntg_gate_words(const void* seq, uint64_t n, int k, const void* table,
                   uint64_t modulus, int wbits, int layout, int hash_num, int snv,
                   int min_threshold, void* out, void* stream)
{
	const uint64_t n_words = (n + 31) / 32;
	const uint64_t blocks = (n_words + kThreads - 1) / kThreads;
	if (n == 0)
		return 0;
	if (k < 1 || k > kHalo + 1)
		return (int)cudaErrorInvalidValue;
	gate_words_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
	    static_cast<const uint8_t*>(seq), n, k, table, modulus, wbits, layout, hash_num, snv,
	    min_threshold, static_cast<uint32_t*>(out), n_words);
	return (int)cudaGetLastError();
}

const char* ntg_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ntg_tile_heads() { return kTile; }
int ntg_halo_bytes() { return kHalo; }

}  // extern "C"
