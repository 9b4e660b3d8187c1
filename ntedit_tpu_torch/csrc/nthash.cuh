// Device code shared by the port's kernels (gate_kernel.cu, snv_kernel.cu):
// ntHash2's split rotation and seeds, the byte classes of isAcceptedBase,
// the exact multiply-based modulo, predicated read-only loads, the filter
// descriptor with its batched probe in the three layouts, and the
// shared-memory tile of a block's ASCII bytes with its roll tables.
//
// Everything lives in namespace nth; a kernel source includes this header
// once and says ``using namespace nth``.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nth {

constexpr int kThreads = 256;               // threads per block
constexpr int kHeads = 32;                  // heads per thread: one output word
constexpr int kTile = kThreads * kHeads;    // heads per block
constexpr int kHalo = 1024;                 // bytes a block may read past its tile
constexpr int kRowStride = 36;              // shared bytes per thread's 32 (9 words: odd)
constexpr int kRows = (kTile + kHalo) / kHeads;
constexpr int kMinBlocks = 4;               // resident blocks per SM to fit in registers

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

// 2-bit code of a byte: A/a 0, C/c 1, T/t 2, G/g 3 (other bytes alias)
__device__ __forceinline__ unsigned code_of(unsigned c) { return (c >> 1) & 3; }

// forward seed and complement seed of a code (btllib's SEED_TAB)
__device__ uint64_t fwd_seed(unsigned code)
{
	switch (code & 3) {
	case 0: return kSeedA;
	case 1: return kSeedC;
	case 2: return kSeedT;
	default: return kSeedG;
	}
}

__device__ uint64_t rev_seed(unsigned code)
{
	switch (code & 3) {
	case 0: return kSeedT;
	case 1: return kSeedG;
	case 2: return kSeedA;
	default: return kSeedC;
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

// x mod m for any 64-bit x, given magic = floor((2^64 - 1) / m): the
// estimate q = floor(x * magic / 2^64) is floor(x / m) or one less, so one
// correction step gives the exact remainder (ops/gate_kernel.py::mod_magic;
// tests/test_torch_gate_kernel.py holds this arithmetic to '%')
__device__ __forceinline__ uint64_t fastmod(uint64_t x, uint64_t m, uint64_t magic)
{
	const uint64_t r = x - __umul64hi(x, magic) * m;
	return r >= m ? r - m : r;
}

// NTM64 extension: hash j of a canonical hash (j > 0)
__device__ __forceinline__ uint64_t extended(uint64_t can, uint64_t mult)
{
	const uint64_t t = can * mult;
	return t ^ (t >> kMultiShift);
}

// *p through the read-only path when pred, else dflt; predicated, not
// branched, so a batch of them goes out back to back
__device__ __forceinline__ uint32_t load_if(const uint32_t* p, uint32_t pred, uint32_t dflt)
{
	uint32_t v = dflt;
	asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q ld.global.nc.u32 %0, [%1];\n\t}"
	    : "+r"(v) : "l"(p), "r"(pred));
	return v;
}

__device__ __forceinline__ uint32_t load_if(const uint8_t* p, uint32_t pred, uint32_t dflt)
{
	uint32_t v = dflt;
	asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q ld.global.nc.u8 %0, [%1];\n\t}"
	    : "+r"(v) : "l"(p), "r"(pred));
	return v;
}

struct Filter {
	const void* table;
	uint64_t modulus;  // words (blocked), bits (plain) or counters
	uint64_t magic;    // mod_magic(modulus), plain and counting
	int wbits;         // log2(words), blocked
	int hash_num;
	int k;
	int min_threshold;
};

// bit i set when hash i of a batch of B canonical hashes fails the filter:
// absent, or (counting) below min_threshold.  Only the hashes in ``live``
// are probed.
template <int L, int B>
__device__ __forceinline__ uint32_t probe_batch(const uint64_t (&can)[B], uint32_t live,
                                                const Filter& f)
{
	if (L == kBlocked) {
		const uint32_t* words = static_cast<const uint32_t*>(f.table);
		uint32_t want[B], got[B];
#pragma unroll
		for (int i = 0; i < B; ++i) {
			uint32_t mask = 0;
			for (int j = 0; j < f.hash_num; ++j)
				mask |= 1u << ((can[i] >> (f.wbits + 5 * j)) & 31);
			want[i] = mask;
			got[i] = load_if(words + (can[i] & (f.modulus - 1)), (live >> i) & 1, 0);
		}
		uint32_t fail = 0;
#pragma unroll
		for (int i = 0; i < B; ++i)
			fail |= (uint32_t)((got[i] & want[i]) != want[i]) << i;
		return fail & live;
	}
	// plain and counting: hash_num rounds, each of B independent loads,
	// each predicated on the hashes the earlier rounds left undecided
	if (L == kPlain) {
		const uint32_t* words = static_cast<const uint32_t*>(f.table);
		uint32_t present = live;
#pragma unroll 1
		for (int j = 0; j < f.hash_num && present; ++j) {
			const uint64_t mult = (uint64_t)j ^ ((uint64_t)f.k * kMultiSeed);
			uint32_t got[B], bit[B];
#pragma unroll
			for (int i = 0; i < B; ++i) {
				const uint64_t h = j ? extended(can[i], mult) : can[i];
				const uint64_t idx = fastmod(h, f.modulus, f.magic);
				bit[i] = (uint32_t)idx & 31;
				got[i] = load_if(words + (idx >> 5), (present >> i) & 1, ~0u);
			}
#pragma unroll
			for (int i = 0; i < B; ++i)
				present &= ~(((~got[i] >> bit[i]) & 1) << i);
		}
		return live & ~present;
	}
	const uint8_t* counters = static_cast<const uint8_t*>(f.table);
	const uint32_t low = f.min_threshold > 1 ? (uint32_t)f.min_threshold : 1;
	uint32_t open = live;  // hashes whose minimum so far is still >= low
#pragma unroll 1
	for (int j = 0; j < f.hash_num && open; ++j) {
		const uint64_t mult = (uint64_t)j ^ ((uint64_t)f.k * kMultiSeed);
		uint32_t got[B];
#pragma unroll
		for (int i = 0; i < B; ++i) {
			const uint64_t h = j ? extended(can[i], mult) : can[i];
			got[i] = load_if(counters + fastmod(h, f.modulus, f.magic), (open >> i) & 1, 255);
		}
#pragma unroll
		for (int i = 0; i < B; ++i)
			open &= ~((uint32_t)(got[i] < low) << i);
	}
	return live & ~open;
}

// ---------------------------------------------------------------------------
// The tile: a block of kThreads threads covers kTile heads, thread t owning
// heads [32 t, 32 t + 32) of the block.  The block's ASCII bytes, plus the
// k - 1 bytes past them (at most kHalo, so k <= kHalo + 1), lie in shared
// memory in rows of 32 bytes at a pitch of kRowStride, so that lanes
// t..t+31 reading the same offset of their rows hit 32 distinct banks.
// ---------------------------------------------------------------------------

// byte p of a thread's window stream: row (p / 32) past its own, column p % 32
__device__ __forceinline__ unsigned tile_byte(const uint8_t* row, int p)
{
	return row[(p >> 5) * kRowStride + (p & 31)];
}

// copy bytes [0, kTile + k - 1) at ``src`` (16-byte aligned) into ``tile``
// (kRows * kRowStride bytes): 16-byte loads, four 4-byte stores each
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* src_bytes, int k,
                                          unsigned t)
{
	const int rows = kThreads + (kHeads - 2 + k) / kHeads;
	const uint4* src = reinterpret_cast<const uint4*>(src_bytes);
	for (int u = t; u < 2 * rows; u += kThreads) {
		const uint4 v = src[u];
		uint32_t* dst = reinterpret_cast<uint32_t*>(tile + (u >> 1) * kRowStride + (u & 1) * 16);
		dst[0] = v.x;
		dst[1] = v.y;
		dst[2] = v.z;
		dst[3] = v.w;
	}
}

// The tables of a rolling window hash, filled by the block's threads:
// cls[c] = byte_class(c); seed_f / seed_r = the seeds by 2-bit code; a roll
// step is fh' = srol1(fh) ^ roll_f[x], rh' = sror1(rh ^ roll_r[x]) with
// x = 4 * code(byte leaving) + code(byte entering).  Their values are right
// for ACGTacgt; any other byte makes its windows invalid or forced.
__device__ __forceinline__ void fill_roll_tables(uint64_t* roll_f, uint64_t* roll_r,
                                                 uint64_t* seed_f, uint64_t* seed_r,
                                                 uint8_t* cls, int k, unsigned t)
{
	static_assert(kThreads == 256, "one thread per byte class");
	cls[t] = byte_class(t);
	if (t < 16) {
		roll_f[t] = srol(fwd_seed(t >> 2), k) ^ fwd_seed(t);
		roll_r[t] = rev_seed(t >> 2) ^ srol(rev_seed(t), k);
	}
	if (t < 4) {
		seed_f[t] = fwd_seed(t);
		seed_r[t] = rev_seed(t);
	}
}

inline unsigned blocks_for(uint64_t threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

}  // namespace nth
