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
//       plain    - hash_num NTM64-extended hashes, each mod bits, bit idx&31
//                  of little-endian word idx>>5;
//       counting - minimum of counters[h mod counters] over the hashes;
//   * gate = valid & (snv | !present | low_count | has_iupac), where
//     valid = every byte of the window passes isAcceptedBase (case-folded)
//     and has_iupac = some byte is accepted but not ACGTacgt (the JAX
//     package force-hints those windows on the host instead);
//   * the pack of 32 gates into one little-endian uint32 word.
//
// Bound.  Each probe is a random read from a filter far larger than the
// 50 MB L2: one 32-byte DRAM sector per probed word (blocked: one per live
// head; plain and counting: up to hash_num).  Beside that the pass reads
// 1 B of ASCII per head and writes 1/8 B per head.  The card's bytes per
// second would allow about 4x the speed; what bounds it is the rate at
// which the DRAM serves random sectors, about 30 G probes/s on an H100
// whether a thread keeps 1 or 8 loads in flight (probe_floor_kernel below;
// PERF.md).  So the design aims at making no probe the gate does not need
// and at keeping the hashing off the memory's critical path.
//
// Design.  One thread owns 32 consecutive heads and writes their gate word
// (a warp's lanes own consecutive words, so no cross-lane pack is needed).
// A block of 256 threads covers an 8192-head tile and copies its ASCII
// bytes, plus the k-1 bytes past it (at most a 1024-byte halo, so k <= 1025),
// into shared memory.  The thread hashes its first window directly (k
// steps), then works through its heads in batches of kBatch:
//
//   1. hash: roll kBatch heads into registers (canonical hash, a live mask
//      of the windows to probe, a mask of the windows whose gate is forced
//      by snv or IUPAC).  A roll step is fh' = srol(fh) ^ F[out][in],
//      rh' = sror(rh ^ R[out][in]) with 16-entry tables in shared memory
//      indexed by the 2-bit codes of the bytes leaving and entering the
//      window; their values are right for ACGTacgt, and any other byte makes
//      the window invalid or forced, so its hash is never used.
//   2. probe: issue the batch's probes as independent predicated
//      ld.global.nc loads (no branch).  Plain and counting make hash_num
//      such rounds; a round probes only the heads that the earlier rounds
//      left undecided (present so far, or a minimum count still >=
//      min_threshold), so an absent k-mer costs what it does on the host.
//   3. gate: fold the loaded words into the batch's gate bits.
//
// kBatch is 2, measured: batches of 1, 2, 4 and 8 heads were timed against
// each other on the same data (PERF.md section 6), and 2 was the fastest
// for plain and counting and within 0.4% of 1 for blocked.  More loads in
// flight per thread do not help: the 131 k threads of a chunk already keep
// more probes in flight than the DRAM serves.
//
// The plain and counting layouts reduce a 64-bit hash modulo the filter
// size with a multiply by a reciprocal computed on the host (fastmod in nthash.cuh,
// ops/gate_kernel.py::mod_magic) instead of a 64-bit '%'.  The blocked
// layout keeps its power-of-two mask.  The shared-memory tile has a row
// pitch of 36 bytes per thread's 32: lanes t..t+31 reading the same
// offset of their rows hit 32 distinct banks.  __launch_bounds__ caps the
// registers so that at least 4 blocks (1024 threads) stay resident per SM:
// a 2^22-head chunk is 512 blocks, one wave on the 132 SMs.  Every index is
// 64-bit.
//
// The hashing, the filter probe and the tile are shared with the SNV
// kernels through nthash.cuh.
//
// probe_floor_kernel, below, is a measuring stick and not on any path: the
// same number of threads each making the same number of random probes of
// the same table with (by default) kBatch loads in flight, and nothing else.

#include "nthash.cuh"

namespace {

using namespace nth;

constexpr int kBatch = 2;                   // heads hashed before their probes issue
constexpr int kMaxFloorBatch = 8;           // the floor kernel's deepest batch

template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gate_words_kernel(const uint8_t* __restrict__ seq, uint64_t n, Filter f, int snv,
                  uint32_t* __restrict__ out, uint64_t n_words)
{
	__shared__ __align__(16) uint8_t tile[kRows * kRowStride];
	__shared__ uint64_t roll_f[16], roll_r[16], seed_f[4], seed_r[4];
	__shared__ uint8_t cls[256];

	const int k = f.k;
	const unsigned t = threadIdx.x;
	fill_roll_tables(roll_f, roll_r, seed_f, seed_r, cls, k, t);
	load_tile(tile, seq + (uint64_t)blockIdx.x * kTile, k, t);
	__syncthreads();

	const uint64_t word = (uint64_t)blockIdx.x * kThreads + t;
	if (word >= n_words)
		return;
	const uint64_t head0 = word * kHeads;
	const uint64_t left = n - head0;
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
	for (int b0 = 0; b0 < kHeads; b0 += kBatch) {
		uint64_t can[kBatch];
		uint32_t live = 0, forced = 0;
#pragma unroll
		for (int i = 0; i < kBatch; ++i) {
			const int j = b0 + i;
			if (j > 0) {
				const unsigned c_out = row[j - 1], c_in = tile_byte(row, j - 1 + k);
				const unsigned x = code_of(c_out) * 4 + code_of(c_in);
				fh = srol1(fh) ^ roll_f[x];
				rh = sror1(rh ^ roll_r[x]);
				bad += (cls[c_in] & 1) - (cls[c_out] & 1);
				iupac += (cls[c_in] >> 1) - (cls[c_out] >> 1);
			}
			can[i] = fh < rh ? fh : rh;
			const bool ok = j < heads && bad == 0;
			const bool force = snv || iupac != 0;
			live |= (uint32_t)(ok && !force) << i;
			forced |= (uint32_t)(ok && force) << i;
		}
		bits |= (forced | probe_batch<L, kBatch>(can, live, f)) << b0;
	}
	out[word] = bits;
}

__device__ __forceinline__ uint64_t mix64(uint64_t c)
{
	uint64_t z = (c + 1) * 0x9E3779B97F4A7C15ULL;  // splitmix64
	z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
	z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
	return z ^ (z >> 31);
}

// Thread i makes probes [probes*i/threads, probes*(i+1)/threads): probe c
// reads table[mix64(c) mod size], ``batch`` (at most kMaxFloorBatch) loads
// in flight, and the thread writes the XOR of what it read.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
probe_floor_kernel(const T* __restrict__ table, uint64_t size, uint64_t magic,
                   uint64_t probes, uint64_t threads, int batch, uint32_t* __restrict__ out)
{
	const uint64_t tid = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
	if (tid >= threads)
		return;
	const uint64_t lo = probes * tid / threads, hi = probes * (tid + 1) / threads;
	uint32_t acc = 0;
	for (uint64_t p = lo; p < hi; p += batch) {
		uint32_t got[kMaxFloorBatch];
#pragma unroll
		for (int i = 0; i < kMaxFloorBatch; ++i)
			got[i] = load_if(table + fastmod(mix64(p + i), size, magic), i < batch && p + i < hi, 0);
#pragma unroll
		for (int i = 0; i < kMaxFloorBatch; ++i)
			acc ^= got[i];
	}
	out[tid] = acc;
}

}  // namespace

extern "C" {

// Gate words for heads [0, n) of ``seq`` on ``stream``.  ``seq`` must hold
// ceil(n / 8192) * 8192 + 1024 readable bytes and be 16-byte aligned;
// ``out`` holds ceil(n / 32) words.  ``magic`` is mod_magic(modulus) for
// the plain and counting layouts.  Returns cudaGetLastError() after the
// launch (0 on success).
int ntg_gate_words(const void* seq, uint64_t n, int k, const void* table, uint64_t modulus,
                   uint64_t magic, int wbits, int layout, int hash_num, int snv,
                   int min_threshold, void* out, void* stream)
{
	if (n == 0)
		return 0;
	if (k < 1 || k > kHalo + 1 || hash_num < 1 || modulus == 0)
		return (int)cudaErrorInvalidValue;
	const uint64_t n_words = (n + kHeads - 1) / kHeads;
	const Filter f{table, modulus, magic, wbits, hash_num, k, min_threshold};
	const auto* s = static_cast<const uint8_t*>(seq);
	auto* o = static_cast<uint32_t*>(out);
	auto st = static_cast<cudaStream_t>(stream);
	const unsigned blocks = blocks_for(n_words);
	switch (layout) {
	case kPlain:
		gate_words_kernel<kPlain><<<blocks, kThreads, 0, st>>>(s, n, f, snv, o, n_words);
		break;
	case kBlocked:
		gate_words_kernel<kBlocked><<<blocks, kThreads, 0, st>>>(s, n, f, snv, o, n_words);
		break;
	case kCounting:
		gate_words_kernel<kCounting><<<blocks, kThreads, 0, st>>>(s, n, f, snv, o, n_words);
		break;
	default:
		return (int)cudaErrorInvalidValue;
	}
	return (int)cudaGetLastError();
}

// The random-probe floor: ``threads`` threads (in blocks of the gate
// kernel's size) make ``probes`` probes of a table of ``size`` elements of
// ``elem_bytes`` (4: words, 1: counters), ``batch`` loads in flight each;
// ``out`` holds one word per thread.
int ntg_probe_floor(const void* table, uint64_t size, uint64_t magic, int elem_bytes,
                    uint64_t probes, uint64_t threads, int batch, void* out, void* stream)
{
	if (threads == 0)
		return 0;
	if (batch < 1 || batch > kMaxFloorBatch || size == 0)
		return (int)cudaErrorInvalidValue;
	auto st = static_cast<cudaStream_t>(stream);
	auto* o = static_cast<uint32_t*>(out);
	if (elem_bytes == 4)
		probe_floor_kernel<uint32_t><<<blocks_for(threads), kThreads, 0, st>>>(
		    static_cast<const uint32_t*>(table), size, magic, probes, threads, batch, o);
	else if (elem_bytes == 1)
		probe_floor_kernel<uint8_t><<<blocks_for(threads), kThreads, 0, st>>>(
		    static_cast<const uint8_t*>(table), size, magic, probes, threads, batch, o);
	else
		return (int)cudaErrorInvalidValue;
	return (int)cudaGetLastError();
}

// Resident blocks per SM: which = 0, 1, 2 for the gate kernel's plain,
// blocked and counting forms, 3 and 4 for the floor's word and counter
// forms.  Negative on error.
int ntg_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gate_words_kernel<kPlain>, kThreads, 0); break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gate_words_kernel<kBlocked>, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gate_words_kernel<kCounting>, kThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_floor_kernel<uint32_t>, kThreads, 0); break;
	case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_floor_kernel<uint8_t>, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* ntg_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ntg_tile_heads() { return kTile; }
int ntg_halo_bytes() { return kHalo; }
int ntg_batch() { return kBatch; }

}  // extern "C"
