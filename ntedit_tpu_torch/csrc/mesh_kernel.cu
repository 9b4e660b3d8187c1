// Row reduce kernels: the local step of the mesh collectives on an H100.
//
// Replace the reduction inside the JAX package's two collectives,
// ntedit_tpu/parallel/mesh.py::ring_or (a ppermute ring OR-ing uint32
// filter words) and ::saturating_add_allreduce (a psum of uint8 counters
// in int32, clipped to 255).  NCCL has no bitwise-OR reduction and no
// saturating byte sum, so the port's collectives (parallel/mesh.py) are an
// all_to_all, this reduce over the D pieces a rank receives, and an
// all_gather.  Two entry points over rows [D, m] of a row stride in bytes:
//
//   * OR      - out[i] = rows[0][i] | ... | rows[D-1][i]   (filter words)
//   * SAT_ADD - out[i] = min(rows[0][i] + ... + rows[D-1][i], 255) per byte
//               (counters).  __vaddus4 adds four unsigned bytes with
//               saturation; saturation is monotone, so chaining it over the
//               rows equals min(sum, 255).
//
// Bound.  A stream: each of the D rows is read once and the result written
// once, (D + 1) * m bytes at the HBM rate, and no arithmetic worth
// counting.  Design: a grid-stride loop in which a thread reads one
// 16-byte vector of each row (neighbouring threads on neighbouring
// vectors, so each row's loads coalesce) and writes one.  The vector
// width is picked per call from the alignment of the rows, their stride
// and the output: 16 bytes where all three allow it (the collectives pad
// each piece to a multiple of 16 bytes), else 4, else 1.  The bytes past
// the last whole vector (m * element size not a multiple of the width)
// are done one byte a thread by the first threads of the same launch.
// D is a runtime argument (any D >= 1); the row loop is unrolled by 4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;  // cap of the grid-stride grid
enum Op : int { kOr = 0, kSatAdd = 1 };

template <int O>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b)
{
	return O == kOr ? (a | b) : __vaddus4(a, b);
}

template <int O>
__device__ __forceinline__ uint4 combine(uint4 a, uint4 b)
{
	return make_uint4(combine<O>(a.x, b.x), combine<O>(a.y, b.y), combine<O>(a.z, b.z),
	                  combine<O>(a.w, b.w));
}

template <int O>
__device__ __forceinline__ uint8_t combine(uint8_t a, uint8_t b)
{
	if (O == kOr)
		return a | b;
	const unsigned s = unsigned(a) + unsigned(b);
	return s > 255u ? 255u : uint8_t(s);
}

// out[i] = reduce over d of row d's vector i, for i < units; then the
// ``tail`` bytes after the units, one a thread.
template <int O, typename V>
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const uint8_t* __restrict__ rows, int rows_n, int64_t stride, int64_t units,
                   int64_t tail, uint8_t* __restrict__ out)
{
	const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
	const int64_t step = int64_t(gridDim.x) * kThreads;
	for (int64_t i = first; i < units; i += step) {
		V acc = __ldg(reinterpret_cast<const V*>(rows) + i);
#pragma unroll 4
		for (int d = 1; d < rows_n; ++d)
			acc = combine<O>(acc, __ldg(reinterpret_cast<const V*>(rows + d * stride) + i));
		reinterpret_cast<V*>(out)[i] = acc;
	}
	if (first < tail) {
		const int64_t b = units * int64_t(sizeof(V)) + first;
		uint8_t acc = __ldg(rows + b);
		for (int d = 1; d < rows_n; ++d)
			acc = combine<O>(acc, __ldg(rows + d * stride + b));
		out[b] = acc;
	}
}

template <int O, typename V>
int launch(const uint8_t* rows, int rows_n, int64_t stride, int64_t nbytes, uint8_t* out,
           cudaStream_t st)
{
	const int64_t units = nbytes / int64_t(sizeof(V));
	const int64_t tail = nbytes % int64_t(sizeof(V));
	const int64_t work = units > tail ? units : tail;
	int dev = 0, sms = 0;
	cudaError_t err = cudaGetDevice(&dev);
	if (err == cudaSuccess)
		err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
	if (err != cudaSuccess)
		return (int)err;
	int64_t blocks = (work + kThreads - 1) / kThreads;
	const int64_t cap = int64_t(sms) * kBlocksPerSm;
	if (blocks > cap)
		blocks = cap;
	reduce_rows_kernel<O, V><<<unsigned(blocks), kThreads, 0, st>>>(rows, rows_n, stride, units,
	                                                                 tail, out);
	return (int)cudaGetLastError();
}

template <int O>
int reduce_rows(const void* rows, int rows_n, int64_t stride, int64_t nbytes, void* out,
                void* stream)
{
	if (rows_n < 1 || nbytes < 0 || (rows_n > 1 && stride < nbytes))
		return (int)cudaErrorInvalidValue;
	if (nbytes == 0)
		return 0;
	const auto* r = static_cast<const uint8_t*>(rows);
	auto* o = static_cast<uint8_t*>(out);
	auto st = static_cast<cudaStream_t>(stream);
	const uint64_t align = uint64_t(reinterpret_cast<uintptr_t>(rows)) | uint64_t(stride) |
	                       uint64_t(reinterpret_cast<uintptr_t>(out));
	if (align % 16 == 0)
		return launch<O, uint4>(r, rows_n, stride, nbytes, o, st);
	if (align % 4 == 0)
		return launch<O, uint32_t>(r, rows_n, stride, nbytes, o, st);
	return launch<O, uint8_t>(r, rows_n, stride, nbytes, o, st);
}

}  // namespace

extern "C" {

// The reduce of ``rows_n`` rows of ``nbytes`` bytes each, row d at
// ``rows + d * stride``, into ``out`` (``nbytes``) on ``stream``:
// op 0 bitwise OR, op 1 saturating byte sum.  Returns cudaGetLastError()
// after the launch (0 on success).
int ntm_reduce_rows(const void* rows, int rows_n, int64_t stride, int64_t nbytes, int op,
                    void* out, void* stream)
{
	switch (op) {
	case kOr: return reduce_rows<kOr>(rows, rows_n, stride, nbytes, out, stream);
	case kSatAdd: return reduce_rows<kSatAdd>(rows, rows_n, stride, nbytes, out, stream);
	default: return (int)cudaErrorInvalidValue;
	}
}

// Resident blocks per SM of each form: 0-2 OR with 16-, 4- and 1-byte
// vectors, 3-5 the saturating sum with the same.  Negative on error.
int ntm_occupancy(int which)
{
	int blocks = 0;
	cudaError_t err = cudaErrorInvalidValue;
	switch (which) {
	case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kOr, uint4>, kThreads, 0); break;
	case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kOr, uint32_t>, kThreads, 0); break;
	case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kOr, uint8_t>, kThreads, 0); break;
	case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kSatAdd, uint4>, kThreads, 0); break;
	case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kSatAdd, uint32_t>, kThreads, 0); break;
	case 5: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reduce_rows_kernel<kSatAdd, uint8_t>, kThreads, 0); break;
	}
	return err == cudaSuccess ? blocks : -(int)err;
}

const char* ntm_error_string(int code)
{
	return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
