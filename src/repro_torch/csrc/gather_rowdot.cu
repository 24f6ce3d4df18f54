// The gathered row-dot of many-model serving:
//
//   out[i] = sum_k phi[i, k] * stack[slots[i], k]      (B rows, D features)
//
// Replaces: no Pallas kernel. The reference gathers each request row's
// theta slot and row-dots it inside XLA (src/repro/serve/kernel_server.py
// :164-169, einsum('bd,bd->b', phi, stack[slots])), fused into its jitted
// scorer. On the card ATen's reduction picks its split from the number of
// rows, and einsum goes through a batched product whose algorithm depends
// on the batch count, so a row's bits would depend on how many other
// tenants share its padded bucket. Serving promises that they do not:
// a request's answer is KernelModel.score_rows at its own row count.
//
// What bounds it on an H100: bytes. Each row reads D floats of phi and D
// of its gathered theta row and does 2 D flops: 0.25 flop per byte, far
// below the card's ~20 fp32 flops per byte. At the largest bucket (B =
// 1024, D = 4096) that is 33.6 MB, 0.0100 ms at 3.35 TB/s.
//
// What the design does about it: one warp per row, so a row never spans
// threads of two blocks and no partial sum leaves the warp. Lane l walks
// the 4-column groups k = l, l + 32, l + 64, ... in order, and within a
// group the columns 4k .. 4k + 3 in order, with one fmaf chain in fp32; a
// fixed __shfl_xor_sync butterfly (16, 8, 4, 2, 1) then finishes the row
// and lane 0 stores it. The order depends on D alone, so row i's bits
// depend only on phi[i] and stack[slots[i]], never on B, the other rows or
// the launch shape. The 16-byte instance reads each group as one float4
// (D % 4 == 0 and both bases 16-byte aligned); the 4-byte instance reads
// the same groups element by element, masked past D, in the same order,
// so where both apply they give the same bits. Slots are checked against
// the stack's rows on the host before the upload: the kernel trusts them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;              // 8 warps, one row each
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gather_rowdot_kernel(const float* __restrict__ phi,
                         const float* __restrict__ stack,
                         const int32_t* __restrict__ slots, int64_t rows,
                         int64_t d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* p = phi + row * d;
  const float* t = stack + static_cast<int64_t>(__ldg(slots + row)) * d;
  const int64_t groups = (d + 3) / 4;
  float acc = 0.0f;
  if (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* t4 = reinterpret_cast<const float4*>(t);
#pragma unroll 4
    for (int64_t k = lane; k < groups; k += 32) {
      const float4 a = __ldg(p4 + k);
      const float4 b = __ldg(t4 + k);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int64_t k = lane; k < groups; k += 32) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t c = 4 * k + j;
        if (c < d) acc = fmaf(__ldg(p + c), __ldg(t + c), acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch over `rows` rows of `d` features on `stream`: vec != 0 takes
// the 16-byte instance (the caller has checked d % 4 == 0 and both bases
// 16-byte aligned). slots is a device pointer to `rows` int32 row indices
// of the stack, all in range. Returns cudaGetLastError().
int gather_rowdot(const float* phi, const float* stack, const int32_t* slots,
                  int64_t rows, int64_t d, int vec, float* out,
                  void* stream) {
  const int64_t blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    gather_rowdot_kernel<true><<<grid, THREADS, 0, s>>>(phi, stack, slots,
                                                        rows, d, out);
  else
    gather_rowdot_kernel<false><<<grid, THREADS, 0, s>>>(phi, stack, slots,
                                                         rows, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
