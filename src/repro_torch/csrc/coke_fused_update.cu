// The fused consensus combine of the ring runtime's gradient primal, per
// agent i and feature d:
//
//   g_aug = g + 2 rho deg theta + gamma - rho (deg theta_hat + left + right)
//   xi_sq = sum_d (theta_hat - theta)^2        (one partial per D-tile)
//
// Replaces: src/repro/kernels/coke_update/coke_update.py::_coke_fused_update
// (kernel body _coke_kernel), the TPU kernel that walks (1, 512) blocks of
// the six (N, D) operands through VMEM and writes one xi_sq partial per
// block, summed outside the kernel.
//
// What bounds it on an H100: bytes. Six (N, D) fp32 reads and one write
// against 10 flops per element, far below the fp32 ridge point. At the
// paper-scale N=20, D=4096 that is 2.29 MB, about 0.7 us at 3.35 TB/s, so
// the launch itself costs more than the transfer.
//
// What the design does about it: one launch, a 2-D grid of (D-tile, agent)
// blocks of 128 threads over 512-feature tiles (the TPU kernel's block), so
// even N=20 rows give 160 blocks. Each thread moves four features of each
// operand: one 16-byte load per operand where every row start is 16-byte
// aligned (D % 4 == 0 and aligned base pointers; the wrapper checks),
// otherwise four coalesced scalar loads. The ragged last tile is masked;
// nothing is padded. Each block reduces its xi_sq partial in a fixed order
// (warp shuffles, then the four warps in order) into an (N, ntiles)
// scratch; the wrapper sums the partials, as the reference sums its block
// partials outside the kernel. No atomics, so results are identical from
// run to run. g_aug is formed with round-to-nearest intrinsics in the
// plain expression's order, so nvcc contracts nothing into an FMA and the
// kernel gives the plain PyTorch version's bits. All arithmetic is fp32.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;   // 512 features per block
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float combine(float g, float th, float hat,
                                         float gm, float l, float r,
                                         float rho, float deg, float c1) {
  // (((g + c1 th) + gm) - rho (((deg hat) + l) + r)), each op rounded
  const float a = __fadd_rn(__fadd_rn(g, __fmul_rn(c1, th)), gm);
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(deg, hat), l), r);
  return __fsub_rn(a, __fmul_rn(rho, b));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
coke_fused_update_kernel(const float* __restrict__ theta,
                         const float* __restrict__ theta_hat,
                         const float* __restrict__ gamma,
                         const float* __restrict__ grad,
                         const float* __restrict__ left,
                         const float* __restrict__ right,
                         float* __restrict__ g_aug,
                         float* __restrict__ partial, int D, int ntiles,
                         float rho, float deg, float c1) {
  const int tile = blockIdx.x;
  const int agent = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row = (size_t)agent * D;
  const int base = tile * TILE;
  float sq = 0.f;

  if (VEC) {
    // D % 4 == 0: a thread's four features are all in range or all out
    const int d = base + tid * PER_THREAD;
    if (d < D) {
      const size_t at = row + d;
      const float4 th = *reinterpret_cast<const float4*>(theta + at);
      const float4 hat = *reinterpret_cast<const float4*>(theta_hat + at);
      const float4 gm = *reinterpret_cast<const float4*>(gamma + at);
      const float4 g = *reinterpret_cast<const float4*>(grad + at);
      const float4 l = *reinterpret_cast<const float4*>(left + at);
      const float4 r = *reinterpret_cast<const float4*>(right + at);
      float4 out;
      out.x = combine(g.x, th.x, hat.x, gm.x, l.x, r.x, rho, deg, c1);
      out.y = combine(g.y, th.y, hat.y, gm.y, l.y, r.y, rho, deg, c1);
      out.z = combine(g.z, th.z, hat.z, gm.z, l.z, r.z, rho, deg, c1);
      out.w = combine(g.w, th.w, hat.w, gm.w, l.w, r.w, rho, deg, c1);
      *reinterpret_cast<float4*>(g_aug + at) = out;
      const float dx = hat.x - th.x, dy = hat.y - th.y;
      const float dz = hat.z - th.z, dw = hat.w - th.w;
      sq = dx * dx + dy * dy + dz * dz + dw * dw;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int d = base + tid + k * THREADS;
      if (d < D) {
        const size_t at = row + d;
        const float th = theta[at], hat = theta_hat[at];
        g_aug[at] = combine(grad[at], th, hat, gamma[at], left[at],
                            right[at], rho, deg, c1);
        const float diff = hat - th;
        sq += diff * diff;
      }
    }
  }

  // fixed-order block reduction of the xi_sq partial
  __shared__ float warp_sums[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sq;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w];
    partial[(size_t)agent * ntiles + tile] = s;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Feature tiles per agent row: the wrapper sizes the (N, ntiles) scratch.
int coke_fused_update_tiles(int D) { return (D + TILE - 1) / TILE; }

// theta, theta_hat, gamma, grad, left, right (N, D) -> g_aug (N, D) and
// partial (N, ntiles) xi_sq partial sums; all fp32, row-major, contiguous,
// on the current device. vec != 0 selects 16-byte loads: the caller
// guarantees D % 4 == 0 and 16-byte aligned pointers. Launches on `stream`
// and returns cudaGetLastError() (0 on success). Does not synchronise.
int coke_fused_update(const float* theta, const float* theta_hat,
                      const float* gamma, const float* grad,
                      const float* left, const float* right, float* g_aug,
                      float* partial, int N, int D, int vec, float rho,
                      float deg, float c1, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = coke_fused_update_tiles(D);
  const dim3 grid(ntiles, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    coke_fused_update_kernel<true><<<grid, THREADS, 0, s>>>(
        theta, theta_hat, gamma, grad, left, right, g_aug, partial, D,
        ntiles, rho, deg, c1);
  else
    coke_fused_update_kernel<false><<<grid, THREADS, 0, s>>>(
        theta, theta_hat, gamma, grad, left, right, g_aug, partial, D,
        ntiles, rho, deg, c1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
