// The fused consensus combine of the ring runtime's gradient primal, per
// agent i and feature d:
//
//   g_aug = g + 2 rho deg theta + gamma - rho (deg theta_hat + left + right)
//   xi_sq = sum_d (theta_hat - theta)^2
//
// Replaces: src/repro/kernels/coke_update/coke_update.py::_coke_fused_update
// (kernel body _coke_kernel), the TPU kernel that walks (1, 512) blocks of
// the six (N, D) operands through VMEM and writes one xi_sq partial per
// block, summed outside the kernel.
//
// What bounds it on an H100: bytes. Six (N, D) fp32 reads and one write
// against 10 flops per element, far below the fp32 ridge point; five reads
// where the two neighbour operands are one tensor, as the fused fallback
// passes them. At N=20, D=4096 the whole call is ~2 MB, resident in L2 and
// about one DRAM round trip's worth of bytes in flight, so a launch costs
// more than the transfer; at D=65536 it is 31-37 MB and streams.
//
// What the design does about it: one launch per call. Each agent row is one
// thread-block cluster of C blocks (C in 1, 2, 4, 8; the plan is
// `fused_update_plan` in the wrapper, taken here as integers). The blocks
// of a cluster cut the row into contiguous slices of `slice` features (a
// multiple of 4); a thread walks its slice in steps of U loads per operand,
// all issued before the arithmetic: 16-byte loads where D % 4 == 0 and
// every row start is 16-byte aligned, else 4-byte loads masked at the
// ragged end (never padded). Operands are read with ld.global.nc.
// L1::no_allocate (each byte is read once) and g_aug is written with
// st.global.cs. An instance for one neighbour operand read once, used as
// both left and right, serves the path's call (the wrapper takes it only
// when both are the same memory): six arrays moved instead of seven, the
// same bits.
//
// xi_sq is finished on the card in a fixed order: a thread adds its steps
// in order (a float4's four squares left to right), warps reduce by a
// shuffle tree, a block adds its warps in order and stores its partial
// into rank 0's shared memory (distributed shared memory); after one
// cluster barrier rank 0 adds the C partials in rank order and writes
// xi_sq[i]. A block may store into rank 0 only once every block of the
// cluster has started: each arrives (relaxed) at a first barrier phase on
// entry and waits on it just before that store, by when it has long
// completed. A full cluster barrier costs ~0.7 us on an H100, as much as
// the path's whole transfer, so there is one. No scratch, no atomics, no
// second launch: a call gives the same bits every time and can be
// captured in a CUDA graph. `ref.xi_sq_in_kernel_order` repeats this
// order on the CPU.
// g_aug and every sum use round-to-nearest intrinsics, so nvcc contracts
// nothing into an FMA: g_aug has the plain PyTorch version's bits. All
// arithmetic is fp32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_CLUSTER = 8;

__device__ __forceinline__ float combine(float g, float th, float hat,
                                         float gm, float l, float r,
                                         float rho, float deg, float c1) {
  // (((g + c1 th) + gm) - rho (((deg hat) + l) + r)), each op rounded
  const float a = __fadd_rn(__fadd_rn(g, __fmul_rn(c1, th)), gm);
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(deg, hat), l), r);
  return __fsub_rn(a, __fmul_rn(rho, b));
}

__device__ __forceinline__ float4 combine(float4 g, float4 th, float4 hat,
                                          float4 gm, float4 l, float4 r,
                                          float rho, float deg, float c1) {
  return make_float4(combine(g.x, th.x, hat.x, gm.x, l.x, r.x, rho, deg, c1),
                     combine(g.y, th.y, hat.y, gm.y, l.y, r.y, rho, deg, c1),
                     combine(g.z, th.z, hat.z, gm.z, l.z, r.z, rho, deg, c1),
                     combine(g.w, th.w, hat.w, gm.w, l.w, r.w, rho, deg, c1));
}

// (hat - th)^2, a float4's four squares added left to right
__device__ __forceinline__ float squares(float hat, float th) {
  const float d = __fsub_rn(hat, th);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ float squares(float4 hat, float4 th) {
  return __fadd_rn(__fadd_rn(__fadd_rn(squares(hat.x, th.x),
                                       squares(hat.y, th.y)),
                             squares(hat.z, th.z)),
                   squares(hat.w, th.w));
}

__device__ __forceinline__ float load(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 load(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void store(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" :: "l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void store(float4* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// V: float4 (16-byte form) or float (4-byte form). SHARED: left is also
// right, read once. U: loads per operand in flight per thread.
template <typename V, bool SHARED, int U>
__global__ void __launch_bounds__(MAX_THREADS, 2)
coke_fused_update_kernel(const float* __restrict__ theta,
                         const float* __restrict__ theta_hat,
                         const float* __restrict__ gamma,
                         const float* __restrict__ grad,
                         const float* __restrict__ left,
                         const float* __restrict__ right,
                         float* __restrict__ g_aug,
                         float* __restrict__ xi_sq, int D, int slice,
                         float rho, float deg, float c1) {
  constexpr int W = sizeof(V) / sizeof(float);   // features per load
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int agent = blockIdx.y;
  // one cluster per agent row, clusters along x: the rank is blockIdx.x
  const int lo = blockIdx.x * slice;
  const int hi = min(lo + slice, D);
  const int n = hi > lo ? (hi - lo) / W : 0;       // loads per operand
  const size_t at = (size_t)agent * D + lo;
  const V* th_p = reinterpret_cast<const V*>(theta + at);
  const V* hat_p = reinterpret_cast<const V*>(theta_hat + at);
  const V* gm_p = reinterpret_cast<const V*>(gamma + at);
  const V* g_p = reinterpret_cast<const V*>(grad + at);
  const V* l_p = reinterpret_cast<const V*>(left + at);
  const V* r_p = reinterpret_cast<const V*>(right + at);
  V* out_p = reinterpret_cast<V*>(g_aug + at);

  // barrier phase 1: every block of the cluster has started (waited on
  // before the store into rank 0's shared memory)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  float sq = 0.f;
  for (int j0 = tid; j0 < n; j0 += U * threads) {
    V th[U], hat[U], gm[U], g[U], l[U], r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * threads;
      if (j < n) {
        th[u] = load(th_p + j);
        hat[u] = load(hat_p + j);
        gm[u] = load(gm_p + j);
        g[u] = load(g_p + j);
        l[u] = load(l_p + j);
        if (!SHARED) r[u] = load(r_p + j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * threads;
      if (j < n) {
        store(out_p + j, combine(g[u], th[u], hat[u], gm[u], l[u],
                                 SHARED ? l[u] : r[u], rho, deg, c1));
        sq = __fadd_rn(sq, squares(hat[u], th[u]));
      }
    }
  }

  // the block's partial: a shuffle tree per warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
  __shared__ float warp_sums[MAX_THREADS / 32];
  __shared__ float partials[MAX_CLUSTER];   // rank 0's: one per rank
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sq;
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < threads / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
    *cluster.map_shared_rank(&partials[rank], 0) = s;
  }
  // phase 2: the partials are in rank 0's shared memory; no block reads
  // another's after it, so every block may leave
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float s = 0.f;
    for (unsigned int r = 0; r < cluster.num_blocks(); ++r)
      s = __fadd_rn(s, partials[r]);
    xi_sq[agent] = s;
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        float*, int, int, float, float, float);

// the instance for (vec, shared, U); nullptr for a U it was not built for
Kernel instance(int vec, int shared, int unroll) {
#define K3_INSTANCE(V, S, U)                                   \
  if (vec == (sizeof(V) == 16) && shared == S && unroll == U) \
    return coke_fused_update_kernel<V, S, U>;
  K3_INSTANCE(float4, true, 1) K3_INSTANCE(float4, true, 2)
  K3_INSTANCE(float4, true, 4) K3_INSTANCE(float4, false, 1)
  K3_INSTANCE(float4, false, 2) K3_INSTANCE(float4, false, 4)
  K3_INSTANCE(float, true, 1) K3_INSTANCE(float, true, 2)
  K3_INSTANCE(float, true, 4) K3_INSTANCE(float, false, 1)
  K3_INSTANCE(float, false, 2) K3_INSTANCE(float, false, 4)
#undef K3_INSTANCE
  return nullptr;
}

cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int N,
                                 int clusters, int threads,
                                 cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters, N);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

bool valid(int N, int clusters, int threads, Kernel k) {
  return k != nullptr && N > 0 && N <= 65535 && clusters >= 1 &&
         clusters <= MAX_CLUSTER && (clusters & (clusters - 1)) == 0 &&
         threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 0 if the current device can hold at least one cluster of the instance
// for (vec, shared, unroll) at `threads` threads and `clusters` blocks per
// cluster; else the CUDA error of the query, or cudaErrorInvalidValue for
// a plan the kernel does not take, or cudaErrorInvalidConfiguration where
// no such cluster fits. The wrapper calls it once per plan.
int coke_fused_update_check(int vec, int shared, int unroll, int clusters,
                            int threads) {
  const Kernel k = instance(vec, shared, unroll);
  if (!valid(1, clusters, threads, k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      launch_config(&attr, 1, clusters, threads, nullptr);
  int fit = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &fit, reinterpret_cast<const void*>(k), &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fit > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// theta, theta_hat, gamma, grad, left, right (N, D) -> g_aug (N, D) and
// xi_sq (N,); all fp32, row-major, contiguous, on the current device.
// vec != 0 selects 16-byte loads: the caller guarantees D % 4 == 0 and
// 16-byte aligned pointers. shared != 0 reads `left` as both neighbour
// operands (`right` is not read): the caller guarantees they are the same
// memory. The plan (clusters C, threads, unroll U, slice) is the wrapper's
// `fused_update_plan`: grid (C, N) in clusters of C blocks along x, block
// r over features [r slice, (r + 1) slice). Launches on `stream` and
// returns the launch's error code (0 on success). Does not synchronise.
int coke_fused_update(const float* theta, const float* theta_hat,
                      const float* gamma, const float* grad,
                      const float* left, const float* right, float* g_aug,
                      float* xi_sq, int N, int D, int vec, int shared,
                      int clusters, int threads, int unroll, int slice,
                      float rho, float deg, float c1, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  const Kernel k = instance(vec, shared, unroll);
  if (!valid(N, clusters, threads, k) || slice <= 0 ||
      (long long)slice * clusters < D || (vec && slice % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = launch_config(
      &attr, N, clusters, threads, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaLaunchKernelEx(
      &config, k, theta, theta_hat, gamma, grad, left, right, g_aug, xi_sq,
      D, slice, rho, deg, c1));
}

}  // extern "C"
