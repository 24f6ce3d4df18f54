// One gradient-primal COKE/DKLA ADMM iteration for all agents, per agent i:
//
//   r_t    = phi_t . theta_i - y_t                  (t = 0..T-1)
//   g      = (2/T) Phi_i^T r
//   g_aug  = g + (2 lam/N) theta_i + 2 rho deg theta_i + gamma_i
//            - rho (deg theta_hat_i + sum_o (theta_hat_{i+o} + theta_hat_{i-o}))
//   theta' = theta_i - lr g_aug          (written in place onto theta)
//   xi_sq  = ||theta' - theta_hat_i||^2
//   resid_sq = sum_t r_t^2               (the train-MSE numerator of theta_i)
//
// Replaces: src/repro/kernels/coke_update/coke_update.py::_coke_megastep
// (kernel body _megastep_kernel), the TPU megakernel that streams the
// (bt, D) feature tiles through VMEM and carries the T-axis gradient sum in
// VMEM scratch across sequential grid steps.
//
// What bounds it on an H100: reading Phi, 4*N*T*D bytes (1.15 GB at the
// paper-scale N=20, T=3500, D=4096) against 4*N*T*D flops. One flop per
// byte is far below the fp32 ridge point, so device-memory bandwidth is the
// limit: the kernel reads Phi exactly once, and has to keep enough bytes in
// flight on every SM at every moment to hold 3.35 TB/s.
//
// What the design does about it. Two launches:
//  * launch A (megastep_stream_kernel): one persistent block per SM. The
//    N*T rows, in agent-major order, are cut into stages of up to R rows of
//    one agent (a stage never crosses an agent boundary); each block walks
//    one contiguous range of stages, balanced to within one stage. The
//    segmentation is computed on the host (megastep_segments in
//    kernels/coke_update/coke_update.py) and passed in `plan`. A block's
//    range may cross agent boundaries: it then keeps one partial gradient
//    (and one partial resid_sq) per (block, agent) segment.
//    A ring of S stages in shared memory is fed by one producer warp: lane
//    0 issues one cp.async.bulk (1-D TMA, no tensor map) per stage, since
//    a stage's rows are contiguous in Phi, completing on the stage's full
//    mbarrier with the stage's exact byte count as its transaction count.
//    Eight consumer warps own the feature columns: each thread keeps its
//    theta columns and its gradient accumulator in registers (16 columns
//    at D = 4096), reads its columns of a stage with 16-byte shared loads,
//    forms its share of the stage's R dot products, reduces them with warp
//    shuffles and one named barrier to r_t, adds r_t phi_t from the same
//    stage into its accumulator, and hands the stage back on its empty
//    mbarrier (one arrival per warp). So loads for the next S-1 stages are
//    in flight while the consumers reduce.
//    Where D % 4 != 0 or Phi's base is not 16-byte aligned, the bulk copy
//    cannot be used; a second instance of the same kernel (BULK = false)
//    stages with 4-byte cp.async from the 32 producer lanes, each arriving
//    on the full barrier when its copies land (cp.async.mbarrier.arrive
//    .noinc), into rows padded to a multiple of 4 columns with zeros.
//  * launch B (megastep_combine_kernel), grid (D-tiles, N): sums agent i's
//    segment partials in segment order, applies the consensus terms (ring
//    neighbours are theta_hat rows (i +- o) mod N, read by index), writes
//    theta' in place and one xi_sq partial per (agent, tile). The last
//    tile of agent i to finish (an integer counter per agent, zeroed by
//    launch A) sums agent i's tile partials in tile order into xi_sq[i];
//    tile 0 writes resid_sq[i] from the segments' partials in order.
// No floating-point atomics and fixed reduction orders, so results are
// bitwise identical from run to run. Writing theta' in place is safe:
// launch A has finished reading theta before B starts, and B reads
// neighbours from theta_hat only. All arithmetic is fp32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int CONSUMERS = 256;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;      // + one producer warp
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_BARRIER = 1;          // named barrier (0: syncthreads)
// dynamic shared memory: mbarriers and the reduction buffer, then the ring
constexpr int RING_OFFSET = 1024;
// a stage of this many bytes or less, where rows allow (at D = 4096: 4 rows
// in 3 stages, the fastest of 1-4 rows per stage on an H100; see PERF.md)
constexpr int STAGE_TARGET_BYTES = 64 * 1024;
// a wait that outlasts this many cycles (~10 s) is a protocol fault: trap
// rather than hang the card
constexpr long long WAIT_LIMIT_CYCLES = 1ll << 34;
constexpr int FIN_THREADS = 256;
constexpr int FIN_WARPS = FIN_THREADS / 32;
constexpr int MAX_OFFSETS = 8;

// float4 column groups per consumer thread (V) -> most rows per stage (R)
constexpr int max_rows(int v) {
  return v <= 2 ? 8 : v <= 4 ? 4 : v <= 8 ? 2 : 1;
}
constexpr int INSTANCES[5] = {1, 2, 4, 8, 20};

struct Offsets {
  int n;
  int o[MAX_OFFSETS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

// one 1-D bulk copy global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed;
// the arrival counts toward the barrier's expected count (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(CONSUMER_BARRIER), "n"(CONSUMERS)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float r, float4 v, float4& acc) {
  acc.x = fmaf(r, v.x, acc.x);
  acc.y = fmaf(r, v.y, acc.y);
  acc.z = fmaf(r, v.z, acc.z);
  acc.w = fmaf(r, v.w, acc.w);
}

// a consumer thread's share of one segment's partials: its columns of the
// gradient sum, and (thread 0) the segment's sum of squared residuals
template <int V, bool BULK>
__device__ __forceinline__ void flush_segment(const float4 (&acc)[V],
                                              float rsq, float* out,
                                              float* rsq_out, int tid, int D,
                                              int Dp4) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int q = tid + k * CONSUMERS;
    if (q >= Dp4) continue;
    if (BULK) {
      reinterpret_cast<float4*>(out)[q] = acc[k];
    } else {
      const int c = 4 * q;
      if (c < D) out[c] = acc[k].x;
      if (c + 1 < D) out[c + 1] = acc[k].y;
      if (c + 2 < D) out[c + 2] = acc[k].z;
      if (c + 3 < D) out[c + 3] = acc[k].w;
    }
  }
  if (tid == 0) *rsq_out = rsq;
}

// plan (int32): stage_begin[G + 1] | block_seg[G] | agent_seg[N + 1].
// Block g walks global stages stage_begin[g] .. stage_begin[g+1]-1; stage
// s belongs to agent s / spa and holds rows (s % spa) * rps .. of it. Its
// first segment is block_seg[g]; a new segment starts at each new agent.
template <int V, int R, bool BULK>
__global__ void __launch_bounds__(THREADS, 1)
megastep_stream_kernel(const float* __restrict__ theta,
                       const float* __restrict__ phi,
                       const float* __restrict__ y,
                       const int* __restrict__ plan,
                       float* __restrict__ partial,
                       float* __restrict__ rsq_part,
                       unsigned* __restrict__ done, int N, int T, int D,
                       int rps, int stages, int spa) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + MAX_STAGES;
  float* red = reinterpret_cast<float*>(empty + MAX_STAGES);  // [2][8][R]
  float* ring = reinterpret_cast<float*>(smem_raw + RING_OFFSET);

  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int s_begin = plan[g];
  const int nst = plan[g + 1] - s_begin;
  const int Dp = BULK ? D : ((D + 3) & ~3);   // row stride in the ring
  const int Dp4 = Dp >> 2;
  const size_t stage_floats = (size_t)rps * Dp;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], BULK ? 1 : 32);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!BULK && Dp != D) {
    // the pad columns are never copied: zero them once, so that they add
    // 0 * 0 to the dot products
    const int pad = Dp - D;
    for (int e = tid; e < stages * rps * pad; e += THREADS)
      ring[(size_t)(e / pad) * Dp + D + e % pad] = 0.f;
  }
  // launch B's per-agent tile counters start at zero
  if (g == 0)
    for (int q = tid; q < N; q += THREADS) done[q] = 0u;
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp ----
    const int lane = tid - CONSUMERS;
    int s = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nst; ++j) {
      if (j >= stages) mbar_wait(&empty[s], phase ^ 1u);
      const int gs = s_begin + j;
      const int agent = gs / spa;
      const int row0 = (gs - agent * spa) * rps;
      const int rows = min(rps, T - row0);
      const float* src = phi + ((size_t)agent * T + row0) * D;
      float* dst = ring + (size_t)s * stage_floats;
      if (BULK) {
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)rows * (uint32_t)D * 4u;
          mbar_arrive_expect_tx(&full[s], bytes);
          bulk_copy(dst, src, bytes, &full[s]);
        }
      } else {
        for (int r = 0; r < rows; ++r)
          for (int c = lane; c < D; c += 32)
            cp_async4(dst + (size_t)r * Dp + c, src + (size_t)r * D + c);
        cp_async_arrive(&full[s]);
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (!BULK) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warps ----
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* block_seg = plan + G + 1;
  float4 th[V], acc[V];
  int agent = -1;
  int seg = block_seg[g] - 1;
  float rsq = 0.f;

  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nst; ++j) {
    const int gs = s_begin + j;
    const int a = gs / spa;
    if (a != agent) {
      if (agent >= 0)
        flush_segment<V, BULK>(acc, rsq, partial + (size_t)seg * D,
                               rsq_part + seg, tid, D, Dp4);
      agent = a;
      ++seg;
      rsq = 0.f;
      const float* tp = theta + (size_t)a * D;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = 4 * (tid + k * CONSUMERS);
        th[k].x = c < D ? tp[c] : 0.f;
        th[k].y = c + 1 < D ? tp[c + 1] : 0.f;
        th[k].z = c + 2 < D ? tp[c + 2] : 0.f;
        th[k].w = c + 3 < D ? tp[c + 3] : 0.f;
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const int row0 = (gs - a * spa) * rps;
    const int rows = min(rps, T - row0);
    float yv[R];
#pragma unroll
    for (int b = 0; b < R; ++b)
      yv[b] = b < rows ? y[(size_t)a * T + row0 + b] : 0.f;

    mbar_wait(&full[s], phase);
    const float4* tile =
        reinterpret_cast<const float4*>(ring + (size_t)s * stage_floats);

    float dot[R];
#pragma unroll
    for (int b = 0; b < R; ++b) dot[b] = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = tid + k * CONSUMERS;
      if (q < Dp4) {
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (b < rows) dot[b] = dot4(tile[b * Dp4 + q], th[k], dot[b]);
      }
    }
    float* red_j = red + (j & 1) * CONSUMER_WARPS * R;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const float v = warp_sum(dot[b]);
      if (lane == 0) red_j[warp * R + b] = v;
    }
    consumer_sync();
    float r[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMER_WARPS; ++w) sum += red_j[w * R + b];
      r[b] = b < rows ? sum - yv[b] : 0.f;
      rsq = fmaf(r[b], r[b], rsq);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = tid + k * CONSUMERS;
      if (q < Dp4) {
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (b < rows) axpy4(r[b], tile[b * Dp4 + q], acc[k]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if (agent >= 0)
    flush_segment<V, BULK>(acc, rsq, partial + (size_t)seg * D,
                           rsq_part + seg, tid, D, Dp4);
}

__global__ void __launch_bounds__(FIN_THREADS)
megastep_combine_kernel(float* __restrict__ theta,
                        const float* __restrict__ theta_hat,
                        const float* __restrict__ gamma,
                        const float* __restrict__ partial,
                        const float* __restrict__ rsq_part,
                        const int* __restrict__ agent_seg,
                        float* __restrict__ xi_part,
                        unsigned* __restrict__ done,
                        float* __restrict__ xi_sq,
                        float* __restrict__ resid_sq, int N, int D,
                        Offsets offs, float rho, float deg, float lam2,
                        float rho2deg, float lr, float inv_t2) {
  __shared__ float red[FIN_WARPS];
  const int ntiles = gridDim.x;
  const int tile = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = tile * FIN_THREADS + tid;
  const int sa = agent_seg[i];
  const int sb = agent_seg[i + 1];
  const size_t row = (size_t)i * D;

  float local = 0.f;
  if (c < D) {
    float g = 0.f;
    for (int s = sa; s < sb; ++s) g += partial[(size_t)s * D + c];
    const float hat = theta_hat[row + c];
    float acc = deg * hat;
    for (int q = 0; q < offs.n; ++q) {
      const int o = offs.o[q];
      const int ip = (i + o) % N;
      const int im = ((i - o) % N + N) % N;
      acc += theta_hat[(size_t)ip * D + c];
      acc += theta_hat[(size_t)im * D + c];
    }
    const float th = theta[row + c];
    const float g_data = inv_t2 * g;
    const float gaug = g_data + lam2 * th + rho2deg * th + gamma[row + c]
                       - rho * acc;
    const float th_new = th - lr * gaug;
    theta[row + c] = th_new;
    const float dd = th_new - hat;
    local = dd * dd;
  }
  local = warp_sum(local);
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < FIN_WARPS; ++w) s += red[w];
    xi_part[(size_t)i * ntiles + tile] = s;
    if (tile == 0 && resid_sq != nullptr) {
      float rs = 0.f;
      for (int q = sa; q < sb; ++q) rs += rsq_part[q];
      resid_sq[i] = rs;
    }
    // publish the partial, then count this tile in; the last one sums
    __threadfence();
    if (atomicAdd(&done[i], 1u) == (unsigned)(ntiles - 1)) {
      __threadfence();
      const float* part = xi_part + (size_t)i * ntiles;
      float x = 0.f;
      for (int t = 0; t < ntiles; ++t) x += __ldcg(part + t);
      xi_sq[i] = x;
    }
  }
}

size_t stream_smem_bytes(int rps, int stages, int Dp) {
  return (size_t)RING_OFFSET + (size_t)stages * rps * Dp * sizeof(float);
}

using StreamKernel = void (*)(const float*, const float*, const float*,
                              const int*, float*, float*, unsigned*, int,
                              int, int, int, int, int);

template <int V>
StreamKernel instance(bool bulk) {
  return bulk ? &megastep_stream_kernel<V, max_rows(V), true>
              : &megastep_stream_kernel<V, max_rows(V), false>;
}

// the instance of launch A for V column groups per thread and the staging;
// null for a V that is not in INSTANCES
StreamKernel stream_kernel(int v, bool bulk) {
  switch (v) {
    case 1: return instance<1>(bulk);
    case 2: return instance<2>(bulk);
    case 4: return instance<4>(bulk);
    case 8: return instance<8>(bulk);
    case 20: return instance<20>(bulk);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch plan of launch A for an (N, T, D) problem on the current device.
// `bulk` = 1 for the bulk-copy instance (D % 4 == 0, Phi 16-byte aligned),
// 0 for the cp.async one. Fills
//   out[0] V, float4 column groups per consumer thread (the instance)
//   out[1] rows per stage
//   out[2] stages in the ring
//   out[3] dynamic shared-memory bytes per block
//   out[4] blocks the card holds at once (SMs x resident blocks per SM)
//   out[5] R, the instance's most rows per stage
// Returns cudaErrorInvalidValue when D is too wide for two one-row stages
// or for the widest instance.
int coke_megastep_plan(int N, int T, int D, int bulk, int* out) {
  if (N <= 0 || T <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int Dp = bulk ? D : ((D + 3) & ~3);
  if (bulk && D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int need = ((Dp / 4) + CONSUMERS - 1) / CONSUMERS;
  int v = 0;
  for (int q = 0; q < 5 && v == 0; ++q)
    if (INSTANCES[q] >= need) v = INSTANCES[q];
  if (v == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rmax = max_rows(v);
  const size_t row_bytes = (size_t)Dp * sizeof(float);
  int rps = 1;
  while (rps < rmax && (size_t)(rps + 1) * row_bytes <= STAGE_TARGET_BYTES)
    ++rps;
  rps = std::min(rps, T);
  const size_t ring = (size_t)optin - RING_OFFSET;
  while (rps > 1 && ring / ((size_t)rps * row_bytes) < 2) --rps;
  const int stages =
      (int)std::min((size_t)MAX_STAGES, ring / ((size_t)rps * row_bytes));
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stream_smem_bytes(rps, stages, Dp);

  const StreamKernel kernel = stream_kernel(v, bulk != 0);
  int blocks = 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = v;
  out[1] = rps;
  out[2] = stages;
  out[3] = (int)smem;
  out[4] = blocks * sms;
  out[5] = rmax;
  return 0;
}

// Launch A: theta (N, D), phi (N, T, D), y (N, T) and the segmentation
// `plan` (device int32, see megastep_stream_kernel) over G blocks ->
// partial (nseg, D), rsq_part (nseg,), and launch B's counters done (N,)
// zeroed. `v`, `rps`, `stages`, `smem` come from coke_megastep_plan with
// the same `bulk`; spa = ceil(T / rps).
int coke_megastep_stream(const float* theta, const float* phi,
                         const float* y, const int* plan, float* partial,
                         float* rsq_part, unsigned* done, int G, int N, int T,
                         int D, int bulk, int v, int rps, int stages,
                         int smem, void* stream) {
  const StreamKernel kernel = stream_kernel(v, bulk != 0);
  if (kernel == nullptr || G <= 0 || N <= 0 || T <= 0 || D <= 0 ||
      rps <= 0 || rps > max_rows(v) || stages < 1 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = bulk ? D : ((D + 3) & ~3);
  if ((bulk && D % 4 != 0) ||
      (size_t)smem < stream_smem_bytes(rps, stages, Dp) ||
      (Dp / 4 + CONSUMERS - 1) / CONSUMERS > v)
    return static_cast<int>(cudaErrorInvalidValue);
  const int spa = (T + rps - 1) / rps;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<G, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      theta, phi, y, plan, partial, rsq_part, done, N, T, D, rps, stages,
      spa);
  return static_cast<int>(cudaGetLastError());
}

// Launch B: the consensus terms, theta' in place, xi_sq (N,), and resid_sq
// (N,) unless it is null; xi_part (N, ntiles) with ntiles = ceil(D / 256)
// is scratch, and done (N,) the counters launch A zeroed. `agent_seg`
// (device int32, N + 1) gives agent i's segments agent_seg[i] ..
// agent_seg[i+1]-1 of partial / rsq_part. `offsets` is a host array.
int coke_megastep_combine(float* theta, const float* theta_hat,
                          const float* gamma, const float* partial,
                          const float* rsq_part, const int* agent_seg,
                          float* xi_part, unsigned* done, float* xi_sq,
                          float* resid_sq, int N, int D,
                          const int* offsets, int n_offsets, float rho,
                          float deg, float lam2, float rho2deg, float lr,
                          float inv_t2, void* stream) {
  if (n_offsets < 0 || n_offsets > MAX_OFFSETS || N <= 0 || N > 65535 ||
      D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  offs.n = n_offsets;
  for (int q = 0; q < MAX_OFFSETS; ++q) offs.o[q] = q < n_offsets ? offsets[q] : 0;
  const dim3 grid((D + FIN_THREADS - 1) / FIN_THREADS, N);
  megastep_combine_kernel<<<grid, FIN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      theta, theta_hat, gamma, partial, rsq_part, agent_seg, xi_part, done,
      xi_sq, resid_sq, N, D, offs, rho, deg, lam2, rho2deg, lr, inv_t2);
  return static_cast<int>(cudaGetLastError());
}

int coke_megastep_combine_tiles(int D) {
  return (D + FIN_THREADS - 1) / FIN_THREADS;
}

}  // extern "C"
