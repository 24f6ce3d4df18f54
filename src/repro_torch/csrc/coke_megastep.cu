// One gradient-primal COKE/DKLA ADMM iteration for all agents, per agent i:
//
//   g      = (2/T) Phi_i^T (Phi_i theta_i - y_i)
//   g_aug  = g + (2 lam/N) theta_i + 2 rho deg theta_i + gamma_i
//            - rho (deg theta_hat_i + sum_o (theta_hat_{i+o} + theta_hat_{i-o}))
//   theta' = theta_i - lr g_aug          (written in place onto theta)
//   xi_sq  = ||theta' - theta_hat_i||^2
//
// Replaces: src/repro/kernels/coke_update/coke_update.py::_coke_megastep
// (kernel body _megastep_kernel), the TPU megakernel that streams the
// (bt, D) feature tiles through VMEM and carries the T-axis gradient sum in
// VMEM scratch across sequential grid steps.
//
// What bounds it on an H100: reading Phi, 4*N*T*D bytes (1.15 GB at the
// paper-scale N=20, T=3500, D=4096) against 4*N*T*D flops. One flop per
// byte is far below the fp32 ridge point, so device-memory bandwidth is the
// limit and the point of the kernel is to read Phi exactly once.
//
// What the design does about it. Hopper blocks run in no order, so the
// TPU's sequential carry becomes two launches:
//  * launch A (megastep_partial_kernel), grid (nchunk, N): block (c, i)
//    walks its contiguous run of rows of agent i, BT rows at a time. Each
//    thread owns the feature columns tid, tid+256, ...; it loads its
//    columns of the BT rows once from device memory (coalesced: a warp
//    reads 32 consecutive floats of a row), keeps them in shared memory,
//    forms its share of phi_t . theta_i, and after a fixed-order block
//    reduction gives r_t = phi_t . theta_i - y_t, adds r_t * phi_t from
//    shared memory into its own accumulator columns. The block writes its
//    D-vector of partial sums to an (N, nchunk, D) scratch. nchunk is
//    sized so the grid fills the card in one wave.
//  * launch B (megastep_finish_kernel), grid (N): sums the nchunk partials
//    in a fixed order, applies the consensus terms (ring neighbours are
//    theta_hat rows (i +- o) mod N, read by index, never rolled copies),
//    writes theta' in place and reduces xi_sq in a fixed order.
// No atomics, so results are identical from run to run. Writing theta' in
// place is safe: launch A has finished reading theta before B starts, and
// B reads neighbours from theta_hat only. Ragged T and D are masked in the
// kernels; nothing is padded or copied. All arithmetic is fp32.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FIN_THREADS = 512;
constexpr int FIN_WARPS = FIN_THREADS / 32;
constexpr int MAX_OFFSETS = 8;
// keep two partial-kernel blocks resident per SM where D allows it
constexpr int BLOCKS_PER_SM_TARGET = 2;

struct Offsets {
  int n;
  int o[MAX_OFFSETS];
};

// dynamic shared memory: theta_s[D] | acc_s[D] | tile_s[BT][D]; thread tid
// touches only its own columns of each, so only the dot-product reduction
// needs barriers
template <int BT>
__global__ void __launch_bounds__(THREADS)
megastep_partial_kernel(const float* __restrict__ theta,
                        const float* __restrict__ phi,
                        const float* __restrict__ y,
                        float* __restrict__ partial, int T, int D,
                        int rows_per_chunk, int nchunk) {
  extern __shared__ float smem[];
  float* theta_s = smem;
  float* acc_s = smem + D;
  float* tile_s = smem + 2 * (size_t)D;
  __shared__ float red[WARPS][BT];
  __shared__ float resid[BT];

  const int chunk = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* th = theta + (size_t)i * D;
  for (int c = tid; c < D; c += THREADS) {
    theta_s[c] = th[c];
    acc_s[c] = 0.f;
  }
  const int t_begin = chunk * rows_per_chunk;
  const int t_end = min(T, t_begin + rows_per_chunk);
  const float* phi_i = phi + (size_t)i * T * D;
  const float* y_i = y + (size_t)i * T;

  for (int t0 = t_begin; t0 < t_end; t0 += BT) {
    float dot[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) dot[b] = 0.f;
#pragma unroll 4
    for (int c = tid; c < D; c += THREADS) {
      const float w = theta_s[c];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int t = t0 + b;
        const float v = (t < t_end) ? phi_i[(size_t)t * D + c] : 0.f;
        tile_s[(size_t)b * D + c] = v;
        dot[b] = fmaf(v, w, dot[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = dot[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][b] = v;
    }
    __syncthreads();
    if (tid < BT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][tid];
      const int t = t0 + tid;
      resid[tid] = (t < t_end) ? s - y_i[t] : 0.f;
    }
    __syncthreads();
    for (int c = tid; c < D; c += THREADS) {
      float a = acc_s[c];
#pragma unroll
      for (int b = 0; b < BT; ++b) a = fmaf(resid[b], tile_s[(size_t)b * D + c], a);
      acc_s[c] = a;
    }
  }

  float* out = partial + ((size_t)i * nchunk + chunk) * D;
  for (int c = tid; c < D; c += THREADS) out[c] = acc_s[c];
}

__global__ void __launch_bounds__(FIN_THREADS)
megastep_finish_kernel(float* __restrict__ theta,
                       const float* __restrict__ theta_hat,
                       const float* __restrict__ gamma,
                       const float* __restrict__ partial,
                       float* __restrict__ xi_sq, int N, int D, int nchunk,
                       Offsets offs, float rho, float deg, float lam2,
                       float rho2deg, float lr, float inv_t2) {
  __shared__ float red[FIN_WARPS];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)i * D;
  const float* p_i = partial + (size_t)i * nchunk * D;

  float local = 0.f;
  for (int c = tid; c < D; c += FIN_THREADS) {
    float g = 0.f;
    for (int k = 0; k < nchunk; ++k) g += p_i[(size_t)k * D + c];
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
    local += dd * dd;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < FIN_WARPS; ++w) s += red[w];
    xi_sq[i] = s;
  }
}

template <int BT>
size_t partial_smem_bytes(int D) {
  return (size_t)(2 + BT) * D * sizeof(float);
}

template <int BT>
cudaError_t launch_partial(const float* theta, const float* phi,
                           const float* y, float* partial, int N, int T,
                           int D, int rows_per_chunk, int nchunk,
                           cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<BT>(D);
  cudaError_t err = cudaFuncSetAttribute(
      megastep_partial_kernel<BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nchunk, N);
  megastep_partial_kernel<BT><<<grid, THREADS, smem, stream>>>(
      theta, phi, y, partial, T, D, rows_per_chunk, nchunk);
  return cudaGetLastError();
}

template <int BT>
cudaError_t occupancy(int D, int* blocks) {
  const size_t smem = partial_smem_bytes<BT>(D);
  cudaError_t err = cudaFuncSetAttribute(
      megastep_partial_kernel<BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, megastep_partial_kernel<BT>, THREADS, smem);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch plan for an (N, T, D) problem on the current device: rows per
// staged tile (bt), rows per block (rows_per_chunk) and blocks per agent
// (nchunk), from the device's SM count and shared memory. Returns
// cudaErrorInvalidValue when one row of D columns does not fit.
int coke_megastep_plan(int N, int T, int D, int* bt, int* rows_per_chunk,
                       int* nchunk) {
  if (N <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, smem_sm = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the largest tile whose working set leaves room for the target number
  // of resident blocks; fall back to fewer rows before giving up
  const size_t static_bytes = 1024;
  const size_t budget = (size_t)smem_sm / BLOCKS_PER_SM_TARGET - static_bytes;
  int b = 0;
  const int candidates[4] = {8, 4, 2, 1};
  for (int q = 0; q < 4 && b == 0; ++q) {
    const size_t need = (size_t)(2 + candidates[q]) * D * sizeof(float);
    if (need <= budget) b = candidates[q];
  }
  if (b == 0 && (size_t)3 * D * sizeof(float) <= (size_t)smem_optin) b = 1;
  if (b == 0) return static_cast<int>(cudaErrorInvalidValue);

  int blocks = 0;
  switch (b) {
    case 8: err = occupancy<8>(D, &blocks); break;
    case 4: err = occupancy<4>(D, &blocks); break;
    case 2: err = occupancy<2>(D, &blocks); break;
    default: err = occupancy<1>(D, &blocks); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  // one wave: N * nchunk <= resident blocks on the card
  const int slots = blocks * sms;
  const int max_chunks = (T + b - 1) / b;
  int n = slots / N;
  if (n < 1) n = 1;
  if (n > max_chunks) n = max_chunks;
  int rows = (T + n - 1) / n;
  rows = ((rows + b - 1) / b) * b;
  *bt = b;
  *rows_per_chunk = rows;
  *nchunk = (T + rows - 1) / rows;
  return 0;
}

// Launch A: theta (N, D), phi (N, T, D), y (N, T) -> partial (N, nchunk, D).
int coke_megastep_partial(const float* theta, const float* phi,
                          const float* y, float* partial, int N, int T,
                          int D, int bt, int rows_per_chunk, int nchunk,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (bt) {
    case 8: err = launch_partial<8>(theta, phi, y, partial, N, T, D, rows_per_chunk, nchunk, s); break;
    case 4: err = launch_partial<4>(theta, phi, y, partial, N, T, D, rows_per_chunk, nchunk, s); break;
    case 2: err = launch_partial<2>(theta, phi, y, partial, N, T, D, rows_per_chunk, nchunk, s); break;
    case 1: err = launch_partial<1>(theta, phi, y, partial, N, T, D, rows_per_chunk, nchunk, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Launch B: consensus terms + in-place theta update + xi_sq (N,).
// `offsets` is a host array of n_offsets ring offsets.
int coke_megastep_finish(float* theta, const float* theta_hat,
                         const float* gamma, const float* partial,
                         float* xi_sq, int N, int D, int nchunk,
                         const int* offsets, int n_offsets, float rho,
                         float deg, float lam2, float rho2deg, float lr,
                         float inv_t2, void* stream) {
  if (n_offsets < 0 || n_offsets > MAX_OFFSETS)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  offs.n = n_offsets;
  for (int q = 0; q < MAX_OFFSETS; ++q) offs.o[q] = q < n_offsets ? offsets[q] : 0;
  megastep_finish_kernel<<<N, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, theta_hat, gamma, partial, xi_sq, N, D, nchunk, offs, rho, deg,
      lam2, rho2deg, lr, inv_t2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
