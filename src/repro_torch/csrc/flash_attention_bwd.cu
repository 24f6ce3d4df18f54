// Flash-attention backward (K7): dQ, dK and dV of softmax(Q K^T scale + mask) V
// with causal and sliding-window masks and grouped-query heads, in fp32.
//
// Replaces no Pallas kernel: the reference trains through its pure-jnp
// blockwise_attention (src/repro/models/attention.py:26) and lets
// jax.value_and_grad differentiate it inside XLA (src/repro/train/
// steps.py:38, :51, :95). The port's training forward runs K4
// (csrc/flash_attention.cu), a ctypes launch autograd cannot see into, so
// the backward of K4 is this kernel.
//
// What bounds it on an H100: operations. Per admissible (query, key) pair
// the backward's five products (S and dP recomputed, dV, dK, dQ) cost
// 10 D flops against operands read a few times, hundreds of flops per
// byte at D = 128. This first design does every product as fp32 FMAs on
// the CUDA cores (67 TFLOP/s), and recomputes S and dP in both passes
// below, so it does 14 D flops a pair where 10 D are needed. Making it
// fast (3xTF32 or wgmma, one pass) is later work.
//
// Design (FlashAttention-2's backward, without atomics):
//  (a) delta_i = rowsum(dO_i * O_i): one warp per query row.
//  (b) one block per (key tile, b, KV head): the block keeps its K and V
//      tile in shared memory and walks the H/KV query heads of its group
//      and, for each, the query tiles that the mask admits. For each query
//      tile it recomputes S = K Q^T, P = exp(S scale - L) with K4's
//      per-row log-sum-exp L, dP = V dO^T and dS = P (dP - delta) scale,
//      and accumulates dV += P dO and dK += dS Q in registers. Each dK and
//      dV tile is written once: the GQA group is summed inside the block.
//  (c) one block per (query tile, b, q head): dQ = sum over the admitted
//      key tiles of dS K, with S, P, dP and dS recomputed as in (b).
// Nothing is summed across blocks, so the result has the same bits from
// run to run. Tiles live in shared memory with a row stride of DP + 1
// floats (DP the head dim rounded up to 64, 128 or 256): the 16 threads
// of a half-warp that read 16 different rows at one column fall in 16
// banks. Thread (ty, tx) of a 16 x 16 block owns rows ty + 16 i and inner
// columns tx + 16 j of every tile it computes. Rows past the sequence
// and columns past D are zero in shared memory; a query row that no key
// may see has L = +inf (K4 writes it so), hence P = 0 and zero gradients.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block, 16 x 16
constexpr int INNER = 32;          // the inner tile: query rows in (b), keys in (c)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;                // (B, H, Sq) natural-log log-sum-exp
  float* delta;                    // (B, H, Sq) scratch, written by (a)
  float* dq;
  float* dk;
  float* dv;
  // element strides for batch, sequence and head of q k v o dout dq dk dv
  int64_t s[8][3];
  int H, KV, group, Sq, Sk, D, causal, window;
  float scale;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ const float* row_ptr(const Params& p, int which,
                                                const float* base, int b,
                                                int head, int row) {
  return base + b * p.s[which][0] + (int64_t)row * p.s[which][1] +
         head * p.s[which][2];
}

__device__ __forceinline__ bool admitted(const Params& p, int qi, int kj) {
  bool ok = qi < p.Sq && kj < p.Sk;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// rows [row0, row0 + rows) of one head of `which` into `dst` (stride DP + 1
// floats), zero past `limit` and past D up to DP
template <int DP>
__device__ __forceinline__ void stage(float* dst, const Params& p, int which,
                                      const float* base, int b, int head,
                                      int row0, int rows, int limit) {
  constexpr int ST = DP + 1;
  for (int e = threadIdx.x; e < rows * DP; e += NT) {
    const int r = e / DP, c = e - r * DP;
    const int row = row0 + r;
    dst[r * ST + c] = (row < limit && c < p.D)
                          ? __ldg(row_ptr(p, which, base, b, head, row) + c)
                          : 0.f;
  }
}

// (a): delta = rowsum(dO * O), one warp per row; grid (ceil(Sq / 8), B H)
__global__ void __launch_bounds__(NT) delta_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + warp;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  if (row >= p.Sq) return;
  const float* o = row_ptr(p, O, p.o, b, h, row);
  const float* d = row_ptr(p, DO, p.dout, b, h, row);
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(__ldg(o + c), __ldg(d + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(int64_t)blockIdx.y * p.Sq + row] = acc;
}

// The scores and their gradient for one (row tile, inner tile) pair of the
// block: for rows ty + 16 i and inner columns tx + 16 j, s = A_r . B_c and
// dp = C_r . E_c over D, then p and ds from the row's or column's L and
// delta. `rows_are_keys` says which side is which for the mask.
template <int DP, int RT>
__device__ __forceinline__ void scores_and_grads(
    const Params& p, const float* A, const float* Bm, const float* C,
    const float* E, const float* Ls, const float* Ds, int row0, int col0,
    bool rows_are_keys, float (&pr)[RT][2], float (&ds)[RT][2]) {
  constexpr int ST = DP + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RT][2], dp[RT][2];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < p.D; ++d) {
    float a[RT], c[RT], bb[2], e[2];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = A[(ty + 16 * i) * ST + d];
      c[i] = C[(ty + 16 * i) * ST + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bb[j] = Bm[(tx + 16 * j) * ST + d];
      e[j] = E[(tx + 16 * j) * ST + d];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
  const float sl = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ri = ty + 16 * i, cj = tx + 16 * j;
      const int qi = rows_are_keys ? col0 + cj : row0 + ri;
      const int kj = rows_are_keys ? row0 + ri : col0 + cj;
      const int qloc = rows_are_keys ? cj : ri;   // the query's slot in Ls/Ds
      float pv = 0.f;
      if (admitted(p, qi, kj)) pv = exp2f(s[i][j] * sl - Ls[qloc] * LOG2E);
      pr[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - Ds[qloc]) * p.scale;
    }
}

// (b): dK, dV. grid (ceil(Sk / BK), B KV); BK keys per block, RT = BK / 16
template <int DP, int BK>
__global__ void __launch_bounds__(NT) dkdv_kernel(const Params p) {
  constexpr int ST = DP + 1, RT = BK / 16, CD = DP / 16, PS = INNER + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * ST;
  float* Qs = Vs + BK * ST;
  float* dOs = Qs + INNER * ST;
  float* Ps = dOs + INNER * ST;
  float* dSs = Ps + BK * PS;
  float* Ls = dSs + BK * PS;
  float* Ds = Ls + INNER;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;

  stage<DP>(Ks, p, K, p.k, b, kvh, k0, BK, p.Sk);
  stage<DP>(Vs, p, V, p.v, b, kvh, k0, BK, p.Sk);
  float dk[RT][CD], dv[RT][CD];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the query rows the mask lets see keys k0 .. k_last
  const int k_last = min(k0 + BK, p.Sk) - 1;
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kvh * p.group + hh;
    const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int q0 = q_begin / INNER * INNER; q0 < q_end; q0 += INNER) {
      __syncthreads();   // the previous tile's Qs, dOs, Ps, dSs are read
      stage<DP>(Qs, p, Q, p.q, b, h, q0, INNER, p.Sq);
      stage<DP>(dOs, p, DO, p.dout, b, h, q0, INNER, p.Sq);
      if (threadIdx.x < INNER) {
        const int qi = q0 + threadIdx.x;
        Ls[threadIdx.x] = qi < p.Sq ? lse[qi] : INFINITY;
        Ds[threadIdx.x] = qi < p.Sq ? delta[qi] : 0.f;
      }
      __syncthreads();
      float pr[RT][2], ds[RT][2];
      scores_and_grads<DP, RT>(p, Ks, Qs, Vs, dOs, Ls, Ds, k0, q0, true, pr,
                               ds);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = pr[i][j];
          dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P dO, dK += dS Q over the tile's query rows
      for (int c = 0; c < INNER; ++c) {
        float pc[RT], sc[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          pc[i] = Ps[(ty + 16 * i) * PS + c];
          sc[i] = dSs[(ty + 16 * i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const float od = dOs[c * ST + tx + 16 * j];
          const float qd = Qs[c * ST + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            dv[i][j] = fmaf(pc[i], od, dv[i][j]);
            dk[i][j] = fmaf(sc[i], qd, dk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Sk) continue;
    float* dkr = p.dk + b * p.s[DK][0] + (int64_t)row * p.s[DK][1] +
                 kvh * p.s[DK][2];
    float* dvr = p.dv + b * p.s[DV][0] + (int64_t)row * p.s[DV][1] +
                 kvh * p.s[DV][2];
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int col = tx + 16 * j;
      if (col < p.D) {
        dkr[col] = dk[i][j];
        dvr[col] = dv[i][j];
      }
    }
  }
}

// (c): dQ. grid (ceil(Sq / BQ), B H); BQ query rows per block, RT = BQ / 16
template <int DP, int BQ>
__global__ void __launch_bounds__(NT) dq_kernel(const Params p) {
  constexpr int ST = DP + 1, RT = BQ / 16, CD = DP / 16, PS = INNER + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * ST;
  float* Ks = dOs + BQ * ST;
  float* Vs = Ks + INNER * ST;
  float* dSs = Vs + INNER * ST;
  float* Ls = dSs + BQ * PS;
  float* Ds = Ls + BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / p.group;

  stage<DP>(Qs, p, Q, p.q, b, h, q0, BQ, p.Sq);
  stage<DP>(dOs, p, DO, p.dout, b, h, q0, BQ, p.Sq);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int qi = q0 + r;
    const int64_t at = ((int64_t)b * p.H + h) * p.Sq + qi;
    Ls[r] = qi < p.Sq ? p.lse[at] : INFINITY;
    Ds[r] = qi < p.Sq ? p.delta[at] : 0.f;
  }
  float dq[RT][CD];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dq[i][j] = 0.f;

  // the keys the mask lets rows q0 .. q_last see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  for (int k0 = k_begin / INNER * INNER; k0 < k_end; k0 += INNER) {
    __syncthreads();   // the previous tile's Ks, Vs, dSs are read
    stage<DP>(Ks, p, K, p.k, b, kvh, k0, INNER, p.Sk);
    stage<DP>(Vs, p, V, p.v, b, kvh, k0, INNER, p.Sk);
    __syncthreads();
    float pr[RT][2], ds[RT][2];
    scores_and_grads<DP, RT>(p, Qs, Ks, dOs, Vs, Ls, Ds, q0, k0, false, pr,
                             ds);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int c = 0; c < INNER; ++c) {
      float sc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) sc[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float kd = Ks[c * ST + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i) dq[i][j] = fmaf(sc[i], kd, dq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    float* dqr = p.dq + b * p.s[DQ][0] + (int64_t)row * p.s[DQ][1] +
                 h * p.s[DQ][2];
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int col = tx + 16 * j;
      if (col < p.D) dqr[col] = dq[i][j];
    }
  }
}

template <int DP, int BK, int BQ>
int run(const Params& p, int B, cudaStream_t stream) {
  constexpr int ST = DP + 1, PS = INNER + 1;
  const int smem_kv =
      (2 * BK * ST + 2 * INNER * ST + 2 * BK * PS + 2 * INNER) * 4;
  const int smem_q =
      (2 * BQ * ST + 2 * INNER * ST + BQ * PS + 2 * BQ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<DP, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  delta_kernel<<<dim3((p.Sq + NT / 32 - 1) / (NT / 32), B * p.H), NT, 0,
                 stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.Sk > 0) {
    dkdv_kernel<DP, BK><<<dim3((p.Sk + BK - 1) / BK, B * p.KV), NT, smem_kv,
                          stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_kernel<DP, BQ><<<dim3((p.Sq + BQ - 1) / BQ, B * p.H), NT, smem_q,
                      stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 tensors by their element strides (batch, sequence, head; the last
// dim contiguous), in the order q, k, v, o, dout, dq, dk, dv: q, o, dout,
// dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D). lse (B, H, Sq) is K4's
// log-sum-exp; delta (B, H, Sq) is scratch. Query head h reads KV head
// h / (H / KV); window 0 = no window. Launches (a), (b) and (c) on
// `stream` in order and returns cudaGetLastError() (0 on success); does
// not synchronise.
int flash_attention_bwd(const float* q, const float* k, const float* v,
                        const float* o, const float* dout, const float* lse,
                        float* delta, float* dq, float* dk, float* dv,
                        const int64_t* strides, int B, int H, int KV, int Sq,
                        int Sk, int D, int causal, int window, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || Sk < 0 || window < 0 ||
      (int64_t)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse;
  p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  p.H = H; p.KV = KV; p.group = H / KV; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run<64, 64, 64>(p, B, s);
  if (D <= 128) return run<128, 64, 64>(p, B, s);
  return run<256, 32, 32>(p, B, s);
}

}  // extern "C"
