// Flash-attention forward: online-softmax attention with causal and
// sliding-window masks and grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// _flash_attention (kernel body _flash_kernel), the TPU kernel that walks a
// (B*H, Sq/bq, Sk/bk) grid with the key axis innermost and keeps m, l and
// the accumulator in VMEM scratch across it.
//
// What bounds it on an H100: the two products. Each admissible (query, key)
// pair costs 2*(Dh + Dv) flops against operands that are read once per
// query tile, so at the model's shapes (Dh = Dv = 128, thousands of keys)
// the work is hundreds of flops per byte: far above the fp32 ridge point.
// The port computes in fp32 on the CUDA cores (no TF32, no tensor cores),
// so the bound is 67 TFLOP/s of fp32 FMA.
//
// What the design does about it:
//  * One block of 256 threads per (query tile of BQ = 64 rows, b*h). The
//    key axis is a loop inside the block: the block stages a BK = 64 key
//    tile of K and V in shared memory (converted to fp32 there), and every
//    thread keeps a 4 x 4 patch of the score tile and 4 rows x up to 16
//    columns of the output accumulator in registers, with the running max
//    and sum of its 4 rows. The output is written once, at the end.
//  * Key tiles that can hold no admissible key are never visited: the loop
//    runs only over the tiles that intersect the causal / window band of
//    the query tile. The TPU kernel visits every tile and masks it.
//  * Query head h reads KV head h / (H / KV): grouped-query attention needs
//    no repeated copy of K and V. Operands are addressed through their
//    element strides for batch, sequence and head, so the model's
//    (B, S, H, D) layout and the (B, H, S, D) layout both launch as they
//    are, with no transpose. Only the last dim must be contiguous.
//  * No padding: ragged query and key tails are masked by index; head dims
//    are zero-filled in shared memory up to a multiple of 4.
//  * Tiles are launched heaviest first (the last query tiles see the most
//    keys under a causal mask), so the short ones fill the tail.
//  * fp32 arithmetic throughout, with the accurate expf. Masked scores are
//    -inf; a row whose running max is still -inf uses 0 in its place, so
//    exp never sees (-inf) - (-inf). A row that no key may see (possible
//    only with a window and Sq > Sk + window - 1) is written as 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per staged tile
constexpr int NT = 256;            // threads per block: 16 x 16
constexpr int PS = BK + 4;         // row stride of the probability tile
constexpr int MAX_HEAD_DIM = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Row stride (floats) of the Q and K tiles: a multiple of 4 whose quarter
// is odd, so the float4 reads of 8 consecutive rows fall in 8 distinct
// bank quads.
__host__ __device__ __forceinline__ int qk_stride(int dh) {
  int s4 = (dh + 3) / 4;
  if ((s4 & 1) == 0) ++s4;
  return 4 * s4;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t q_sb, q_ss, q_sh;        // element strides of q: batch, seq, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, group, Sq, Sk, Dh, Dv, causal, window;
  float scale;
};

// NJ: 64-wide column groups of the output a thread row covers (Dv <= 64*NJ).
template <typename T, int NJ>
__global__ void __launch_bounds__(NT, 1)
flash_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qs = qk_stride(p.Dh);
  const int dh4 = (p.Dh + 3) / 4;
  constexpr int VS = 64 * NJ;                  // row stride of the V tile
  float* Qs = smem;                            // BQ x qs
  float* Ks = Qs + BQ * qs;                    // BK x qs
  float* Vs = Ks + BK * qs;                    // BK x VS
  float* Ps = Vs + BK * VS;                    // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;                     // score cols tx + 16 j
  const int ty = tid >> 4;                     // rows 4 ty + i
  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;          // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / p.group;
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  // Q tile, zero-filled past Sq and Dh
  for (int e = tid; e < BQ * qs; e += NT) {
    const int r = e / qs, d = e % qs;
    const int qr = q0 + r;
    Qs[e] = (qr < p.Sq && d < p.Dh)
                ? to_float(qb[(int64_t)qr * p.q_ss + d]) : 0.f;
  }

  // the band of keys this query tile can see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * qs; e += NT) {
      const int c = e / qs, d = e % qs;
      const int kc = k0 + c;
      Ks[e] = (kc < p.Sk && d < p.Dh)
                  ? to_float(kb[(int64_t)kc * p.k_ss + d]) : 0.f;
    }
    for (int e = tid; e < BK * VS; e += NT) {
      const int c = e / VS, d = e % VS;
      const int kc = k0 + c;
      Vs[e] = (kc < p.Sk && d < p.Dv)
                  ? to_float(vb[(int64_t)kc * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < dh4; ++d4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * qs +
                                                 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * qs +
                                                 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + 4 * ty + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        bool ok = kc < p.Sk;
        if (p.causal) ok = ok && kc <= qr;
        if (p.window > 0) ok = ok && kc > qr - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] - m_use);
        row_sum += pr;
        Ps[(4 * ty + i) * PS + tx + 16 * j] = pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][j][u] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's keys
    const int kmax = min(BK, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(4 * ty + i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + c * VS + 64 * j + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pr[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr[i], vv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pr[i], vv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pr[i], vv.w, acc[i][j][3]);
        }
      }
    }
  }

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    if (qr >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 64 * j + 4 * tx + u;
        if (d < p.Dv) store(ob + (int64_t)qr * p.o_ss + d, acc[i][j][u] * inv);
      }
  }
}

template <typename T, int NJ>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int qs = qk_stride(p.Dh);
  const size_t smem = sizeof(float) *
      ((size_t)(BQ + BK) * qs + (size_t)BK * 64 * NJ + (size_t)BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_attention_kernel<T, NJ><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t stream) {
  switch ((p.Dv + 63) / 64) {
    case 1: return launch<T, 1>(p, B, stream);
    case 2: return launch<T, 2>(p, B, stream);
    case 3: return launch<T, 3>(p, B, stream);
    case 4: return launch<T, 4>(p, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, Dh) by its strides, k (B, Sk, KV, Dh), v (B, Sk, KV, Dv),
// out (B, Sq, H, Dv); strides in elements for batch, sequence and head, the
// last dim contiguous. dtype 0 = fp32, 1 = bf16 (all four tensors alike).
// Query head h reads KV head h / (H / KV). window 0 = no window. Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, const int64_t* strides, int B, int H,
                        int KV, int Sq, int Sk, int Dh, int Dv, int causal,
                        int window, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Dh <= 0 || Dh > MAX_HEAD_DIM || Dv <= 0 ||
      Dv > MAX_HEAD_DIM || Sk < 0 || window < 0 ||
      (int64_t)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.H = H; p.group = H / KV; p.Sq = Sq; p.Sk = Sk; p.Dh = Dh; p.Dv = Dv;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
