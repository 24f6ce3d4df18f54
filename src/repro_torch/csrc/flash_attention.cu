// Flash-attention forward on the tensor cores: online-softmax attention
// with causal and sliding-window masks and grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// _flash_attention (kernel body _flash_kernel), the TPU kernel that walks a
// (B*H, Sq/bq, Sk/bk) grid with the key axis innermost and keeps m, l and
// the accumulator in VMEM scratch across it.
//
// What bounds it on an H100: the two products, S = Q K^T and O += P V. Each
// admissible (query, key) pair costs 2 (Dh + Dv) flops against operands
// read once per query tile, so at the model's shapes (Dh = Dv = 128,
// thousands of keys) the work is hundreds of flops per byte, far above the
// ridge point of either instance:
//  * bf16: m16n8k16 bf16 MMAs with fp32 accumulation, bounded by the dense
//    bf16 tensor-core rate (989 TFLOP/s); warp-level mma.sync reaches only
//    part of it (wgmma is the way to the rest).
//  * fp32: 3xTF32 on m16n8k8 TF32 MMAs. Each fp32 operand x is split into
//    big = rna_tf32(x) and small = x - big in TF32, and each product
//    accumulates small*big + big*small, then big*big (CUTLASS's
//    OpMultiplyAddFastF32): fp32-level accuracy, which single-pass TF32
//    does not give. Three MMAs per product, so the bound is 3x the flops at
//    the TF32 rate (495 TFLOP/s), below the fp32 CUDA-core bound (67). The
//    splits are CUDA-core instructions beside the MMAs, three per operand
//    and made by every warp that reads it; on the card the kernel's time
//    follows their count.
//
// What the design does about it (FlashAttention-2's shape):
//  * One block of 4 warps per (query tile, b*h). Each warp owns 16*MT query
//    rows (fp32: 64-row tiles, MT = 1; bf16: 128-row tiles, MT = 2, or
//    64 rows where Dv > 128) and keeps its S tile, P, the running max and
//    sum of its rows and its slice of the O accumulator in registers. P
//    goes from the score MMA's C fragments straight into the A fragments of
//    the P V MMA: no shared memory and no block barrier between the two
//    products.
//      bf16: the C fragments of two n8 score tiles are the A fragment of one
//      m16n8k16 product once packed to bf16 (P is rounded to bf16 there).
//      fp32: the C fragment of an n8 tile holds keys (2t, 2t+1) of rows g
//      and g+8 (g = lane/4, t = lane%4); the m16n8k8 A fragment wants
//      columns t and t+4. The kernel permutes the 8 keys of the k dimension
//      instead of the data: a = (c0, c2, c1, c3), and V's B fragment is
//      read from key rows 2t and 2t+1. The sum over keys does not depend
//      on their order.
//  * fp32: the small terms of the scores go to an accumulator of their own,
//    so each score tile has two short MMA chains instead of one long one;
//    the MMA asm is not volatile, so the compiler interleaves independent
//    products.
//  * fp32: the tensor cores round their fp32 accumulation toward zero, not
//    to nearest. O sums over every key of the row, so it is never an MMA
//    accumulator: each key tile's P V goes into a fragment zeroed for the
//    tile, and the CUDA cores fold that into O with one IEEE fmaf per
//    element, o = o * corr + frag, which is also the online softmax's
//    rescale. The error then stays flat in the row length instead of
//    growing with the 1536 roundings of a 4096-key row (bf16 keeps its
//    accumulator: P is rounded to bf16 there anyway).
//  * Q and K fragments come from shared memory through ldmatrix (for fp32,
//    each 32-bit element is a pair of b16 in ldmatrix's view, which gives
//    the TF32 fragment layouts), V through ldmatrix.trans (bf16) or 32-bit
//    loads (fp32). Row strides are 16 bytes times an odd number, so the 8
//    rows one ldmatrix matrix reads, and the 32 lanes of an fp32 V read,
//    fall in distinct banks.
//  * K and V tiles are copied with cp.async, 16 bytes a thread where the
//    operands allow it (element-wise loads otherwise), into a ring of 2 or
//    3 shared-memory stages sized from the device (the most blocks per SM,
//    then the most stages): the products on tile j run while tile j+1
//    loads, with one block barrier per key tile. At Dh = Dv = 128 that is
//    99-102 KB per block, two blocks per SM.
//  * Key tiles that can hold no admissible key are never visited (the loop
//    runs over the tiles that meet the causal / window band of the query
//    tile), the mask is applied only on tiles that straddle the band or
//    the ragged key tail, and the heaviest query tiles launch first.
//  * Query head h reads KV head h / (H / KV), with no repeated copy of K and
//    V; operands are addressed through element strides for batch, sequence
//    and head, so the (B, S, H, D) and (B, H, S, D) layouts both launch as
//    they are. Only the last dim must be contiguous.
//  * No padding in device memory: ragged query and key tails and head dims
//    that are not a multiple of the MMA's k are zero-filled in shared
//    memory (cp.async's src-size), Dh and Dv anywhere in 1..256.
//  * Softmax in fp32 in log2 units with the accurate exp2f (not the
//    approximate __expf). Masked scores are -inf; a row whose running max
//    is still -inf uses 0 in its place, so exp never sees (-inf) - (-inf).
//    A row that no key may see (possible only with a window and
//    Sq > Sk + window - 1) is written as 0.
//  * Training (the fp32 instance only, a template flag, so the serving
//    instances compile as before): given a non-null `lse`, the kernel also
//    writes each row's log-sum-exp L = m + log(l) of the scaled scores, in
//    natural-log units, fp32 (B, H, Sq) contiguous, +inf for a row that no
//    key may see. The backward kernel (csrc/flash_attention_bwd.cu)
//    recomputes P = exp(S scale - L) from it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;              // warps per block
constexpr int NT = 32 * NW;        // threads per block
constexpr int MAX_HEAD_DIM = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                      // (B, H, Sq) or null (the LSE instances)
  int64_t q_sb, q_ss, q_sh;        // element strides of q: batch, seq, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, group, Sq, Sk, Dh, Dv, causal, window;
  float scale;
  int vec16;                       // q, k, v rows start 16-byte aligned
  int stages;                      // K/V ring depth, 2 or 3 (the plan's)
};

// Bytes of a staged row that the fragments read: the head dim rounded up to
// 32 bytes (one k step of either MMA, or two n8 tiles of bf16 V).
__host__ __device__ __forceinline__ int fill_bytes(int d, int elem) {
  return (d * elem + 31) / 32 * 32;
}
// Row stride in shared memory: 16 bytes times an odd number.
__host__ __device__ __forceinline__ int row_stride(int d, int elem) {
  return fill_bytes(d, elem) + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most stages - 2 groups are pending
__device__ __forceinline__ void cp_async_wait(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// (not volatile: independent MMAs may be interleaved by the compiler)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, each TF32. big is cvt.rna.tf32.f32(x), rounded to
// nearest with ties away from zero (half an ulp added to the magnitude, the
// low 13 bits cleared: two integer instructions, where the cvt costs more).
// small is x - big truncated to TF32 (one instruction): its error, 2^-21 of
// |x| at most, stays far below fp32 tolerances, and a NaN x, which the
// rounding of big may carry into the sign bit, stays NaN in small.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Raw Q and K fragments of k chunk kc (32 bytes of the head dim: one k16
// step of bf16, one k8 step of fp32; for fp32 each 32-bit element is a pair
// of b16 in ldmatrix's view, which gives the TF32 fragment layouts). a[mt]
// is the A fragment of m16 tile mt; b[jj] holds the B fragments (b0, b1)
// of n8 key tiles 2 jj and 2 jj + 1.
template <int MT, int NS>
__device__ __forceinline__ void load_qk(uint32_t (&a)[MT][4],
                                        uint32_t (&b)[NS / 2][4],
                                        uint32_t q_addr, uint32_t k_addr,
                                        int qst, int kc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldsm_x4(a[mt], q_addr + mt * 16 * qst + kc * 32);
#pragma unroll
  for (int jj = 0; jj < NS / 2; ++jj)
    ldsm_x4(b[jj], k_addr + jj * 16 * qst + kc * 32);
}

// The MMA policies: S = Q K^T over the staged key tile (`scores`) and
// O += P V from the registers (`pv`).
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int BK = 64;    // keys per staged tile
  template <int MT, int NS>
  static __device__ __forceinline__ void scores(float (&s)[MT][NS][4],
                                                uint32_t q_addr,
                                                uint32_t k_addr, int qst,
                                                int kchunks) {
#pragma unroll 2
    for (int kc = 0; kc < kchunks; ++kc) {
      uint32_t a[MT][4], b[NS / 2][4];
      load_qk<MT, NS>(a, b, q_addr, k_addr, qst, kc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          mma_bf16(s[mt][2 * jj], a[mt], b[jj][0], b[jj][1]);
          mma_bf16(s[mt][2 * jj + 1], a[mt], b[jj][2], b[jj][3]);
        }
    }
  }
  // the C fragments of n8 tiles 2 kk and 2 kk + 1, packed to bf16 pairs,
  // are the A fragment of k16 step kk; V's B fragments by ldmatrix.trans.
  // O accumulates in the MMAs across key tiles (P is rounded to bf16, so
  // the sums' rounding is far below the instance's tolerance); the kernel
  // rescales it by corr before each tile.
  static constexpr bool FOLDS = false;
  template <int MT, int NS, int NV>
  static __device__ __forceinline__ void pv(float (&o)[MT][NV][4],
                                            const float (&s)[MT][NS][4],
                                            const float (&)[MT][2],
                                            const unsigned char* vs, int vst,
                                            int lane, int dv) {
    const uint32_t base = smem_u32(vs) + (lane & 15) * vst + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        if (16 * np >= dv) break;
        uint32_t b[4];
        ldsm_x4_trans(b, base + kk * 16 * vst + np * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(o[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
};

struct Tf32x3 {
  using T = float;
  static constexpr int BK = 32;
  // the small terms go to an accumulator of their own, added at the end:
  // two independent MMA chains per score tile instead of one of three
  template <int MT, int NS>
  static __device__ __forceinline__ void scores(float (&s)[MT][NS][4],
                                                uint32_t q_addr,
                                                uint32_t k_addr, int qst,
                                                int kchunks) {
    float lo[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) lo[mt][j][u] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < kchunks; ++kc) {
      uint32_t a[MT][4], b[NS / 2][4];
      load_qk<MT, NS>(a, b, q_addr, k_addr, qst, kc);
      uint32_t ab[MT][4], as[MT][4], bb[NS / 2][4], bs[NS / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          split_tf32(__uint_as_float(a[mt][u]), ab[mt][u], as[mt][u]);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          split_tf32(__uint_as_float(b[jj][u]), bb[jj][u], bs[jj][u]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          mma_tf32(lo[mt][2 * jj], as[mt], bb[jj][0], bb[jj][1]);
          mma_tf32(lo[mt][2 * jj + 1], as[mt], bb[jj][2], bb[jj][3]);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          mma_tf32(lo[mt][2 * jj], ab[mt], bs[jj][0], bs[jj][1]);
          mma_tf32(lo[mt][2 * jj + 1], ab[mt], bs[jj][2], bs[jj][3]);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          mma_tf32(s[mt][2 * jj], ab[mt], bb[jj][0], bb[jj][1]);
          mma_tf32(s[mt][2 * jj + 1], ab[mt], bb[jj][2], bb[jj][3]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[mt][j][u] += lo[mt][j][u];
  }
  // n8 tile j of P is k8 step j with its keys in the order (0, 2, 4, 6 |
  // 1, 3, 5, 7): a = (c0, c2, c1, c3), and V's B fragment is (V[2t][g],
  // V[2t + 1][g]). The tensor cores round each fp32 sum toward zero, so an
  // accumulator that lived across key tiles would drift toward zero by up
  // to an ulp of O per MMA (three per k8 step: 1536 over 4096 keys). No MMA
  // accumulator outlives the key tile: P is split once for all NS steps;
  // each group of four n8 output tiles takes the tile's MMAs (twelve per
  // output tile, small terms first in each k8 step) into a zeroed
  // fragment, which the CUDA cores fold into O in IEEE fp32 with the row's
  // rescale: o = o * corr + frag.
  static constexpr bool FOLDS = true;
  template <int MT, int NS, int NV>
  static __device__ __forceinline__ void pv(float (&o)[MT][NV][4],
                                            const float (&s)[MT][NS][4],
                                            const float (&corr)[MT][2],
                                            const unsigned char* vs, int vst,
                                            int lane, int dv) {
    const int g = lane >> 2, t = lane & 3;
    const int vw = vst / 4;
    const float* v0 = reinterpret_cast<const float*>(vs) + 2 * t * vw + g;
    uint32_t ab[MT][NS][4], as[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        split_tf32(s[mt][j][0], ab[mt][j][0], as[mt][j][0]);
        split_tf32(s[mt][j][2], ab[mt][j][1], as[mt][j][1]);
        split_tf32(s[mt][j][1], ab[mt][j][2], as[mt][j][2]);
        split_tf32(s[mt][j][3], ab[mt][j][3], as[mt][j][3]);
      }
#pragma unroll
    for (int n0 = 0; n0 < NV; n0 += 4) {
      if (8 * n0 >= dv) break;
      float f[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[mt][u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float* vj = v0 + 8 * j * vw;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool on = 8 * (n0 + u) < dv;
          split_tf32(on ? vj[8 * (n0 + u)] : 0.f, bb[u][0], bs[u][0]);
          split_tf32(on ? vj[vw + 8 * (n0 + u)] : 0.f, bb[u][1], bs[u][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32(f[mt][u], as[mt][j], bb[u][0], bb[u][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32(f[mt][u], ab[mt][j], bs[u][0], bs[u][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32(f[mt][u], ab[mt][j], bb[u][0], bb[u][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[mt][n0 + u][e] =
                fmaf(o[mt][n0 + u][e], corr[mt][e >> 1], f[mt][u][e]);
    }
  }
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Stage `rows` rows (row0 + r, r < rows; rows at or past `limit` are zero)
// of `d` elements into shared memory at `dst` (row stride `dst_stride`
// bytes), zero-filled up to fill_bytes(d). cp.async 16 bytes at a time when
// the rows start 16-byte aligned, else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_stride,
                                           const T* src, int64_t row_stride,
                                           int row0, int limit, int rows,
                                           int d, bool vec16, int tid) {
  constexpr int E = sizeof(T);
  const int fill = fill_bytes(d, E);
  if (vec16) {
    const int chunks = fill / 16;
    const int valid = d * E;
    for (int c = tid; c < rows * chunks; c += NT) {
      const int r = c / chunks;
      const int off = (c - r * chunks) * 16;
      const int row = row0 + r;
      const int n = row < limit ? min(max(valid - off, 0), 16) : 0;
      const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
      if (n > 0) s += ((int64_t)row * row_stride) * E + off;
      cp_async16(smem_u32(dst + r * dst_stride + off), s, n);
    }
  } else {
    const int per_row = fill / E;
    for (int e = tid; e < rows * per_row; e += NT) {
      const int r = e / per_row;
      const int c = e - r * per_row;
      const int row = row0 + r;
      *reinterpret_cast<T*>(dst + r * dst_stride + c * E) =
          (row < limit && c < d) ? src[(int64_t)row * row_stride + c]
                                 : zero<T>();
    }
  }
}

// MT: m16 tiles of query rows per warp; NJ: 64-wide groups of output
// columns (Dv <= 64 NJ); LSE: also write the rows' log-sum-exp.
template <class P, int MT, int NJ, bool LSE>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const Params p) {
  using T = typename P::T;
  constexpr int E = sizeof(T);
  constexpr int BQ = 16 * MT * NW;   // query rows per block
  constexpr int BK = P::BK;          // keys per staged tile
  constexpr int NS = BK / 8;         // n8 score tiles per key tile
  constexpr int NV = 8 * NJ;         // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int qst = row_stride(p.Dh, E), vst = row_stride(p.Dv, E);
  const int stage_bytes = BK * (qst + vst);
  unsigned char* const qs = smem;
  unsigned char* const ring = smem + BQ * qst;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int q0 = qt * BQ;
  const bool vec16 = p.vec16 != 0;
  const int stages = p.stages;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the band of keys this query tile can see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int t_begin = k_begin / BK;
  const int ntiles =
      k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  auto stage_kv = [&](int i) {       // key tile t_begin + i into its slot
    unsigned char* ks = ring + (i % stages) * stage_bytes;
    const int k0 = (t_begin + i) * BK;
    stage_rows<T>(ks, qst, kb, p.k_ss, k0, p.Sk, BK, p.Dh, vec16, tid);
    stage_rows<T>(ks + BK * qst, vst, vb, p.v_ss, k0, p.Sk, BK, p.Dv, vec16,
                  tid);
  };
  if (ntiles > 0) {
    stage_rows<T>(qs, qst, qb, p.q_ss, q0, p.Sq, BQ, p.Dh, vec16, tid);
    for (int i = 0; i < stages - 1; ++i) {
      if (i < ntiles) stage_kv(i);
      cp_async_commit();
    }
  }

  const int row0 = warp * 16 * MT;   // this warp's first row in the tile
  // scores and the running max in log2 units: p = exp2(x - m)
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int kchunks = fill_bytes(p.Dh, E) / 32;
  float o[MT][NV][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[mt][n][u] = 0.f;
  }
  // ldmatrix row addresses: Q rows row0 + (lane & 15), 16-byte half
  // lane >> 4; K rows ((lane >> 4) << 3) + (lane & 7), half (lane >> 3) & 1
  const uint32_t q_addr =
      smem_u32(qs) + (row0 + (lane & 15)) * qst + (lane >> 4) * 16;
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * qst +
                    ((lane >> 3) & 1) * 16;

  for (int i = 0; i < ntiles; ++i) {
    const int k0 = (t_begin + i) * BK;
    cp_async_wait(stages);
    __syncthreads();   // tile i has landed; tile i - 1's slot is free
    if (i + stages - 1 < ntiles) stage_kv(i + stages - 1);
    cp_async_commit();
    const unsigned char* ks = ring + (i % stages) * stage_bytes;
    const uint32_t k_addr = smem_u32(ks) + k_off;

    // S = Q K^T for this warp's rows and the tile's BK keys
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[mt][j][u] = 0.f;
    P::template scores<MT, NS>(s, q_addr, k_addr, qst, kchunks);

    // mask where the tile straddles the band or the key tail, then the
    // online-softmax update of each row (rows g and g + 8 of each m16 tile;
    // the 4 lanes of a row are t = 0..3)
    float cr[MT][2];                   // each row's rescale of O
    const bool full = k0 + BK <= p.Sk &&
                      (!p.causal || k0 + BK - 1 <= q0) &&
                      (p.window == 0 || k0 > q_last - p.window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = q0 + row0 + mt * 16 + g + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[mt][j][2 * r + e] * scale_log2;
            if (!full) {
              const int kc = k0 + 8 * j + 2 * t + e;
              bool ok = kc < p.Sk;
              if (p.causal) ok = ok && kc <= qr;
              if (p.window > 0) ok = ok && kc > qr - p.window;
              x = ok ? x : -INFINITY;
            }
            s[mt][j][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[mt][r] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pr = exp2f(s[mt][j][2 * r + e] - m_use);
            s[mt][j][2 * r + e] = pr;
            sum += pr;
          }
        l[mt][r] = l[mt][r] * corr + sum;   // this lane's share of the row
        m[mt][r] = m_new;
        cr[mt][r] = corr;
      }
    if (!P::FOLDS) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int u = 0; u < 4; ++u) o[mt][n][u] *= cr[mt][u >> 1];
    }

    // O = O corr + P V, P from the registers (the policy folds or rescales)
    P::template pv<MT, NS, NV>(o, s, cr, ks + BK * qst, vst, lane, p.Dv);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int qr = q0 + row0 + mt * 16 + g + 8 * r;
      if (qr >= p.Sq) continue;
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      if (LSE && t == 0)     // m in log2 units of the scaled scores
        p.lse[((int64_t)b * p.H + h) * p.Sq + qr] =
            sum > 0.f ? (m[mt][r] + log2f(sum)) * 0.6931471805599453f
                      : INFINITY;
      T* orow = ob + (int64_t)qr * p.o_ss;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < p.Dv) store(orow + c, o[mt][n][2 * r] * inv);
        if (c + 1 < p.Dv) store(orow + c + 1, o[mt][n][2 * r + 1] * inv);
      }
    }
}

// Tile sizes, ring depth and shared memory of one launch, from the device:
// the most blocks per SM (occupancy API), then the most stages (2 or 3).
struct Plan {
  int bq, bk, stages, smem, blocks_per_sm;
};

template <class P, int MT, int NJ, bool LSE>
cudaError_t plan(int Dh, int Dv, Plan* out) {
  constexpr int E = sizeof(typename P::T);
  const int bq = 16 * MT * NW, bk = P::BK;
  const int qst = row_stride(Dh, E), vst = row_stride(Dv, E);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  Plan best{bq, bk, 0, 0, 0};
  for (int stages = 2; stages <= 3; ++stages) {
    const int smem = bq * qst + stages * bk * (qst + vst);
    if (smem > optin) break;
    err = cudaFuncSetAttribute(flash_attention_kernel<P, MT, NJ, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_attention_kernel<P, MT, NJ, LSE>, NT, smem);
    if (err != cudaSuccess) return err;
    if (blocks > 0 && blocks >= best.blocks_per_sm)
      best = Plan{bq, bk, stages, smem, blocks};
  }
  if (best.stages == 0) return cudaErrorInvalidValue;
  *out = best;
  return cudaFuncSetAttribute(flash_attention_kernel<P, MT, NJ, LSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              best.smem);
}

template <class P, int MT, int NJ, bool LSE = false>
int run(Params p, int B, cudaStream_t stream, Plan* plan_only) {
  Plan pl;
  cudaError_t err = plan<P, MT, NJ, LSE>(p.Dh, p.Dv, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan_only) {
    *plan_only = pl;
    return 0;
  }
  p.stages = pl.stages;
  const dim3 grid((p.Sq + pl.bq - 1) / pl.bq, B * p.H);
  flash_attention_kernel<P, MT, NJ, LSE><<<grid, NT, pl.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16: 128-row query tiles (MT = 2) up to Dv = 128, 64 rows past it (the
// accumulator would not fit the registers); fp32: 64-row tiles. The LSE
// instances are fp32's only.
int dispatch(const Params& p, int B, int dtype, cudaStream_t stream,
             Plan* plan_only) {
  const int nj = (p.Dv + 63) / 64;
  if (dtype == 0 && p.lse) {
    switch (nj) {
      case 1: return run<Tf32x3, 1, 1, true>(p, B, stream, plan_only);
      case 2: return run<Tf32x3, 1, 2, true>(p, B, stream, plan_only);
      case 3: return run<Tf32x3, 1, 3, true>(p, B, stream, plan_only);
      case 4: return run<Tf32x3, 1, 4, true>(p, B, stream, plan_only);
    }
  } else if (dtype == 0) {
    switch (nj) {
      case 1: return run<Tf32x3, 1, 1>(p, B, stream, plan_only);
      case 2: return run<Tf32x3, 1, 2>(p, B, stream, plan_only);
      case 3: return run<Tf32x3, 1, 3>(p, B, stream, plan_only);
      case 4: return run<Tf32x3, 1, 4>(p, B, stream, plan_only);
    }
  } else if (dtype == 1) {
    switch (nj) {
      case 1: return run<Bf16, 2, 1>(p, B, stream, plan_only);
      case 2: return run<Bf16, 2, 2>(p, B, stream, plan_only);
      case 3: return run<Bf16, 1, 3>(p, B, stream, plan_only);
      case 4: return run<Bf16, 1, 4>(p, B, stream, plan_only);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* ptr, const int64_t* strides, int n, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if ((strides[i] * elem) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, Dh) by its strides, k (B, Sk, KV, Dh), v (B, Sk, KV, Dv),
// out (B, Sq, H, Dv); strides in elements for batch, sequence and head, the
// last dim contiguous. dtype 0 = fp32, 1 = bf16 (all four tensors alike).
// Query head h reads KV head h / (H / KV). window 0 = no window. lse, null
// or fp32 (B, H, Sq) contiguous, takes each row's log-sum-exp (dtype 0
// only). Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, const int64_t* strides, int B, int H,
                        int KV, int Sq, int Sk, int Dh, int Dv, int causal,
                        int window, float scale, int dtype, float* lse,
                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Dh <= 0 || Dh > MAX_HEAD_DIM || Dv <= 0 ||
      Dv > MAX_HEAD_DIM || Sk < 0 || window < 0 ||
      (int64_t)B * H > 65535 || (dtype != 0 && dtype != 1) ||
      (lse && dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.H = H; p.group = H / KV; p.Sq = Sq; p.Sk = Sk; p.Dh = Dh; p.Dv = Dv;
  p.causal = causal; p.window = window; p.scale = scale;
  p.vec16 = aligned16(q, strides, 3, elem) &&
            aligned16(k, strides + 3, 3, elem) &&
            aligned16(v, strides + 6, 3, elem);
  return dispatch(p, B, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch plan of flash_attention_fwd for (Dh, Dv, dtype) on the current
// device: out = {query rows per block, keys per staged tile, K/V stages,
// dynamic shared memory bytes, blocks per SM}. Returns a CUDA error code.
int flash_attention_plan(int Dh, int Dv, int dtype, int* out) {
  if (Dh <= 0 || Dh > MAX_HEAD_DIM || Dv <= 0 || Dv > MAX_HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.Dh = Dh; p.Dv = Dv;   // lse null: the serving instances' plan
  Plan pl;
  const int code = dispatch(p, 1, dtype, nullptr, &pl);
  if (code == 0) {
    out[0] = pl.bq; out[1] = pl.bk; out[2] = pl.stages; out[3] = pl.smem;
    out[4] = pl.blocks_per_sm;
  }
  return code;
}

}  // extern "C"
