// Flash-attention backward (K7): dQ, dK and dV of softmax(Q K^T scale + mask) V
// with causal and sliding-window masks and grouped-query heads, in fp32; q
// and k of head dim Dh, v, O and dO of head dim Dv (MLA's Dh != Dv).
//
// Replaces no Pallas kernel: the reference trains through its pure-jnp
// blockwise_attention (src/repro/models/attention.py:26) and lets
// jax.value_and_grad differentiate it inside XLA (src/repro/train/
// steps.py:38, :51, :95). The port's training forward runs K4
// (csrc/flash_attention.cu), a ctypes launch autograd cannot see into, so
// the backward of K4 is this kernel.
//
// What bounds it on an H100: operations. Per admissible (query, key) pair
// the backward's products (S and dP recomputed, dV, dK, dQ) cost 6 Dh +
// 4 Dv flops against operands read a few times, hundreds of flops per byte
// at Dh = Dv = 128. They run as 3xTF32 on m16n8k8 TF32 MMAs (mma.sync), as
// K4's fp32 instance does: each fp32 operand x is split into big and small
// TF32 halves, and each product accumulates small*big + big*small, then
// big*big: fp32-level accuracy at 3x the flops on the TF32 tensor cores
// (494.7 TFLOP/s), below the fp32 CUDA-core bound (67). S and dP are
// recomputed in both passes below, so the kernel does 10 Dh + 8 Dv flops a
// pair where 6 Dh + 4 Dv are needed; a single pass would have to sum dQ
// across key tiles in a fixed order.
//
// Design (FlashAttention-2's backward, without atomics):
//  (a) delta_i = rowsum(dO_i * O_i) over Dv: one warp per query row.
//  (b) dK, dV: one block per (key tile, b, KV head, column block). The
//      block's key rows are its stationary rows; it streams the query
//      tiles that the mask admits, of every query head of its GQA group.
//      Each dK and dV tile is written once: the group is summed inside
//      the block.
//  (c) dQ: one block per (query tile, b, q head, column block), streaming
//      the admitted key tiles; the heaviest query tiles launch first.
// Both passes are one kernel template. Warps form an RW x CW grid: warp
// (rw, cw) owns stationary rows 16 rw .. 16 rw + 15 and streamed rows
// 8 NS cw .. 8 NS cw + 8 NS - 1 of each step's tile. It computes its
// scores X = A1 B1^T (S^T in (b), S in (c)) over Dh and Y = A2 B2^T (dP^T,
// dP) over Dv in registers, turns them into P and dS = P (dP - delta)
// scale in place, and accumulates dV += P dO and dK += dS Q (b), or dQ +=
// dS K (c), for its 16 rows and the block's columns. P and dS never leave
// the registers: the m16n8 C fragment of n8 tile j holds streamed columns
// (2t, 2t+1) of rows g and g+8 (g = lane/4, t = lane%4); the m16n8k8 A
// fragment wants columns t and t+4. The kernel permutes the 8 streamed
// rows of the k dimension instead of the data: a = (c0, c2, c1, c3), and
// the B fragment is read from streamed rows 2t and 2t+1. The CW warps of a
// row group sum their partial accumulators through shared memory in a
// fixed order at the end, so the result has the same bits from run to run
// (nothing is summed across blocks).
// Accumulation: the tensor cores add fp32 products into their accumulator
// with truncation, so a sum carried in an MMA accumulator across the
// hundreds of streamed steps of a long row drifts toward zero with the row
// count (dV by 4.4e-5 of its mean at 4096 rows where values share a sign,
// as K4's O did). Each step's product therefore gathers the warp's 8 NS
// streamed rows in a fragment zeroed for that step, and the CUDA cores add
// the fragment to the accumulator in IEEE fp32: no MMA accumulator lives
// across streamed tiles. The n8 tiles of a product go in chunks, k steps
// outer, so that several independent MMA chains interleave (one chain a
// tile left the tensor cores waiting on each MMA's result). dP = dO V^T
// is folded the same way, each k8 step of Dv: dS = P (dP - delta) cancels
// most of dP where values share a sign, and a chain of 3 Dv / 8
// truncating MMAs left dQ's error at 8192 rows 4x its 1024-row value
// (PERF.md, K7's findings; +6 % time). S = A1 B1^T stays one chain:
// folding it too cut the flat mean errors a further 2.7x for another 5 %.
// Two widths: WH, Dh rounded to 64, 128 or 256, for Q and K, and WV, Dv
// rounded, for V and dO; each operand is staged at its own width and row
// stride. X runs over WH and Y over WV: one loop over the first WV columns
// forms both, a second over the rest of WH forms X alone (staging V and dO
// at Q's width instead would cost shared memory and MMAs on zeros).
// Instances: WH = WV (64, 128, 256), and (128, 64) and (256, 128), the MLA
// models' widths; Dh < Dv has none.
// Staging: the stationary rows (K, V in (b); Q, dO in (c)) arrive once by
// cp.async; the streamed tiles (Q, dO in (b); K, V in (c)) by cp.async (16
// bytes a copy where every row starts 16-byte aligned, 4 bytes otherwise)
// into a ring of two buffers, tile i + 1 loading while tile i computes,
// with one block barrier a step. L and delta of the streamed query rows
// ride along by 4-byte cp.async. Tiles stay raw fp32 in shared memory and
// each fragment is split as it is loaded, in two instructions: big = x
// with its low 13 bits cleared, small = x - big (exact; the MMA reads its
// top 19 bits). Splitting once per staged tile into big and small copies
// in shared memory was slower on the card (PERF.md, K7's findings): it
// doubles the shared-memory bytes each MMA reads, and those bytes, not the
// two-instruction splits, bound a 16-row warp tile. The score products'
// fragments come through ldmatrix (each 32-bit element a pair of b16,
// which gives the TF32 fragment layouts). Row stride width + 4 floats: 16
// bytes times an odd number, so the 8 rows of an ldmatrix matrix and the
// 32 lanes of the other fragment loads fall in distinct banks. Rows past
// the sequence and columns past Dh or Dv are zero in shared memory, so
// every product runs over the whole width with no branch in its loops (a
// branch per n8 tile made the kernel 15 % slower on the card). A query row
// that no key may see has L = +inf (K4 writes it so), hence P = 0 and zero
// gradients.
// The plan (rows per block, warps, rows a step) comes from the caller,
// which sizes it from the card's SM count and shared memory
// (kernels/flash_attention/flash_attention_bwd.py::attention_bwd_plan); at
// WH = 256 the grid's z splits each output in two: a block accumulates 128
// columns of dK (or dQ) and WV / 2 of dV, so both blocks of a key tile do
// the same work, with S and dP recomputed for each.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;   // an H100 block's opt-in maximum
constexpr uint32_t TF32 = 0xffffe000u;   // the bits of a TF32 value
// n8 tiles whose MMA chains interleave in the dK, dV and dQ products (in
// these chunks ptxas fits every instance in 255 registers with no spill;
// eight and eight spilled 8 bytes in the (4, 2, 4) dK/dV instance at width
// 128, and were 1 % faster)
constexpr int DK_TILES = 4, DV_TILES = 16, DQ_TILES = 8;

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
  int H, KV, group, Sq, Sk, Dh, Dv, causal, window, vec16;
  float scale;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

// The geometry of one instance: WH the width of Q and K, WV of V and dO,
// RW x CW warps, NS n8 tiles of streamed rows per warp and step; KVP the
// dK/dV pass.
template <int WH, int WV, int RW, int CW, int NS, bool KVP>
struct Geo {
  static_assert(WH >= WV, "no instance with Dv wider than Dh");
  static constexpr int NT = 32 * RW * CW;       // threads
  static constexpr int STH = WH + 4;            // row stride of Q, K, floats
  static constexpr int STV = WV + 4;            // row stride of V, dO
  static constexpr int BR = 16 * RW;            // stationary rows
  static constexpr int BC = 8 * NS * CW;        // streamed rows a step
  static constexpr int Z = WH > 128 ? 2 : 1;    // column blocks (grid z)
  static constexpr int NH = WH / Z / 8;         // n8 tiles of dK or dQ
  static constexpr int NV = KVP ? WV / Z / 8 : 0;   // n8 tiles of dV
  static constexpr int NA = NV + NH;            // accumulator tiles
  static constexpr int TILE = BC * (STH + STV); // a streamed step, floats
  static constexpr int LD = KVP ? 4 * BC : 2 * BR;   // L and delta
  static constexpr int FLOATS = BR * (STH + STV) + 2 * TILE + LD;
  static constexpr int SMEM = 4 * FLOATS;
  static constexpr int REDUCE = (CW - 1) * RW * NA * 128;
  static_assert(NS >= 1 && REDUCE <= FLOATS, "bad instance");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// (not volatile: independent MMAs may be interleaved by the compiler)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big = x with its low 13 bits cleared (TF32), small =
// x - big, exact in fp32; the MMA reads small's top 19 bits. Two
// instructions (rounding big to nearest instead cost the card 8 % and
// moved no error: the error is fp32's, of sums over thousands of rows).
__device__ __forceinline__ void split(uint32_t x, uint32_t& big,
                                      uint32_t& small) {
  big = x & TF32;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}
// an A fragment's halves, made once and reused across the n8 tiles
__device__ __forceinline__ void split4(const uint32_t a[4], uint32_t ab[4],
                                       uint32_t as[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split(a[u], ab[u], as[u]);
}
// c += a b as 3xTF32 from split A and B fragments (b: big b0, b1, small
// b0, b1): a_small b_big + a_big b_small, then a_big b_big
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4],
                                     const uint32_t b[4]) {
  mma_tf32(c, as, b[0], b[1]);
  mma_tf32(c, ab, b[2], b[3]);
  mma_tf32(c, ab, b[0], b[1]);
}
// the halves of a B fragment (b0, b1) for mma3
__device__ __forceinline__ void split_b(uint32_t b0, uint32_t b1,
                                        uint32_t b[4]) {
  split(b0, b[0], b[2]);
  split(b1, b[1], b[3]);
}

// the block's index along x, y or z, read anew (not kept live in a
// register across the streamed loop)
__device__ __forceinline__ int ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int ctaid_z() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(v));
  return v;
}

__device__ __forceinline__ bool admitted(const Params& p, int qi, int kj) {
  bool ok = qi < p.Sq && kj < p.Sk;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// Copy rows [row0, row0 + rows) of one head (`src` at its batch and head,
// `rs` its row stride) into `dst` (stride ST floats) by cp.async, W
// columns a row: zero past `limit` and past D.
template <int NT, int W, int ST>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t rs, int row0, int rows,
                                      int limit, int D, bool vec16) {
  if (vec16) {
    constexpr int chunks = W / 4;
    for (int c = threadIdx.x; c < rows * chunks; c += NT) {
      const int r = c / chunks, off = (c - r * chunks) * 4;
      const int row = row0 + r;
      const int n = row < limit ? min(max(D - off, 0), 4) * 4 : 0;
      cp_async16(smem_u32(dst + r * ST + off),
                 n > 0 ? src + (int64_t)row * rs + off : src, n);
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += NT) {
      const int r = e / W, c = e - r * W;
      const int row = row0 + r;
      const bool ok = row < limit && c < D;
      cp_async4(smem_u32(dst + r * ST + c),
                ok ? src + (int64_t)row * rs + c : src, ok ? 4 : 0);
    }
  }
}

// `n` floats of a (B, H, Sq) row at `src` + row0 into `dst` by 4-byte
// cp.async, zero past `limit`
template <int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int row0, int n, int limit) {
  for (int r = threadIdx.x; r < n; r += NT) {
    const bool ok = row0 + r < limit;
    cp_async4(smem_u32(dst + r), ok ? src + row0 + r : src, ok ? 4 : 0);
  }
}

// (a): delta = rowsum(dO * O) over Dv, one warp per row; grid (ceil(Sq /
// 8), B H)
__global__ void __launch_bounds__(256) delta_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  if (row >= p.Sq) return;
  const float* o = p.o + b * p.s[O][0] + (int64_t)row * p.s[O][1] +
                   h * p.s[O][2];
  const float* d = p.dout + b * p.s[DO][0] + (int64_t)row * p.s[DO][1] +
                   h * p.s[DO][2];
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32)
    acc = fmaf(__ldg(o + c), __ldg(d + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(int64_t)blockIdx.y * p.Sq + row] = acc;
}

// One k8 step (columns 8 kc .. 8 kc + 7) of the scores over the warp's NS
// n8 tiles of streamed rows: X += A1 B1^T and, with BOTH, Y += A2 B2^T.
// The a*/b* addresses are this lane's ldmatrix rows (bytes).
template <int NS, int STH, int STV, bool BOTH>
__device__ __forceinline__ void score_step(float (&x)[NS][4],
                                           float (&y)[NS][4],
                                           uint32_t a1_addr, uint32_t a2_addr,
                                           uint32_t b1_addr, uint32_t b2_addr,
                                           int kc) {
  uint32_t a1[4], a2[4], a1b[4], a1l[4], a2b[4], a2l[4];
  ldsm_x4(a1, a1_addr + kc * 32);
  if constexpr (BOTH) ldsm_x4(a2, a2_addr + kc * 32);
  split4(a1, a1b, a1l);
  if constexpr (BOTH) split4(a2, a2b, a2l);
#pragma unroll
  for (int jj = 0; jj < (NS + 1) / 2; ++jj) {
    // n8 tiles 2 jj and 2 jj + 1 (x4), or the last odd one (x2)
    const bool pair = 2 * jj + 1 < NS;
    uint32_t r1[4], r2[4];
    const uint32_t at1 = jj * 16 * STH * 4 + kc * 32;
    const uint32_t at2 = jj * 16 * STV * 4 + kc * 32;
    if (pair) {
      ldsm_x4(r1, b1_addr + at1);
      if constexpr (BOTH) ldsm_x4(r2, b2_addr + at2);
    } else {
      ldsm_x2(r1, b1_addr + at1);
      if constexpr (BOTH) ldsm_x2(r2, b2_addr + at2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !pair) break;
      uint32_t b1[4], b2[4];
      split_b(r1[2 * h], r1[2 * h + 1], b1);
      if constexpr (BOTH) split_b(r2[2 * h], r2[2 * h + 1], b2);
      mma3(x[2 * jj + h], a1b, a1l, b1);
      if constexpr (BOTH) mma3(y[2 * jj + h], a2b, a2l, b2);
    }
  }
}

// acc[n] += A B over one streamed step for the NN n8 tiles of output
// columns, A the C fragments `c` of the NS k steps (P or dS; k step j is
// streamed rows c0 + 8 j + (0, 2, 4, 6 | 1, 3, 5, 7)), B from `e0` (B's
// element at streamed row c0 + 2t, column cb + g; row stride ST). Each
// tile's three MMAs per k step chain over the NS k steps into a fragment
// zeroed here, which the CUDA cores then add to acc[n] in IEEE fp32. The
// tiles go in chunks of CH, k steps outer, so that CH independent MMA
// chains interleave; each k step's A fragment is split once a chunk.
template <int NS, int ST, int NN, int CHUNK>
__device__ __forceinline__ void fold_product(float (*acc)[4],
                                             const float (&c)[NS][4],
                                             const float* bs, int e0) {
  constexpr int CH = NN < CHUNK ? NN : CHUNK;
  static_assert(NN % CH == 0, "bad chunk");
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += CH) {
    float f[CH][4];
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) f[n][u] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const uint32_t a[4] = {
          __float_as_uint(c[j][0]), __float_as_uint(c[j][2]),
          __float_as_uint(c[j][1]), __float_as_uint(c[j][3])};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int n = 0; n < CH; ++n) {
        const int e = e0 + 8 * j * ST + 8 * (n0 + n);
        uint32_t b[4];
        split_b(__float_as_uint(bs[e]), __float_as_uint(bs[e + ST]), b);
        mma3(f[n], ab, as, b);
      }
    }
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[n0 + n][u] += f[n][u];
  }
}

// (b) with KVP, (c) without. grid (stationary tiles, B x heads, Z)
template <int WH, int WV, int RW, int CW, int NS, bool KVP>
__global__ void __launch_bounds__(32 * RW * CW, 1) bwd_kernel(const Params p) {
  using G = Geo<WH, WV, RW, CW, NS, KVP>;
  constexpr int NT = G::NT, STH = G::STH, STV = G::STV, BR = G::BR;
  constexpr int BC = G::BC, NH = G::NH, NV = G::NV, NA = G::NA;
  constexpr int TILE = G::TILE;
  extern __shared__ __align__(16) float smem[];
  float* const a1s = smem;                  // K (b) or Q (c), width WH
  float* const a2s = a1s + BR * STH;        // V (b) or dO (c), width WV
  float* const ring = a2s + BR * STV;       // [stage][B1 (WH), B2 (WV)]
  float* const lds = ring + 2 * TILE;       // L, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, cw = warp / RW;
  const int heads = KVP ? p.KV : p.H;
  const int b = blockIdx.y / heads, head = blockIdx.y % heads;
  const int tile = KVP ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int r0 = tile * BR;                 // first stationary row
  const int cbh = blockIdx.z * (WH / G::Z); // first column of dK or dQ
  const int kvh = KVP ? head : head / p.group;
  const bool vec16 = p.vec16 != 0;
  const int s_lim = KVP ? p.Sk : p.Sq;      // stationary rows' limit
  const int t_lim = KVP ? p.Sq : p.Sk;      // streamed rows' limit

  // operands: A1, A2 stationary; B1, B2 streamed; A1, B1 of width Dh
  constexpr int A1 = KVP ? K : Q, A2 = KVP ? V : DO;
  constexpr int B1 = KVP ? Q : K, B2 = KVP ? DO : V;
  const float* a1g = (KVP ? p.k : p.q) + b * p.s[A1][0] + head * p.s[A1][2];
  const float* a2g = (KVP ? p.v : p.dout) + b * p.s[A2][0] +
                     head * p.s[A2][2];
  const float* b1g = (KVP ? p.q : p.k) + b * p.s[B1][0];
  const float* b2g = (KVP ? p.dout : p.v) + b * p.s[B2][0];

  // the streamed steps the mask admits
  int t0, nq, nsteps;
  if (KVP) {   // query tiles that see keys r0 .. k_last, for each head
    const int k_last = min(r0 + BR, p.Sk) - 1;
    const int q_begin = p.causal ? r0 : 0;
    const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
    t0 = q_begin / BC;
    nq = q_end > q_begin ? (q_end + BC - 1) / BC - t0 : 0;
    nsteps = nq * p.group;
  } else {     // key tiles that rows r0 .. q_last see
    const int q_last = min(r0 + BR, p.Sq) - 1;
    const int k_begin = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
    const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
    t0 = k_begin / BC;
    nq = k_end > k_begin ? (k_end + BC - 1) / BC - t0 : 0;
    nsteps = nq;
  }
  // step i streams rows srow0(i) .. + BC of head shead(i)
  auto shead = [&](int i) { return KVP ? head * p.group + i / nq : kvh; };
  auto srow0 = [&](int i) { return (t0 + (KVP ? i % nq : i)) * BC; };
  auto stage_step = [&](int i) {
    float* dst = ring + (i & 1) * TILE;
    const int h = shead(i), row0 = srow0(i);
    stage<NT, WH, STH>(dst, b1g + h * p.s[B1][2], p.s[B1][1], row0, BC,
                       t_lim, p.Dh, vec16);
    stage<NT, WV, STV>(dst + BC * STH, b2g + h * p.s[B2][2], p.s[B2][1],
                       row0, BC, t_lim, p.Dv, vec16);
    if (KVP) {
      const int64_t at = ((int64_t)b * p.H + h) * p.Sq;
      float* l = lds + (i & 1) * 2 * BC;
      stage_vec<NT>(l, p.lse + at, row0, BC, p.Sq);
      stage_vec<NT>(l + BC, p.delta + at, row0, BC, p.Sq);
    }
  };

  // prologue: the stationary rows (and their L, delta in (c)), tile 0
  stage<NT, WH, STH>(a1s, a1g, p.s[A1][1], r0, BR, s_lim, p.Dh, vec16);
  stage<NT, WV, STV>(a2s, a2g, p.s[A2][1], r0, BR, s_lim, p.Dv, vec16);
  if (!KVP) {
    const int64_t at = ((int64_t)b * p.H + head) * p.Sq;
    stage_vec<NT>(lds, p.lse + at, r0, BR, p.Sq);
    stage_vec<NT>(lds + BR, p.delta + at, r0, BR, p.Sq);
  }
  if (nsteps > 0) stage_step(0);
  cp_async_commit();

  // tiles 0 .. NV - 1 accumulate dV, NV .. NA - 1 dK (b) or dQ (c)
  float acc[NA][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[a][u] = 0.f;

  const float sl = p.scale * LOG2E;
  const int c0 = cw * 8 * NS;               // the warp's streamed rows
  // ldmatrix row addresses (bytes): A rows 16 rw + (lane & 15), 16-byte
  // half lane >> 4; B rows c0 + ((lane >> 4) << 3) + (lane & 7), half
  // (lane >> 3) & 1, two n8 tiles a load
  // (the second operand's addresses are the first's plus terms that vanish
  // where Dh and Dv share a width, so that there they cost no register)
  const int a_row = rw * 16 + (lane & 15), b_row = c0 + ((lane >> 4) << 3) +
                                                   (lane & 7);
  const uint32_t a1_addr = smem_u32(a1s) + a_row * STH * 4 + (lane >> 4) * 16;
  const uint32_t a2_addr = a1_addr + BR * STH * 4 + a_row * (STV - STH) * 4;
  const int b_off = b_row * STH * 4 + ((lane >> 3) & 1) * 16;
  const int b2_off = BC * STH * 4 + b_row * (STV - STH) * 4;
  // the first element of the accumulation products' B fragments
  const int e1 = (c0 + 2 * t) * STH + cbh + g;
  const int e2 = e1 + (c0 + 2 * t) * (STV - STH) +
                 blockIdx.z * ((WV - WH) / G::Z);

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait_all();   // this thread's copies of tile i have landed
    __syncthreads();       // tile i visible; step i - 1's buffer free
    if (i + 1 < nsteps) stage_step(i + 1);
    cp_async_commit();
    const float* b1s = ring + (i & 1) * TILE;
    const float* b2s = b1s + BC * STH;
    const uint32_t b1_addr = smem_u32(b1s) + b_off;
    const uint32_t b2_addr = b1_addr + b2_off;
    const float* lq = KVP ? lds + (i & 1) * 2 * BC : lds;
    const float* dl = lq + (KVP ? BC : BR);
    const int row0 = srow0(i);

    // X = A1 B1^T over WH, Y = A2 B2^T over WV; each k8 step's Y products
    // chain in a fragment zeroed for that step, added to y in IEEE fp32
    float x[NS][4], y[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) x[j][u] = y[j][u] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < WV / 8; ++kc) {
      float fy[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) fy[j][u] = 0.f;
      score_step<NS, STH, STV, true>(x, fy, a1_addr, a2_addr, b1_addr,
                                     b2_addr, kc);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) y[j][u] += fy[j][u];
    }
#pragma unroll 2
    for (int kc = WV / 8; kc < WH / 8; ++kc)
      score_step<NS, STH, STV, false>(x, y, a1_addr, a2_addr, b1_addr,
                                      b2_addr, kc);

    // P = exp(S scale - L) where admitted, dS = P (dP - delta) scale
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rl = rw * 16 + g + 8 * (u >> 1);
        const int cl = c0 + 8 * j + 2 * t + (u & 1);
        const int qi = KVP ? row0 + cl : r0 + rl;
        const int kj = KVP ? r0 + rl : row0 + cl;
        const int ql = KVP ? cl : rl;
        float pv = 0.f;
        if (admitted(p, qi, kj)) pv = exp2f(x[j][u] * sl - lq[ql] * LOG2E);
        x[j][u] = pv;
        y[j][u] = pv * (y[j][u] - dl[ql]) * p.scale;
      }

    // (b): dK += dS B1, then dV += P B2; (c): dQ += dS B1, over the warp's
    // streamed rows, one product at a time (fewer registers live at once)
    fold_product<NS, STH, NH, KVP ? DK_TILES : DQ_TILES>(acc + NV, y, b1s, e1);
    if constexpr (KVP) fold_product<NS, STV, NV, DV_TILES>(acc, x, b2s, e2);
  }
  cp_async_wait_all();

  // the CW warps of row group rw sum their accumulators in order cw = 0,
  // 1, ..; warp (0, rw) writes each n8 tile as soon as it is summed
  constexpr int WARP_FLOATS = NA * 128;
  const float* red = smem + rw * WARP_FLOATS + lane;
  if (CW > 1) {
    __syncthreads();   // every warp is done with the tiles
    // the partial of warp (c, rw) at ((c - 1) RW + rw) WARP_FLOATS, in
    // fragment order
    if (cw > 0)
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          smem[(rw + (cw - 1) * RW) * WARP_FLOATS + lane + (a * 4 + u) * 32] =
              acc[a][u];
    __syncthreads();
    if (cw > 0) return;
  }

  // rows r0 + 16 rw + (g, g + 8), columns 8 n + (2t, 2t + 1) of tile n;
  // the block's indices read anew
  const int yb = ctaid_y(), zb = ctaid_z();
  const int ob = yb / heads, oh = yb % heads;
  const int row = (KVP ? ctaid_x() : gridDim.x - 1 - ctaid_x()) * BR +
                  rw * 16 + g;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    for (int c = 1; c < CW; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[a][u] += red[(c - 1) * RW * WARP_FLOATS + (a * 4 + u) * 32];
    const bool is_v = a < NV;
    const int w = KVP ? (is_v ? DV : DK) : DQ;
    float* base = (KVP ? (is_v ? p.dv : p.dk) : p.dq) + ob * p.s[w][0] +
                  oh * p.s[w][2];
    const int lim = is_v ? p.Dv : p.Dh;
    const int col = (is_v ? zb * (WV / G::Z) + 8 * a
                          : zb * (WH / G::Z) + 8 * (a - NV)) + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (row + 8 * hr >= s_lim) continue;
      float* out = base + (int64_t)(row + 8 * hr) * p.s[w][1];
      if (col < lim) out[col] = acc[a][2 * hr];
      if (col + 1 < lim) out[col + 1] = acc[a][2 * hr + 1];
    }
  }
}

// One pass's launch (or, with `blocks`, its occupancy) for the instance
// (WH, WV, rw, cw, ns)
template <int WH, int WV, int RW, int CW, int NS, bool KVP>
cudaError_t pass(const Params& p, int B, cudaStream_t stream, int* blocks,
                 int* smem) {
  using G = Geo<WH, WV, RW, CW, NS, KVP>;
  static_assert(G::SMEM <= MAX_SMEM, "instance exceeds shared memory");
  auto kernel = bwd_kernel<WH, WV, RW, CW, NS, KVP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  if (smem) *smem = G::SMEM;
  if (blocks)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         G::NT, G::SMEM);
  const int rows = KVP ? p.Sk : p.Sq;
  const dim3 grid((rows + G::BR - 1) / G::BR, B * (KVP ? p.KV : p.H), G::Z);
  kernel<<<grid, G::NT, G::SMEM, stream>>>(p);
  return cudaGetLastError();
}

__host__ __device__ constexpr int width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// The instances of both passes. Dh and Dv of one width (WH = WV), (width,
// rw, cw, ns): 64-row tiles of 8 warps with 64 streamed rows a step,
// 32-row tiles of 8 warps and 16-row tiles of 4 warps with 32; at width 256
// the 32- and 16-row tiles. Dh wider than Dv, (WH, WV, rw, cw, ns): at
// (128, 64) the same three; at (256, 128) 64-row tiles of 8 warps with 32
// streamed rows a step, and the 32- and 16-row tiles.
// cudaErrorInvalidValue for any other.
template <bool KVP>
cudaError_t dispatch(const Params& p, int B, int rw, int cw, int ns,
                     cudaStream_t stream, int* blocks, int* smem) {
  const int WH = width(p.Dh), WV = width(p.Dv);
  const int key = rw * 100 + cw * 10 + ns;
#define K7_CASE(dp, r, c, n)                                             \
  if (WH == dp && WV == dp && key == r * 100 + c * 10 + n)               \
    return pass<dp, dp, r, c, n, KVP>(p, B, stream, blocks, smem);
  K7_CASE(64, 4, 2, 4) K7_CASE(64, 2, 4, 1) K7_CASE(64, 1, 4, 1)
  K7_CASE(128, 4, 2, 4) K7_CASE(128, 2, 4, 1) K7_CASE(128, 1, 4, 1)
  K7_CASE(256, 2, 4, 1) K7_CASE(256, 1, 4, 1)
#undef K7_CASE
#define K7_PAIR(wh, wv, r, c, n)                                         \
  if (WH == wh && WV == wv && key == r * 100 + c * 10 + n)               \
    return pass<wh, wv, r, c, n, KVP>(p, B, stream, blocks, smem);
  K7_PAIR(128, 64, 4, 2, 4) K7_PAIR(128, 64, 2, 4, 1) K7_PAIR(128, 64, 1, 4, 1)
  K7_PAIR(256, 128, 4, 2, 2) K7_PAIR(256, 128, 2, 4, 1)
  K7_PAIR(256, 128, 1, 4, 1)
#undef K7_PAIR
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 tensors by their element strides (batch, sequence, head; the last
// dim contiguous), in the order q, k, v, o, dout, dq, dk, dv: q, dq (B, Sq,
// H, Dh); o, dout (B, Sq, H, Dv); k, dk (B, Sk, KV, Dh); v, dv (B, Sk, KV,
// Dv). lse (B, H, Sq) is K4's log-sum-exp; delta (B, H, Sq) is scratch.
// Query head h reads KV head h / (H / KV); window 0 = no window. The plan:
// (rw, cw, ns) of the dK/dV pass (kv_*) and of the dQ pass (q_*),
// instances above. Launches (a), (b) and (c) on `stream` in order and
// returns cudaGetLastError() (0 on success); does not synchronise.
int flash_attention_bwd(const float* q, const float* k, const float* v,
                        const float* o, const float* dout, const float* lse,
                        float* delta, float* dq, float* dk, float* dv,
                        const int64_t* strides, int B, int H, int KV, int Sq,
                        int Sk, int Dh, int Dv, int causal, int window,
                        float scale, int kv_rw, int kv_cw, int kv_ns,
                        int q_rw, int q_cw, int q_ns, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Dh <= 0 || Dh > 256 || Dv <= 0 || Dv > 256 ||
      Sk < 0 || window < 0 || (int64_t)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse;
  p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  bool vec16 = true;
  const void* staged[4] = {q, k, v, dout};
  const int which[4] = {Q, K, V, DO};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) {
    vec16 = vec16 && reinterpret_cast<uintptr_t>(staged[i]) % 16 == 0;
    for (int j = 0; j < 3; ++j) vec16 = vec16 && p.s[which[i]][j] % 4 == 0;
  }
  p.H = H; p.KV = KV; p.group = H / KV; p.Sq = Sq; p.Sk = Sk; p.Dh = Dh;
  p.Dv = Dv; p.causal = causal; p.window = window; p.vec16 = vec16;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  delta_kernel<<<dim3((Sq + 7) / 8, B * H), 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && Sk > 0)
    err = dispatch<true>(p, B, kv_rw, kv_cw, kv_ns, s, nullptr, nullptr);
  if (err == cudaSuccess)
    err = dispatch<false>(p, B, q_rw, q_cw, q_ns, s, nullptr, nullptr);
  return static_cast<int>(err);
}

// The card's figures and one instance's fit: out = {SMs, shared memory a
// block may opt into (bytes), the instance's dynamic shared memory
// (bytes), its blocks per SM by the occupancy API}; rw 0 = the card's
// figures alone. kvp 1 = the dK/dV pass; the instance is the one head
// dims Dh and Dv run at. Returns a CUDA error code (cudaErrorInvalidValue
// for an instance not built).
int flash_attention_bwd_limits(int Dh, int Dv, int kvp, int rw, int cw,
                               int ns, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  out[2] = out[3] = 0;
  if (err != cudaSuccess || rw == 0) return static_cast<int>(err);
  if (Dh <= 0 || Dh > 256 || Dv <= 0 || Dv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.Dh = Dh;
  p.Dv = Dv;
  err = kvp ? dispatch<true>(p, 1, rw, cw, ns, nullptr, &out[3], &out[2])
            : dispatch<false>(p, 1, rw, cw, ns, nullptr, &out[3], &out[2]);
  return static_cast<int>(err);
}

}  // extern "C"
