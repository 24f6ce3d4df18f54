// Counter-based random words bit-compatible with jax.random's default
// generator: threefry2x32, 20 rounds, in the partitionable form
// (jax_threefry_partitionable=True).
//
//   word i  = hi ^ lo,  (hi, lo) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//   uniform = max(bitcast<float>((word >> 9) | 0x3F800000) - 1, 0)
//
// Replaces: no Pallas kernel. The reference draws inside XLA
// (jax.random.uniform in src/repro/core/step.py:79 for gossip
// participation, src/repro/core/comm.py for Quantize and Drop), fused into
// its compiled chunk. The port's plain version (kernels/threefry/ref.py)
// runs the same hash as ~173 elementwise int64 launches per draw; this is
// one launch.
//
// What bounds it on an H100: integer operations. A word costs 20 rounds of
// add, rotate (one funnel shift) and xor, six key injections and the
// output's shift, or, subtract and max, about 80 INT32 instructions (the
// SASS count is printed by chip_smoke.py phase 2), against 4 bytes written
// (8 for the int64 words of random_bits). At 64 INT32 lanes per SM that is
// ~16.7 TOPS against 3.35 TB/s: the operations bound it from ~200 bytes
// of output per microsecond upwards. The draws on the path are small
// ((N,) = 20 words for participation, (N, D) = 81 920 for Quantize), so a
// launch costs more than the work.
//
// What the design does about it: nothing is staged; one thread computes one
// word in registers and stores it, in a grid-stride loop over the words of
// one key. A single key arrives as two 32-bit kernel arguments (nothing to
// upload); G keys as a pointer to the (G, 2) int64 key tensor, one row of
// the grid (blockIdx.y) per key, each key's words counted from 0 so that
// lane g is bitwise the single draw under key g.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(R)    \
  x0 += x1;            \
  x1 = rotl(x1, R) ^ x0;

#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// threefry2x32 of the counter pair (i >> 32, i & 0xFFFFFFFF) under (k0, k1),
// the two output words xored: jax's _threefry2x32_lowering, then
// random_bits' hi ^ lo.
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  TF_GROUP_A x0 += k1; x1 += k2 + 1u;
  TF_GROUP_B x0 += k2; x1 += k0 + 2u;
  TF_GROUP_A x0 += k0; x1 += k1 + 3u;
  TF_GROUP_B x0 += k1; x1 += k2 + 4u;
  TF_GROUP_A x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_GROUP_A
#undef TF_GROUP_B
#undef TF_ROUND

// UNIFORM: float32 in [0, 1) from the word's top 23 bits; else the word
// as an int64 in [0, 2^32). keys == nullptr: one key (k0, k1); else row
// blockIdx.y of the (G, 2) int64 keys. out holds G rows of n words.
template <bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
    threefry_kernel(uint32_t k0, uint32_t k1, const int64_t* __restrict__ keys,
                    int64_t n, void* __restrict__ out) {
  const int64_t lane = blockIdx.y;
  if (keys != nullptr) {
    k0 = static_cast<uint32_t>(keys[2 * lane]);
    k1 = static_cast<uint32_t>(keys[2 * lane + 1]);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const uint32_t w = threefry_word(k0, k1, static_cast<uint64_t>(i));
    if (UNIFORM) {
      const float f = __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
      static_cast<float*>(out)[lane * n + i] = fmaxf(f, 0.0f);
    } else {
      static_cast<int64_t*>(out)[lane * n + i] = static_cast<int64_t>(w);
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch: `lanes` rows (blockIdx.y) of `n` words each, `blocks` blocks
// of THREADS threads per row, on `stream`. keys == nullptr draws under the
// single key (k0, k1) (then lanes must be 1). Returns cudaGetLastError().
int threefry_launch(uint32_t k0, uint32_t k1, const int64_t* keys, int64_t n,
                    int lanes, int uniform, int blocks, void* out,
                    void* stream) {
  const dim3 grid(blocks, lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform)
    threefry_kernel<true><<<grid, THREADS, 0, s>>>(k0, k1, keys, n, out);
  else
    threefry_kernel<false><<<grid, THREADS, 0, s>>>(k0, k1, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
