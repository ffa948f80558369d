// The group step loop's draw block for Hopper (sm_90a): one launch.
//
// Replaces no TPU kernel: the JAX package draws with jax.random under XLA,
// which fuses the threefry rounds by itself.  The port's plain version
// (ref.group_draws_ref, a composition of prng.py calls) computes them as
// ~170 int64 elementwise kernels a threefry call, four calls a block, each
// reading and writing tensors of C x n x B x n_draw int64 lanes; this
// kernel computes the same words in registers and writes only the outputs.
//
// For every cell c (its key (k0, k1), uint32 values held in int64) and
// step s in [i0, i0 + n), with j = s - i0:
//
//     k          = fold_in(key[c], s)       = threefry(key[c], (0, s))
//     (k1, k2)   = split(k)                 = threefry(k, (0, 0)), (0, 1)
//     e[c, j, w] = exponential of the bits of threefry(k1, (0, w)),
//                  w < B x n_draw
//     u[c, j, w] = uniform of the bits of threefry(k2, (0, w)), w < B x G
//     r[c, j, w] = uniform of the bits of threefry(fold_in(k2, 1), (0, w)),
//                  w < B (leased reads only; fold_in(k2, 1) = threefry(k2,
//                  (0, 1)))
//
// where the bits of a block are x0 ^ x1, uniform(b) is ((b >> 9) |
// 0x3F800000) read as f32, minus 1, clamped at 0, and exponential(b) is
// -log1p(-uniform(b)) with log1p evaluated in float64 and rounded to f32.
// The outputs are (C, n, B, n_draw), (C, n, B, G) and (C, n, B) f32, row
// major, as prng.exponential / uniform return them.
//
// Bit equality with the plain version: threefry's uint32 adds, xors and
// rotates and the uniform's bit trick are exact; the one rounding is the
// float64 log1p, which calls the CUDA math library's log1p as PyTorch's
// CUDA log1p kernel does, built with nvcc's default contraction as
// PyTorch is (tests/test_torch_draws_sm90.py holds all 2**23 values a
// uniform can take to torch's -log1p(-u) on the card, bit for bit; with
// -fmad=false they were equal too).
//
// What bounds it on this card: integer issue, far below the old path's
// memory traffic.  At pig25.montecarlo's block (24,576 cells, one step, B
// 8, n_draw 56, G 3) it computes 11.6 M words, each one threefry (~80
// 32-bit integer instructions) and, for 95% of them, one float64 log1p,
// and writes 46.4 MB: 14 us of stores at 3.35 TB/s, 52 us of INT32 issue
// at 16.7 TOP/s.  Measured on an H100 80GB HBM3 at 700 W: 0.0995 ms a
// launch (53% of that bound), against 14.35 ms for the plain version.
//
// Design: one warp a (cell, step) row.  Every lane derives the row's keys
// itself (three threefry calls, identical across the warp, in registers:
// no shuffle, no shared memory), then the lanes stride over the row's
// words, so the stores of a warp are 32 consecutive floats.  8 warps a
// block.  The launch allocates nothing and never synchronises, so a CUDA
// graph can capture it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, on the block (x0, x1) under key (k0, k1): the
// schedule of prng.threefry2x32 unrolled.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

// The random bits of word w under key (k0, k1): x0 ^ x1 of counter (0, w).
__device__ __forceinline__ uint32_t word_bits(uint32_t k0, uint32_t k1,
                                              uint32_t w) {
  uint32_t x0 = 0u, x1 = w;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform_of(uint32_t b) {
  return fmaxf(__uint_as_float((b >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

__device__ __forceinline__ float exponential_of(float u) {
  return static_cast<float>(-log1p(-static_cast<double>(u)));
}

struct DrawsIn {
  const int64_t* key;  // (C, 2)
  float* e;            // (C, n, B * n_draw)
  float* u;            // (C, n, B * G)
  float* r;            // (C, n, B) or null
  int rows, n, i0, e_words, u_words, r_words;
};

__global__ void __launch_bounds__(kWarps * 32)
threefry_draws_kernel(DrawsIn in) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= in.rows) return;
  const int c = row / in.n;
  const uint32_t step = static_cast<uint32_t>(in.i0 + (row - c * in.n));
  uint32_t f0 = 0u, f1 = step;                 // fold_in(key[c], step)
  threefry(static_cast<uint32_t>(in.key[2 * c]),
           static_cast<uint32_t>(in.key[2 * c + 1]), f0, f1);
  uint32_t a0 = 0u, a1 = 0u;                   // k1 = split(k)[0]
  threefry(f0, f1, a0, a1);
  uint32_t b0 = 0u, b1 = 1u;                   // k2 = split(k)[1]
  threefry(f0, f1, b0, b1);

  float* e = in.e + static_cast<size_t>(row) * in.e_words;
  for (int w = lane; w < in.e_words; w += 32)
    e[w] = exponential_of(uniform_of(word_bits(a0, a1, w)));
  float* u = in.u + static_cast<size_t>(row) * in.u_words;
  for (int w = lane; w < in.u_words; w += 32)
    u[w] = uniform_of(word_bits(b0, b1, w));
  if (in.r != nullptr) {
    uint32_t r0 = 0u, r1 = 1u;                 // fold_in(k2, 1)
    threefry(b0, b1, r0, r1);
    float* r = in.r + static_cast<size_t>(row) * in.r_words;
    for (int w = lane; w < in.r_words; w += 32)
      r[w] = uniform_of(word_bits(r0, r1, w));
  }
}

// exponential_of over given uniforms: what the tests hold to torch's
// -log1p(-u) on every value a uniform can take.
__global__ void threefry_exp_kernel(const float* u, float* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = exponential_of(u[i]);
}

}  // namespace

extern "C" int threefry_draws_sm90_launch(const void* key, void* e, void* u,
                                          void* r, int cells, int n, int i0,
                                          int e_words, int u_words,
                                          int r_words, void* stream) {
  DrawsIn in{static_cast<const int64_t*>(key), static_cast<float*>(e),
             static_cast<float*>(u), static_cast<float*>(r), cells * n, n,
             i0, e_words, u_words, r_words};
  const int blocks = (in.rows + kWarps - 1) / kWarps;
  threefry_draws_kernel<<<blocks, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(in);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_draws_sm90_exp_launch(const void* u, void* out,
                                              int count, void* stream) {
  threefry_exp_kernel<<<(count + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}
