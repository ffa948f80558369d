// The batch step loops' draw blocks for Hopper (sm_90a): one launch a
// block, in two entries that share the threefry device functions and no
// logic: the group loop's (threefry_draws_kernel) and the EPaxos loop's
// (threefry_epaxos_kernel, described after it).
//
// The group step loop's draw block.
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

// The EPaxos step loop's draw block.  Its plain version is
// ref.epaxos_draws_ref (prng.py on int64, ~170 elementwise kernels a
// threefry call, ~1,600 a block).  For every cell c and step s in
// [i0, i0 + b), row = c x b + (s - i0):
//
//     k            = fold_in(key[c], s)
//     k0 .. k4     = split(k, 5)             = threefry(k, (0, j)), j < 5
//     coord[row]   = randint(k0, (), 0, n): ka, kb = split(k0), hi and lo
//                    the bits of word 0 of ka and of kb, and in uint32
//                    (wrapping) with span = max(n, 1) and mult = ((2**16 %
//                    span)**2) % span: (hi % span x mult + lo % span) %
//                    span, written as int64
//     ecl[row, w]   = exponential of the bits of threefry(k1, (0, w)), w < 2
//     eout[row, w]  = exponential of word w of k2, w < n
//     eback[row, w] = exponential of word w of k3, w < n
//     ukey[row]     = uniform of word 0 of k4
//
// The outputs are (C, b) int64, (C, b, 2), (C, b, n), (C, b, n) and (C, b)
// f32, row major, as prng returns them; every word equals the plain
// version's bit for bit, by the same argument as the group loop's.
//
// What bounds it: a row is only 2n + 5 words (55 at n = 25), and deriving
// its keys takes 8 threefry calls (fold_in, the 5-way split, randint's
// split).  One warp a row with every lane deriving the keys, as the group
// loop's entry does, would repeat that work 32 times: ~100 M threefry calls
// a block at epaxos25.montecarlo's 393,216 cells against ~25 M useful ones.
// Here each lane derives the keys of one row once, and the words of a
// warp's 32 consecutive rows are then shared out lane by lane, each lane
// taking the keys of the row it works on from the lane that made them
// (__shfl_sync).  So every threefry call is made once: at 393,216 rows,
// 393,216 x (55 + 8) = 24.8 M calls, ~1.85e9 INT32 operations, 0.111 ms at
// 16.7 TOP/s; ~20 M float64 log1p beside them; and 86.5 MB of output,
// 0.026 ms at 3.35 TB/s.  Integer issue bounds it.  Measured on an H100
// 80GB HBM3 at 700 W: 0.195 ms a launch (57% of that bound), against 29.7
// ms for the plain version.  A warp's words of one output are consecutive
// in memory (its rows are), so its lanes store 32 consecutive words; coord
// and ukey, one a row, are stored by the lane that owns the row.  Every
// lane of a warp makes the same number of shuffles (the rows past the end
// take key 0 and store nothing), so the full-mask shuffles are convergent.
constexpr int kRows = 32;  // rows a warp

struct EpaxosIn {
  const int64_t* key;  // (C, 2)
  int64_t* coord;      // (C, b)
  float* ecl;          // (C, b, 2)
  float* eout;         // (C, b, n)
  float* eback;        // (C, b, n)
  float* ukey;         // (C, b)
  int64_t rows;
  int b, i0, n;
};

// The exponentials of words [0, words) under each of the warp's rows' keys
// (k0, k1 of the lane that owns the row), row major from out: lane l takes
// the flat indices l, l + 32, ..., so the warp stores 32 consecutive floats
// at a time; indices of the rows past valid are computed and not stored.
__device__ __forceinline__ void warp_exponentials(uint32_t k0, uint32_t k1,
                                                  int words, int valid,
                                                  float* out) {
  const int lane = threadIdx.x & 31;
  const int limit = valid * words;
  const int dr = kRows / words, dw = kRows % words;
  int r = lane / words, w = lane % words;
  for (int f = lane; f < kRows * words; f += kRows) {
    const uint32_t a0 = __shfl_sync(0xffffffffu, k0, r);
    const uint32_t a1 = __shfl_sync(0xffffffffu, k1, r);
    const float e = exponential_of(uniform_of(word_bits(a0, a1, w)));
    if (f < limit) out[f] = e;
    r += dr;
    w += dw;
    if (w >= words) { w -= words; ++r; }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
threefry_epaxos_kernel(EpaxosIn in) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRows;
  if (base >= in.rows) return;                 // the whole warp
  const int64_t left = in.rows - base;
  const int valid = left < kRows ? static_cast<int>(left) : kRows;
  const int64_t row = base + lane;
  uint32_t f0 = 0u, f1 = 0u, c0 = 0u, c1 = 0u;
  if (lane < valid) {
    const int64_t c = row / in.b;
    f1 = static_cast<uint32_t>(in.i0 + static_cast<int>(row - c * in.b));
    c0 = static_cast<uint32_t>(in.key[2 * c]);
    c1 = static_cast<uint32_t>(in.key[2 * c + 1]);
  }
  threefry(c0, c1, f0, f1);                    // k = fold_in(key[c], s)
  uint32_t k[5][2];                            // split(k, 5)
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    k[j][0] = 0u;
    k[j][1] = static_cast<uint32_t>(j);
    threefry(f0, f1, k[j][0], k[j][1]);
  }
  uint32_t ka0 = 0u, ka1 = 0u, kb0 = 0u, kb1 = 1u;  // split(k0)
  threefry(k[0][0], k[0][1], ka0, ka1);
  threefry(k[0][0], k[0][1], kb0, kb1);
  const uint32_t hi = word_bits(ka0, ka1, 0u), lo = word_bits(kb0, kb1, 0u);
  const uint32_t span = in.n > 0 ? static_cast<uint32_t>(in.n) : 1u;
  const uint32_t m = 65536u % span;
  const uint32_t mult = (m * m) % span;        // wraps to 0 above 2**16
  const uint32_t off = (hi % span) * mult + lo % span;
  const float u = uniform_of(word_bits(k[4][0], k[4][1], 0u));
  if (lane < valid) {
    in.coord[row] = static_cast<int64_t>(off % span);
    in.ukey[row] = u;
  }
  warp_exponentials(k[1][0], k[1][1], 2, valid, in.ecl + base * 2);
  warp_exponentials(k[2][0], k[2][1], in.n, valid, in.eout + base * in.n);
  warp_exponentials(k[3][0], k[3][1], in.n, valid, in.eback + base * in.n);
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

extern "C" int threefry_epaxos_draws_sm90_launch(const void* key, void* coord,
                                                 void* ecl, void* eout,
                                                 void* eback, void* ukey,
                                                 int cells, int b, int i0,
                                                 int n, void* stream) {
  EpaxosIn in{static_cast<const int64_t*>(key), static_cast<int64_t*>(coord),
              static_cast<float*>(ecl), static_cast<float*>(eout),
              static_cast<float*>(eback), static_cast<float*>(ukey),
              static_cast<int64_t>(cells) * b, b, i0, n};
  const int64_t rows_a_block = static_cast<int64_t>(kWarps) * kRows;
  const int blocks = static_cast<int>((in.rows + rows_a_block - 1)
                                      / rows_a_block);
  threefry_epaxos_kernel<<<blocks, kWarps * 32, 0,
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
