// Chunked linear recurrence (the RWKV6 / SSM scan) for Hopper (sm_90a):
// 3xTF32 mma.sync on the tensor cores, one block per (b, h, 64 columns).
//
// Replaces repro/kernels/ssm_scan.py::_ssm_kernel
// (src/repro/kernels/ssm_scan.py:26), the TPU Pallas kernel that rwkv6's
// prefill runs once per layer, for Dk = 64, Dv a multiple of 64 and chunk
// 16 in bf16 and f32; ssm_scan.cu keeps every other shape.  It computes the
// function of ssm_scan.cu (and of kernels/ref.py::ssm_scan_ref): for q, k,
// log_a (B, T, H, 64) and v (B, T, H, Dv) in the model's layout the state
// S (64 x Dv, f32) of every (b, h) starts at s0 (or 0) and each chunk of
// C = 16 rows, with A the inclusive cumulative sum of log_a over the chunk
// and Atot its last row, computes
//
//     s[t, s'] = (q[t] e^{A[t]}) . (k[s'] e^{-A[s']})   masked to s' <= t,
//                                 or s' < t plus the bonus diagonal
//                                 q[t] . (u * k[t]) at s' = t (RWKV6)
//     y[t]     = sum_s' s[t, s'] v[s'] + (q[t] e^{A[t]}) S
//     S        = S * e^{Atot} (per row d) + sum_t (k[t] e^{Atot - A[t]}) v[t]
//
// and stores y in v's type (nearest even for bf16).  Rows past T load as
// zeros: a decay of 1 and no kv, so the state is unchanged, and their y is
// not stored.
//
// What bounds it on this card: bytes.  At rwkv6-3b's prefill (B 4, T 2048,
// H 40, Dk = Dv = 64) it reads q, k, v (bf16) and log_a (f32) once and
// writes y (bf16), with s0 and the state (f32): 256.9 MB, 0.077 ms at
// 3.35 TB/s.  Its products, three TF32 passes each, take 0.037 ms at the
// tensor cores' 495 TFLOP/s.  What the design does about each fault of
// ssm_scan.cu (1.75 ms there, 5% of its f32 bound):
//
// 1. One block per (b, h) and 64 state columns (160 blocks at rwkv6-3b's
//    prefill, two resident on an SM in 105 KB of shared memory each), so a
//    chunk's loads, exponentials, cumulative sum and scores are computed
//    once, not once a 16-column slab.
// 2. The serial chain is short.  The block walks the sequence in tiles of
//    64 rows (four chunks).  Phase L, one warp a chunk, does all the
//    chunk-local work of the tile at once: the cumulative sum (a lane owns
//    two channels), the factors q e^A, k e^-A, k e^{Atot-A} and e^{Atot},
//    the bonus diagonal and the masked 16 x 16 scores.  Phase C, one warp a
//    16-column slab of the state, walks the tile's four chunks in order:
//    y = v^T s^T + S^T (q e^A)^T, then S = e^{Atot} * S + v^T (k e^{Atot-A}).
//    Only the last step's elementwise FMA depends on the previous chunk.
// 3. Products on the tensor cores: mma.sync.m16n8k8 TF32 with f32
//    accumulators, three passes (hi.hi + hi.lo + lo.hi, each f32 operand
//    split into hi = rna(x) and lo = rna(x - hi), the cross terms summed
//    apart and added last): one TF32 pass moves y past the port's
//    tolerance and the state past 1e-6 (tests/test_torch_ssm_sm90.py).  A
//    bf16 operand is exact in TF32, so the products with v take two
//    passes.  The hi.hi products of each k-step of y and of the scores go
//    to a fresh accumulator added in f32 (mma_add): chained on one
//    accumulator, the tensor cores' truncating sums moved y far enough from
//    the plain version that its bf16 rounding flipped often enough to take
//    rwkv6-3b's block output 2.2e-3 from the plain one's (chip_smoke's
//    layer check; bound 2e-3).  The state lives in registers in the
//    accumulator layout of v^T (k e^{Atot-A}), held transposed (S^T: rows =
//    columns of v), which is also the A fragment of S^T (q e^A)^T once the
//    k index is permuted (k positions tig and tig + 4 name channels 2 tig
//    and 2 tig + 1), so it never goes through shared memory.
// 4. Loads in flight: a two-stage ring of 64-row tiles of log_a, q, k, v
//    filled by cp.async (16 bytes a copy, zero-filled past T) while the
//    previous tile computes.  Phase L's results overwrite its inputs in the
//    stage: k e^-A over the chunk's q and k rows until the scores are done,
//    then q e^A split once into TF32 hi (over log_a) and lo (over q and k),
//    so that phase C's four warps load both halves instead of each
//    splitting them; k e^{Atot-A} is stored transposed and the scores as
//    hi/lo pairs.  Rows are XOR-swizzled in 16-byte units so that every
//    fragment load is free of bank conflicts.
// 5. The exponentials are expf and the cumulative sum runs row by row in
//    f32, as in the plain version, but for e^{Atot-A}, taken as
//    e^{Atot} e^{-A} (one expf fewer for each factor of k); the bonus
//    diagonal is summed over the warp by a reduce-scatter (16 shuffles for
//    the chunk's 16 rows).
//
// What holds it back (PERF.md): instruction issue, not the tensor cores or
// the bytes.  A lane's share of a chunk's phase L holds 66 expf, and each
// chunk of phase C 88 mma.sync a warp beside the TF32 splits, the fresh
// accumulators' adds and the swizzled addresses, with 8 warps an SM
// (registers and shared memory allow no more); the two phases of a block
// are separated by barriers, and 28 of the 132 SMs carry two of the 160
// blocks.  Pairs of warps splitting the channels (16 warps an SM, y
// partials exchanged on named barriers) ran slower, and so did splitting
// k e^{Atot-A} once in phase L (v single-buffered to make room): phase L,
// one warp a chunk, is on the critical path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DK = 64;       // channels: the state's rows
constexpr int DV = 64;       // state columns a block owns
constexpr int C = 16;        // rows a chunk
constexpr int TILE = 64;     // rows a tile: four chunks
constexpr int THREADS = 128; // four warps

template <typename T>
struct Smem {
  static constexpr int RB = DK * static_cast<int>(sizeof(T));  // q/k/v row
  static constexpr int LA = TILE * DK * 4;     // log_a, then q e^A (f32)
  static constexpr int QKV = TILE * RB;        // q, k (then k e^-A), v
  static constexpr int STAGE = LA + 3 * QKV;
  static constexpr int KST = DK * TILE * 4;    // (k e^{Atot-A})^T: [d][t]
  static constexpr int SC = TILE * C * 8;      // scores, hi/lo: [t][s]
  static constexpr int EA = TILE / C * DK * 4; // e^{Atot}: [chunk][d]
  static constexpr int BYTES = 2 * STAGE + KST + SC + EA;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float index of element x within row r of 64 f32 (256 bytes) whose
// 16-byte units are XOR-swizzled by 2 (r mod 4): the fragment loads of
// four rows at one column then hit four distinct bank groups
__device__ __forceinline__ int swz(int r, int x) {
  return (((x >> 2) ^ ((r & 3) << 1)) << 2) + (x & 3);
}
__device__ __forceinline__ int sw256(int r, int x) {
  return r * 64 + swz(r, x);
}

// the 16-byte unit of v's row r that holds logical unit c: rows 2 apart
// (a fragment's four k rows) land in distinct bank groups
template <typename T>
__device__ __forceinline__ int v_unit(int r, int c) {
  return sizeof(T) == 2 ? c ^ ((r >> 1) & 3) : c ^ (((r >> 1) & 3) << 1);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x = hi + lo: hi = x rounded to TF32 (nearest, ties away), lo = the rest
// rounded to TF32.  The rounding is cvt.rna.tf32.f32's for finite x, done
// on the bits in two integer operations (half a TF32 ulp added to the
// magnitude, the 13 low bits cleared): ptxas expands the cvt into a dozen
// instructions with NaN and infinity checks, and the split ran on every
// fragment
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage of the bonus diagonal's reduce-scatter over the warp: lanes
// with bit 2W keep rows W..2W-1 of the 2W they hold, the others rows
// 0..W-1, each adding its partner's (2W lanes apart) share of them
template <int W>
__device__ __forceinline__ void fold(float (&dp)[16], int lane) {
  const bool up = lane & (2 * W);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float mine = up ? dp[i + W] : dp[i];
    dp[i] = mine + __shfl_xor_sync(0xffffffffu, up ? dp[i] : dp[i + W],
                                   2 * W);
  }
}

// d += a * b with the product's own sum rounded once more, to nearest: the
// tensor cores truncate their sum, so a chain of mma on one accumulator
// biases a long dot product toward zero; a fresh accumulator a k-step, added
// in f32, keeps each truncation to the k-step's own eight products
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
ssm_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ log_a,
               const float* __restrict__ u, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_out, int Tlen, int H,
               int Dv) {
  using S_ = Smem<T>;
  constexpr int RB = S_::RB;
  constexpr bool EXACT_V = sizeof(T) == 2;     // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* kst = reinterpret_cast<float*>(smem + 2 * S_::STAGE);
  float4* sc = reinterpret_cast<float4*>(smem + 2 * S_::STAGE + S_::KST);
  float* ea = reinterpret_cast<float*>(smem + 2 * S_::STAGE + S_::KST
                                       + S_::SC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int j0 = blockIdx.x * DV, h = blockIdx.y, b = blockIdx.z;
  const bool bonus = u != nullptr;
  const size_t head = static_cast<size_t>(b) * Tlen * H + h;  // (b, 0, h)
  const size_t state = (static_cast<size_t>(b) * H + h) * DK * Dv + j0;

  // the state, transposed, in the accumulator layout of phase C's products:
  // st[n][i] = S[d][j], d = 8 n + 2 tig + (i & 1),
  //                    j = 16 warp + g + 8 (i >> 1)
  float st[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 8 * n + 2 * tig + (i & 1);
      const int j = 16 * warp + g + 8 * (i >> 1);
      st[n][i] = s0 ? s0[state + static_cast<size_t>(d) * Dv + j] : 0.f;
    }

  // the copies a thread issues for a tile: log_a's 16-byte unit lc of rows
  // lr + 8 i, and q's, k's and v's unit qc of rows qr + RPI i; rows past T
  // copy nothing and fill zeros (the source is then any valid address)
  constexpr int U = RB / 16;                              // units a row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // elements a unit
  constexpr int RPI = THREADS / U;                        // rows an issue
  const int lc = tid & 15, lr = tid >> 4, qc = tid % U, qr = tid / U;
  const size_t rstep = static_cast<size_t>(H);            // rows of (b, ., h)
  auto load_tile = [&](int tile) {
    unsigned char* base = smem + (tile & 1) * S_::STAGE;
    const int t0 = tile * TILE;
#pragma unroll
    for (int i = 0; i < TILE / (THREADS / 16); ++i) {
      const int r = lr + i * (THREADS / 16);
      const bool ok = t0 + r < Tlen;
      const size_t row = head + (ok ? t0 + r : 0) * rstep;
      cp16(smem_addr(base + r * 256 + ((lc ^ ((r & 3) << 1)) << 4)),
           log_a + row * DK + lc * 4, ok);
    }
#pragma unroll
    for (int i = 0; i < TILE / RPI; ++i) {
      const int r = qr + i * RPI;
      const bool ok = t0 + r < Tlen;
      const size_t row = head + (ok ? t0 + r : 0) * rstep;
      unsigned char* qkv = base + S_::LA + r * RB;
      cp16(smem_addr(qkv + qc * 16), q + row * DK + qc * PER, ok);
      cp16(smem_addr(qkv + S_::QKV + qc * 16), k + row * DK + qc * PER, ok);
      cp16(smem_addr(qkv + 2 * S_::QKV + v_unit<T>(r, qc) * 16),
           v + row * Dv + j0 + qc * PER, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int ntiles = (Tlen + TILE - 1) / TILE;
  if (ntiles > 0) load_tile(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TILE;
    unsigned char* base = smem + (tile & 1) * S_::STAGE;
    float* la = reinterpret_cast<float*>(base);           // then q e^A
    const T* qs = reinterpret_cast<const T*>(base + S_::LA);
    const T* ks = reinterpret_cast<const T*>(base + S_::LA + S_::QKV);
    const T* vs = reinterpret_cast<const T*>(base + S_::LA + 2 * S_::QKV);
    // row s (256 bytes, 64 f32) of chunk c's scratch in the stage: the
    // chunk's q rows, then its k rows.  k e^-A in phase L, then the TF32
    // lo part of q e^A (its hi part stays over log_a)
    auto qk_row = [&](int c, int s) {
      constexpr int IN_Q = C * RB / 256;
      unsigned char* p = s < IN_Q
          ? base + S_::LA + C * c * RB + s * 256
          : base + S_::LA + S_::QKV + C * c * RB + (s - IN_Q) * 256;
      return reinterpret_cast<float*>(p);
    };
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();          // the tile landed; the last tile's phase C ended
    if (tile + 1 < ntiles) load_tile(tile + 1);

    // ---------------- phase L: warp w does chunk w of the tile
    const int r0 = C * warp;
    if (t0 + r0 < Tlen) {
      float2 A[C], qv[C], kv[C];
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float2 x = load2(la + sw256(r0 + t, 2 * lane));
        acc.x += x.x;
        acc.y += x.y;
        A[t] = acc;
        qv[t] = load2(qs + (r0 + t) * DK + 2 * lane);
        kv[t] = load2(ks + (r0 + t) * DK + 2 * lane);
      }
      __syncwarp();   // k e^-A overwrites this chunk's q and k rows
      const float2 eat = make_float2(expf(acc.x), expf(acc.y));
      *reinterpret_cast<float2*>(ea + warp * DK + 2 * lane) = eat;
      const float2 uu = bonus ? load2(u + h * DK + 2 * lane)
                              : make_float2(0.f, 0.f);
      float2 qe[C];                     // q e^A, split after the scores
      float dp[C];                      // this lane's share of the diagonal
      float4 k0, k1;                    // k e^{Atot-A}, four rows a store
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float2 a = A[t];
        qe[t] = make_float2(qv[t].x * expf(a.x), qv[t].y * expf(a.y));
        const float2 ena = make_float2(expf(-a.x), expf(-a.y));
        const float2 ke = make_float2(kv[t].x * ena.x, kv[t].y * ena.y);
        // e^{Atot-A} = e^{Atot} e^{-A}: within 2 ulps of expf(Atot - A)
        const float2 ks2 = make_float2(kv[t].x * (eat.x * ena.x),
                                       kv[t].y * (eat.y * ena.y));
        *reinterpret_cast<float2*>(la + sw256(r0 + t, 2 * lane)) = qe[t];
        *reinterpret_cast<float2*>(qk_row(warp, t) + swz(t, 2 * lane)) = ke;
        (&k0.x)[t & 3] = ks2.x;
        (&k1.x)[t & 3] = ks2.y;
        if ((t & 3) == 3) {
          *reinterpret_cast<float4*>(kst + sw256(2 * lane, r0 + t - 3)) = k0;
          *reinterpret_cast<float4*>(kst + sw256(2 * lane + 1, r0 + t - 3)) =
              k1;
        }
        dp[t] = qv[t].x * uu.x * kv[t].x + qv[t].y * uu.y * kv[t].y;
      }
      // the bonus diagonal q . (u k): the 16 rows' sums over the warp as a
      // reduce-scatter (16 shuffles), lane 2 (bit-reversed row) ending with
      // a row's sum; then rows g and g + 8 fetched
      float dg0 = 0.f, dg1 = 0.f;
      if (bonus) {
        fold<8>(dp, lane);
        fold<4>(dp, lane);
        fold<2>(dp, lane);
        fold<1>(dp, lane);
        dp[0] += __shfl_xor_sync(0xffffffffu, dp[0], 1);
        // lane l holds row ((l >> 4) & 1) * 8 + ((l >> 3) & 1) * 4
        //                  + ((l >> 2) & 1) * 2 + ((l >> 1) & 1)
        auto holder = [](int r) {
          return ((r >> 3) & 1) << 4 | ((r >> 2) & 1) << 3 |
                 ((r >> 1) & 1) << 2 | (r & 1) << 1;
        };
        dg0 = __shfl_sync(0xffffffffu, dp[0], holder(g));
        dg1 = __shfl_sync(0xffffffffu, dp[0], holder(g + 8));
      }
      __syncwarp();
      // the masked scores (q e^A)(k e^-A)^T: 16 x 16 over 64 channels
      float sm[2][4] = {}, sx[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int d0 = 8 * kk + 2 * tig;
        const float2 qa = load2(la + sw256(r0 + g, d0));
        const float2 qb = load2(la + sw256(r0 + g + 8, d0));
        uint32_t ah[4], al[4];
        split(qa.x, ah[0], al[0]);
        split(qb.x, ah[1], al[1]);
        split(qa.y, ah[2], al[2]);
        split(qb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = 8 * n + g;
          const float2 kb = load2(qk_row(warp, s) + swz(s, d0));
          uint32_t bh0, bl0, bh1, bl1;
          split(kb.x, bh0, bl0);
          split(kb.y, bh1, bl1);
          mma(sx[n], al, bh0, bh1);
          mma(sx[n], ah, bl0, bl1);
          mma_add(sm[n], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = g + 8 * half;
          float val[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = 8 * n + 2 * tig + i;
            const float x = sm[n][2 * half + i] + sx[n][2 * half + i];
            val[i] = (bonus ? s < t : s <= t) ? x : 0.f;
            if (bonus && s == t) val[i] = half ? dg1 : dg0;
          }
          uint32_t h0, l0, h1, l1;
          split(val[0], h0, l0);
          split(val[1], h1, l1);
          const int row = r0 + t, unit = (4 * n + tig) ^ ((row & 1) << 2);
          sc[row * 8 + unit] = make_float4(
              __uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
              __uint_as_float(l1));
        }
      __syncwarp();   // k e^-A read: q e^A's TF32 split replaces it
#pragma unroll
      for (int t = 0; t < C; ++t) {
        uint32_t h0, l0, h1, l1;
        split(qe[t].x, h0, l0);
        split(qe[t].y, h1, l1);
        *reinterpret_cast<uint2*>(la + sw256(r0 + t, 2 * lane)) =
            make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(qk_row(warp, t) + swz(t, 2 * lane)) =
            make_uint2(l0, l1);
      }
    }
    __syncthreads();

    // ---------------- phase C: warp w owns state columns 16 w .. 16 w + 15
    const int jw = 16 * warp;
#pragma unroll
    for (int c = 0; c < TILE / C; ++c) {
      if (t0 + C * c >= Tlen) break;
      // v^T as the A fragment (k = the chunk's rows, permuted like d)
      uint32_t vh[2][4], vl[2][4];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int r = C * c + 8 * kb + 2 * tig;
        const int rr[4] = {r, r, r + 1, r + 1};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = jw + g + 8 * (i & 1);
          const float x = to_f32(
              vs[rr[i] * DV + v_unit<T>(rr[i], j / PER) * PER + j % PER]);
          if (EXACT_V) {
            vh[kb][i] = __float_as_uint(x);
            vl[kb][i] = 0u;
          } else {
            split(x, vh[kb][i], vl[kb][i]);
          }
        }
      }
      // y^T = v^T s'^T + S^T (q e^A)^T
      float ym[2][4] = {}, yx[2][4] = {}, yz[2][4] = {};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int row = C * c + 8 * n + g;
          const float4 f = sc[row * 8 + ((4 * kb + tig) ^ ((row & 1) << 2))];
          const uint32_t bh0 = __float_as_uint(f.x);
          const uint32_t bh1 = __float_as_uint(f.y);
          const uint32_t bl0 = __float_as_uint(f.z);
          const uint32_t bl1 = __float_as_uint(f.w);
          if (!EXACT_V) mma(yz[n], vl[kb], bh0, bh1);
          mma(yx[n], vh[kb], bl0, bl1);
          mma_add(ym[n], vh[kb], bh0, bh1);
        }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ah[4], al[4];
        split(st[kk][0], ah[0], al[0]);
        split(st[kk][2], ah[1], al[1]);
        split(st[kk][1], ah[2], al[2]);
        split(st[kk][3], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int t = 8 * n + g, d0 = 8 * kk + 2 * tig;
          const uint2 hi = *reinterpret_cast<const uint2*>(
              la + sw256(C * c + t, d0));
          const uint2 lo = *reinterpret_cast<const uint2*>(
              qk_row(c, t) + swz(t, d0));
          const uint32_t bh0 = hi.x, bh1 = hi.y, bl0 = lo.x, bl1 = lo.y;
          mma(yz[n], al, bh0, bh1);
          mma(yx[n], ah, bl0, bl1);
          mma_add(ym[n], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + C * c + 8 * n + 2 * tig + (i & 1);
          const int j = jw + g + 8 * (i >> 1);
          if (t < Tlen) {
            y[(head + static_cast<size_t>(t) * H) * Dv + j0 + j] =
                from_f32<T>(ym[n][i] + (yz[n][i] + yx[n][i]));
          }
        }
      // S = e^{Atot} * S + v^T (k e^{Atot-A})
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float dm[4] = {}, dx[4] = {};
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          const float2 kf = load2(kst + sw256(8 * n + g,
                                              C * c + 8 * kb + 2 * tig));
          uint32_t bh0, bl0, bh1, bl1;
          split(kf.x, bh0, bl0);
          split(kf.y, bh1, bl1);
          if (!EXACT_V) mma(dx, vl[kb], bh0, bh1);
          mma(dx, vh[kb], bl0, bl1);
          mma(dm, vh[kb], bh0, bh1);
        }
        const float2 e = load2(ea + c * DK + 8 * n + 2 * tig);
        st[n][0] = fmaf(st[n][0], e.x, dm[0] + dx[0]);
        st[n][1] = fmaf(st[n][1], e.y, dm[1] + dx[1]);
        st[n][2] = fmaf(st[n][2], e.x, dm[2] + dx[2]);
        st[n][3] = fmaf(st[n][3], e.y, dm[3] + dx[3]);
      }
    }
  }

  if (s_out) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 8 * n + 2 * tig + (i & 1);
        const int j = 16 * warp + g + 8 * (i >> 1);
        s_out[state + static_cast<size_t>(d) * Dv + j] = st[n][i];
      }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int Tlen, int H, int Dv, cudaStream_t stream) {
  constexpr int bytes = Smem<T>::BYTES;
  auto kernel = ssm_mma_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Dv / DV, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), Tlen, H, Dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched).  q, k, v and y
// are contiguous (B, T, H, D) of one type (dtype 0: f32, 1: bf16), 16-byte
// aligned; log_a f32 like q; u (H, 64) f32 or null (no bonus: the inclusive
// mask); s0 and s_out (B, H, 64, Dv) f32 or null.  The wrapper
// (ssm_scan.py) has checked Dk = 64, Dv a multiple of 64 and chunk 16.
extern "C" int ssm_scan_sm90_launch(const void* q, const void* k,
                                    const void* v, const void* log_a,
                                    const void* u, const void* s0, void* y,
                                    void* s_out, int B, int T, int H, int Dv,
                                    int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, log_a, u, s0, y, s_out, B, T, H, Dv, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, log_a, u, s0, y, s_out, B, T, H,
                                 Dv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of each type requests (for the reports).
extern "C" int ssm_scan_sm90_smem_bytes(int dtype) {
  return dtype == 0 ? Smem<float>::BYTES : Smem<__nv_bfloat16>::BYTES;
}
