// Causal flash attention with GQA for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel
// (src/repro/kernels/flash_attention.py:22), the TPU Pallas kernel that the
// dense models' prefill runs once per layer (models/layers.py, impl="flash").
// For q (B, Hq, Sq, Dh) and k, v (B, Hkv, Sk, Dh), all contiguous, it
// computes for every query head h (reading KV head h / (Hq / Hkv))
//
//     s[i, j] = (f32(q[i]) * sm_scale) . f32(k[j])       (-1e30 where masked)
//     o[i]    = sum_j exp(s[i, j] - m_i) f32(v[j]) / max(l_i, 1e-30)
//
// with the causal mask j <= i (top-left aligned) or none, the online
// softmax's running max m and sum l in f32, and o cast to q's type (round to
// nearest even for bf16).  Keys past the last query row of a tile are never
// loaded: the TPU kernel's skipped blocks above the diagonal.
//
// What bounds it on this card: operations.  Granite-8b's prefill (B 4,
// Hq 32, Dh 128, S 2048) needs 4 B Hq Dh S (S + 1) / 2 = 1.38e11 operations,
// 0.139 ms at the tensor cores' 989 TFLOP/s bf16; its bytes (q, k, v read
// once, o written once, 168 MB) take 0.050 ms at 3.35 TB/s.  This kernel
// keeps the TPU kernel's f32 arithmetic (P stays f32, as in the reference)
// on the CUDA cores, so 67 TFLOP/s f32 puts its floor near 2 ms a launch;
// wgmma with a bf16 P is later work and would change the numbers.
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch).  The TPU's sequential key-block grid axis becomes a loop inside
// the block over key tiles of 64.  The block converts its q tile (scaled)
// and each k and v tile to f32 in shared memory, rows padded by one word so
// that the column reads below hit 32 distinct banks.  Thread (ty, tx) of a
// 16 x 16 layout owns query rows ty + 16 i (i < 4): it computes the 4 x 4
// scores of keys tx + 16 j from registers, so every value read from shared
// memory feeds 4 multiply-adds.  A row's 64 scores sit in the 16 lanes of
// one half-warp, which reduce the row max and sum with xor shuffles; the
// probabilities go through shared memory to the P.V product, where the same
// thread owns output columns tx + 16 c of its rows in registers.  The ragged
// edge is masked here: q, k and v rows past Sq / Sk load as zeros, and keys
// past Sk are masked like the causal ones.  The largest query tiles, which
// see the most keys, are scheduled first.  Shared memory is 3 x 64 x (Dh+1)
// + 64 x 64 words (115 KB at Dh 128, 214 KB at Dh 256), above the default
// 48 KB, so the launcher opts in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // query rows per block = keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;   // 16 bytes
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;   // 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Copy rows [0, TILE) of a (rows, DH) row-major tile into shared memory as
// f32 times `scale`, with row stride DH + 1; rows >= nvalid become zeros.
// Consecutive threads take consecutive rows of one 16-byte column chunk, so
// their shared-memory stores fall in distinct banks.
template <typename T, int DH>
__device__ void load_tile(const T* __restrict__ src, int nvalid, float* dst,
                          float scale) {
  constexpr int N = Vec<T>::N;
  constexpr int CHUNKS = DH / N;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i % TILE;
    const int c = (i / TILE) * N;
    float x[N];
    if (r < nvalid) {
      Vec<T>::load(src + static_cast<size_t>(r) * DH + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * (DH + 1) + c + e] = x[e] * scale;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, DH <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Sk, int causal, float sm_scale) {
  constexpr int LD = DH + 1;     // padded row stride of the q, k, v tiles
  constexpr int NC = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // TILE x LD
  float* sk = sq + TILE * LD;    // TILE x LD
  float* sv = sk + TILE * LD;    // TILE x LD
  float* sp = sv + TILE * LD;    // TILE x TILE probabilities

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * DH
                  + static_cast<size_t>(q0) * DH;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * DH;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * DH;

  load_tile<T, DH>(qb, min(TILE, Sq - q0), sq, sm_scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kend = causal ? min(Sk, min(q0 + TILE, Sq)) : Sk;
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DH>(kb + static_cast<size_t>(k0) * DH, Sk - k0, sk, 1.f);
    load_tile<T, DH>(vb + static_cast<size_t>(k0) * DH, Sk - k0, sv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        sp[(ty + 16 * i) * TILE + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * TILE + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * Hq + h) * Sq * DH
                + static_cast<size_t>(r) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      orow[tx + 16 * c] = Vec<T>::store(acc[i][c] / lsum);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = (3 * TILE * (DH + 1) + TILE * TILE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + TILE - 1) / TILE, Hq, B);
  flash_attention_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
              int B, int Hq, int Hkv, int Sq, int Sk, int causal,
              float sm_scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                  sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                  sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                    sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                    sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched).  dtype 0 is
// f32, 1 is bf16; Dh must be 32, 64, 128 or 256 (else cudaErrorInvalidValue).
// The wrapper (kernels/flash_attention.py) checks shapes, types, contiguity
// and 16-byte alignment before it calls this.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int Dh,
                                      int dtype, int causal, float sm_scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                    causal, sm_scale, s);
  if (dtype == 0)
    return launch_dh<float>(Dh, q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                            sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
