// Chunked linear recurrence (the SSM / RWKV6 scan) for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::_ssm_kernel
// (src/repro/kernels/ssm_scan.py:26), the TPU Pallas kernel, and adds what
// a serving cache needs: an initial state s0 in and the final state out.
// For q, k, log_a (B, T, H, Dk) and v (B, T, H, Dv) in the model's layout,
// a per-channel log-decay (f32), the state S (Dk x Dv, f32) of every
// (b, h) starts at s0 (or 0) and each chunk of C rows computes, with
// A = the inclusive cumulative sum of log_a over the chunk's rows and
// Atot = its last row,
//
//     s[t, s'] = (q[t] e^{A[t]}) . (k[s'] e^{-A[s']})   masked to s' <= t,
//                                 or s' < t with the bonus u (RWKV6)
//     y[t]     = sum_s' s[t, s'] v[s']  (+ (q[t] . (u * k[t])) v[t])
//                + (q[t] e^{A[t]}) S
//     S        = S * e^{Atot} (per row d) + sum_t (k[t] e^{Atot - A[t]}) v[t]
//
// all in f32, y stored in v's type (round to nearest even for bf16).  The
// factored form needs C * max|log_a| well under log(f32 max) ~ 88: RWKV
// clamps log_a to [-2.3, -1e-4] and runs C = 16 (e^36.8 at most).
//
// What bounds it on this card: at rwkv6-3b's prefill (B 4, T 2048, H 40,
// Dk = Dv = 64, C 16) the products the mask leaves live (the strict
// triangles of scores and intra term, the bonus diagonal, inter and state)
// are 6.08e9 f32 operations, 0.091 ms at 67 TFLOP/s on the CUDA cores; the
// bytes (q, k, v bf16 and log_a f32 read once, y bf16 written, s0 and the
// state f32) are 256.9 MB, 0.077 ms at 3.35 TB/s.  This kernel does plain f32 FMAs on the CUDA cores, so it
// is held to the operations bound; tensor cores (TF32 wgmma) and TMA come
// later.
//
// Design: the TPU grid (BH, nc) runs its chunk axis in order on one core
// with S in VMEM scratch.  Here one block of 128 threads owns a (b, h,
// slab of 16 state columns) and loops over the chunks itself: the state's
// columns are independent (y[:, j] reads only S[:, j] and v[:, j]), so
// B H Dv / 16 blocks run in parallel (640 at rwkv6-3b's prefill, ~5 per
// SM) at the price of every slab recomputing the chunk's scores.  The slab
// of S (Dk x 16 f32, 4 KB) stays in shared memory for the whole scan.  Each
// chunk loads its rows of q, k, log_a and the slab of v straight from the
// (B, T, H, D) layout by strides (no transposed copies) as f32 into shared
// memory, rows padded by one word against bank conflicts; rows past T load
// as zeros (a decay of 1 and no kv: the state is unchanged, and their y is
// not stored).  Then, separated by barriers: the cumulative sum (one thread
// a channel) and the bonus diagonal (one thread a row); the factors
// e^{A}, e^{-A}, e^{Atot - A} in place; the C x C masked scores; y; the
// state update, each thread owning fixed (d, j) entries of S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int W = 16;          // state columns a block owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DK, int C>
constexpr int smem_floats() {
  return 3 * C * (DK + 1)      // q / q e^A, k / k e^-A, log_a / A / k e^{Atot-A}
         + C * W               // v slab
         + DK * W              // state slab
         + C * (C + 1)         // scores
         + C                   // bonus diagonal
         + 2 * DK;             // Atot, e^{Atot}
}

template <typename T, int DK, int C>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ log_a,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ s_out, int Tlen, int H,
                int Dv) {
  constexpr int LD = DK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // C x LD
  float* sK = sQ + C * LD;          // C x LD
  float* sL = sK + C * LD;          // C x LD
  float* sV = sL + C * LD;          // C x W
  float* sS = sV + C * W;           // DK x W
  float* sSc = sS + DK * W;         // C x (C + 1)
  float* sDiag = sSc + C * (C + 1); // C
  float* sAtot = sDiag + C;         // DK
  float* sEA = sAtot + DK;          // DK

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * W;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool bonus = u != nullptr;
  // element (b, t, h, d) of a (B, T, H, D) tensor
  const size_t row_stride_k = static_cast<size_t>(H) * DK;
  const size_t row_stride_v = static_cast<size_t>(H) * Dv;
  const size_t base_k = (static_cast<size_t>(b) * Tlen * H + h) * DK;
  const size_t base_v = (static_cast<size_t>(b) * Tlen * H + h) * Dv + j0;
  const size_t state_base = ((static_cast<size_t>(b) * H + h) * DK) * Dv + j0;

  for (int e = tid; e < DK * W; e += THREADS) {
    const int d = e / W, j = e % W;
    sS[e] = s0 ? s0[state_base + static_cast<size_t>(d) * Dv + j] : 0.f;
  }

  const int nc = (Tlen + C - 1) / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    // ---- load the chunk's rows (zeros past T)
    for (int e = tid; e < C * DK; e += THREADS) {
      const int t = e / DK, d = e % DK;
      float qv = 0.f, kv = 0.f, lv = 0.f;
      if (t0 + t < Tlen) {
        const size_t off = base_k + (t0 + t) * row_stride_k + d;
        qv = to_f32(q[off]);
        kv = to_f32(k[off]);
        lv = log_a[off];
      }
      sQ[t * LD + d] = qv;
      sK[t * LD + d] = kv;
      sL[t * LD + d] = lv;
    }
    for (int e = tid; e < C * W; e += THREADS) {
      const int t = e / W, j = e % W;
      sV[e] = t0 + t < Tlen ? to_f32(v[base_v + (t0 + t) * row_stride_v + j])
                            : 0.f;
    }
    __syncthreads();
    // ---- inclusive cumulative decay (a thread a channel) and the bonus
    //      diagonal (q . (u * k)), a thread a row
    if (tid < DK) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += sL[t * LD + tid];
        sL[t * LD + tid] = acc;
      }
      sAtot[tid] = acc;
      sEA[tid] = expf(acc);
    } else if (bonus) {
      for (int t = tid - DK; t < C; t += THREADS - DK) {
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < DK; ++d) {
          acc += (sQ[t * LD + d] * u[h * DK + d]) * sK[t * LD + d];
        }
        sDiag[t] = acc;
      }
    }
    __syncthreads();
    // ---- factors, in place: q e^A, k e^-A, k e^{Atot - A}
    for (int e = tid; e < C * DK; e += THREADS) {
      const int t = e / DK, d = e % DK;
      const float a = sL[t * LD + d];
      const float kv = sK[t * LD + d];
      sQ[t * LD + d] *= expf(a);
      sK[t * LD + d] = kv * expf(-a);
      sL[t * LD + d] = kv * expf(sAtot[d] - a);
    }
    __syncthreads();
    // ---- masked scores
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      float acc = 0.f;
      if (bonus ? s < t : s <= t) {
#pragma unroll 16
        for (int d = 0; d < DK; ++d) acc += sQ[t * LD + d] * sK[s * LD + d];
      }
      sSc[t * (C + 1) + s] = acc;
    }
    __syncthreads();
    // ---- y = scores v (+ diag v) + (q e^A) S
    for (int e = tid; e < C * W; e += THREADS) {
      const int t = e / W, j = e % W;
      float intra = 0.f;
#pragma unroll 16
      for (int s = 0; s < C; ++s) intra += sSc[t * (C + 1) + s] * sV[s * W + j];
      if (bonus) intra += sDiag[t] * sV[t * W + j];
      float inter = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) inter += sQ[t * LD + d] * sS[d * W + j];
      if (t0 + t < Tlen) {
        y[base_v + (t0 + t) * row_stride_v + j] = from_f32<T>(intra + inter);
      }
    }
    __syncthreads();
    // ---- state update: S = S e^{Atot} + (k e^{Atot - A})^T v
    for (int e = tid; e < DK * W; e += THREADS) {
      const int d = e / W, j = e % W;
      float acc = 0.f;
#pragma unroll 16
      for (int t = 0; t < C; ++t) acc += sL[t * LD + d] * sV[t * W + j];
      sS[e] = sS[e] * sEA[d] + acc;
    }
    __syncthreads();
  }

  if (s_out) {
    for (int e = tid; e < DK * W; e += THREADS) {
      const int d = e / W, j = e % W;
      s_out[state_base + static_cast<size_t>(d) * Dv + j] = sS[e];
    }
  }
}

template <typename T, int DK, int C>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int Tlen, int H, int Dv, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DK, C>() * 4;
  auto kernel = ssm_scan_kernel<T, DK, C>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Dv / W, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), Tlen, H, Dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK>
int by_chunk(int chunk, const void* q, const void* k, const void* v,
             const void* la, const void* u, const void* s0, void* y,
             void* s_out, int B, int Tlen, int H, int Dv, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch<T, DK, 16>(q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
    case 32: return launch<T, DK, 32>(q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
    case 64: return launch<T, DK, 64>(q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_dk(int Dk, int chunk, const void* q, const void* k, const void* v,
          const void* la, const void* u, const void* s0, void* y,
          void* s_out, int B, int Tlen, int H, int Dv, cudaStream_t st) {
  switch (Dk) {
    case 16: return by_chunk<T, 16>(chunk, q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
    case 32: return by_chunk<T, 32>(chunk, q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
    case 64: return by_chunk<T, 64>(chunk, q, k, v, la, u, s0, y, s_out, B, Tlen, H, Dv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched).  q, k, v and y
// are contiguous (B, T, H, D) of one type (dtype 0: f32, 1: bf16); log_a
// f32 like q; u (H, Dk) f32 or null (no bonus: the inclusive mask); s0 and
// s_out (B, H, Dk, Dv) f32 or null.  The wrapper (ssm_scan.py) has checked
// Dk, chunk in {16, 32, 64} and Dv a multiple of 16.
extern "C" int ssm_scan_launch(const void* q, const void* k, const void* v,
                               const void* log_a, const void* u,
                               const void* s0, void* y, void* s_out, int B,
                               int T, int H, int Dk, int Dv, int chunk,
                               int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_dk<float>(Dk, chunk, q, k, v, log_a, u, s0, y, s_out, B, T, H,
                        Dv, st);
  }
  if (dtype == 1) {
    return by_dk<__nv_bfloat16>(Dk, chunk, q, k, v, log_a, u, s0, y, s_out,
                                B, T, H, Dv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
