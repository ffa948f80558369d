// Pig relay aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/pig_aggregate.py::_agg_kernel, the TPU Pallas
// kernel that the quantized Pig schedule's relay runs on what the other
// pods sent it: G int8 shards with one f32 scale per block of `block`
// elements, dequantized and summed in one pass,
//
//     out[n] = sum_g float(shards[g, n]) * scales[g, n / block],
//
// so the dequantized f32 copies never reach device memory.
//
// What bounds it on this card: bytes.  Per element it reads G int8 and
// writes one f32 (at G = 2: 2 bytes in, 4 out), plus G f32 scales per
// block; it does 2G flops per element, far below the memory time.
//
// Design: a grid-stride loop in which each thread owns 16 contiguous
// outputs.  For each g it makes one 16-byte load of the int8 row and reads
// that row's scale once (block % 16 == 0, so the 16 elements share one
// block), then writes its 16 sums as four float4 stores.  The sum starts
// from 0.0f and runs over g in ascending order, as the plain version's
// loop does (so a -0 product gives +0 alike).  Build with -fmad=false:
// otherwise nvcc contracts acc + q * s into an FMA and the result stops
// matching the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPerThread = 16;

__global__ void pig_aggregate_kernel(const int8_t* __restrict__ shards,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, int G,
                                     long long N, int block) {
  const long long chunks = N / kPerThread;
  const long long nb = N / block;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < chunks; c += stride) {
    const long long n0 = c * kPerThread;
    const long long b = n0 / block;
    float acc[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
    for (int g = 0; g < G; ++g) {
      const int4 raw =
          __ldg(reinterpret_cast<const int4*>(shards + g * N + n0));
      const float s = __ldg(scales + g * nb + b);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        acc[j] = acc[j] + static_cast<float>(q[j]) * s;
      }
    }
    float4* o = reinterpret_cast<float4*>(out + n0);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      o[w] = make_float4(acc[4 * w], acc[4 * w + 1], acc[4 * w + 2],
                         acc[4 * w + 3]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// wrapper (pig_aggregate.py) has checked N % block == 0, block % 16 == 0
// and 16-byte alignment of both pointers.
extern "C" int pig_aggregate_launch(const void* shards, const void* scales,
                                    void* out, int G, long long N, int block,
                                    int blocks, int threads, void* stream) {
  pig_aggregate_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(shards), static_cast<const float*>(scales),
      static_cast<float*>(out), G, N, block);
  return static_cast<int>(cudaGetLastError());
}
