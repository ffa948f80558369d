// Segmented quorum fan-in for Hopper (sm_90a).
//
// Replaces repro/kernels/segfanin.py::_fanin_kernel, the TPU Pallas kernel
// of the batch backend's relay reply fan-in.  For one burst row and every
// flat follower slot i it computes
//
//     rank_j = #{k in seg(j) : v_k < v_j  or  (v_k == v_j and k < j)}
//     y_j    = v_j + max(coef_j + vcoef * (v_j - anchor), 0) + md1 - rank_j * c
//     out_i  = max { y_j : j in seg(i), rank_j <= kcap_i, v_j < +inf }
//
// (-inf when that set is empty).  The tie-break is the stable (value, index)
// order of the reference's two-key sort, so ranks equal sorted positions.
//
// What bounds it on this card: bytes.  Per row it reads 2F f32 (vals, coef)
// and writes F f32; per cell it reads 2F int32 (segid, kcap) and per row one
// (4,) f32 scalar row.  The arithmetic is O(F * S) compares for segments of
// S slots (S <= 32 at N=1025/R=32), far below the memory time.
//
// Design: one thread block per row (row = cell * rows_per_cell + b).  The
// block stages the row's vals/coef and its cell's segid/kcap in shared
// memory.  Segments are contiguous runs of equal segid (the precondition
// the batch layout guarantees), so each slot finds its segment bounds by
// walking its neighbours and compares only inside the segment: O(F * S)
// work instead of the TPU kernel's dense O(F^2) compare matrix.  Slots are
// strided over the block, so F may exceed blockDim.  Build with -fmad=false:
// otherwise nvcc contracts u + vcoef*(v-anchor) and rank*c into FMAs and
// the result stops matching the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void seg_fanin_kernel(const float* __restrict__ vals,
                                 const float* __restrict__ coef,
                                 const int* __restrict__ segid,
                                 const int* __restrict__ kcap,
                                 const float* __restrict__ scal,
                                 float* __restrict__ out,
                                 int F, int rows_per_cell) {
  extern __shared__ float smem[];
  float* sv = smem;                                   // vals   (F)
  float* su = sv + F;                                 // coef   (F)
  float* sy = su + F;                                 // y      (F)
  int* ss = reinterpret_cast<int*>(sy + F);           // segid  (F)
  int* sk = ss + F;                                   // kcap   (F)
  int* sr = sk + F;                                   // rank   (F)

  const long long row = blockIdx.x;
  const long long cell = row / rows_per_cell;
  const float* v_row = vals + row * F;
  const float* u_row = coef + row * F;
  const int* s_cell = segid + cell * F;
  const int* k_cell = kcap + cell * F;
  const float vcoef = scal[row * 4 + 0];
  const float md1 = scal[row * 4 + 1];
  const float c = scal[row * 4 + 2];
  const float anchor = scal[row * 4 + 3];

  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    sv[i] = v_row[i];
    su[i] = u_row[i];
    ss[i] = s_cell[i];
    sk[i] = k_cell[i];
  }
  __syncthreads();

  // rank and transformed value of every slot, counted inside its segment
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const int s = ss[i];
    int lo = i;
    while (lo > 0 && ss[lo - 1] == s) --lo;
    int hi = i + 1;
    while (hi < F && ss[hi] == s) ++hi;
    const float vi = sv[i];
    int rank = 0;
    for (int j = lo; j < hi; ++j) {
      const float vj = sv[j];
      rank += (vj < vi || (vj == vi && j < i)) ? 1 : 0;
    }
    sr[i] = rank;
    // the plain version's operation order, one rounding per operation
    float t = vi - anchor;
    t = vcoef * t;
    t = su[i] + t;
    t = fmaxf(t, 0.0f);
    float y = vi + t;
    y = y + md1;
    const float rc = static_cast<float>(rank) * c;
    sy[i] = y - rc;
  }
  __syncthreads();

  // capped segment max
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const int s = ss[i];
    int lo = i;
    while (lo > 0 && ss[lo - 1] == s) --lo;
    int hi = i + 1;
    while (hi < F && ss[hi] == s) ++hi;
    const int cap = sk[i];
    float m = -CUDART_INF_F;
    for (int j = lo; j < hi; ++j) {
      if (sr[j] <= cap && sv[j] < CUDART_INF_F) m = fmaxf(m, sy[j]);
    }
    out[row * F + i] = m;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// block's shared memory is six F-slot arrays (segfanin.smem_bytes checks
// it against the 48 KB a launch gets without opting in).
extern "C" int seg_fanin_launch(const void* vals, const void* coef,
                                const void* segid, const void* kcap,
                                const void* scal, void* out, int rows, int F,
                                int rows_per_cell, int threads, void* stream) {
  const size_t smem = 6 * static_cast<size_t>(F) * sizeof(float);
  seg_fanin_kernel<<<rows, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(coef),
      static_cast<const int*>(segid), static_cast<const int*>(kcap),
      static_cast<const float*>(scal), static_cast<float*>(out), F,
      rows_per_cell);
  return static_cast<int>(cudaGetLastError());
}
