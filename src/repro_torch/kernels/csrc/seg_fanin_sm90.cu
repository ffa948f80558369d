// Segmented quorum fan-in for Hopper (sm_90a): warp-resident segments.
//
// Replaces repro/kernels/segfanin.py::_fanin_kernel
// (src/repro/kernels/segfanin.py:46), the TPU Pallas kernel of the batch
// backend's relay reply fan-in, which the step loop runs once a scan step.
// It computes what kernels/ref.py::_fanin_plain computes, bit for bit: for
// one burst row, with the slots cut into segments (maximal runs of equal
// segment id),
//
//     arr_s  = the row sorted by (segment, value, slot), so each segment's
//              values sit ascending in its own slots, ties in slot order
//     y_p    = arr_s_p + max(coef_p + vcoef * (arr_s_p - anchor), 0) + md1
//              - (p - lo) * c                (lo = the segment's first slot)
//     y_p    = -inf where arr_s_p is +inf (a masked slot)
//     out_i  = max { y_p : lo <= p <= min(lo + kcap_i, hi) }
//
// (hi = the segment's last slot), one rounding per operation in that order:
// the build passes -fmad=false so that nvcc contracts no multiply and add
// into an FMA.  With a segment-constant coef and kcap (the batch layout's)
// out_i is the capped segment max, as kernels/ref.py::seg_fanin_rows_ref
// computes it.
//
// Two entries share the code:
//
// - fanin_rows_kernel (segfanin.seg_fanin_rows): vals/coef (R, F) f32,
//   segid/kcap (C, F) int32 once per cell, scal (R, 4) f32 rows of
//   [vcoef, md1, c, anchor]; writes out (R, F).
// - fanin_groups_kernel (segfanin.FaninGroups, the step loop's route): the
//   gathers around the fan-in fused in.  It reads arr_back (R, F) f32 and
//   peer_mask (R, F) bool (a masked slot is +inf), B_r (R, G) f32 per group
//   (coef_p = B_r[grp[p]]), grp (C, F), gstart and kg (C, G) int32
//   (kcap_i = kg[grp[i]]), rho - 1, md1 and c_repl (C,) f32 and L1 (R,) f32
//   (the anchor), and writes mg (R, G): out at slot clamp(gstart[g], 0,
//   F - 1) for every group g, so a padded group of size 0 gets the m of the
//   segment that slot lies in, as torch.gather(m, 2, gread) does.
//
// What bounds it on this card: bytes, and below them the launch.  At
// N=1025's shape (384 rows x 1024 slots) the grouped entry reads 1.97 MB
// (arr_back 4 B and peer_mask 1 B a slot, the rest per group or cell):
// 0.6 us at 3.35 TB/s.  A warp's work is one 32-slot window: a 15-stage
// bitonic network and a 5-step scan, ~200 instructions, ~2.5 M for the
// whole call, ~2.7 us of issue across 132 SMs.
//
// Design:
//
// 1. Segments from the slots' own ids, in registers.  A warp takes a
//    32-slot window of one row, one slot a lane.  Each lane compares its
//    id with its neighbours' (shuffles; lanes 0 and 31 read one id more)
//    and two ballots mark the first and last slot of every run, so a lane
//    finds its segment's bounds with one __clz and one __ffs: no walk over
//    neighbours.  The ids, not gstart / sizes, define the runs because
//    they are what the plain version segments by: the padded tail of a
//    mixed grid's row (slots past the last group) is a run of its own or
//    joins the last group's, and the per-slot entry has no gstart at all.
// 2. Segments inside the window (every segment of the main path: 32 slots
//    at N=1025, 16 at N=257, 8 at R=3, 1 for Paxos) are sorted in
//    registers: a bitonic network over the warp on 64-bit keys
//    (segment start, value as ordered bits, lane), which keeps every
//    segment in its own lanes, ascending, ties in slot order, exactly
//    the plain version's two stable sorts.  Lane p then holds arr_s_p,
//    computes y_p, and a segmented scan by __shfl_up_sync gives the prefix
//    max that lane i reads at min(lo + kcap_i, hi).  -0 is ordered as +0
//    (value equality, as the sort compares) and comes back as +0.
// 3. Segments that cross a window (ragged layouts; PigPaxos at R=1, one
//    segment of F - 1 slots) take a second route through shared memory.
//    The block owns whole rows; every window stages its values and its
//    two run masks there, so a crossing lane finds its bounds by scanning
//    the masks and counts its rank over its segment; the value goes to
//    slot lo + rank, y is computed at each sorted slot, and each lane takes
//    the max of its capped prefix.  It is correct for any layout up to
//    F = 2048 (segfanin.F_MAX); a block skips it (__syncthreads_or) when
//    none of its windows has a crossing segment.
// 4. Several rows a block when rows are short: a block has
//    max(1, 8 / windows) rows and one warp a window, up to 32 warps (R=3:
//    8 rows of 24 slots a 256-thread block, 192 blocks instead of 1536
//    one-warp ones; N=1025: one row a 1024-thread block).
//
// TMA, cp.async and the tensor cores have nothing to do here: a row is at
// most 8 KB, read once with coalesced loads, and the work is compares.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise with the host, so a CUDA graph can capture them
// (chip_smoke's phase 4 replays 200 captured launches).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

// A value's bits in an order that compares like the float (-0 as +0).
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b ^ 0x80000000u) : ~b);
}

// The plain version's y at a sorted slot, one rounding per operation.
__device__ __forceinline__ float fanin_y(float v, float u, int rank,
                                         float vcoef, float md1, float c,
                                         float anchor) {
  float t = v - anchor;
  t = vcoef * t;
  t = u + t;
  t = fmaxf(t, 0.0f);
  float y = v + t;
  y = y + md1;
  const float rc = static_cast<float>(rank) * c;
  y = y - rc;
  return v < CUDART_INF_F ? y : -CUDART_INF_F;
}

// The per-slot entry's inputs.
struct RowsIn {
  const float* vals;
  const float* coef;
  const int* segid;
  const int* kcap;
  const float* scal;
  float* out;
  int F;
  __device__ int seg(int c, int j) const { return segid[c * F + j]; }
  __device__ float value(int r, int, int j) const { return vals[r * F + j]; }
  __device__ float coeff(int r, int, int j, int) const {
    return coef[r * F + j];
  }
  __device__ int cap(int c, int j, int) const { return kcap[c * F + j]; }
  __device__ void scalars(int r, int, float& vcoef, float& md1, float& c,
                          float& anchor) const {
    vcoef = scal[r * 4 + 0];
    md1 = scal[r * 4 + 1];
    c = scal[r * 4 + 2];
    anchor = scal[r * 4 + 3];
  }
  __device__ void emit(int r, int j, float m, float*) const {
    out[r * F + j] = m;
  }
};

// The grouped entry's inputs: the masked arrivals, the per-group coef and
// cap, per-cell scalars.
struct GroupsIn {
  const float* arr;
  const unsigned char* mask;
  const float* br;
  const int* grp;
  const int* gstart;
  const int* kg;
  const float* rm1;
  const float* md1;
  const float* crepl;
  const float* l1;
  float* out;
  int F, G;
  __device__ int seg(int c, int j) const { return grp[c * F + j]; }
  __device__ float value(int r, int, int j) const {
    const float a = arr[r * F + j];   // not behind the mask's load
    return mask[r * F + j] ? a : CUDART_INF_F;
  }
  __device__ float coeff(int r, int, int, int g) const {
    return br[r * G + g];
  }
  __device__ int cap(int c, int, int g) const { return kg[c * G + g]; }
  __device__ void scalars(int r, int c, float& vcoef, float& m, float& cc,
                          float& anchor) const {
    vcoef = rm1[c];
    m = md1[c];
    cc = crepl[c];
    anchor = l1[r];
  }
  __device__ void emit(int, int j, float m, float* sm_row) const {
    sm_row[j] = m;   // read back per group once the block is done
  }
};

// First slot of the run holding slot w * 32 + lane, from the staged
// first-slot masks of the row's windows (slot 0 always starts a run).
__device__ __forceinline__ int run_lo(const unsigned* first, int w, int lane) {
  unsigned b = first[w] & (kFull >> (31 - lane));
  while (!b) b = first[--w];
  return w * 32 + 31 - __clz(b);
}

// Last slot of that run (slot F - 1 always ends one).
__device__ __forceinline__ int run_hi(const unsigned* last, int w, int lane) {
  unsigned b = last[w] & (kFull << lane);
  while (!b) b = last[++w];
  return w * 32 + __ffs(b) - 1;
}

// Shared memory of a block: v (then y), the sorted values and m, each
// rows_per_block x windows x 32 floats, and two run masks a window.
__host__ __device__ inline int fanin_smem_bytes(int F, int rows_per_block) {
  const int W = (F + 31) / 32;
  return rows_per_block * W * (3 * 32 * 4 + 2 * 4);
}

// n / d, by a shift where the launcher found d a power of two (shift >= 0)
__device__ __forceinline__ int divide(int n, int d, int shift) {
  return shift >= 0 ? n >> shift : n / d;
}

template <class In, bool kGrouped>
__device__ void fanin_block(const In& in, int R, int F, int rows_per_cell,
                            int rows_per_block, int cell_shift,
                            int window_shift) {
  extern __shared__ float smem[];
  const int W = (F + 31) >> 5;                 // windows a row
  const int S = W * 32;                        // a row's stride in shared
  const int items = rows_per_block * W;
  float* sv = smem;                            // values, then y (route 3)
  float* ss = sv + rows_per_block * S;         // values in sorted order
  float* sm = ss + rows_per_block * S;         // m per slot (grouped)
  unsigned* sfirst = reinterpret_cast<unsigned*>(sm + rows_per_block * S);
  unsigned* slast = sfirst + items;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * rows_per_block;

  // ---- phase 1: every window; segments inside it in registers
  bool crossing = false;
  for (int it = warp; it < items; it += nwarps) {
    const int rl = divide(it, W, window_shift), w = it - rl * W;
    const int r = r0 + rl;
    if (r >= R) break;                         // warp-uniform; rows ascend
    const int c = divide(r, rows_per_cell, cell_shift);
    const int j = w * 32 + lane;
    const bool live = j < F;
    // every load first, so that their latencies overlap the network
    const int sid = live ? in.seg(c, j) : -1;
    const float v = live ? in.value(r, c, j) : CUDART_INF_F;
    const int left = lane == 0 && live && j > 0 ? in.seg(c, j - 1) : 0;
    const int right = lane == 31 && j + 1 < F ? in.seg(c, j + 1) : 0;
    const float u = live ? in.coeff(r, c, j, sid) : 0.f;
    const int kc = live ? in.cap(c, j, sid) : 0;
    float vcoef, md1, cc, anchor;
    in.scalars(r, c, vcoef, md1, cc, anchor);
    const int prev = __shfl_up_sync(kFull, sid, 1);
    const int next = __shfl_down_sync(kFull, sid, 1);
    const bool first = live && (j == 0 || (lane == 0 ? left : prev) != sid);
    const bool last =
        live && (j == F - 1 || (lane == 31 ? right : next) != sid);
    const unsigned fw = __ballot_sync(kFull, first);
    const unsigned lw = __ballot_sync(kFull, last);
    const unsigned fb = fw & (kFull >> (31 - lane));   // starts at <= lane
    const unsigned la = lw & (kFull << lane);          // ends at >= lane
    const bool inwin = live && fb && la;
    if (lane == 0) {
      sfirst[it] = fw;
      slast[it] = lw;
    }
    sv[rl * S + j] = v;
    crossing |= live && !inwin;
    if (!__any_sync(kFull, inwin)) continue;
    // run start inside the window (0 for a run from an earlier window, 32
    // for a dead lane): the key's high field keeps every run in its lanes
    const int lo = fb ? 31 - __clz(fb) : 0;
    const int hi = la ? __ffs(la) - 1 : 31;
    uint64_t key = live ? (static_cast<uint64_t>(lo) << 40) |
                              (static_cast<uint64_t>(ordered_bits(v)) << 8) |
                              static_cast<uint64_t>(lane)
                        : ~0ull;
    // K: the smallest aligned block of lanes that holds every in-window
    // segment (8 at R=3, 16 at N=257, 1 for Paxos); the network sorts each
    // K-block ascending and stops there.  Keys are distinct (the lane is in
    // them): a lane takes its partner's key when that one belongs on its
    // side of the pair
    const unsigned span =
        __reduce_max_sync(kFull, inwin ? static_cast<unsigned>(lo ^ hi) : 0u);
    const int K = span ? 1 << (32 - __clz(span)) : 1;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
      if (k > K) break;
#pragma unroll
      for (int d = k >> 1; d > 0; d >>= 1) {
        const uint64_t o = __shfl_xor_sync(kFull, key, d);
        const bool up = k == K || (lane & k) == 0;
        const bool keep_min = up == ((lane & d) == 0);
        key = ((o < key) == keep_min) ? o : key;
      }
    }
    const float vs = from_ordered_bits(static_cast<unsigned>(key >> 8));
    float y = live ? fanin_y(vs, u, lane - lo, vcoef, md1, cc, anchor)
                   : -CUDART_INF_F;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d >= K) break;                       // a segment spans < K lanes
      const float o = __shfl_up_sync(kFull, y, d);
      if (lane - d >= lo) y = fmaxf(y, o);
    }
    const int src = lo + min(max(kc, 0), hi - lo);
    const float m = __shfl_sync(kFull, y, src & 31);
    if (inwin) in.emit(r, j, m, sm + rl * S);
  }

  // ---- route 3: segments that cross a window, through shared memory
  if (__syncthreads_or(crossing)) {
    // rank of each crossing slot; its value goes to its sorted slot
    for (int it = warp; it < items; it += nwarps) {
      const int rl = divide(it, W, window_shift), w = it - rl * W;
      if (r0 + rl >= R) break;
      const int j = w * 32 + lane;
      const unsigned* fr = sfirst + rl * W;
      const unsigned* lr = slast + rl * W;
      if (j >= F || ((fr[w] & (kFull >> (31 - lane))) &&
                     (lr[w] & (kFull << lane))))
        continue;
      const int lo = run_lo(fr, w, lane), hi = run_hi(lr, w, lane);
      const float* row = sv + rl * S;
      const float v = row[j];
      int rank = 0;
      for (int k = lo; k <= hi; ++k) {
        const float o = row[k];
        rank += (o < v || (o == v && k < j)) ? 1 : 0;
      }
      ss[rl * S + lo + rank] = v;
    }
    __syncthreads();
    // y at each sorted slot (into sv: the ranks are counted)
    for (int it = warp; it < items; it += nwarps) {
      const int rl = divide(it, W, window_shift), w = it - rl * W;
      const int r = r0 + rl;
      if (r >= R) break;
      const int c = divide(r, rows_per_cell, cell_shift);
      const int j = w * 32 + lane;
      const unsigned* fr = sfirst + rl * W;
      const unsigned* lr = slast + rl * W;
      if (j >= F || ((fr[w] & (kFull >> (31 - lane))) &&
                     (lr[w] & (kFull << lane))))
        continue;
      const int lo = run_lo(fr, w, lane);
      float vcoef, md1, cc, anchor;
      in.scalars(r, c, vcoef, md1, cc, anchor);
      sv[rl * S + j] = fanin_y(ss[rl * S + j], in.coeff(r, c, j, in.seg(c, j)),
                               j - lo, vcoef, md1, cc, anchor);
    }
    __syncthreads();
    // each slot's capped prefix max
    for (int it = warp; it < items; it += nwarps) {
      const int rl = divide(it, W, window_shift), w = it - rl * W;
      const int r = r0 + rl;
      if (r >= R) break;
      const int c = divide(r, rows_per_cell, cell_shift);
      const int j = w * 32 + lane;
      const unsigned* fr = sfirst + rl * W;
      const unsigned* lr = slast + rl * W;
      if (j >= F || ((fr[w] & (kFull >> (31 - lane))) &&
                     (lr[w] & (kFull << lane))))
        continue;
      const int lo = run_lo(fr, w, lane), hi = run_hi(lr, w, lane);
      const int e = lo + min(max(in.cap(c, j, in.seg(c, j)), 0), hi - lo);
      float m = -CUDART_INF_F;
      for (int k = lo; k <= e; ++k) m = fmaxf(m, sv[rl * S + k]);
      in.emit(r, j, m, sm + rl * S);
    }
    __syncthreads();
  }

  // ---- grouped entry: each group's m at its read slot
  if constexpr (kGrouped) {
    const int G = in.G;
    for (int t = threadIdx.x; t < rows_per_block * G; t += blockDim.x) {
      const int rl = t / G, g = t - rl * G;
      const int r = r0 + rl;
      if (r >= R) break;
      const int c = divide(r, rows_per_cell, cell_shift);
      const int p = min(max(in.gstart[c * G + g], 0), F - 1);
      in.out[r * G + g] = sm[rl * S + p];
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    fanin_rows_kernel(RowsIn in, int R, int F, int rows_per_cell,
                      int rows_per_block, int cell_shift, int window_shift) {
  fanin_block<RowsIn, false>(in, R, F, rows_per_cell, rows_per_block,
                             cell_shift, window_shift);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    fanin_groups_kernel(GroupsIn in, int R, int F, int rows_per_cell,
                        int rows_per_block, int cell_shift,
                        int window_shift) {
  fanin_block<GroupsIn, true>(in, R, F, rows_per_cell, rows_per_block,
                              cell_shift, window_shift);
}

// log2(d) for a power of two, else -1 (the kernel then divides)
int pow2_shift(int d) {
  if (d <= 0 || (d & (d - 1))) return -1;
  int s = 0;
  while ((1 << s) < d) ++s;
  return s;
}

// The floor a launch cannot go under (chip_smoke times it in a graph).
__global__ void fanin_empty_kernel() {}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// rows_per_block and warps come from segfanin.geometry(F); the block's
// shared memory (at most 25,088 B at F = 2048) needs no opt-in.
extern "C" int seg_fanin_sm90_rows_launch(const void* vals, const void* coef,
                                          const void* segid, const void* kcap,
                                          const void* scal, void* out,
                                          int rows, int F, int rows_per_cell,
                                          int rows_per_block, int warps,
                                          void* stream) {
  RowsIn in{static_cast<const float*>(vals), static_cast<const float*>(coef),
            static_cast<const int*>(segid), static_cast<const int*>(kcap),
            static_cast<const float*>(scal), static_cast<float*>(out), F};
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  fanin_rows_kernel<<<blocks, warps * 32,
                      fanin_smem_bytes(F, rows_per_block),
                      static_cast<cudaStream_t>(stream)>>>(
      in, rows, F, rows_per_cell, rows_per_block, pow2_shift(rows_per_cell),
      pow2_shift((F + 31) / 32));
  return static_cast<int>(cudaGetLastError());
}

// What a grid's grouped fan-in keeps from call to call (segfanin.FaninGroups
// fills it once), so that a step's call passes its own tensors alone.
struct FaninPlan {
  const int* grp;
  const int* gstart;
  const int* kg;
  int rows, F, G, rows_per_cell, rows_per_block, warps;
};

extern "C" int seg_fanin_sm90_groups_launch(const FaninPlan* plan,
                                            const void* arr, const void* mask,
                                            const void* br, const void* rm1,
                                            const void* md1, const void* crepl,
                                            const void* l1, void* out,
                                            void* stream) {
  const FaninPlan& p = *plan;
  GroupsIn in{static_cast<const float*>(arr),
              static_cast<const unsigned char*>(mask),
              static_cast<const float*>(br), p.grp, p.gstart, p.kg,
              static_cast<const float*>(rm1), static_cast<const float*>(md1),
              static_cast<const float*>(crepl), static_cast<const float*>(l1),
              static_cast<float*>(out), p.F, p.G};
  const int blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  fanin_groups_kernel<<<blocks, p.warps * 32,
                        fanin_smem_bytes(p.F, p.rows_per_block),
                        static_cast<cudaStream_t>(stream)>>>(
      in, p.rows, p.F, p.rows_per_cell, p.rows_per_block,
      pow2_shift(p.rows_per_cell), pow2_shift((p.F + 31) / 32));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_fanin_sm90_empty_launch(void* stream) {
  fanin_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_fanin_sm90_smem_bytes(int F, int rows_per_block) {
  return fanin_smem_bytes(F, rows_per_block);
}
