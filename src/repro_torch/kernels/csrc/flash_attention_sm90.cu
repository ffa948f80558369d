// Causal flash attention with GQA for Hopper (sm_90a): wgmma, TMA, mbarriers.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel
// (src/repro/kernels/flash_attention.py:22), the TPU Pallas kernel that the
// dense models' prefill runs once per layer (models/layers.py, impl="flash"),
// for bf16 at head dims 64, 128 and 256; flash_attention.cu keeps f32 and
// Dh 32.  For q (B, Hq, Sq, Dh) and k, v (B, Hkv, Sk, Dh), each held by a
// 4-D tensor map of dims (Dh, S, H, B) with byte strides, it computes for
// every query head h (reading KV head h / (Hq / Hkv))
//
//     s[i, j] = q[i] . k[j]                                (-1e30 where masked)
//     p[i, j] = 2^(s[i, j] sm_scale log2(e) - m_i)
//     o[i]    = sum_j (hi(p) + lo(p))[i, j] v[j] / max(l_i, 1e-30)
//
// with the causal mask j <= i (top-left aligned) or none, the online
// softmax's running max m and sum l in f32 (l sums the f32 p), products
// accumulated in f32, and o rounded once to bf16 (nearest even).  hi(p) is
// p rounded to bf16 and lo(p) the rest rounded to bf16: ~16 bits of p.
//
// What bounds it on this card: operations.  Granite-8b's prefill (B 4,
// Hq 32, Dh 128, S 2048) needs 4 B Hq Dh S (S + 1) / 2 = 1.38e11 operations,
// 0.139 ms at the tensor cores' 989 TFLOP/s bf16; its bytes (168 MB) take
// 0.050 ms at 3.35 TB/s.  What the design does about each fault of the
// CUDA-core kernel in flash_attention.cu:
//
// 1. Tensor cores: both products are wgmma.mma_async with f32 accumulators.
//    S = Q K^T reads Q and K from shared memory (K-major); O += P V takes P
//    from registers (the S accumulator's fragment is the k16 A fragment of
//    the next product, so P never touches shared memory) and V from shared
//    memory as the MN-major (transposed) B operand.
// 2. Tiles stay bf16 in shared memory, in the 128-byte swizzle that TMA
//    writes and the wgmma descriptors name: Q (128 rows) + 2 stages of K and
//    V (64 keys) = 96 KB at Dh 128, 192 KB at Dh 256.
// 3. Loads overlap compute: one producer thread starts the TMA loads into the
//    ring of stages, with a full mbarrier per tile (K and V apart, so Q K^T
//    starts before V lands) and an empty mbarrier that the eight consumer
//    warps release; the two consumer warpgroups (64 query rows each)
//    interleave their products and softmax on the SM.  setmaxnreg moves
//    registers from the producer warpgroup (40) to the consumers (232).
//    (More stages, a ping-pong of the two warpgroups on named barriers and
//    FA3's overlap of one tile's softmax with the last tile's P V were all
//    no faster on the H100: the last two spill at 232 registers.)
// 4. P is converted in registers, as bf16 hi + lo for two products: one
//    bf16 P (2^-9 relative per probability) moved outputs that cancel to
//    near 0 by ~4e-3, over the port's 2e-3 + 1.6e-2 |o| bound; the split
//    costs half again the products.  l is summed from the f32 p.
// 5. Layout by strides: the tensor maps read (B, H, S, Dh) and the model's
//    (B, S, H, Dh) alike, so no transpose is made outside the kernel.  Rows
//    past S load as zeros (TMA's out-of-bounds fill), keys past Sk are
//    masked, and the output tile leaves by a TMA store that drops rows past
//    Sq.
//
// Softmax works on the accumulator fragment: the running max is kept in
// units of log2, so sm_scale log2(e) enters as one FFMA a score before
// ex2.approx; a row's values sit in the four lanes of a quad, which reduce
// the row max with two shuffles; each thread keeps its partial l, summed
// over the quad once at the end.  The masks are applied only on tiles that
// need them (the diagonal tiles and the last key tile).  Each block (128 query rows, head, batch) loops over key tiles up
// to its diagonal; the 1-D grid runs the heaviest query tiles first, with
// the heads of a KV group adjacent so that their K/V tiles meet in L2.  An
// mbarrier wait that outlasts 4 s traps, so that a lost transfer fails the
// launch instead of hanging the card.
//
// Registers (ptxas -v, CUDA 12.9): a consumer thread holds O (Dh / 2 f32),
// S (32 f32) and P hi + lo (32 words).  At Dh 64 and 128 that fits the
// consumers' 232 with no spills.  At Dh 256, off the dense models' main
// path (O alone is 128 registers), ptxas spills ~450 bytes and serializes
// the wgmmas.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;   // query rows per block: 2 warpgroups x 64
constexpr int THREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int ROW_BYTES = 128; // one swizzled row: 64 bf16 columns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// the launcher's own errors, beyond CUDA's codes
constexpr int ENCODE_UNAVAILABLE = 9999;  // no cuTensorMapEncodeTiled
constexpr int ENCODE_FAILED = 10000;      // plus the CUresult

constexpr int BN = 64;         // keys per tile
constexpr int STAGES = 2;      // K/V tiles in flight

template <int DH>
struct Tile {
  static constexpr int CB = DH / 64;                    // 64-column blocks
  static constexpr int Q_BYTES = BLOCK_M * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;
  // tiles, then 1 + 3 STAGES mbarriers, plus room to align to 1024 bytes
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 128 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo) << 16)
         | (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until this warpgroup's committed products are done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 64) += A (64 x 16, shared) . B (64 x 16, shared), both K-major;
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256) += A (64 x 16, registers) . B (16 x 256, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// 2^x, one MUFU instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two probabilities as bf16 pairs hi + lo: hi rounds them (nearest even),
// lo rounds what hi leaves (exact in f32), so hi + lo carries ~16 bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - back.x, b - back.y);
}

// An address the compiler cannot see through, so that what is derived from
// it (the wgmma descriptors) is computed in the loop, not hoisted out of it
// into registers for every k-step and stage.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The shared-memory layout of a block: Q (BLOCK_M rows), STAGES K tiles,
// STAGES V tiles (each in 64-column blocks of 128-byte swizzled rows), then
// the mbarriers.
template <int DH>
struct Smem {
  using T = Tile<DH>;
  uint32_t q, k, v, bars;
  __device__ __forceinline__ explicit Smem(uint32_t base)
      : q(base), k(base + T::Q_BYTES),
        v(base + T::Q_BYTES + STAGES * T::KV_BYTES),
        bars(base + T::Q_BYTES + 2 * STAGES * T::KV_BYTES) {}
  __device__ __forceinline__ uint32_t q_full() const { return bars; }
  __device__ __forceinline__ uint32_t k_full(int s) const {
    return bars + 8 * (1 + s);
  }
  __device__ __forceinline__ uint32_t v_full(int s) const {
    return bars + 8 * (1 + STAGES + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (1 + 2 * STAGES + s);
  }
};

// A consumer warpgroup: 64 query rows, their O, m and l in registers.
template <int DH>
struct Consumer {
  using T = Tile<DH>;
  Smem<DH> sm;
  uint32_t s_qw;             // this warpgroup's 64 rows of Q
  int Sk, causal, wg_row, row0, quad, lane;
  float scale_log2;
  float o[DH / 2];
  float sc[BN / 2];          // S of one tile
  float m0, m1, l0, l1;      // rows r and r + 8 of the thread

  // S = Q K^T of tile t into sc, started and committed: DH / 16 k-steps of
  // 16 columns (32 bytes), a descriptor advancing by its offset in 16-byte
  // units.  (sc starts at 0: the first k-step overwrites it, but the asm
  // reads it; the fence orders that write before the products.)
  __device__ __forceinline__ void start_qk(int t) {
    const int s = t % STAGES;
    mbar_wait(sm.k_full(s), (t / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    const uint64_t q_desc = sw128_desc(opaque(s_qw), 1, 64);
    const uint64_t k_desc = sw128_desc(opaque(sm.k + s * T::KV_BYTES), 1, 64);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t q_off = (kk / 4) * BLOCK_M * ROW_BYTES + (kk % 4) * 32;
      const uint32_t k_off = (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss(sc, q_desc + (q_off >> 4), k_desc + (k_off >> 4), kk > 0);
    }
    wgmma_commit();
  }

  // O += P_hi V + P_lo V of tile t, started and committed (after a fence
  // that orders the writes of O and P before the products): BN / 16 k-steps
  // of 16 keys (2048 bytes of V); V's 64-column blocks lie BN rows apart
  // (the leading byte offset)
  __device__ __forceinline__ void start_pv(int t, const uint32_t* p_hi,
                                           const uint32_t* p_lo) {
    const int s = t % STAGES;
    mbar_wait(sm.v_full(s), (t / STAGES) & 1);
    const uint64_t v_desc = sw128_desc(opaque(sm.v + s * T::KV_BYTES),
                                       BN * ROW_BYTES / 16, 64);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs(o, p_hi + 4 * kk, v_desc + kk * 16 * ROW_BYTES / 16);
      wgmma_rs(o, p_lo + 4 * kk, v_desc + kk * 16 * ROW_BYTES / 16);
    }
    wgmma_commit();
  }

  // this warp is done with tile t's stage
  __device__ __forceinline__ void release(int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(t % STAGES));
  }

  // Online softmax of tile t on the fragment (sc[4i + e] is row
  // r + 8 (e / 2), column k0 + 8i + 2 quad + (e % 2)), P into p_hi, p_lo;
  // returns the rows' rescale factors of O in a0, a1.  m is kept in units
  // of log2, so the scale is one FFMA a score.
  __device__ __forceinline__ void softmax(int t, uint32_t* p_hi,
                                          uint32_t* p_lo, float& a0,
                                          float& a1) {
    const int k0 = t * BN;
    const bool mask = k0 + BN > Sk || (causal && k0 + BN - 1 > wg_row);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (mask) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * i + 2 * quad + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) sc[4 * i + e] = NEG_INF;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float p0 = ex2(fmaf(sc[4 * i], scale_log2, -m0));
      const float p1 = ex2(fmaf(sc[4 * i + 1], scale_log2, -m0));
      const float p2 = ex2(fmaf(sc[4 * i + 2], scale_log2, -m1));
      const float p3 = ex2(fmaf(sc[4 * i + 3], scale_log2, -m1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      split_bf16(p0, p1, p_hi[2 * i], p_lo[2 * i]);
      split_bf16(p2, p3, p_hi[2 * i + 1], p_lo[2 * i + 1]);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  }

  __device__ __forceinline__ void rescale(float a0, float a1) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
  }

  // Tiles 0..nw-1 (those at or below the warpgroup's diagonal), each
  // Q K^T, softmax, P V in turn, then the release of tiles nw..nt-1, which
  // it never reads.  The other consumer warpgroup's products fill the
  // tensor cores while this one works its softmax.
  __device__ __forceinline__ void run(int nw, int nt) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    m0 = m1 = NEG_INF;
    l0 = l1 = 0.f;
    // P as bf16 hi + lo: the accumulator's columns 16kk..16kk+15 are the
    // k16 A fragment of k-step kk
    uint32_t p_hi[BN / 4], p_lo[BN / 4];
    mbar_wait(sm.q_full(), 0);
    for (int t = 0; t < nw; ++t) {
      start_qk(t);
      wgmma_wait_all();
      fence_regs(sc);
      float a0, a1;
      softmax(t, p_hi, p_lo, a0, a1);
      rescale(a0, a1);
      fence_regs(o);
      start_pv(t, p_hi, p_lo);
      wgmma_wait_all();
      fence_regs(o);
      release(t);
    }
    for (int t = nw; t < nt; ++t) {
      // wait for the load (the stage's phases stay in order), then release
      mbar_wait(sm.v_full(t % STAGES), (t / STAGES) & 1);
      release(t);
    }
  }

  // o / max(l, 1e-30) in bf16 into this warpgroup's Q rows (the same
  // swizzle), then one TMA store per 64-column block; r is the thread's
  // first row in the warpgroup
  __device__ __forceinline__ void store(const CUtensorMap* tm_o, int r,
                                        int wg, int h, int b) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const uint32_t blk = s_qw + (i / 8) * BLOCK_M * ROW_BYTES;
      const uint32_t chunk = ((i % 8) ^ (r % 8)) * 16 + 4 * quad;
      const uint32_t lo = pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
      const uint32_t hi = pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(blk + r * ROW_BYTES + chunk), "r"(lo) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(blk + (r + 8) * ROW_BYTES + chunk), "r"(hi)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int j = 0; j < T::CB; ++j)
        tma_store(tm_o, s_qw + j * BLOCK_M * ROW_BYTES, 64 * j, wg_row, h,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
};

// One block per (128 query rows, query head, batch).  Threads 0-127 are the
// producer warpgroup (thread 0 starts every TMA load); 128-383 are two
// consumer warpgroups of 64 query rows each.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int B, int Hq,
                   int Hkv, int Sq, int Sk, int causal, float scale_log2) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const Smem<DH> sm((smem_addr(smem_raw) + 1023) & ~1023u);

  // heads fastest, then batch, then query tiles from the last (the most
  // keys) to the first
  const int nq = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int h = blockIdx.x % Hq;
  const int b = (blockIdx.x / Hq) % B;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / Hq) / B) * BLOCK_M;
  const int hk = h / (Hq / Hkv);
  const int kend = causal ? min(Sk, q0 + BLOCK_M) : Sk;
  const int nt = (kend + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.empty(s), 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform for the compiler (a shuffle from
  // lane 0), so that each role's branch runs under its own register count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.q_full(), T::Q_BYTES);
      for (int j = 0; j < T::CB; ++j)
        tma_load(sm.q + j * BLOCK_M * ROW_BYTES, &tm_q, sm.q_full(), 64 * j,
                 q0, h, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(sm.empty(s), ((t / STAGES) - 1) & 1);
        const uint32_t k_dst = sm.k + s * T::KV_BYTES;
        const uint32_t v_dst = sm.v + s * T::KV_BYTES;
        mbar_expect_tx(sm.k_full(s), T::KV_BYTES);
        for (int j = 0; j < T::CB; ++j)
          tma_load(k_dst + j * BN * ROW_BYTES, &tm_k, sm.k_full(s), 64 * j,
                   t * BN, hk, b);
        mbar_expect_tx(sm.v_full(s), T::KV_BYTES);
        for (int j = 0; j < T::CB; ++j)
          tma_load(v_dst + j * BN * ROW_BYTES, &tm_v, sm.v_full(s), 64 * j,
                   t * BN, hk, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = role - 1;                      // consumer warpgroup 0, 1
    const int tid = threadIdx.x % 128;
    const int r = 16 * (tid / 32) + (tid % 32) / 4;   // rows r, r + 8
    Consumer<DH> c{sm};
    c.s_qw = sm.q + 64 * wg * ROW_BYTES;
    c.Sk = Sk;
    c.causal = causal;
    c.wg_row = q0 + 64 * wg;
    c.row0 = c.wg_row + r;
    c.lane = tid % 32;
    c.quad = tid % 4;
    c.scale_log2 = scale_log2;
    // tiles from nw on lie above this warpgroup's diagonal
    const int nw = causal ? min(nt, (c.wg_row + 64 + BN - 1) / BN) : nt;
    c.run(nw, nt);
    c.store(&tm_o, r, wg, h, b);
  }
}

// ----------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// geom: (Dh, S, H, B) and the byte strides of S, H and B
int encode(CUtensorMap* map, const void* ptr, const long long* geom,
           int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_UNAVAILABLE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(geom[0]),
                              static_cast<cuuint64_t>(geom[1]),
                              static_cast<cuuint64_t>(geom[2]),
                              static_cast<cuuint64_t>(geom[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(geom[4]),
                                 static_cast<cuuint64_t>(geom[5]),
                                 static_cast<cuuint64_t>(geom[6])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* geom, int B, int Hq, int Hkv, int Sq, int Sk,
           int causal, float sm_scale, cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap maps[4];
  int err = encode(&maps[0], q, geom, BLOCK_M);
  if (!err) err = encode(&maps[1], k, geom + 7, BN);
  if (!err) err = encode(&maps[2], v, geom + 14, BN);
  if (!err) err = encode(&maps[3], o, geom + 21, 64);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long blocks =
      static_cast<long long>((Sq + BLOCK_M - 1) / BLOCK_M) * Hq * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_wgmma_kernel<DH><<<static_cast<unsigned>(blocks), THREADS, T::SMEM,
                           stream>>>(maps[0], maps[1], maps[2], maps[3], B,
                                     Hq, Hkv, Sq, Sk, causal,
                                     sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns 0, a CUDA error, or ENCODE_FAILED plus the
// CUresult when a tensor map cannot be encoded.  bf16 only; Dh must be 64,
// 128 or 256 (else cudaErrorInvalidValue).  geom holds, for q, k, v and o in
// turn, (Dh, S, H, B) and the byte strides of S, H and B
// (kernels/flash_attention.py::tensor_map_args); the wrapper checks shapes,
// types, 16-byte strides and 16-byte aligned pointers before it calls this.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           const long long* geom, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int Dh, int causal, float sm_scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch<64>(q, k, v, o, geom, B, Hq, Hkv, Sq, Sk, causal,
                               sm_scale, s);
    case 128: return launch<128>(q, k, v, o, geom, B, Hq, Hkv, Sq, Sk, causal,
                                 sm_scale, s);
    case 256: return launch<256>(q, k, v, o, geom, B, Hq, Hkv, Sq, Sk, causal,
                                 sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
