// Blocked online-softmax attention with GQA, causal and sliding-window
// masks, on Hopper's tensor cores (sm_90a): bf16 q, k and v at head dims
// 64, 128 and 256.  fp32 inputs and other head dims run the fp32 FMA
// design of flash_attention.cu; kernels/flash_attention.py::_design picks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel) and computes what it computes:
// right-aligned positions (query row i sits at key position sk - sq + i),
// key j visible iff j <= pos(i) (causal) and j > pos(i) - window; -inf
// for masked scores; fp32 scores, running max m, normaliser l and output
// accumulator; p = 0 while the running max is -inf and alpha = 0 after
// such a max; the output acc / max(l, 1e-30) in bf16.  Query head h reads
// KV head h / (hq / hkv).  Given a non-null `lse` (fp32, (b, hq, sq)),
// the epilogue also writes each row's log-sum-exp of the scaled, masked
// scores, (m + log2 l) ln 2 in the exp2 units kept here (-inf for a row
// with no visible key), which flash_attention_bwd.cu reads; with a null
// pointer nothing else changes.
//
// Bound on the H100: operations.  At the LM path's shape (b, hq, hkv, s,
// d) = (64, 4, 1, 2048, 256) the call moves 0.40 GB (0.12 ms at 3.35
// TB/s) for 4 d FLOP per visible (query, key) pair: 0.55 TFLOP causal and
// 0.24 TFLOP with window 512, 0.556 and 0.243 ms at the card's 989
// TFLOP/s bf16 dense tensor-core rate.
//
// The fp32 contract of P @ V.  S = Q K^T takes bf16 products, exact in
// fp32, summed in fp32 on the tensor cores; the scale (times log2 e, for
// exp2) is applied to the fp32 scores.  P is fp32 and V bf16, so P splits
// into hi = bf16(p) and lo = bf16(p - hi), and acc += hi V + lo V: two
// wgmma with A from registers.  hi + lo carries p to 2^-18 of itself, far
// below the bf16 rounding of the output, for 1.5x the tensor work of one
// bf16 P (S is one unit, P @ V two): bounds of 0.834 and 0.365 ms at the
// path's two calls.  Rounding P to one bf16, as PyTorch's SDPA does, would
// change the contract.
//
// Design.  One block of two warpgroups per (128 query rows, query head,
// batch row); the query head is fastest in the grid, so that the g blocks
// of one KV head run together and read its K and V from L2, and the
// latest query blocks (most keys under the causal mask) start first.
// Thread 0 issues TMA loads: the Q tile once (128 x d), then K and V tiles
// of 64 keys into a two-stage ring with full / empty mbarriers, refilling
// a stage as soon as all eight warps have released it, and only for the
// key tiles between the first key the block's first row can see (window)
// and the last its last row can see (causal).  Tiles are bf16 with
// 128-byte swizzle, one box of 64 columns (128 bytes) per chunk of the
// head dim, so a d = 256 row takes four boxes; TMA zero-fills rows past
// sq and sk.  Shared memory at d = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB)
// = 192 KB.  Warpgroup w owns 64 query rows: per key tile one m64n64k16
// wgmma chain for S (Q and K from shared memory, K-major), the masks only
// on tiles that straddle the diagonal, the window edge or sk, the online
// softmax on the accumulator layout (a row's 16 values per thread sit in
// one quad of four lanes: the row max reduces with two shuffles, and the
// partial sums of l only once at the end), then the S registers converted
// in place into the hi and lo A fragments and two m64n{d}k16 wgmma per 16
// keys with V as an MN-major B operand (the transpose bit).  The output
// accumulators, d / 2 floats a thread (128 at d = 256), stay in
// registers; the epilogue divides by max(l, 1e-30), converts to bf16 and
// stores with a row guard.
//
// Why no producer warp.  A third warpgroup that only issues TMA, with
// setmaxnreg moving its registers to the two others, compiled (nvcc 12.8)
// to 168 registers for the whole block: ptxas sizes a block of three
// warpgroups to 65,536 / 384 registers a thread and did not raise its
// allocation after setmaxnreg.inc, so at d = 256 (214 registers needed)
// it spilled and serialised every wgmma; the kernel took 2.9 ms on the
// global call where this two-warpgroup one takes 1.75 ms (PERF.md).
//
// Registers and spills (nvcc -Xptxas -v, printed by chip_smoke.py's build
// phase): 214, 150 and 116 registers at d = 256, 128 and 64, no spills.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // query rows per block
constexpr int kThreads = 256;   // two warpgroups of 64 query rows each
constexpr int kBN = 64;         // keys per tile
constexpr int kStages = 2;      // K / V ring
constexpr int kBox = 64;        // bf16 columns per TMA box: 128 bytes
constexpr int kRow = 128;       // bytes of one swizzled box row

struct Params {
  void* out;
  float* lse;                   // (b, hq, sq) or null
  int hq, g, sq, sk, nqb;
  float scale_log2;             // scale * log2(e): scores go through exp2
  int causal, has_window, window;
};

// Shared memory at head dim D, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).  A tile is D / 64
// chunks of [rows][64] bf16, each chunk one TMA box.
template <int D>
struct Layout {
  static constexpr int kChunks = D / kBox;
  static constexpr int kQBytes = kChunks * kBM * kRow;
  static constexpr int kTileBytes = kChunks * kBN * kRow;   // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, then k_full, v_full and empty of each stage; then slack for
  // the alignment
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
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

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a lost arrival) traps, so that a fault of the
// pipeline is an error at the launch's next synchronisation, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++spins == (1u << 26)) __trap();
  } while (!done);
}

// One box (64 columns x the map's box rows) at (c0, c1, c2), innermost
// coordinate first, into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma registers across this:
// before wgmma.fence (so that no write of an operand lands between the
// fence and the wgmma, which would serialise the chain) and after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// S (m64 x n64) = A (m64 x k16) B (k16 x n64), both K-major in shared
// memory: the first step of a chain, which overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// S (m64 x n64) += A (m64 x k16) B (k16 x n64), both K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64) += A (m64 x k16, bf16 pairs in registers) x B (k16 x
// n64, MN-major in shared memory: the transpose bit for 16-bit types).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128) += A (m64 x k16, bf16 pairs in registers) x B (k16 x
// n128, MN-major in shared memory: the transpose bit for 16-bit types).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n256) += A (m64 x k16, bf16 pairs in registers) x B (k16 x
// n256, MN-major in shared memory: the transpose bit for 16-bit types).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p = hi + lo to 2^-18 of p: hi = bf16(p), lo = bf16(p - hi), as the A
// fragments (bf16 pairs, the lower column in the low half) of two wgmma.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, const Params& p) {
  return kpos < p.sk && (!p.causal || kpos <= qpos)
         && (!p.has_window || kpos > qpos - p.window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const Params p) {
  using L = Layout<D>;
  constexpr int NC = L::kChunks;
  constexpr int NO = D / 2;             // output accumulators a thread
  constexpr int NP = kBN / 16;           // A fragments of P a tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };

  // Query head fastest, then query blocks latest first, then batch rows.
  int idx = blockIdx.x;
  const int h = idx % p.hq;
  idx /= p.hq;
  const int qb = p.nqb - 1 - idx % p.nqb;
  const int b = idx / p.nqb;
  const int bh_q = b * p.hq + h;
  const int bh_kv = b * (p.hq / p.g) + h / p.g;

  // Key tiles between the first key the block's first row can see and
  // the last its last row can see, on right-aligned positions.
  const int offset = p.sk - p.sq;
  const int row0 = qb * kBM;
  const int pos_lo = offset + row0;
  const int pos_hi = offset + min(row0 + kBM, p.sq) - 1;
  int kb_hi = (p.sk + kBN - 1) / kBN - 1;
  if (p.causal) kb_hi = pos_hi < 0 ? -1 : min(kb_hi, pos_hi / kBN);
  int kb_lo = 0;
  if (p.has_window) kb_lo = max(0, pos_lo - p.window + 1) / kBN;
  const int ntiles = max(0, kb_hi - kb_lo + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);           // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every TMA load: Q and the first kStages tiles now, each
  // later tile once every warp has released its stage (in the loop).
  auto load_tile = [&](int t) {
    const int s = t % kStages, k0 = (kb_lo + t) * kBN;
    mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(s_k + s * L::kTileBytes + c * kBN * kRow, &tm_k, k_full(s),
               c * kBox, k0, bh_kv);
    mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(s_v + s * L::kTileBytes + c * kBN * kRow, &tm_v, v_full(s),
               c * kBox, k0, bh_kv);
  };
  // After tile t: release its stage and, on thread 0, refill the stage
  // with tile t + kStages once all eight warps have released it.
  auto release = [&](int t) {
    const int s = t % kStages;
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && t + kStages < ntiles) {
      mbar_wait(empty(s), (t / kStages) & 1);
      load_tile(t + kStages);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(s_q + c * kBM * kRow, &tm_q, q_full, c * kBox, row0, bh_q);
    for (int t = 0; t < min(kStages, ntiles); ++t) load_tile(t);
  }

  // Warp-uniform for the compiler (a shuffle from lane 0), so that the
  // wgmma descriptors derived from it live in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // Warpgroup wg owns query rows row0 + 64 wg .. + 63.
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  // This thread's two rows (accumulators 4j, 4j + 1 and 4j + 2, 4j + 3)
  // and its column pair in each block of 8 columns.
  const int row_a = row0 + wg * 64 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int qpos_a = offset + row_a, qpos_b = offset + row_b;
  const int col = 2 * (lane % 4);

  // The warpgroup's own tiles within the block's, and its real rows.
  const int w_row0 = row0 + wg * 64;
  const int w_rows = min(64, p.sq - w_row0);
  const int wpos_lo = offset + w_row0, wpos_hi = wpos_lo + w_rows - 1;
  int w_lo = kb_lo, w_hi = kb_hi;
  if (w_rows <= 0) {
    w_lo = kb_hi + 1;
  } else {
    if (p.causal) w_hi = min(w_hi, wpos_hi < 0 ? -1 : wpos_hi / kBN);
    if (p.has_window)
      w_lo = max(w_lo, max(0, wpos_lo - p.window + 1) / kBN);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float sc[kBN / 2];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  const uint32_t q_wg = s_q + wg * 64 * kRow;

  mbar_wait(q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const int kb = kb_lo + t;
    mbar_wait(k_full(s), phase);
    if (kb < w_lo || kb > w_hi) {     // no key of it visible to our rows
      // wait for V too: a stage is released only after its loads
      mbar_wait(v_full(s), phase);
      release(t);
      continue;
    }
    const int k0 = kb * kBN;

    // S = Q K^T over the head dim, 16 columns (32 bytes) a step.
    const uint32_t k_tile = s_k + s * L::kTileBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da =
          smem_desc(q_wg + (kk / 4) * kBM * kRow + off, 16, 1024);
      const uint64_t db =
          smem_desc(k_tile + (kk / 4) * kBN * kRow + off, 16, 1024);
      if (kk == 0) wgmma_ss_n64_first(sc, da, db);
      else wgmma_ss_n64(sc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scale, mask (only where the tile straddles a mask edge), online
    // softmax with the Pallas kernel's -inf rules.
    const bool whole = k0 + kBN <= p.sk
        && (!p.causal || k0 + kBN - 1 <= wpos_lo)
        && (!p.has_window || k0 > wpos_hi - p.window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[4 * j + e] * p.scale_log2;
        float xb = sc[4 * j + 2 + e] * p.scale_log2;
        if (!whole) {
          const int kpos = k0 + 8 * j + col + e;
          if (!visible(kpos, qpos_a, p)) xa = -INFINITY;
          if (!visible(kpos, qpos_b, p)) xb = -INFINITY;
        }
        sc[4 * j + e] = xa;
        sc[4 * j + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // p = 0 while the max is -inf; alpha = 0 after a -inf max
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float alpha_a = exp2_approx(m_a - mu_a);
    const float alpha_b = exp2_approx(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2_approx(sc[4 * j + e] - mu_a);
        sc[4 * j + 2 + e] = exp2_approx(sc[4 * j + 2 + e] - mu_b);
        sum_a += sc[4 * j + e];
        sum_b += sc[4 * j + 2 + e];
      }
    l_a = l_a * alpha_a + sum_a;      // this thread's columns only
    l_b = l_b * alpha_b + sum_b;
    // S accumulators 8kk .. 8kk + 7 are the A fragment of keys
    // 16kk .. 16kk + 15: register r packs accumulators 8kk + 2r, + 1.
    uint32_t hi[NP][4], lo[NP][4];
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
              lo[kk][r]);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }

    // acc += hi V + lo V, 16 keys a step.  V is MN-major (the head dim
    // contiguous): chunks of 64 columns kBN * kRow bytes apart (the
    // leading byte offset), groups of 8 keys 1024 bytes apart (the
    // stride byte offset).
    mbar_wait(v_full(s), phase);
    const uint32_t v_tile = s_v + s * L::kTileBytes;
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      const uint64_t dv = smem_desc(v_tile + kk * 16 * kRow, kBN * kRow,
                                    1024);
      wgmma_rs<D>(o, hi[kk], dv);
      wgmma_rs<D>(o, lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    release(t);
  }

  // Epilogue: acc / max(l, 1e-30) in bf16, rows past sq dropped.
  const float lq_a = quad_sum(l_a), lq_b = quad_sum(l_b);
  const float inv_a = 1.0f / fmaxf(lq_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(lq_b, 1e-30f);
  if (p.lse != nullptr && lane % 4 == 0) {   // m and l agree in a quad
    constexpr float kLn2 = 0.693147180559945309f;
    float* lse = p.lse + static_cast<size_t>(bh_q) * p.sq;
    if (row_a < p.sq)
      lse[row_a] = m_a == -INFINITY ? -INFINITY : (m_a + log2f(lq_a)) * kLn2;
    if (row_b < p.sq)
      lse[row_b] = m_b == -INFINITY ? -INFINITY : (m_b + log2f(lq_b)) * kLn2;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out)
                       + static_cast<size_t>(bh_q) * p.sq * D;
  if (row_a < p.sq) {
    __nv_bfloat16* dst = out + static_cast<size_t>(row_a) * D + col;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
  }
  if (row_b < p.sq) {
    __nv_bfloat16* dst = out + static_cast<size_t>(row_b) * D + col;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                o[4 * j + 3] * inv_b);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// A (heads, rows, d) bf16 tensor as boxes of box_rows x 64 columns with
// 128-byte swizzle; rows past `rows` read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__global__ void fill_kernel(float* x, size_t n, float value) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    x[i] = value;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hq, int hkv, int sq, int sk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, D, sq, b * hq, kBM)
      || !make_map(encode, &tm_k, k, D, sk, b * hkv, kBN)
      || !make_map(encode, &tm_v, v, D, sk, b * hkv, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<D>::kBytes;
  auto kernel = flash_attention_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqb = (sq + kBM - 1) / kBM;
  const Params p{out, lse, hq, hq / hkv, sq, sk, nqb,
                 scale * 1.44269504088896341f, causal, has_window, window};
  kernel<<<b * hq * nqb, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: q (b, hq, sq, d), k and v (b, hkv, sk, d), all
// contiguous bf16 with 16-byte aligned data, d in {64, 128, 256}; `lse`
// (fp32 (b, hq, sq)) may be null.  Returns cudaGetLastError() (0 on
// success); other head dims or a misaligned pointer return an error
// without launching.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int b, int hq, int hkv, int sq, int sk, int d, float scale, int causal,
    int has_window, int window, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || (d != 64 && d != 128 && d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
       | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out))
      % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0 || sq == 0) return 0;
  if (sk == 0) {                        // no key: every row gives 0
    if (lse != nullptr) {
      fill_kernel<<<64, 256, 0, s>>>(lse, static_cast<size_t>(b) * hq * sq,
                                     -INFINITY);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(b) * hq * sq * d * 2, s));
  }
  if (d == 64)
    return launch<64>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                      has_window, window, s);
  if (d == 128)
    return launch<128>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale,
                       causal, has_window, window, s);
  return launch<256>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                     has_window, window, s);
}
