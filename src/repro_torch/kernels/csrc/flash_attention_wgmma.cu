// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bfloat16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention) for bfloat16 inputs; float32 inputs go to
// the CUDA-core kernel of flash_attention.cu, which keeps full float32
// products (on the tensor cores float32 would run as TF32).  It computes
// what that kernel and the plain version
// repro_torch/kernels/flash_attention.py::flash_attention_ref compute:
// scores q·Kᵀ in float32 times `scale`; masks from absolute positions,
// suffix-aligned (query i at Sk − Sq + i, key j at j; causal keeps
// j <= q_pos, a window w > 0 keeps q_pos − j < w); GQA (query head h reads
// KV head h / G); p = expf(s − m) against the running row max m, the row
// sum l taken from the unrounded p, p rounded to bf16 before P·V (as
// p.astype(v.dtype) in the Pallas kernel), O / l at the end; a row with no
// key to attend to gives 0.
//
// Layout: q (B, Sq, Hq, dh), k / v (B, Sk, Hkv, dh), out (B, Sq, Hq, dh),
// all bfloat16; dh is 32, 64, 128 or 256; any Sq and Sk.
//
// What bounds it.  Operations: a causal prefill of S tokens does
// 4 · dh · Hq · S (S + 1) / 2 flops on (2 Sq Hq + 2 Sk Hkv) · dh · 2 bytes,
// thousands of flops a byte against the card's ~295, so the bound is the
// bf16 tensor cores' 989 TFLOP/s.
//
// Design.  One block of two consumer warpgroups per (tile of BQ = 128 query
// rows, query head, batch row); each warpgroup owns 64 rows.  Every load is
// a TMA copy issued by one thread: thread 0 loads the block's Q tile and
// the first K and V tiles of BK keys into a ring of STAGES stages, each
// completing on its mbarrier; the second warpgroup to finish with a stage
// (a count in shared memory tells which is second) refills it with the
// tile STAGES ahead, so the warpgroups never wait for each other and one's
// softmax can overlap the other's products.  TMA maps are 4-D over (dh, H,
// S, B), so rows past Sq or Sk arrive as zeros and never from the next
// batch row.  Tiles are swizzled sub-tiles of 64 columns (128-byte rows,
// 128-byte swizzle; 32 columns and 64-byte swizzle at dh = 32), which is
// the layout the wgmma descriptors read.  S = Q·Kᵀ is wgmma m64nBKk16 with
// both operands read from shared memory as stored (dh contiguous,
// K-major).  The online softmax works on the accumulator fragment in
// registers: a thread holds two rows, and a row's max is reduced over its
// four lanes with two shuffles (its sum once, at the end).  O += P·V is
// wgmma m64n(dh)k16 with P converted to bf16 in registers as the A operand
// (the accumulator fragment of S is the A fragment of P·V) and V read from
// shared memory in its (Sk, dh) layout through the descriptor's transpose
// bit.  A block visits only the KV tiles its rows can see; a warpgroup
// skips a tile none of its rows sees, and only tiles that cross the causal
// diagonal, a window edge or the Sk tail apply the per-element mask.
// Causal query tiles run heaviest first (the grid's slowest dimension,
// reversed).  Shared memory is dynamic: Q (BQ × dh) + STAGES × (K + V) (BK
// × dh each) in bf16, 72 KB (dh 32) to 225 KB (dh 128).  By count, the
// softmax's instructions (about 13 an element, with expf and the scale
// kept as the plain version rounds them) rather than the tensor cores set
// the pace; that is an estimate, not measured apart.
//
// Build report (-Xptxas=-v, sm_90a, nvcc 12.9): 231 / 199 / 156 / 139
// registers a thread at dh 256 / 128 / 64 / 32, no spills; dynamic shared
// memory 197,664 / 230,444 / 148,536 / 74,808 bytes (tiles, mbarriers,
// counts and 1 KB to align the tiles).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int WGS = 2;              // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * WGS;        // query rows a block
constexpr int THREADS = 128 * WGS;

// keys a tile and stages of the ring, by head dim
template <int DH> struct Tile;
template <> struct Tile<32> { static constexpr int BK = 128, STAGES = 4; };
template <> struct Tile<64> { static constexpr int BK = 128, STAGES = 4; };
template <> struct Tile<128> { static constexpr int BK = 128, STAGES = 3; };
template <> struct Tile<256> { static constexpr int BK = 64, STAGES = 2; };

// columns of a swizzled sub-tile: 128-byte rows, 64-byte rows at dh 32
template <int DH> __host__ __device__ constexpr int sub_cols() {
  return DH < 64 ? DH : 64;
}

template <int DH> constexpr int smem_bytes() {
  return (BQ + 2 * Tile<DH>::STAGES * Tile<DH>::BK) * DH * 2  // tiles
         + 8 * (Tile<DH>::STAGES + 1)                          // mbarriers
         + 4 * Tile<DH>::STAGES                     // warpgroups done
         + 1024;                     // to align the tiles to 1,024 bytes
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; a load that never
// lands stops the kernel with an error instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the old value of the shared word at `addr`, which gains `v`
__device__ __forceinline__ uint32_t smem_fetch_add(uint32_t addr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared::cta.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "r"(addr), "r"(v) : "memory");
  return old;
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
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

// Keep the compiler from moving reads or writes of registers that a wgmma
// owns across the fence, commit and wait around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x N, f32) = A (64 x 16) · B (16 x N) (+ D if accumulate): A and B
// from shared memory, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);

// D (64 x N, f32) += A (64 x 16, bf16 in registers) · B (16 x N): B from
// shared memory, N-major (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// K and V rows [tile BK, tile BK + BK) of KV head kvh, batch row b, into
// stage `stage` of the ring, completing on the stage's mbarrier
template <int DH>
__device__ __forceinline__ void load_kv(uint32_t skv, uint32_t bars,
                                        int stage, int tile,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kvh,
                                        int b) {
  constexpr int BK = Tile<DH>::BK, SC = sub_cols<DH>();
  constexpr uint32_t ROW = SC * 2, KV_BYTES = BK * DH * 2;
  const uint32_t bar = bars + 8 * stage;
  const uint32_t dk = skv + stage * 2 * KV_BYTES, dv = dk + KV_BYTES;
  mbar_expect_tx(bar, 2 * KV_BYTES);
#pragma unroll
  for (int c = 0; c < DH / SC; ++c) {
    tma_load(dk + c * BK * ROW, tk, bar, c * SC, kvh, tile * BK, b);
    tma_load(dv + c * BK * ROW, tv, bar, c * SC, kvh, tile * BK, b);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                             int Hq, int Hkv, float scale, int causal,
                             int window) {
  constexpr int BK = Tile<DH>::BK, STAGES = Tile<DH>::STAGES;
  constexpr int SC = sub_cols<DH>();       // columns of a sub-tile
  constexpr uint32_t ROW = SC * 2;         // bytes of a sub-tile row
  constexpr int NSUB = DH / SC;            // sub-tiles of a head row
  constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : 2;
  constexpr uint32_t ATOM = 8 * ROW;       // 8 rows: one swizzle pattern
  constexpr uint32_t Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2;

  extern __shared__ uint8_t smem_raw[];
  // Q's sub-tiles, then stage s's K at skv + 2 s KV_BYTES and V after it,
  // then the stages' mbarriers and Q's, then a word a stage that counts
  // the warpgroups done with it
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + Q_BYTES;
  const uint32_t bars = skv + STAGES * 2 * KV_BYTES;
  const uint32_t qbar = bars + 8 * STAGES;
  const uint32_t done = qbar + 8;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int kvh = h / (Hq / Hkv);
  const int q_offset = Sk - Sq;

  // the keys this block's queries can see, as whole tiles
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_begin = 0, kv_end = Sk;
  if (window > 0) kv_begin = max(0, q_lo - window + 1);
  if (causal) kv_end = min(Sk, q_hi + 1);
  const int t_first = kv_begin / BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end + BK - 1) / BK - t_first : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st <= STAGES; ++st) mbar_init(bars + 8 * st, 1);
    for (int st = 0; st < STAGES; ++st)
      asm volatile("st.shared.u32 [%0], 0;\n" :: "r"(done + 4 * st) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c)
      tma_load(sq + c * BQ * ROW, &tq, qbar, c * SC, h, q0, b);
    for (int st = 0; st < STAGES && st < n_tiles; ++st)
      load_kv<DH>(skv, bars, st, t_first + st, &tk, &tv, kvh, b);
  }

  // this thread's rows of the warpgroup's 64: row0 and row0 + 8
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int qp0 = q_offset + row0, qp1 = qp0 + 8;
  const bool wg_live = q0 + 64 * wg < Sq;
  const int wq_lo = q_offset + q0 + 64 * wg;
  const int wq_hi = q_offset + min(q0 + 64 * wg + 64, Sq) - 1;
  const uint32_t q_rows = sq + 64 * wg * ROW;

  // accumulator fragments: value i of a thread sits in row row0 (i % 4 < 2)
  // or row0 + 8, column 8 (i / 4) + 2 (lane % 4) + i % 2
  float o[DH / 2], sc[BK / 2];
  uint32_t p[BK / 4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = 0u;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % STAGES;
    const int t0 = (t_first + j) * BK;
    const uint32_t kt = skv + stage * 2 * KV_BYTES, vt = kt + KV_BYTES;
    const bool seen = wg_live && !(causal && t0 > wq_hi)
                      && !(window > 0 && t0 + BK - 1 < wq_lo - window + 1);
    // every thread waits, so that no load is left in flight into a stage
    // that is refilled or at the end
    mbar_wait(bars + 8 * stage, (j / STAGES) & 1);
    if (seen) {
      // S = Q·Kᵀ over dh in steps of 16 (32 bytes of a sub-tile row)
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t col = kk * 16 % SC * 2, sub = kk * 16 / SC;
        wgmma_ss<BK>(sc,
                     desc(q_rows + sub * BQ * ROW + col, 16, ATOM, SWIZZLE),
                     desc(kt + sub * BK * ROW + col, 16, ATOM, SWIZZLE),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // scale, mask where the tile crosses an edge, running max
      const bool edge = t0 + BK > Sk || (causal && t0 + BK - 1 > wq_lo)
                        || (window > 0 && t0 < wq_hi - window + 1);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * scale;
        if (edge) {
          const int key = t0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int qp = i % 4 < 2 ? qp0 : qp1;
          bool ok = key < Sk;
          if (causal) ok = ok && key <= qp;
          if (window > 0) ok = ok && qp - key < window;
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        if (i % 4 < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = m0 <= NEG_INF / 2 ? 0.f : expf(m0 - mn0);
      const float a1 = m1 <= NEG_INF / 2 ? 0.f : expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p = exp(s - m); the sums from p, P·V from p rounded to bf16
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float mm = i % 4 < 2 ? mn0 : mn1;
        const float e0 = mm <= NEG_INF / 2 ? 0.f : expf(sc[i] - mm);
        const float e1 = mm <= NEG_INF / 2 ? 0.f : expf(sc[i + 1] - mm);
        if (i % 4 < 2) {
          ps0 += e0;
          ps0 += e1;
        } else {
          ps1 += e0;
          ps1 += e1;
        }
        p[i / 2] = pack_bf16(e0, e1);
      }
      l0 = a0 * l0 + ps0;
      l1 = a1 * l1 + ps1;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= i % 4 < 2 ? a0 : a1;

      // O += P·V over the tile's keys in steps of 16
      pin(o);
      pin(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<DH>(o, a, desc(vt + kk * 16 * ROW, BK * ROW, ATOM, SWIZZLE));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(p);
    }
    // The second warpgroup done with this stage refills it, so that
    // neither waits for the other and one's softmax overlaps the other's
    // products.
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (tid % 128 == 0) {
      __threadfence_block();
      if (smem_fetch_add(done + 4 * stage, 1) % WGS == WGS - 1 &&
          j + STAGES < n_tiles) {
        __threadfence_block();
        load_kv<DH>(skv, bars, stage, t_first + j + STAGES, &tk, &tv, kvh, b);
      }
    }
  }

  // a row's sum over its four lanes; O / l, 0 where l is 0
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  const size_t row_stride = (size_t)Hq * DH;
  __nv_bfloat16* o0 =
      out + ((size_t)b * Sq + row0) * row_stride + (size_t)h * DH + 2 * (lane % 4);
  if (row0 < Sq) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * c) =
          __floats2bfloat162_rn(o[4 * c] / d0, o[4 * c + 1] / d0);
  }
  if (row0 + 8 < Sq) {
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the
// runtime (the library links no libcuda)
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (dh, H, S, B) of a (B, S, H, dh) bf16 tensor whose boxes
// are `rows` rows of one head and `cols` columns, swizzled as the wgmma
// descriptors read them.  Returns 0, or the CUresult of the encoding.
int make_map(CUtensorMap* map, const void* ptr, int dh, int H, int S, int B,
             int rows, int cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)H * dh * 2,
                                 (cuuint64_t)S * H * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int SC = sub_cols<DH>();
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, DH, Hq, Sq, B, BQ, SC);
  if (err == 0) err = make_map(&mk, k, DH, Hkv, Sk, B, Tile<DH>::BK, SC);
  if (err == 0) err = make_map(&mv, v, DH, Hkv, Sk, B, Tile<DH>::BK, SC);
  if (err != 0) return -err;
  const auto kernel = flash_attention_wgmma_kernel<DH>;
  constexpr int SMEM = smem_bytes<DH>();
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the bf16 attention of B rows on `stream`.  Pointers are device
// pointers aligned to 16 bytes; window <= 0 means no window.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape
// the kernel does not take (Sk = 0 among them), or minus the CUresult of a
// tensor map that could not be encoded.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int Hq, int Hkv,
                                            int dh, float scale, int causal,
                                            int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Sk < 1 ||
      (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
