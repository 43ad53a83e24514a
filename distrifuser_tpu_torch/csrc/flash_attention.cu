// Flash attention for Hopper (sm_90a): non-causal multi-head SDPA over
// [B, L, C] tensors, bf16 in and out, fp32 logits and softmax state.
//
// Replaces the Pallas TPU kernel distrifuser_tpu/ops/flash_attention.py:41
// (_flash_kernel, launched through pl.pallas_call by flash_sdpa).  Same
// arithmetic: logits s = (q . k) * scale in fp32; KV columns at or past
// kv_len get the logit -1e30; an online softmax keeps the row max m and the
// normalizer l in fp32; p = exp(s - m) is rounded to bf16 before the P.V
// product (fp32 accumulation) while l sums the unrounded p; the output
// acc / l is rounded to bf16.  The exponentials are taken in base 2 with
// log2(e) folded into the scale (exp2(s * scale * log2e - m2)).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the UNet's
// self-attention (SDXL d = 64, L = 1024 or 4096; SD 1.5 d = 40, 80, 160 at
// L = 4096, 1024, 256) and the VAE's mid attention (d = 512, L = 4096 or
// 16384) do 4 L^2 d operations on 4 L d bf16 values, hundreds of operations
// per byte at the large L, so they are bound by operations; the
// cross-attention over 77 text tokens reads and writes q and o once per
// query row with only 77 keys, so it is bound by bytes.
//
// Design.  One block per (tile of BQ = 64 * NQ query rows, batch * head).
// Its threads are NQ * NC consumer warpgroups followed by one producer
// warp.
// * Tiles arrive through TMA (cp.async.bulk.tensor; Q through a 4-D map
//   (d, H, L, B), K and V through 3-D maps (H * d, L, B), each with the
//   view's own row and batch strides, so heads and the k / v halves of the
//   fused to_kv output are read in place) into a ring of STAGES K/V stages
//   in shared memory.  The producer's lane 0 fills a stage as soon
//   as the consumers have released it ("empty" mbarrier, one arrival per
//   consumer thread) and the hardware signals its "full" mbarrier when the
//   bytes have landed, so loads run ahead of the math.  TMA was taken over
//   cp.async because one thread moves a whole tile, swizzled as wgmma's
//   descriptors expect, and zero-fills rows past the map's extent without
//   spending consumer registers or instructions.  The KV loop has no
//   __syncthreads: only the two mbarriers of a stage order producer and
//   consumers.  Host cost per launch: three cuTensorMapEncodeTiled calls
//   (host arithmetic; the driver entry point is looked up once per
//   process), part of the wrapper's host time per call that chip_smoke.py
//   reports (host_us_per_launch).
// * Both products run on the tensor cores through wgmma.mma_async.
//   S = Q K^T reads Q and K from shared memory (both K-major, d contiguous,
//   in 128-, 64- or 32-byte swizzled blocks of 64, 32 or 16 columns, the
//   widest that divides the head dim: 16 for d = 80, 32 for d = 160).
//   O += P V takes P from registers as the A operand: the fp32 fragment of
//   S, packed to bf16 pairs, already has the A-register layout.  V is the
//   MN-major B operand (transpose bit set), read from the same layout K has.
// * Softmax and accumulator stay in registers: each thread holds two rows'
//   worth of S and O fragments; the row max and sum are reduced over the
//   four threads that share a row with __shfl_xor_sync 1 and 2, and corr
//   scales the O fragment in place.  Nothing of S, P or O goes through
//   shared memory; O is written once, from registers, as bf16 pairs.
// * Per head dim (a template instance each; the wrapper refuses any other
//   d): d = 16, 32, 64 take one warpgroup of 64 query rows and BK = 128,
//   three blocks to an SM, so one block's softmax overlaps another's wgmma
//   and the level-2 self-attention (1024 rows, 40 heads) spreads 640
//   blocks over 396 resident slots (two warpgroups of 128 query rows per
//   block were slower at both UNet self-attention shapes).  d = 128 and
//   256 take BK = 64.  d = 512 (the VAE) splits O's 512 columns over two
//   warpgroups of 64 x 256 (128 registers each); both compute the same
//   64 x 32 S tile from the full Q row, which costs half again the
//   operations of the products but hands nothing between them through
//   shared memory; Q (64 KB) and two stages of 32-row K and V tiles
//   (128 KB) fit in 227 KB.  BQ is chosen per head dim, not per shape; the
//   grid is not persistent.  SD 1.x's head dims: d = 40 runs as d = 64
//   does, on 48 columns; d = 80 (BK = 128) and 160 (BK = 64, O 64 x 160 in
//   80 registers a thread) two blocks to an SM.
// * d = 40 is not a multiple of wgmma's k16: its tiles are 48 columns wide,
//   and only Q's 8 pad columns must be zero.  Q's 4-D map has the real d as
//   its head extent, so Q's pad columns, past the head or before it, load
//   as zeros (TMA's out-of-bounds fill), once per block.  K's and V's 3-D
//   maps span the whole row, so their pad columns are a neighbouring head's
//   (finite values; zeros past either end of the row): against Q's zeros
//   they add nothing to Q.K^T, and the O columns they feed are not stored.
//   A head starts at byte 80h, so every odd head's 32-byte box rows would
//   straddle two 32-byte sectors: such a head loads Q, K and V from 8
//   columns earlier (k_shift, v_shift, from the pointers' alignment), its
//   pad in front, and O is stored shifted back.  The scale is 1/sqrt(40),
//   the real head dim's, as the wrapper passes it.
// * d = 72 (PixArt-α's DiT: 16 heads of 72) runs by the same scheme on 96
//   columns in three 32-column (64-byte swizzled) boxes, O 64 x 96 in 48
//   registers a thread (164 in all), BK = 128, and two warpgroups of 64
//   query rows sharing each K/V tile (BQ = 128, one block to an SM).  At
//   PixArt's shapes that is 1.55x faster a launch than d = 80's layout (80
//   columns in five 16-column, 32-byte boxes, one warpgroup, two blocks to
//   an SM), though it multiplies 20% more columns: the 96-column boxes
//   gave 1.3x, the second warpgroup 1.17x (chip_smoke.py
//   --flash_variants).  A head starts at byte 144h, and 144 = 16 mod 32 as
//   80 is, so every odd head loads from 8 columns earlier, inside its 24
//   pad columns.  The last head's K / V pad lies past H * d, outside the
//   3-D maps' extent, and loads as zeros.
// * Ragged edges: the Q map's row extent is Lq and the K/V maps' is
//   kv_len, so rows past them load as zeros; query rows >= Lq are not
//   stored; KV columns >= kv_len in the last tile get the -1e30 logit, and
//   tiles wholly past kv_len are not visited.  Rows of K and V between
//   kv_len and Lk are never read.
// * Log-sum-exp output (the LSE instances, one more per head dim): for the
//   ring attention's merge of chunk partials, the kernel also writes the
//   natural-log log-sum-exp of every query row's logits, ln 2 * (m + log2 l)
//   from the base-2 max and normalizer it already holds, float32 [B, H, Lq],
//   and writes O = acc / l in float32 instead of bf16, so the merge rounds
//   nothing.  The lane that holds column 0 of a row stores its LSE.  The
//   main loop is the same code; only the epilogue differs.
// * Set-up: cudaFuncSetAttribute runs once per template instance (a
//   function-local static), not per launch.  A refused launch, or a tensor
//   map the driver will not encode, returns its error code; nothing falls
//   back.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask logit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma wrappers, one per shape the kernel issues (m64nNk16, bf16 in, fp32
// accumulate).  "ss": A and B from shared-memory descriptors, both K-major.
// "rs": A from registers, B MN-major (transpose bit set).

// S (+)= A . B^T, A [64 x 16] and B [32 x 16] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= A . B^T, A [64 x 16] and B [64 x 16] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= A . B^T, A [64 x 16] and B [128 x 16] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 16] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 32] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 48] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 80] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 96] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 128] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 160] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A [64 x 16] bf16 from registers, B [16 x 256] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, db);
  else {
    static_assert(N == 256, "no wgmma_rs shape");
    wgmma_rs_n256(d, a, db);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// D: head dim; BK: KV rows per tile; NQ: 64-row query groups per block; NC:
// warpgroups that split O's columns for one query group; STAGES: K/V ring
// depth; MINB: blocks per SM the registers are budgeted for; DP_: the
// padded width, if not D rounded up to wgmma's k16.  A head's DP columns in
// shared memory load Q's pad columns as zeros (they lie outside its map's
// head extent), K's and V's as a neighbouring head's columns, and no pad
// column is stored.
template <int D_, int BK_, int NQ_, int NC_, int STAGES_, int MINB_, int DP_ = 0>
struct Config {
  static constexpr int D = D_, BK = BK_, NQ = NQ_, NC = NC_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int DP = DP_ ? DP_ : (D + 15) / 16 * 16;
  // columns per swizzled block: the widest of 64, 32, 16 that divides DP
  static constexpr int CW = DP % 64 == 0 ? 64 : (DP % 32 == 0 ? 32 : 16);
  static constexpr int SW = CW * 2;           // its row, in bytes: 32, 64, 128
  static constexpr int SWIZZLE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int NCB = DP / CW;         // column blocks per row
  static constexpr int BQ = 64 * NQ;
  static constexpr int DN = DP / NC;          // O columns per warpgroup
  static constexpr int NWG = NQ * NC;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  // +1024: the dynamic window is aligned up to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + BAR_OFFSET + (2 * STAGES + 1) * 8;
  static_assert(D % 8 == 0, "head dim: a 16-byte head stride");
  static_assert(DP >= D + (DP > D ? 8 : 0), "pad: room for an odd head's 8-column shift");
  static_assert(DP % CW == 0 && DN % CW == 0, "column split");
  static_assert(BK % 16 == 0 && BK <= 256 && BQ <= 256, "tile");
};

// LSE: O in float32 and the rows' log-sum-exp into lse [B, H, Lq]; else O
// in bf16 and lse unused.
template <class C, bool LSE>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 void* __restrict__ o, long long o_bs, long long o_rs,
                 float* __restrict__ lse, int heads, int lq, int kv_len,
                 int k_align, int v_align, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::Q_BYTES;
  const uint32_t bars = base + C::BAR_OFFSET;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (C::STAGES + s); };
  const uint32_t q_bar = bars + 8u * (2 * C::STAGES);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * C::BQ;
  // a padded head (DP > D) whose K / V columns start 16 bytes past a 32-byte
  // boundary loads from 8 columns earlier: its rows then lie on whole
  // sectors; Q shifts with K, and O is stored shifted back by V's shift
  int k_shift = 0, v_shift = 0;
  if constexpr (C::DP != C::D) {
    k_shift = (k_align + h * C::D * 2) % 32 / 2;
    v_shift = (v_align + h * C::D * 2) % 32 / 2;
  }
  const int n_tiles = (kv_len + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), C::NWG * 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::NWG * 128) {
    // producer warp: lane 0 keeps the ring full
    if (threadIdx.x == C::NWG * 128) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb) {
        tma_load_4d(q_s + cb * C::BQ * C::SW, &q_map, q_bar, cb * C::CW - k_shift, h,
                    q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) mbar_wait(empty_bar(s), (t / C::STAGES - 1) & 1);
        mbar_expect_tx(full_bar(s), C::STAGE_BYTES);
        const uint32_t k_dst = kv_s + s * C::STAGE_BYTES;
        const uint32_t v_dst = k_dst + C::KV_BYTES;
        for (int cb = 0; cb < C::NCB; ++cb) {
          const int col = cb * C::CW;
          tma_load_3d(k_dst + cb * C::BK * C::SW, &k_map, full_bar(s),
                      h * C::D + col - k_shift, t * C::BK, b);
          tma_load_3d(v_dst + cb * C::BK * C::SW, &v_map, full_bar(s),
                      h * C::D + col - v_shift, t * C::BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: 64 query rows (group rg), O columns cs*DN .. +DN
  const int wg = threadIdx.x / 128;
  const int rg = wg / C::NC;
  const int cs = wg % C::NC;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);  // first of this thread's two columns per 8

  float acc[C::DN / 2];
#pragma unroll
  for (int i = 0; i < C::DN / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // row max (rows r, r + 8), log2 domain
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  constexpr uint32_t kSbo = 8 * C::SW;  // next 8-row group
  const uint32_t q_rows = q_s + rg * 64 * C::SW;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t k_tile = kv_s + s * C::STAGE_BYTES;
    const uint32_t v_tile = k_tile + C::KV_BYTES;
    mbar_wait(full_bar(s), (t / C::STAGES) & 1);

    // S = Q K^T over the (padded) head dim, 16 columns of d per wgmma
    float sc[C::BK / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk) {
      const int cb = kk / (C::CW / 16);
      const uint32_t koff = (kk % (C::CW / 16)) * 32;
      const uint64_t da = make_desc(q_rows + cb * C::BQ * C::SW + koff, 16, kSbo,
                                    C::SWIZZLE);
      const uint64_t db = make_desc(k_tile + cb * C::BK * C::SW + koff, 16, kSbo,
                                    C::SWIZZLE);
      wgmma_ss<C::BK>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // KV columns at or past kv_len: the -1e30 logit (last tile only)
    const int valid = kv_len - t * C::BK;
    if (valid < C::BK) {
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j + c0 + e >= valid) {
            sc[4 * j + e] = kNegInf;
            sc[4 * j + 2 + e] = kNegInf;
          }
        }
      }
    }

    // online softmax on the fragment: row max over the 4 threads of a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = ex2(m0 - mn0);
    const float corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = exp2(s * scale * log2e - m); l sums p unrounded, P is bf16
    uint32_t pa[C::BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      const float p00 = ex2(fmaf(sc[4 * j], scale_log2, -mn0));
      const float p01 = ex2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
      const float p10 = ex2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
      const float p11 = ex2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int j = 0; j < C::DN / 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // O += P V: P from registers, V MN-major (16 KV rows per wgmma)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
      const uint64_t db =
          make_desc(v_tile + (cs * C::DN / C::CW) * C::BK * C::SW + ks * 16 * C::SW,
                    C::BK * C::SW, kSbo, C::SWIZZLE);
      wgmma_rs<C::DN>(acc, pa[ks], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty_bar(s));
  }

  // out = acc / l, bf16; query rows >= lq and pad columns are not stored
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + rg * 64 + warp * 16 + lane / 4;
  // O column cs * DN + 8j + c0 holds head column cs * DN + 8j + c0 - v_shift
  const long long o_off = b * o_bs + h * C::D + cs * C::DN + c0 - v_shift;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= lq) continue;
    const float l = half ? l1 : l0;
    if constexpr (LSE) {
      if (cs == 0 && c0 == 0) lse[static_cast<long long>(bh) * lq + r] = (
          (half ? m1 : m0) + log2f(l)) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < C::DN / 8; ++j) {
      const int col = cs * C::DN + 8 * j - v_shift;
      if (col < 0 || col >= C::D) continue;
      const float lo = acc[4 * j + 2 * half] / l, hi = acc[4 * j + 2 * half + 1] / l;
      if constexpr (LSE) {
        float* orow = static_cast<float*>(o) + o_off + r * o_rs;
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(lo, hi);
      } else {
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + o_off + r * o_rs;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(lo, hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A map over a bf16 [B, L, H * d] view with row stride `rs` and batch stride
// `bs` elements, boxes of `box_cols` columns x `box_rows` rows: per head (Q:
// 4-D (d, H, rows, B), a box past column d of its head reads zeros) or over
// the whole row (K, V: 3-D (H * d, rows, B)).
bool encode_map(CUtensorMap* map, const void* ptr, bool per_head, int d, int heads,
                int rows, int batch, long long rs, long long bs, int box_cols,
                int box_rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t c = static_cast<cuuint64_t>(d), h = static_cast<cuuint64_t>(heads),
                   r = static_cast<cuuint64_t>(rows), n = static_cast<cuuint64_t>(batch);
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(rs) * 2,
                   batch_bytes = static_cast<cuuint64_t>(bs) * 2;
  const cuuint32_t bc = static_cast<cuuint32_t>(box_cols),
                   br = static_cast<cuuint32_t>(box_rows);
  const cuuint64_t dims4[4] = {c, h, r, n};
  const cuuint64_t strides4[3] = {c * 2, row_bytes, batch_bytes};
  const cuuint32_t box4[4] = {bc, 1, br, 1};
  const cuuint64_t dims3[3] = {h * c, r, n};
  const cuuint64_t strides3[2] = {row_bytes, batch_bytes};
  const cuuint32_t box3[3] = {bc, br, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, per_head ? 4 : 3,
                const_cast<void*>(ptr), per_head ? dims4 : dims3,
                per_head ? strides4 : strides3, per_head ? box4 : box3, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, int heads, int lq, int kv_len, long long q_bs, long long q_rs,
                   long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                   long long o_bs, long long o_rs, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<C, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, true, C::D, heads, lq, b, q_rs, q_bs, C::CW, C::BQ) ||
      !encode_map(&k_map, k, false, C::D, heads, kv_len, b, k_rs, k_bs, C::CW, C::BK) ||
      !encode_map(&v_map, v, false, C::D, heads, kv_len, b, v_rs, v_bs, C::CW, C::BK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((lq + C::BQ - 1) / C::BQ, b * heads);
  flash_fwd_kernel<C, LSE><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, o, o_bs, o_rs, lse, heads, lq, kv_len,
      static_cast<int>(reinterpret_cast<uintptr_t>(k) % 32),
      static_cast<int>(reinterpret_cast<uintptr_t>(v) % 32), scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// One instance per head dim: X(D, BK, NQ, NC, STAGES, MINB[, DP]).
#define FLASH_VARIANTS(X)    \
  X(16, 128, 1, 1, 2, 3)     \
  X(32, 128, 1, 1, 2, 3)     \
  X(40, 128, 1, 1, 2, 3)     \
  X(64, 128, 1, 1, 2, 3)     \
  X(72, 128, 2, 1, 2, 1, 96) \
  X(80, 128, 1, 1, 2, 2)     \
  X(128, 64, 1, 1, 2, 2)     \
  X(160, 64, 1, 1, 2, 2)     \
  X(256, 64, 1, 1, 2, 1)     \
  X(512, 32, 1, 2, 2, 1)

namespace {

template <bool LSE>
int flash_entry(const void* q, const void* k, const void* v, void* o, float* lse,
                int b, int heads, int lq, int kv_len, int d, long long q_bs,
                long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                long long v_rs, long long o_bs, long long o_rs, float scale,
                void* stream) {
  if (lq <= 0 || kv_len <= 0 || b <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(...)                                                            \
  static_cast<int>(launch<Config<__VA_ARGS__>, LSE>(q, k, v, o, lse, b, heads, lq,  \
                                                    kv_len, q_bs, q_rs, k_bs, k_rs, \
                                                    v_bs, v_rs, o_bs, o_rs, scale, s))
  switch (d) {
#define FLASH_CASE(D, ...) \
  case D: return FLASH_LAUNCH(D, __VA_ARGS__);
    FLASH_VARIANTS(FLASH_CASE)
#undef FLASH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}

}  // namespace

// Plain C entry points (bound with ctypes).  q, k, v are bf16 device
// pointers; strides are in elements; d is one of 16, 32, 40, 64, 72, 80,
// 128, 160, 256, 512, rows and pointers 16-byte aligned (checked by the Python
// wrapper).  flash_sdpa_bf16 writes O in bf16; flash_sdpa_bf16_lse writes O
// in float32 and the rows' log-sum-exp into lse, float32 [B, H, Lq]
// contiguous.  Each returns the launch's cudaError_t (0 on success).
extern "C" int flash_sdpa_bf16(const void* q, const void* k, const void* v,
                               void* o, int b, int heads, int lq, int kv_len,
                               int d, long long q_bs, long long q_rs,
                               long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, long long o_bs, long long o_rs,
                               float scale, void* stream) {
  return flash_entry<false>(q, k, v, o, nullptr, b, heads, lq, kv_len, d, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, stream);
}

extern "C" int flash_sdpa_bf16_lse(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int b, int heads, int lq,
                                   int kv_len, int d, long long q_bs, long long q_rs,
                                   long long k_bs, long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs, long long o_rs,
                                   float scale, void* stream) {
  return flash_entry<true>(q, k, v, o, static_cast<float*>(lse), b, heads, lq, kv_len,
                           d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale,
                           stream);
}

// The variant that head dim d runs (its LSE instance if lse is nonzero):
// registers per thread (as compiled), dynamic shared memory bytes and
// threads per block, KV rows per tile and query rows per block.  Returns a
// cudaError_t (invalid value for an unsupported d).
extern "C" int flash_sdpa_variant(int d, int lse, int* registers, int* smem_bytes,
                                  int* threads, int* block_k, int* block_q) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
#define FLASH_CASE(D, ...)                                         \
  case D: {                                                        \
    using C = Config<D, __VA_ARGS__>;                              \
    err = lse ? cudaFuncGetAttributes(&attr, flash_fwd_kernel<C, true>)   \
              : cudaFuncGetAttributes(&attr, flash_fwd_kernel<C, false>); \
    *smem_bytes = C::SMEM;                                         \
    *threads = C::THREADS;                                         \
    *block_k = C::BK;                                              \
    *block_q = C::BQ;                                              \
    break;                                                         \
  }
    FLASH_VARIANTS(FLASH_CASE)
#undef FLASH_CASE
    default: return static_cast<int>(err);
  }
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}
