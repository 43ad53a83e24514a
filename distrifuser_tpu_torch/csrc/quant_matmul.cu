// Quantized matmul for Hopper (sm_90a): out[M, N] = (xq @ wq) * sw with
// 8-bit operands on the tensor cores, in two epilogue forms.
//
// Replaces the Pallas TPU kernel distrifuser_tpu/ops/quant_matmul.py:54
// (_qmm_kernel, launched through pl.pallas_call by quant_matmul).  Same
// arithmetic:
// * int8:  s8 x s8 products summed in int32 (wgmma .s32.s8.s8; no
//          .satfinite: 5120 * 127^2 < 2^31), converted to fp32 (round to
//          nearest) and multiplied by sw[n];
// * fp8:   e4m3 x e4m3 products summed in fp32 (wgmma .f32.e4m3.e4m3),
//          multiplied by sw[n].
// Two epilogues of one kernel template:
// (a) the JAX contract: fp32 out[m, n] = float(acc) * sw[n];
// (b) the fused form of ops/linear.py's "pallas" route: out[m, n] =
//     cast((float(acc) * sw[n]) * sx[m]) in bf16 (or fp32), with sx the
//     per-token activation scale, optionally followed by the bias added as
//     linear adds it (the cast output plus bias[n] in fp32, cast again).
//     The fp32 multiplications run in the order of quant_matmul(...) *
//     sx[..., None] followed by .to(bf16), so int8 is bit-identical to it.
//
// Operands: xq [M, K] row-major (K contiguous) and wq's memory [N, K] (K
// contiguous; the [K, N] payload is its transpose view): both are K-major,
// which is the only layout 8-bit wgmma takes (it has no transpose bit).
//
// Design.
// * BM x BN output tiles (BM = 128): two consumer warpgroups of 64 rows
//   each, then one producer warp (288 threads).  The grid is persistent:
//   min(tiles, MINB x SMs) blocks, each walking tiles blockIdx.x,
//   + gridDim.x, ... (N tiles fastest); the TPU grid's sequential K axis
//   becomes a loop over 128-byte K slices inside a tile.
// * The producer's lane 0 keeps a ring of STAGES (A, B) slice pairs in
//   flight with TMA (cp.async.bulk.tensor.2d, 128-byte swizzle: one K slice
//   per row is one swizzle row), signalling each stage's "full" mbarrier
//   with the bytes landed, and runs on into the block's next tile while the
//   consumers store the current one; consumers release a stage on its
//   "empty" mbarrier (one arrival per consumer thread).  A slice counter
//   that runs across tiles gives each barrier's phase.  No __syncthreads
//   after set-up.
// * Each consumer warpgroup issues four wgmma m64nBNk32 per slice with A
//   and B read from shared memory through descriptors (K-major, SBO = 8
//   rows of 128 bytes; a 32-byte K step advances the start address inside
//   the swizzled row).  int8 keeps one wgmma group in flight across slices
//   (wait_group 1, then the previous slice's stage is released).
// * fp8 promotion: each 128-deep K slice is summed in a fresh wgmma
//   accumulator, which is added into a separate fp32 register sum once its
//   group has drained (wait_group 0): wgmma's fp8 accumulation keeps fewer
//   bits than fp32 (DeepSeek-V3 report; PERF.md has the error measured with
//   and without).  Alternating two fresh accumulators so that one slice's
//   wgmma overlaps the previous slice's addition was tried: ptxas then
//   serializes the wgmma (C7514, accumulator registers read inside the
//   async window) and spills; it ran several times slower in a one-off
//   probe on the card.  While one warpgroup drains, the other three of
//   its SM (two blocks) keep the tensor cores busy.
// * Tiles (one per payload, not per shape), both with two blocks per SM so
//   that one block's epilogue overlaps the other's K loop: int8 BN = 128,
//   3 stages of 32 KB; fp8 BN = 64 (the promoted sum doubles the
//   accumulator registers), 4 stages of 24 KB.  For two 288-thread blocks
//   per SM ptxas caps a thread at 96 registers (the int8 bf16 instance
//   spills a few hundred bytes in its epilogue).  One-off probes on the card
//   found fp8 BN = 128 with one block per SM slower at most shapes in the
//   fused form, and a 128 x 256 int8 tile (one block per SM), a 128 x 64
//   int8 tile and a non-persistent grid no faster overall.  At large N
//   each block reads its A and B slices from L2 again, (BM + BN) * K bytes
//   per tile, about 420 MB for the (8192, 640, 5120) product at BN = 128:
//   L2 bandwidth, not the card's rates, is the likely limit there (not
//   measured).
// * Ragged edges: TMA zero-fills rows past M or N and K columns past K (a
//   zero MAC is exact, as the TPU wrapper's zero padding is); outputs past
//   M or N are not stored.  TMA needs 16-byte aligned bases and row
//   strides: the Python wrapper hands over a padded or re-allocated copy
//   where an operand has neither (K % 16 != 0, a shifted view).
// * Epilogue straight from the accumulator fragments, the token scales
//   loaded before the K loop.  bf16 output with N % 8 == 0 (every shape of
//   the path): the four lanes that share a row swap their packed column
//   pairs (quad_transpose) so that each holds eight adjacent columns, and
//   a warp store writes 64 contiguous bytes of each of 8 rows.  Storing
//   the pairs as they lie (4 bytes a lane, half a 32-byte sector per row)
//   made the bf16 form slower than the fp32 one although it writes half
//   the bytes (PERF.md).  Other outputs store the pairs (bf16x2 or
//   float2).
// * Host cost per launch: a tensor map depends only on (pointer, rows, K,
//   row stride, box rows), so both A's and B's are cached under that key
//   (an encoding is a pure function of its key, so a pointer that the
//   caching allocator hands out again still gets a correct map; A's
//   activations come back at a few hundred such keys per pipeline call);
//   cudaFuncSetAttribute runs once per instance.
//
// What bounds it: 2*M*N*K operations at 1,979 TOP/s against M*K + K*N +
// 4*N bytes in plus 4*M*N (contract) or 4*M + 2*M*N (fused, bf16) bytes at
// 3.35 TB/s.  The fused form moves half the contract's bytes; at the UNet's
// shapes (K = 640..5120) both bounds are close, so neither dominates.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquant_matmul.so quant_matmul.cu

#include <cuda_bf16.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "sm90.cuh"

namespace {

enum Payload { kInt8 = 0, kFp8 = 1 };
enum OutType { kOutF32 = 0, kOutBF16 = 1 };

// ---------------------------------------------------------------------------
// wgmma m64nNk32, both operands K-major in shared memory (descriptors)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_e4m3_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <bool kInt, int BN>
__device__ __forceinline__ void wgmma_8bit(
    std::conditional_t<kInt, int, float> (&d)[BN / 2], uint64_t da, uint64_t db,
    int scale_d) {
  if constexpr (kInt) wgmma_s8_n128(d, da, db, scale_d);
  else wgmma_e4m3_n64(d, da, db, scale_d);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// P: payload; BN: output columns per block; STAGES: ring depth; MINB: blocks
// per SM the registers are budgeted for.  fp8 sums are promoted to fp32.
template <int P, int BN_, int STAGES_, int MINB_>
struct Config {
  static constexpr bool INT8 = P == kInt8;
  static constexpr int BM = 128, BN = BN_, BK = 128, STAGES = STAGES_, MINB = MINB_;
  static constexpr bool PROMOTE = !INT8;
  static constexpr int THREADS = 2 * 128 + 32;
  static constexpr int A_BYTES = BM * BK;  // one byte per element
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  // +1024: the dynamic window is aligned up to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + BAR_OFFSET + 2 * STAGES * 8;
  static_assert(INT8 ? BN == 128 : BN == 64, "tile");
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// out[row, col] and out[row, col + 1] from two fp32 values: cast, then the
// bias added in fp32 to the cast value and cast again (linear's order)
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* out, const OutT* bias, int col,
                                           float v0, float v1, bool both, bool paired) {
  OutT o0 = from_float<OutT>(v0), o1 = from_float<OutT>(v1);
  if (bias != nullptr) {
    o0 = from_float<OutT>(widen(o0) + widen(bias[col]));
    if (both) o1 = from_float<OutT>(widen(o1) + widen(bias[col + 1]));
  }
  if (paired) {  // both columns in range, 2-element aligned
    if constexpr (std::is_same<OutT, float>::value) {
      *reinterpret_cast<float2*>(out) = make_float2(o0, o1);
    } else {
      __nv_bfloat162 p;
      p.x = o0;
      p.y = o1;
      *reinterpret_cast<__nv_bfloat162*>(out) = p;
    }
  } else {
    out[0] = o0;
    if (both) out[1] = o1;
  }
}

// 4 x 4 transpose of 32-bit words across the four lanes of a quad: lane q
// holds row q in w[0..3]; afterwards w[s] is lane s's w[q].  Round r: each
// lane sends its word (q + r) % 4 and takes lane (q - r) % 4's.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int lane) {
  const int q = lane % 4;
  uint32_t u[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int send = (q + r) % 4, src = (q + 4 - r) % 4;
    const uint32_t v = send == 0 ? w[0] : send == 1 ? w[1] : send == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_sync(0xffffffffu, v, (lane & ~3) | src);
#pragma unroll
    for (int e = 0; e < 4; ++e) u[e] = e == src ? got : u[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = u[e];
}

// The bf16 epilogue with 16-byte stores, for N % 8 == 0: each thread casts
// its column pairs (bias added as store_pair does) into packed words, a
// quad transposes every four 8-column groups so that each lane holds eight
// adjacent columns, and a warp store covers 64 contiguous bytes of 8 rows.
// All lanes shuffle, so rows past M and columns past N are masked only at
// the store.
template <int BN, typename Acc>
__device__ __forceinline__ void store_wide(const Acc (&acc)[BN / 2], __nv_bfloat16* out,
                                           const float* sw, const __nv_bfloat16* bias,
                                           const float (&rs)[2], int r0, int n0, int M,
                                           int N, int lane) {
  const int q = lane % 4;
#pragma unroll
  for (int g = 0; g < BN / 32; ++g) {
    uint32_t w[2][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * g + jj;
      const int col = n0 + 8 * j + 2 * q;
      const bool in = col < N;  // N even: col + 1 < N too
      const float w0 = in ? sw[col] : 0.f, w1 = in ? sw[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        __nv_bfloat16 o0 = __float2bfloat16_rn(to_float(acc[i]) * w0 * rs[half]);
        __nv_bfloat16 o1 = __float2bfloat16_rn(to_float(acc[i + 1]) * w1 * rs[half]);
        if (bias != nullptr && in) {
          o0 = __float2bfloat16_rn(__bfloat162float(o0) + __bfloat162float(bias[col]));
          o1 = __float2bfloat16_rn(__bfloat162float(o1) + __bfloat162float(bias[col + 1]));
        }
        __nv_bfloat162 p;
        p.x = o0;
        p.y = o1;
        w[half][jj] = *reinterpret_cast<uint32_t*>(&p);
      }
    }
    const int col8 = n0 + 8 * (4 * g + q);  // this lane's eight columns
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      quad_transpose(w[half], lane);
      const int row = r0 + 8 * half;
      if (row < M && col8 < N) {
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col8) =
            make_uint4(w[half][0], w[half][1], w[half][2], w[half][3]);
      }
    }
  }
}

template <class C, typename OutT>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
qmm_kernel(const __grid_constant__ CUtensorMap a_map,
           const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sw,
           const float* __restrict__ sx, const OutT* __restrict__ bias,
           OutT* __restrict__ out, int M, int N, int K) {
  using Acc = std::conditional_t<C::INT8, int, float>;
  constexpr int NACC = C::BN / 2;  // accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atom
  const uint32_t bars = base + C::BAR_OFFSET;
  auto a_tile = [&](int s) { return base + s * C::STAGE_BYTES; };
  auto b_tile = [&](int s) { return base + s * C::STAGE_BYTES + C::A_BYTES; };
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (C::STAGES + s); };

  const int n_k = (K + C::BK - 1) / C::BK;
  const int n_n = (N + C::BN - 1) / C::BN;
  const int n_tiles = n_n * ((M + C::BM - 1) / C::BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tiles tile = blockIdx.x, + gridDim.x, ... (N tiles fastest); `it` counts
  // K slices over all of this block's tiles, so stage it % STAGES is used
  // for the (it / STAGES)-th time: the parity its barriers wait on.
  if (threadIdx.x >= 2 * 128) {
    // producer warp: lane 0 keeps the ring full, running into the next tile
    // while the consumers finish the current one
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_n) * C::BM, n0 = (tile % n_n) * C::BN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) mbar_wait(empty_bar(s), (it / C::STAGES - 1) & 1);
          mbar_expect_tx(full_bar(s), C::STAGE_BYTES);
          tma_load_2d(a_tile(s), &a_map, full_bar(s), kt * C::BK, m0);
          tma_load_2d(b_tile(s), &b_map, full_bar(s), kt * C::BK, n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: output rows m0 + 64 * wg .. + 64, all BN columns
  const int wg = threadIdx.x / 128;
  constexpr uint32_t kSbo = 8 * C::BK;  // next 8-row group
  // wait for slice `it`, then issue its four wgmma into d (scale_d 0 on
  // the first one starts d afresh)
  auto issue = [&](Acc(&d)[NACC], int it, bool fresh) {
    const int s = it % C::STAGES;
    mbar_wait(full_bar(s), (it / C::STAGES) & 1);
    const uint32_t a_rows = a_tile(s) + wg * 64 * C::BK;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 32; ++kk) {
      const uint64_t da = make_desc(a_rows + kk * 32, 16, kSbo, 1);
      const uint64_t db = make_desc(b_tile(s) + kk * 32, 16, kSbo, 1);
      wgmma_8bit<C::INT8, C::BN>(d, da, db, (fresh && kk == 0) ? 0 : 1);
    }
    wgmma_commit();
  };
  auto release = [&](int it) { mbar_arrive(empty_bar(it % C::STAGES)); };
  // sum += part once part's wgmma group has completed
  auto add_into = [](Acc(&sum)[NACC], Acc(&part)[NACC]) {
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] += part[i];
  };

  // epilogue fragment: thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8)
  // and columns 8 j + 2 (l % 4) (+ 1) of the warpgroup's 64 x BN tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  // bf16 rows of whole 8-column groups, 16-byte aligned: 16-byte stores
  const bool wide = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_n) * C::BM, n0 = (tile % n_n) * C::BN;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    // the rows' token scales, loaded before the K loop hides their latency
    float rs[2] = {1.f, 1.f};
    if (sx != nullptr) {
      if (r0 < M) rs[0] = sx[r0];
      if (r0 + 8 < M) rs[1] = sx[r0 + 8];
    }
    // acc: the tile's sum (int8) or, for fp8, the
    // fp32 sum that each slice's fresh accumulator is added into once its
    // wgmma group has completed
    Acc acc[NACC];
    if constexpr (C::PROMOTE) {
      Acc part[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        issue(part, it, true);
        wgmma_wait<0>();
        release(it);
        add_into(acc, part);
      }
    } else {
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        issue(acc, it, kt == 0);
        // one group stays in flight: the previous slice's stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);
    }

    // epilogue, straight from the accumulator fragment
    if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
      if (wide) {
        store_wide<C::BN>(acc, out, sw, bias, rs, r0, n0, M, N, lane);
        continue;
      }
    }
    const bool even_n = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
      const bool both = col + 1 < N;
      const float w0 = sw[col];
      const float w1 = both ? sw[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= M) continue;
        const int i = 4 * j + 2 * half;
        float v0 = to_float(acc[i]) * w0;
        float v1 = to_float(acc[i + 1]) * w1;
        if (sx != nullptr) {
          v0 *= rs[half];
          v1 *= rs[half];
        }
        store_pair(out + (size_t)row * N + col, bias, col, v0, v1, both, both && even_n);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// 2-D map (K, rows) over 8-bit rows of `ld` bytes; boxes of 128 x box_rows,
// 128-byte swizzle
bool encode_map(CUtensorMap* map, const void* ptr, int k, int rows, long long ld,
                int box_rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A's and B's maps, cached by everything that goes into the encoding
struct MapKey {
  const void* ptr;
  long long ld;
  int n, k, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && ld == o.ld && n == o.n && k == o.k && box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& key) const {
    size_t h = std::hash<const void*>()(key.ptr);
    for (long long v : {key.ld, (long long)key.n, (long long)key.k, (long long)key.box_rows}) {
      h = h * 1000003u ^ std::hash<long long>()(v);
    }
    return h;
  }
};
constexpr size_t kMaxCachedMaps = 4096;

bool cached_map(CUtensorMap* map, const void* ptr, int rows, int k, long long ld,
                int box_rows) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, ld, rows, k, box_rows};
  std::lock_guard<std::mutex> guard(lock);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_map(map, ptr, k, rows, ld, box_rows)) return false;
  if (cache.size() >= kMaxCachedMaps) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// SMs of the current device (looked up once per device)
int sm_count() {
  static int counts[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  int& n = counts[device & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <class C, typename OutT>
cudaError_t launch(const void* a, long long lda, const void* b, long long ldb,
                   const float* sw, const float* sx, const void* bias, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_kernel<C, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap a_map, b_map;
  if (!cached_map(&a_map, a, M, K, lda, C::BM) ||
      !cached_map(&b_map, b, N, K, ldb, C::BN)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = ((N + C::BN - 1) / C::BN) * ((M + C::BM - 1) / C::BM);
  const int grid = tiles < C::MINB * sm_count() ? tiles : C::MINB * sm_count();
  qmm_kernel<C, OutT><<<grid, C::THREADS, C::SMEM, stream>>>(
      a_map, b_map, sw, sx, static_cast<const OutT*>(bias), static_cast<OutT*>(out), M,
      N, K);
  return cudaGetLastError();
}

// The instances: X(name, payload, BN, STAGES, MINB)
#define QMM_TILES(X)             \
  X(Int8, kInt8, 128, 3, 2)      \
  X(Fp8, kFp8, 64, 4, 2)

enum Tile {
#define QMM_ENUM(name, ...) kTile##name,
  QMM_TILES(QMM_ENUM)
#undef QMM_ENUM
};

Tile pick_tile(int payload) { return payload == kFp8 ? kTileFp8 : kTileInt8; }

}  // namespace

// Plain C entry point (bound with ctypes).  a: xq [M, K], rows of lda bytes;
// b: the [K, N] payload's memory [N, K], rows of ldb bytes (both 8-bit,
// 16-byte aligned bases and row strides, K >= 16: checked by the Python
// wrapper); sw: fp32 [N]; sx: fp32 [M] or null (contract form); bias: [N]
// of the output type or null; out: [M, N] row-major.  payload: 0 int8, 1 fp8
// e4m3; out_type: 0 fp32, 1 bf16.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int quant_matmul_8bit(const void* a, long long lda, const void* b,
                                 long long ldb, const float* sw, const float* sx,
                                 const void* bias, void* out, int M, int N, int K,
                                 int payload, int out_type, void* stream) {
  if (M <= 0 || N <= 0 || K < 16 || (payload != kInt8 && payload != kFp8) ||
      (out_type != kOutF32 && out_type != kOutBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = out_type == kOutF32;
  switch (pick_tile(payload)) {
#define QMM_CASE(name, ...)                                                          \
  case kTile##name: {                                                                \
    using C = Config<__VA_ARGS__>;                                                   \
    return static_cast<int>(                                                         \
        f32 ? launch<C, float>(a, lda, b, ldb, sw, sx, bias, out, M, N, K, s)        \
            : launch<C, __nv_bfloat16>(a, lda, b, ldb, sw, sx, bias, out, M, N, K, s)); \
  }
    QMM_TILES(QMM_CASE)
#undef QMM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance a product of `payload` runs: registers per thread (as
// compiled, bf16 output), dynamic shared memory bytes, threads per block,
// output columns per block, ring stages.  Returns a cudaError_t.
extern "C" int quant_matmul_variant(int payload, int* registers, int* smem_bytes, int* threads,
                                    int* block_n, int* stages) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (pick_tile(payload)) {
#define QMM_CASE(name, ...)                                              \
  case kTile##name: {                                                    \
    using C = Config<__VA_ARGS__>;                                       \
    err = cudaFuncGetAttributes(&attr, qmm_kernel<C, __nv_bfloat16>);    \
    *smem_bytes = C::SMEM;                                               \
    *threads = C::THREADS;                                               \
    *block_n = C::BN;                                                    \
    *stages = C::STAGES;                                                 \
    break;                                                               \
  }
    QMM_TILES(QMM_CASE)
#undef QMM_CASE
  }
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}
