// Quantized matmul for Hopper (sm_90a): out[M, N] = (xq @ wq) * sw in fp32,
// with 8-bit operands on the tensor cores.
//
// Replaces the Pallas TPU kernel distrifuser_tpu/ops/quant_matmul.py
// (_qmm_kernel, launched by quant_matmul through pl.pallas_call).  Same
// arithmetic:
// * int8:  s8 x s8 products summed in int32 (mma.sync m16n8k32 .s32.s8.s8),
//          converted to fp32 (round to nearest) and multiplied by sw[n];
// * fp8:   e4m3 x e4m3 products summed in fp32 (mma.sync m16n8k32
//          .f32.e4m3.e4m3), multiplied by sw[n];
// * the per-output-channel weight scale sw is applied in the epilogue, once,
//   while the sum is still in registers (the TPU kernel applies it on its
//   last K step while the accumulator is still in VMEM).
//
// Operands: xq [M, K] row-major (K contiguous); wq is the [K, N] weight held
// column-major, i.e. its memory is [N, K] with K contiguous (torch's Linear
// layout).  That is the .row.col operand pair mma.sync takes, so both tiles
// are staged with 16-byte copies and every fragment register is one aligned
// 32-bit shared-memory load (8-bit data has no ldmatrix.trans).
//
// Design for the GPU rather than the TPU grid:
// * one 256-thread block per 128x128 output tile; the TPU grid's sequential
//   K axis becomes a loop over 64-byte K slices inside the block;
// * the slices are staged through a two-stage cp.async ring in shared
//   memory (rows padded to 80 bytes, so the fragment loads of a warp hit 32
//   distinct banks); each of the 8 warps owns a 64x32 sub-tile held in
//   registers;
// * ragged edges are masked here, not padded by the caller: rows past M or
//   N and K columns past K are zero-filled in shared memory (a zero MAC is
//   exact, as the TPU wrapper's zero padding is), and outputs past M or N are
//   not stored.  When K is not a multiple of 16 or a base pointer is not
//   16-byte aligned, the slices are staged byte by byte instead (the entry
//   point decides from K and the pointers);
// * fp8 promotion: Hopper's fp8 tensor-core accumulation is reported to
//   keep fewer than 32 significant bits (DeepSeek-V3 report, for wgmma), so
//   every 64-deep K slice is summed in a fresh MMA accumulator and then
//   added into a separate fp32 register sum.  For this mma.sync kernel a
//   single accumulator over the whole K was measured as accurate (below
//   3e-7 relative at K <= 5120) and 2-6% faster (PERF.md); the promotion is
//   kept as the guard the TPU arithmetic's fp32 sum implies.
//
// What bounds it: the contract's output is fp32 [M, N], 4 bytes per output
// against 1 byte per input element, so at the UNet's shapes (K = 320..5120)
// the bytes moved, (M*K + K*N + 4*N + 4*M*N), bound it more often than the
// 2*M*N*K operations at the 1,979 TOP/s 8-bit rate.  Folding the per-token
// scale and the bf16 cast into this epilogue would cut that 4x, but changes
// the contract.  This first version (mma.sync, no wgmma/TMA, one block per
// tile) is below both bounds; PERF.md keeps its measured times.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquant_matmul.so quant_matmul.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 64;   // K bytes per staged slice
constexpr int kLd = kBK + 16;  // padded shared-memory row, bytes
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 64 rows per warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns per warp
constexpr int kMT = kWM / 16;       // m16 tiles per warp
constexpr int kNT = kWN / 8;        // n8 tiles per warp
constexpr int kStages = 2;
constexpr int kStageBytes = (kBM + kBN) * kLd;

enum PayloadType { kInt8 = 0, kFp8 = 1 };

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x kBK bytes of a K-contiguous operand (row stride K) into shared
// memory, starting at global row r0 and column k0; rows >= rows_valid and
// columns >= K are zero-filled
template <bool kAligned>
__device__ inline void stage_operand(uint8_t* dst, const uint8_t* src,
                                     int rows, int r0, int rows_valid,
                                     int k0, int K) {
  if (kAligned) {  // K % 16 == 0: a 16-byte chunk is wholly in or out
    constexpr int kChunks = kBK / 16;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      const bool ok = (r0 + r) < rows_valid && (k0 + c) < K;
      const uint8_t* g = ok ? src + (size_t)(r0 + r) * K + k0 + c : src;
      cp_async16(dst + r * kLd + c, g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const bool ok = (r0 + r) < rows_valid && (k0 + c) < K;
      dst[r * kLd + c] = ok ? src[(size_t)(r0 + r) * K + k0 + c] : 0;
    }
  }
}

__device__ inline uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ inline void mma(int (&c)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline float to_float(int v) { return __int2float_rn(v); }
__device__ inline float to_float(float v) { return v; }

// Acc: the MMA accumulator type (int for s8, float for e4m3)
template <typename Acc, bool kAligned>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           const float* __restrict__ sw, float* __restrict__ out, int M, int N,
           int K) {
  // fp8 adds the MMA accumulator into a separate fp32 sum after every K
  // slice; int32 sums are exact and need no promotion
  constexpr bool kPromote = std::is_same<Acc, float>::value;
  __shared__ __align__(16) uint8_t smem[kStages * kStageBytes];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // mma groupID
  const int t = lane % 4;  // mma threadID_in_group
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  Acc acc[kMT][kNT][4];
  float sum[kPromote ? kMT : 1][kPromote ? kNT : 1][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = Acc(0);
        if constexpr (kPromote) sum[i][j][e] = 0.f;
      }

  auto stage = [&](int s, int k0) {
    uint8_t* as = smem + s * kStageBytes;
    uint8_t* bs = as + kBM * kLd;
    stage_operand<kAligned>(as, a, kBM, m0, M, k0, K);
    stage_operand<kAligned>(bs, b, kBN, n0, N, k0, K);
  };

  const int n_slices = (K + kBK - 1) / kBK;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_slices; ++kt) {
    if (kt + 1 < n_slices) stage((kt + 1) % kStages, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest is done: slice kt
    __syncthreads();

    const uint8_t* as = smem + (kt % kStages) * kStageBytes;
    const uint8_t* bs = as + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4];
      uint32_t bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint8_t* p = as + (wm * kWM + i * 16 + g) * kLd + kk + t * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kLd);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint8_t* p = bs + (wn * kWN + j * 8 + g) * kLd + kk + t * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(acc[i][j], af[i], bf[j]);
    }
    if constexpr (kPromote) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][j][e] += to_float(acc[i][j][e]);
            acc[i][j][e] = Acc(0);
          }
    }
    __syncthreads();  // slice kt is read; the next iteration refills it
  }

  // epilogue: fp32 sum times the output channel's weight scale, one store
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * kWM + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * kWN + j * 8 + t * 2 + (e & 1);
        if (row < M && col < N) {
          float v;
          if constexpr (kPromote) {
            v = sum[i][j][e];
          } else {
            v = to_float(acc[i][j][e]);
          }
          out[(size_t)row * N + col] = v * sw[col];
        }
      }
}

template <typename Acc>
cudaError_t launch(const void* a, const void* b, const float* sw, float* out,
                   int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  // 16-byte cp.async needs every row start 16-byte aligned
  const bool aligned = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (aligned) {
    qmm_kernel<Acc, true>
        <<<grid, kThreads, 0, stream>>>(pa, pb, sw, out, M, N, K);
  } else {
    qmm_kernel<Acc, false>
        <<<grid, kThreads, 0, stream>>>(pa, pb, sw, out, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  a: xq [M, K] row-major, int8 or
// float8_e4m3fn bytes; b: wq [K, N] column-major (memory [N, K]), the same
// payload type; sw: fp32 [N]; out: fp32 [M, N] row-major.  payload: 0 int8,
// 1 fp8 e4m3.  Returns the launch's cudaError_t (0 on success).
extern "C" int quant_matmul_8bit(const void* a, const void* b, const float* sw,
                                 float* out, int M, int N, int K, int payload,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload == kInt8) {
    return static_cast<int>(launch<int>(a, b, sw, out, M, N, K, s));
  }
  if (payload == kFp8) {
    return static_cast<int>(launch<float>(a, b, sw, out, M, N, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
