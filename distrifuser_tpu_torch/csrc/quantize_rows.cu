// Per-token activation quantization in one pass over the activation, for
// Hopper (sm_90a): for each row of x [M, K],
//
//   amax = max |x|
//   s    = max(amax, 1e-12) * (1 / LIMIT)           LIMIT = 127 or 448
//   xq   = clip(round_half_even(x / s), +-127) as int8, or
//          (x / s) cast to e4m3 (round to nearest even)
//
// and writes xq [M, K] (8-bit, row-major: the A operand of
// csrc/quant_matmul.cu) and s [M] in fp32.  No Pallas counterpart: the JAX
// package leaves this to XLA, which fuses it into the ops around it
// (distrifuser_tpu/parallel/compress.py quantize); the port's plain version
// is parallel/compress.py quantize, run eagerly as about nine launches with
// an fp32 copy of the activation.
//
// Bit for bit with that plain version on the card:
// * the scale is amax times the fp32 reciprocal of LIMIT, because that is
//   how PyTorch's CUDA division by a Python scalar computes
//   clamp(amax) / LIMIT;
// * x / s is a correctly rounded division (__fdiv_rn; this file is never
//   built with --use_fast_math), as PyTorch's tensor-by-tensor division is;
// * rounding is half to even (rintf), as torch.round's;
// * the e4m3 cast is cvt.rn.satfinite: round to nearest even, as
//   PyTorch's software cast; the two differ only past 464, and |x / s| <=
//   448 up to one rounding here.
//
// Design: one warp per row, eight rows per 256-thread block.  Pass 1 reads
// the row in 16-byte vectors and reduces |x| to the row max with
// __shfl_xor_sync; pass 2 reads the row again (an L1/L2 hit: a row is at
// most 10 KB at K = 5120) and writes the payload in 8- or 4-byte vectors.
// Rows whose K or alignment does not allow vectors take scalar loads.
//
// What bounds it: bytes.  It reads x once from device memory (2 bytes per
// element in bf16) and writes 1 byte per element plus 4 per row; no
// operation count comes near the card's rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquantize_rows.so quantize_rows.cu

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum InType { kInF32 = 0, kInBF16 = 1 };
enum Payload { kInt8 = 0, kFp8 = 1 };

constexpr int kRowsPerBlock = 8;
constexpr float kScaleFloor = 1e-12f;  // an all-zero row: exact zeros

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool kFp8>
__device__ __forceinline__ uint8_t quantize_one(float x, float s) {
  const float v = __fdiv_rn(x, s);
  if constexpr (kFp8) {
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  } else {
    const float r = fminf(fmaxf(rintf(v), -127.f), 127.f);
    return static_cast<uint8_t>(static_cast<int8_t>(r));
  }
}

// V: elements per 16-byte load (1: scalar loads)
template <typename InT, bool kFp8, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
quantize_rows_kernel(const InT* __restrict__ x, long long ldx, uint8_t* __restrict__ q,
                     float* __restrict__ scale, int M, int K) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const InT* xr = x + row * ldx;
  uint8_t* qr = q + static_cast<long long>(row) * K;
  struct alignas(V * sizeof(InT)) Vec {
    InT v[V];
  };
  struct alignas(V) Out {
    uint8_t v[V];
  };
  const int n_vec = K / V;

  float amax = 0.f;
  for (int c = lane; c < n_vec; c += 32) {
    const Vec in = reinterpret_cast<const Vec*>(xr)[c];
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(widen(in.v[e])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = fmaxf(amax, kScaleFloor) * (1.0f / (kFp8 ? 448.0f : 127.0f));
  if (lane == 0) scale[row] = s;

  for (int c = lane; c < n_vec; c += 32) {
    const Vec in = reinterpret_cast<const Vec*>(xr)[c];
    Out o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = quantize_one<kFp8>(widen(in.v[e]), s);
    reinterpret_cast<Out*>(qr)[c] = o;
  }
}

template <typename InT, bool kFp8>
cudaError_t launch(const void* x, long long ldx, void* q, float* scale, int M, int K,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(InT);
  const InT* xp = static_cast<const InT*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool vec = K % V == 0 && ldx % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % V == 0;
  if (vec) {
    quantize_rows_kernel<InT, kFp8, V>
        <<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, ldx, qp, scale, M, K);
  } else {
    quantize_rows_kernel<InT, kFp8, 1>
        <<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, ldx, qp, scale, M, K);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: [M, K] with unit column
// stride and row stride ldx elements, fp32 (in_type 0) or bf16 (1); q:
// [M, K] row-major int8 (payload 0) or e4m3 (1) bytes; scale: fp32 [M].
// Returns the launch's cudaError_t (0 on success).
extern "C" int quantize_rows(const void* x, long long ldx, void* q, float* scale, int M,
                             int K, int in_type, int payload, void* stream) {
  if (M <= 0 || K <= 0 || ldx < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kInBF16 && payload == kInt8) {
    return static_cast<int>(launch<__nv_bfloat16, false>(x, ldx, q, scale, M, K, s));
  }
  if (in_type == kInBF16 && payload == kFp8) {
    return static_cast<int>(launch<__nv_bfloat16, true>(x, ldx, q, scale, M, K, s));
  }
  if (in_type == kInF32 && payload == kInt8) {
    return static_cast<int>(launch<float, false>(x, ldx, q, scale, M, K, s));
  }
  if (in_type == kInF32 && payload == kFp8) {
    return static_cast<int>(launch<float, true>(x, ldx, q, scale, M, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
