// What the refresh codec's two kernels share (csrc/quantize_rows.cu, the
// encoder, and csrc/dequantize_rows.cu, the decoder): the block size, the
// segments a launch's table holds, the search for a block's segment, the
// widening of a source element and the alignment test of the vector paths.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A launch's table is one kernel parameter of up to about 32 KB: CUDA 12.1
// allows 32,764 bytes of parameters on sm_70 and later.
#if defined(CUDART_VERSION) && CUDART_VERSION < 12010
#error "the segment table is a large kernel parameter: CUDA 12.1 or later"
#endif

namespace codec {

constexpr int kThreads = 256;   // threads a block
constexpr int kCapacity = 192;  // segments a launch's table holds

// The segment of ``block``: the last whose first block is not after it.
template <typename Table>
__device__ __forceinline__ int find_segment(const Table& t, int block) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].block0 <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace codec
