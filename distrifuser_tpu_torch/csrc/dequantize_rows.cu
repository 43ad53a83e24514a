// Per-row dequantization for Hopper (sm_90a): the decoder of the patch
// path's compressed refresh payloads, fused with what the context does with
// a decoded row.  For output row j of a part,
//
//   out[j] = cast(base[j] + q[j / k] * s[j / k])   j % k == r (refreshed)
//   out[j] = prev[j]                               every other row
//
// with k = 1, r = 0 when every row refreshes and the base term only under
// residual coding.  The counterpart of the JAX package's dequantize
// (distrifuser_tpu/parallel/compress.py:142, left to XLA) followed by the
// residual add and scatter_every_kth; the port's plain version is
// ops/quantize.py's composition of parallel/compress.py (dequantize,
// take_every_kth(base).float() + ..., .to(dtype), scatter_every_kth, and
// torch.stack of a halo's two halves), about eight launches a payload.
//
// Bit for bit with that plain version on the card: the payload widens
// exactly (int8 and e4m3 are exact in fp32), q * s is one correctly rounded
// fp32 multiplication (__fmul_rn) and base + q * s one correctly rounded
// fp32 addition (__fadd_rn): the intrinsics keep nvcc from contracting the
// two into a fused multiply-add, which PyTorch's two separate kernels never
// do.  The cast to bf16 rounds to nearest even (__float2bfloat16_rn), as
// PyTorch's .to(torch.bfloat16).
//
// The output is always a new buffer (the context's double buffer forbids
// writing into a tensor the step still reads), contiguous [parts, rows, K]:
// the gathered KV [n, B, L / n, 2C] with the n ranks as parts, or a halo
// buffer [2, B, halo, W, C] with the two halves as parts, which replaces the
// stack of the halves.  A part's payload and scales may lie anywhere (the
// two halves of a halo exchange arrive in two receive buffers, the
// gathered flat buffer holds every rank's payloads at one stride): each
// part is reached by a byte offset from part 0.
//
// What one launch covers: a table of segments passed by value as the
// kernel's parameter, as csrc/quantize_rows.cu's (up to kCapacity of them,
// CUDA 12.1 or later), so that the batched flush of a step decodes every
// layer's refresh, and the sender's own-rows reconstruction of residual
// halo coding, in one launch, straight from the flat receive buffers.
//
// Design: 256-thread blocks, each serving one segment; a team of 32 to 256
// threads serves one output row (about two 16-byte output vectors a
// thread), in 16-byte vectors of the output, base and previous rows and 8-
// or 4-byte vectors of the payload where the alignment allows, else scalar
// accesses.  The rotation r is read from a device scalar when given.
//
// What bounds it: bytes.  It reads one byte a refreshed element, 4 bytes a
// refreshed row, the base of the refreshed rows and the kept rows of the
// previous buffer, and writes every output element; two fp32 operations an
// element are far below the card's rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdequantize_rows.so dequantize_rows.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "refresh_codec.cuh"

namespace {

using codec::aligned;
using codec::find_segment;
using codec::kCapacity;
using codec::kThreads;
using codec::widen;

// DequantSpec.flags
constexpr int kOutBF16 = 1;

// One segment as the host describes it (ops/quantize.py mirrors this layout
// with ctypes).  Strides are in elements of the output type unless named
// bytes.
struct DequantSpec {
  const void* q;           // payload row 0 of part 0; rows of K bytes
  const void* s;           // fp32 scale of row 0 of part 0
  void* out;               // [parts, full_rows, K], contiguous
  const void* base;        // residual base rows (output type), or null
  const void* prev;        // rows a partial refresh keeps, or null
  const long long* rot;    // device rotation r, or null (then rot_const)
  long long q_part;        // bytes between payload parts
  long long s_part;        // bytes between scale parts
  long long base_part;     // between the base's parts
  long long base_ld;       // between the base's rows
  long long prev_part;
  long long prev_ld;
  int parts;
  int full_rows;           // output rows of a part
  int K;
  int every;               // k of the partial refresh (1: every row)
  int rot_const;
  int flags;
};

struct DequantSeg {
  DequantSpec p;
  int block0;  // the segment's first block
  int team;    // threads a row
  int vec;     // 16-byte vectors everywhere
};

template <int CAP>
struct DequantTable {
  int n;
  DequantSeg seg[CAP];
};

static_assert(sizeof(DequantTable<kCapacity>) <= 32764,
              "a launch's segment table must fit the kernel parameter space");


template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kFp8>
__device__ __forceinline__ float payload_value(uint8_t b) {
  if constexpr (kFp8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

template <int V>
struct alignas(V) Bytes {
  uint8_t v[V];
};

// One output row per team; V elements a vector (1: scalar accesses).
template <typename T, bool kFp8, int V>
__device__ __forceinline__ void decode_rows(const DequantSeg& seg, int r) {
  const DequantSpec& p = seg.p;
  const int team = seg.team;
  const int lane = threadIdx.x % team;
  const int o = (blockIdx.x - seg.block0) * (kThreads / team) + threadIdx.x / team;
  if (o >= p.parts * p.full_rows) return;
  const int part = p.parts > 1 ? o / p.full_rows : 0;
  const int j = o - part * p.full_rows;
  const int nvec = p.K / V;
  using Out = Vec<T, V>;
  Out* out = reinterpret_cast<Out*>(static_cast<T*>(p.out) + static_cast<long long>(o) * p.K);
  if (p.every > 1 && j % p.every != r) {  // a row the partial refresh keeps
    const Out* prev = reinterpret_cast<const Out*>(
        static_cast<const T*>(p.prev) + part * p.prev_part + j * p.prev_ld);
    for (int c = lane; c < nvec; c += team) out[c] = prev[c];
    return;
  }
  const int li = p.every > 1 ? j / p.every : j;
  const Bytes<V>* q = reinterpret_cast<const Bytes<V>*>(
      static_cast<const uint8_t*>(p.q) + part * p.q_part + static_cast<long long>(li) * p.K);
  const float s = *reinterpret_cast<const float*>(
      static_cast<const char*>(p.s) + part * p.s_part + 4LL * li);
  const Out* base = nullptr;
  if (p.base != nullptr) {
    base = reinterpret_cast<const Out*>(
        static_cast<const T*>(p.base) + part * p.base_part + static_cast<long long>(j) * p.base_ld);
  }
  for (int c = lane; c < nvec; c += team) {
    const Bytes<V> qv = q[c];
    Out b;
    if (base != nullptr) b = base[c];
    Out y;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = __fmul_rn(payload_value<kFp8>(qv.v[e]), s);
      y.v[e] = narrow<T>(base != nullptr ? __fadd_rn(widen(b.v[e]), d) : d);
    }
    out[c] = y;
  }
}

template <int CAP, bool kFp8>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const __grid_constant__ DequantTable<CAP> t) {
  const DequantSeg& seg = t.seg[find_segment(t, blockIdx.x)];
  int r = seg.p.rot_const;
  if (seg.p.rot != nullptr) {
    const int k = seg.p.every;
    r = ((static_cast<int>(*seg.p.rot % k)) + k) % k;
  }
  if (seg.p.flags & kOutBF16) {
    if (seg.vec) {
      decode_rows<__nv_bfloat16, kFp8, 8>(seg, r);
    } else {
      decode_rows<__nv_bfloat16, kFp8, 1>(seg, r);
    }
  } else {
    if (seg.vec) {
      decode_rows<float, kFp8, 4>(seg, r);
    } else {
      decode_rows<float, kFp8, 1>(seg, r);
    }
  }
}

bool plan(const DequantSpec& p, DequantSeg* seg, int block0) {
  if (p.q == nullptr || p.s == nullptr || p.out == nullptr || p.K <= 0 || p.every < 1 ||
      p.parts < 1 || p.full_rows < 1 || p.full_rows % p.every != 0 ||
      static_cast<long long>(p.parts) * p.full_rows > 0x7fffffffLL) {
    return false;
  }
  if (p.every > 1 && p.prev == nullptr) return false;
  if (p.rot == nullptr && (p.rot_const < 0 || p.rot_const >= p.every)) return false;
  const int V = (p.flags & kOutBF16) ? 8 : 4;
  bool vec = p.K % V == 0 && aligned(p.out, 16) && aligned(p.q, V) && p.q_part % V == 0;
  if (p.base != nullptr) {
    vec = vec && aligned(p.base, 16) && p.base_part % V == 0 && p.base_ld % V == 0;
  }
  if (p.prev != nullptr) {
    vec = vec && aligned(p.prev, 16) && p.prev_part % V == 0 && p.prev_ld % V == 0;
  }
  const int nvec = vec ? p.K / V : p.K;
  int team = 32;
  while (team < kThreads && team * 2 <= nvec) team *= 2;
  seg->p = p;
  seg->block0 = block0;
  seg->team = team;
  seg->vec = vec ? 1 : 0;
  return true;
}

template <int CAP>
cudaError_t launch(const DequantSpec* specs, int n, int payload, cudaStream_t stream) {
  DequantTable<CAP> t;
  t.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (!plan(specs[i], &t.seg[i], static_cast<int>(blocks))) return cudaErrorInvalidValue;
    const int per_block = kThreads / t.seg[i].team;
    const long long rows = static_cast<long long>(specs[i].parts) * specs[i].full_rows;
    blocks += (rows + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  if (payload == 1) {
    dequantize_rows_kernel<CAP, true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(t);
  } else {
    dequantize_rows_kernel<CAP, false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(t);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// dequantize_rows_grouped: one launch over n segments (1 <= n <= capacity),
// payload 0 int8 or 1 e4m3.  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue for a malformed table, before launching.
extern "C" int dequantize_rows_grouped(const void* specs, int n, int payload, void* stream) {
  if (specs == nullptr || n < 1 || n > kCapacity || (payload != 0 && payload != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DequantSpec* s = static_cast<const DequantSpec*>(specs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 1) return static_cast<int>(launch<1>(s, n, payload, st));
  if (n <= 16) return static_cast<int>(launch<16>(s, n, payload, st));
  return static_cast<int>(launch<kCapacity>(s, n, payload, st));
}

extern "C" int dequantize_rows_capacity(void) { return kCapacity; }
extern "C" int dequantize_rows_spec_bytes(void) { return static_cast<int>(sizeof(DequantSpec)); }

// The compiled instance of a table capacity (1, 16 or the full one) and
// payload: registers a thread, local (spilled) bytes a thread, the table's
// parameter bytes.  Returns a cudaError_t.
extern "C" int dequantize_rows_variant(int capacity, int payload, int* registers,
                                       int* local_bytes, int* param_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  const bool fp8 = payload == 1;
  if (capacity == 1) {
    err = fp8 ? cudaFuncGetAttributes(&attr, dequantize_rows_kernel<1, true>)
              : cudaFuncGetAttributes(&attr, dequantize_rows_kernel<1, false>);
    *param_bytes = static_cast<int>(sizeof(DequantTable<1>));
  } else if (capacity == 16) {
    err = fp8 ? cudaFuncGetAttributes(&attr, dequantize_rows_kernel<16, true>)
              : cudaFuncGetAttributes(&attr, dequantize_rows_kernel<16, false>);
    *param_bytes = static_cast<int>(sizeof(DequantTable<16>));
  } else {
    err = fp8 ? cudaFuncGetAttributes(&attr, dequantize_rows_kernel<kCapacity, true>)
              : cudaFuncGetAttributes(&attr, dequantize_rows_kernel<kCapacity, false>);
    *param_bytes = static_cast<int>(sizeof(DequantTable<kCapacity>));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
