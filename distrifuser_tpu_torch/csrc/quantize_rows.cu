// Per-row quantization for Hopper (sm_90a): the encoder of the quantized
// linears' activations and of the patch path's compressed refresh payloads.
// For each selected row x of a segment, with an optional residual base b,
//
//   d    = x - b                                (fp32; d = x without a base)
//   amax = max |d|
//   s    = max(amax, 1e-12) * (1 / LIMIT)       LIMIT = 127 or 448
//   q    = clip(round_half_even(d / s), +-127) as int8, or
//          (d / s) cast to e4m3 (round to nearest even, saturating)
//
// and writes the payload row q (8-bit) and its fp32 scale s.  No Pallas
// counterpart: the JAX package leaves this to XLA, which fuses it into the
// ops around it (distrifuser_tpu/parallel/compress.py quantize, and the
// residual subtraction and take_every_kth of its refresh path).  The port's
// plain version is ops/quantize.py's composition of parallel/compress.py
// (x.float(), minus base.float(), take_every_kth, quantize), run eagerly as
// ten or more launches with an fp32 copy of the activation.
//
// Bit for bit with that plain version on the card:
// * the residual is one correctly rounded fp32 subtraction (__fsub_rn) of
//   the widened operands, as src.float() - base.float();
// * the scale is amax times the fp32 reciprocal of LIMIT, because that is
//   how PyTorch's CUDA division by a Python scalar computes
//   clamp(amax) / LIMIT;
// * d / s is the correctly rounded quotient, as PyTorch's tensor-by-tensor
//   division gives it, computed without a division: from the row's
//   correctly rounded reciprocal y = 1 / s, q0 = d * y and two
//   corrections q += (d - s * q) * y, each parenthesis one fused
//   multiply-add; the second rounds correctly by Markstein's theorem
//   (quotient(); this file is never built with --use_fast_math);
// * rounding is half to even, as torch.round's: the quotient, clipped to
//   +-127, plus 1.5 * 2^23 in fp32 (one addition in place of rintf and a
//   float-to-int conversion, which runs at a quarter of the fp32 rate);
// * the e4m3 cast is cvt.rn.satfinite (two values an instruction): round
//   to nearest even, as PyTorch's software cast; the two differ only past
//   464, and |d / s| <= 448 up to one rounding here.
//
// What one launch covers: a table of segments, passed by value as the
// kernel's parameter (up to kCapacity segments, about 30 KB: CUDA 12.1
// allows 32,764 bytes of parameters on sm_70 and later; the Python wrapper
// splits a longer table into several launches).  A CUDA graph bakes the
// table into its kernel node, so a graphed step copies nothing from the
// host.  A segment is one payload:
// * its source rows are addressed through a part index and three row
//   indices with element strides, so a halo x[:, :halo] (and its partner
//   x[:, h - halo:] as the second part) of a [B, h, W, C] activation is
//   read in place; the columns are contiguous;
// * it may select rows r, r + k, ... of each part (the partial refresh,
//   take_every_kth; the per-rank chunks of a layout with groups > 1 are
//   whole multiples of k, so the selection is the same on the flattened
//   rows); r is read from a device scalar when given, so one captured graph
//   serves every rotation;
// * its payload and scale rows land at any byte offset a part (the flat
//   send buffer of a batched flush, one byte buffer for every payload and
//   scale of a step).
//
// Design, the staged path: a warp serves one row at a time, and each warp
// walks several rows of its segment (its block's share, one warp-count
// apart).  A row (and its base row) is staged in the warp's slice of
// shared memory by 16-byte cp.async copies (cp.async.cg: through L2, not
// L1), double-buffered: the copies of the warp's next row are issued
// before it reduces and encodes the current one, so a row's load overlaps
// the previous row's arithmetic.  Each lane copies, and later reads back,
// the same vectors of the row, so a lane waits only for its own copies
// (cp.async.wait_group) and no barrier is needed; the row max is a warp
// shuffle.  The row is read from device memory once; the encode pass reads
// it from shared memory and stores 8- or 4-byte payload vectors.  A
// launch's block has 1 to 8 warps: as many as the table's rows fill across
// the card's SMs, fewer where 8 warps' stages would not fit the 227 KB a
// block may take; each warp walks enough rows that the grid is about one
// wave of resident blocks (the 154-row text KV runs two warps a block on
// 77 SMs).  The narrow path: a launch of at least 4096 rows of at most 640
// bf16 (320 fp32) columns without a base, the quantized linears at SDXL's
// and SD 1.5's first level, would leave most lanes of a warp idle; there a
// team of 8 or 16 lanes serves a row, each lane holding its (at most five)
// 16-byte vectors in registers, two or four rows a warp.  Rows one stride
// apart within a part (a contiguous activation, a KV, a halo slab at B =
// 1) are addressed by one multiply; only other layouts pay the division of
// the row index into its three indices.  Rows whose strides or alignment
// rule out 16-byte vectors, or too wide for one warp's stages, take a
// two-pass loop that reads the row again (an L1/L2 hit).  Each block finds
// its segment by a binary search over the segments' first blocks.
//
// What bounds it: bytes, then the arithmetic a launch's latency cannot
// hide.  It reads x (2 or 4 bytes an element) and the base once, and
// writes 1 byte an element and 4 a row; the quotient costs five fp32
// operations an element (a __fdiv_rn sequence, with its reciprocal on the
// quarter-rate unit and its branch, cost a third of the kernel's time),
// and most launches are a few microseconds long, so the launch's ramp and
// tail count (PERF.md gives the probes: the quotient replaced by the
// product d * y alone, and a cold L2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquantize_rows.so quantize_rows.cu

#include <cuda_bf16.h>
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

constexpr int kMaxWarps = kThreads / 32;  // warps a block
constexpr int kStages = 2;                // row buffers a warp cycles through
constexpr int kNarrowVecs = 5;            // 16-byte vectors a lane holds on the narrow path
constexpr int kNarrowRows = 4096;         // rows a launch takes the narrow path from
constexpr int kBlockSmem = 227 * 1024;    // shared memory a block may take
constexpr int kSmSmem = 228 * 1024;       // shared memory of an SM
constexpr int kSmThreads = 2048;          // resident threads an SM
constexpr int kSmBlocks = 32;             // resident blocks an SM
constexpr float kMagic = 12582912.0f;     // 1.5 * 2^23: x + kMagic rounds x to an integer
constexpr float kScaleFloor = 1e-12f;     // an all-zero row: exact zeros

// QuantSpec.flags
constexpr int kSrcBF16 = 1;
constexpr int kHasBase = 2;

// One segment as the host describes it (ops/quantize.py mirrors this layout
// with ctypes).  Strides are in elements of the source type unless named
// bytes; parts are the outermost index, rows within a part are flattened
// over dims[1..3] (dims[3] fastest).
struct QuantSpec {
  const void* src;         // row (0, 0, 0, 0) of the source
  const void* base;        // residual base rows, same type as src, or null
  void* q;                 // payload row 0 of part 0; rows of K bytes
  void* s;                 // fp32 scale of row 0 of part 0
  const long long* rot;    // device rotation r, or null (then rot_const)
  long long src_stride[4]; // part, then the three row indices
  int dims[4];             // parts, then the three row sizes
  long long base_part;     // between the base's parts
  long long base_ld;       // between the base's rows
  long long q_part;        // bytes between payload parts
  long long s_part;        // bytes between scale parts
  int K;                   // columns
  int every;               // k of the partial refresh (1: every row)
  int rot_const;
  int flags;
};

struct QuantSeg {
  QuantSpec p;
  long long src_ld;    // between source rows, where they are one stride apart
  int rows;            // payload rows of the segment (all parts)
  int rows_per_part;   // payload rows of a part
  int block0;          // the segment's first block
  int rows_per_block;  // the rows a block walks
  int team;            // lanes a row on the narrow path: 8 or 16
  unsigned vec : 1;     // 16-byte vectors everywhere
  unsigned staged : 1;  // rows staged in shared memory (vec, and they fit)
  unsigned flat : 1;    // source rows one stride (src_ld) apart within a part
};

template <int CAP>
struct QuantTable {
  int n;
  QuantSeg seg[CAP];
};

static_assert(sizeof(QuantTable<kCapacity>) <= 32764,
              "a launch's segment table must fit the kernel parameter space");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The max of v over the calling lane's team of `team` (8, 16 or 32) lanes;
// every lane of the warp calls this.
__device__ __forceinline__ float team_max(float v, int team) {
  for (int off = team >> 1; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename T, int V>
struct alignas(V * sizeof(T)) InVec {
  T v[V];
};

template <int V>
struct alignas(V) OutVec {
  uint8_t v[V];
};

// The correctly rounded quotient a / s without a division: y is the
// correctly rounded 1 / s, q0 = a * y is within 1.5 units in the last place
// of a / s, the first correction q1 = q0 + (a - s * q0) * y (each
// parenthesis one fused multiply-add) makes it faithful, and by
// Markstein's theorem the second, from the exact remainder a - s * q1,
// rounds it correctly.  Where an intermediate would underflow, |a / s| is
// below 2^-54 and every payload is zero either way; a zero a keeps its
// sign (the corrections would turn -0 into +0).  The caller divides
// instead where y is 0 (an infinite scale).
__device__ __forceinline__ float quotient(float a, float s, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, a), y, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-s, q1, a), y, q1);
  return a == 0.f ? a : q2;
}

// The payload bytes of V differences d over the row's scale s (y: the
// correctly rounded 1 / s, 0 when s is infinite).  The quotient is the
// correctly rounded d / s, as PyTorch's division gives it.  int8:
// clip(q) to +-127, then the float addition of 1.5 * 2^23 rounds it to the
// nearest integer, ties to even, as rintf does, and leaves that integer in
// the low mantissa bits (two's complement in the low byte for negative
// ones); clipping before rounding is the same as after, the bounds being
// integers.  fp8: the e4m3 conversion two at a time (cvt.rn.satfinite
// .e4m3x2: the first value in the low byte), each as the one-value form
// rounds it.
template <bool kFp8, int V>
__device__ __forceinline__ void encode_vec(const float (&d)[V], float s, float y,
                                           OutVec<V>& o) {
  float v[V];
  if (y != 0.f) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = quotient(d[e], s, y);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __fdiv_rn(d[e], s);
  }
  if constexpr (kFp8) {
    if constexpr (V % 2 == 0) {
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        const __nv_fp8x2_storage_t two = __nv_cvt_float2_to_fp8x2(
            make_float2(v[e], v[e + 1]), __NV_SATFINITE, __NV_E4M3);
        o.v[e] = static_cast<uint8_t>(two & 0xffu);
        o.v[e + 1] = static_cast<uint8_t>(two >> 8);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o.v[e] = static_cast<uint8_t>(__nv_cvt_float_to_fp8(v[e], __NV_SATFINITE, __NV_E4M3));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float c = fminf(fmaxf(v[e], -127.f), 127.f);
      o.v[e] = static_cast<uint8_t>(__float_as_uint(__fadd_rn(c, kMagic)) & 0xffu);
    }
  }
}

template <bool kBase, typename T>
__device__ __forceinline__ float diff(T x, T b) {
  if constexpr (kBase) {
    return __fsub_rn(widen(x), widen(b));
  } else {
    return widen(x);
  }
}

// Where payload row i of a segment (r: the rotation) reads and writes.
template <typename T, bool kBase>
struct RowAt {
  const T* x;
  const T* b;
  uint8_t* q;
  float* s;

  __device__ __forceinline__ RowAt(const QuantSeg& seg, int i, int r) {
    const QuantSpec& p = seg.p;
    int part = 0, li = i;
    if (p.dims[0] > 1) {
      part = i / seg.rows_per_part;
      li = i - part * seg.rows_per_part;
    }
    const int j = li * p.every + r;  // the row within the part
    long long off = part * p.src_stride[0];
    if (seg.flat) {
      off += j * seg.src_ld;
    } else {
      const int c = j % p.dims[3];
      const int t = j / p.dims[3];
      off += (t / p.dims[2]) * p.src_stride[1] + (t % p.dims[2]) * p.src_stride[2] +
             c * p.src_stride[3];
    }
    x = static_cast<const T*>(p.src) + off;
    b = kBase ? static_cast<const T*>(p.base) + part * p.base_part + j * p.base_ld : nullptr;
    q = static_cast<uint8_t*>(p.q) + part * p.q_part + static_cast<long long>(li) * p.K;
    s = reinterpret_cast<float*>(static_cast<char*>(p.s) + part * p.s_part) + li;
  }
};

// The rows of this block, a warp each, staged in shared memory: `stage` is
// the block's dynamic shared memory, kStages row buffers (x, then the
// base's row) a warp.
template <typename T, bool kFp8, bool kBase>
__device__ __forceinline__ void encode_staged(const QuantSeg& seg, int r, unsigned char* stage) {
  constexpr int V = 16 / sizeof(T);
  using In = InVec<T, V>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int first = (blockIdx.x - seg.block0) * seg.rows_per_block;
  const int last = min(first + seg.rows_per_block, seg.rows);
  const int nvec = seg.p.K / V;
  const int row_vecs = kBase ? 2 * nvec : nvec;
  In* mine = reinterpret_cast<In*>(stage) + warp * kStages * row_vecs;

  // copies this lane's vectors of row i (and of its base row) into buffer
  // `buf`, one commit group
  auto issue = [&](int i, int buf) {
    const RowAt<T, kBase> at(seg, i, r);
    In* dst = mine + buf * row_vecs;
    for (int c = lane; c < nvec; c += 32) {
      cp_async16(dst + c, reinterpret_cast<const In*>(at.x) + c);
      if constexpr (kBase) cp_async16(dst + nvec + c, reinterpret_cast<const In*>(at.b) + c);
    }
    cp_async_commit();
  };

  int i = first + warp;
  if (i < last) issue(i, 0);
  for (int buf = 0; i < last; i += warps, buf ^= 1) {
    if (i + warps < last) {
      issue(i + warps, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const In* xs = mine + buf * row_vecs;
    float amax = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      const In x = xs[c];
      In b;
      if constexpr (kBase) b = xs[nvec + c];
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(diff<kBase>(x.v[e], b.v[e])));
    }
    amax = team_max(amax, 32);
    const float s = fmaxf(amax, kScaleFloor) * (1.0f / (kFp8 ? 448.0f : 127.0f));
    const RowAt<T, kBase> at(seg, i, r);
    if (lane == 0) *at.s = s;
    const float y = __frcp_rn(s);
    for (int c = lane; c < nvec; c += 32) {
      const In x = xs[c];
      In b;
      if constexpr (kBase) b = xs[nvec + c];
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = diff<kBase>(x.v[e], b.v[e]);
      OutVec<V> o;
      encode_vec<kFp8, V>(d, s, y, o);
      reinterpret_cast<OutVec<V>*>(at.q)[c] = o;
    }
  }
}

// The rows of this block, a warp each, read twice from device memory (the
// second read an L1/L2 hit): rows that are not staged.  V: elements a
// vector (1: scalar accesses).
template <typename T, bool kFp8, int V, bool kBase>
__device__ __forceinline__ void encode_twopass(const QuantSeg& seg, int r) {
  using In = InVec<T, V>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int first = (blockIdx.x - seg.block0) * seg.rows_per_block;
  const int last = min(first + seg.rows_per_block, seg.rows);
  const int nvec = seg.p.K / V;
  for (int i = first + warp; i < last; i += warps) {
    const RowAt<T, kBase> at(seg, i, r);
    const In* xr = reinterpret_cast<const In*>(at.x);
    const In* br = reinterpret_cast<const In*>(at.b);
    float amax = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      const In x = xr[c];
      In b;
      if constexpr (kBase) b = br[c];
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(diff<kBase>(x.v[e], b.v[e])));
    }
    amax = team_max(amax, 32);
    const float s = fmaxf(amax, kScaleFloor) * (1.0f / (kFp8 ? 448.0f : 127.0f));
    if (lane == 0) *at.s = s;
    const float y = __frcp_rn(s);
    for (int c = lane; c < nvec; c += 32) {
      const In x = xr[c];
      In b;
      if constexpr (kBase) b = br[c];
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = diff<kBase>(x.v[e], b.v[e]);
      OutVec<V> o;
      encode_vec<kFp8, V>(d, s, y, o);
      reinterpret_cast<OutVec<V>*>(at.q)[c] = o;
    }
  }
}

// The rows of this block on the narrow path, a team of 8 or 16 lanes each
// (no base): each lane holds its at most kNarrowVecs vectors of the row in
// registers between the row max and the encoding.  A row of 40 or 80
// vectors (320 or 640 bf16 columns) leaves most of a warp idle in the
// staged path; here a warp serves two or four rows at once.
template <typename T, bool kFp8>
__device__ __forceinline__ void encode_narrow(const QuantSeg& seg, int r) {
  constexpr int V = 16 / sizeof(T);
  using In = InVec<T, V>;
  const int team = seg.team, lane = threadIdx.x % team;
  const int i = (blockIdx.x - seg.block0) * seg.rows_per_block + threadIdx.x / team;
  const bool active = i < seg.rows;
  const int nvec = seg.p.K / V;
  In xs[kNarrowVecs];
  float amax = 0.f;
  const RowAt<T, false> at(seg, active ? i : 0, r);
#pragma unroll
  for (int m = 0; m < kNarrowVecs; ++m) {
    const int c = lane + m * team;
    if (active && c < nvec) {
      xs[m] = reinterpret_cast<const In*>(at.x)[c];
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(widen(xs[m].v[e])));
    }
  }
  amax = team_max(amax, team);
  if (!active) return;
  const float s = fmaxf(amax, kScaleFloor) * (1.0f / (kFp8 ? 448.0f : 127.0f));
  if (lane == 0) *at.s = s;
  const float y = __frcp_rn(s);
#pragma unroll
  for (int m = 0; m < kNarrowVecs; ++m) {
    const int c = lane + m * team;
    if (c < nvec) {
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = widen(xs[m].v[e]);
      OutVec<V> o;
      encode_vec<kFp8, V>(d, s, y, o);
      reinterpret_cast<OutVec<V>*>(at.q)[c] = o;
    }
  }
}

template <int CAP, bool kFp8, typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_narrow_kernel(const __grid_constant__ QuantTable<CAP> t) {
  const QuantSeg& seg = t.seg[find_segment(t, blockIdx.x)];
  int r = seg.p.rot_const;
  if (seg.p.rot != nullptr) {
    const int k = seg.p.every;
    r = ((static_cast<int>(*seg.p.rot % k)) + k) % k;
  }
  encode_narrow<T, kFp8>(seg, r);
}

// One instance per table capacity, payload, source type and base: every
// segment of a launch shares the last two (the wrapper groups a mixed
// table), so that each instance holds only its own path's registers.
template <int CAP, bool kFp8, typename T, bool kBase>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const __grid_constant__ QuantTable<CAP> t) {
  extern __shared__ __align__(16) unsigned char stage[];
  const QuantSeg& seg = t.seg[find_segment(t, blockIdx.x)];
  int r = seg.p.rot_const;
  if (seg.p.rot != nullptr) {
    const int k = seg.p.every;
    r = ((static_cast<int>(*seg.p.rot % k)) + k) % k;
  }
  if (seg.staged) {
    encode_staged<T, kFp8, kBase>(seg, r, stage);
  } else if (seg.vec) {
    encode_twopass<T, kFp8, 16 / sizeof(T), kBase>(seg, r);
  } else {
    encode_twopass<T, kFp8, 1, kBase>(seg, r);
  }
}

// Bytes of one warp's stages for a segment's rows.
long long stage_bytes(const QuantSpec& p) {
  const int esize = (p.flags & kSrcBF16) ? 2 : 4;
  return static_cast<long long>(kStages) * p.K * esize * ((p.flags & kHasBase) ? 2 : 1);
}

// Fills the derived fields of one segment but its blocks; false if the spec
// is malformed.
bool plan(const QuantSpec& p, QuantSeg* seg) {
  if (p.src == nullptr || p.q == nullptr || p.s == nullptr || p.K <= 0 || p.every < 1) {
    return false;
  }
  if (((p.flags & kHasBase) != 0) != (p.base != nullptr)) return false;
  if (p.rot == nullptr && (p.rot_const < 0 || p.rot_const >= p.every)) return false;
  long long full = 1;
  for (int d = 0; d < 4; ++d) {
    if (p.dims[d] <= 0) return false;
    if (d > 0) full *= p.dims[d];
  }
  if (full % p.every != 0 || full / p.every * p.dims[0] > 0x7fffffffLL) return false;
  const int esize = (p.flags & kSrcBF16) ? 2 : 4;
  const int V = 16 / esize;
  bool vec = p.K % V == 0 && aligned(p.src, 16) && aligned(p.q, V) && p.q_part % V == 0;
  for (int d = 0; d < 4; ++d) vec = vec && p.src_stride[d] % V == 0;
  if (p.base != nullptr) {
    vec = vec && aligned(p.base, 16) && p.base_part % V == 0 && p.base_ld % V == 0;
  }
  // rows one stride apart within a part: every row index with more than
  // one value steps by the inner index's span
  long long ld = 0, span = 0;
  bool flat = true, seen = false;
  for (int d = 3; d >= 1; --d) {
    if (p.dims[d] == 1) continue;
    if (!seen) {
      ld = span = p.src_stride[d];
      seen = true;
    } else if (p.src_stride[d] != span) {
      flat = false;
    }
    span *= p.dims[d];
  }
  seg->p = p;
  seg->src_ld = ld;
  seg->rows_per_part = static_cast<int>(full / p.every);
  seg->rows = seg->rows_per_part * p.dims[0];
  seg->vec = vec ? 1u : 0u;
  seg->staged = vec && stage_bytes(p) <= kBlockSmem ? 1u : 0u;
  seg->flat = flat ? 1u : 0u;
  return true;
}

// The kernel instance of a capacity, payload and the segments' flags.
template <int CAP, bool kFp8>
const void* instance_of(int flags) {
  switch (flags) {
    case kSrcBF16 | kHasBase:
      return reinterpret_cast<const void*>(quantize_rows_kernel<CAP, kFp8, __nv_bfloat16, true>);
    case kSrcBF16:
      return reinterpret_cast<const void*>(quantize_rows_kernel<CAP, kFp8, __nv_bfloat16, false>);
    case kHasBase:
      return reinterpret_cast<const void*>(quantize_rows_kernel<CAP, kFp8, float, true>);
    case 0:
      return reinterpret_cast<const void*>(quantize_rows_kernel<CAP, kFp8, float, false>);
    default:
      return nullptr;
  }
}

template <int CAP>
const void* instance(int payload, int flags) {
  return payload == 1 ? instance_of<CAP, true>(flags) : instance_of<CAP, false>(flags);
}

// The narrow path's instance of a capacity, payload and source type.
template <int CAP>
const void* narrow_instance(int payload, int flags) {
  const bool bf16 = (flags & kSrcBF16) != 0;
  if (payload == 1) {
    return bf16 ? reinterpret_cast<const void*>(quantize_rows_narrow_kernel<CAP, true, __nv_bfloat16>)
                : reinterpret_cast<const void*>(quantize_rows_narrow_kernel<CAP, true, float>);
  }
  return bf16 ? reinterpret_cast<const void*>(quantize_rows_narrow_kernel<CAP, false, __nv_bfloat16>)
              : reinterpret_cast<const void*>(quantize_rows_narrow_kernel<CAP, false, float>);
}

// Plans and launches one table.  The narrow path where every segment's
// rows are 16-byte vectors, without a base, of at most 16 * kNarrowVecs
// vectors, and the table has at least kNarrowRows rows: 256-thread blocks,
// a team of 8 lanes a row (16 above 8 * kNarrowVecs vectors).  Else the staged
// path: the block's warps, as many as the rows fill over the SMs (at most
// 8), fewer where their stages would not fit a block's shared memory; each
// warp walks enough rows that the grid is about one wave of resident
// blocks.
template <int CAP>
cudaError_t launch(const QuantSpec* specs, int n, int payload, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  QuantTable<CAP> t;
  t.n = n;
  const int V = 16 / ((specs[0].flags & kSrcBF16) ? 2 : 4);
  long long rows = 0, stage = 0;
  bool narrow = (specs[0].flags & kHasBase) == 0;
  for (int i = 0; i < n; ++i) {
    if (specs[i].flags != specs[0].flags) return cudaErrorInvalidValue;
    if (!plan(specs[i], &t.seg[i])) return cudaErrorInvalidValue;
    rows += t.seg[i].rows;
    if (t.seg[i].staged) stage = stage > stage_bytes(specs[i]) ? stage : stage_bytes(specs[i]);
    narrow = narrow && t.seg[i].vec && specs[i].K <= 16 * kNarrowVecs * V;
  }
  narrow = narrow && rows >= kNarrowRows;
  long long warps = kMaxWarps, depth = 1;
  int smem = 0;
  if (!narrow) {
    warps = (rows + sms - 1) / sms;
    warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
    while (warps > 1 && warps * stage > kBlockSmem) --warps;
    smem = static_cast<int>(warps * stage);
    long long per_sm = kSmThreads / (32 * warps);
    per_sm = per_sm < kSmBlocks ? per_sm : kSmBlocks;
    if (smem > 0) {
      const long long fit = kSmSmem / (smem + 1024);  // 1 KB an SM keeps a block
      per_sm = per_sm < fit ? per_sm : fit;
    }
    const long long resident = per_sm * sms;
    depth = (rows + warps * resident - 1) / (warps * resident);
  }
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    QuantSeg& seg = t.seg[i];
    seg.team = specs[i].K <= kNarrowVecs * 8 * V ? 8 : 16;
    seg.block0 = static_cast<int>(blocks);
    seg.rows_per_block = static_cast<int>(narrow ? kThreads / seg.team : warps * depth);
    blocks += (seg.rows + seg.rows_per_block - 1) / seg.rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  const void* fn = narrow ? narrow_instance<CAP>(payload, specs[0].flags)
                          : instance<CAP>(payload, specs[0].flags);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&t};
  return cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                          dim3(static_cast<unsigned>(32 * warps)), args,
                          static_cast<size_t>(smem), stream);
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// quantize_rows_grouped: one launch over n segments (1 <= n <= capacity),
// payload 0 int8 or 1 e4m3.  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue for a malformed table, before launching.
extern "C" int quantize_rows_grouped(const void* specs, int n, int payload, void* stream) {
  if (specs == nullptr || n < 1 || n > kCapacity || (payload != 0 && payload != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QuantSpec* s = static_cast<const QuantSpec*>(specs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 1) return static_cast<int>(launch<1>(s, n, payload, st));
  if (n <= 16) return static_cast<int>(launch<16>(s, n, payload, st));
  return static_cast<int>(launch<kCapacity>(s, n, payload, st));
}

// The segments one launch takes, and the size of a segment's description
// (the wrapper checks its ctypes mirror against it).
extern "C" int quantize_rows_capacity(void) { return kCapacity; }
extern "C" int quantize_rows_spec_bytes(void) { return static_cast<int>(sizeof(QuantSpec)); }

// The compiled instances of a table capacity (1, 16 or the full one) and
// payload, over the four source types and bases and the narrow path's two
// source types: the most registers a thread and local (spilled) bytes a
// thread of any, and the table's parameter bytes.  Returns a cudaError_t.
extern "C" int quantize_rows_variant(int capacity, int payload, int* registers,
                                     int* local_bytes, int* param_bytes) {
  *registers = *local_bytes = 0;
  const int every_flags[] = {0, kSrcBF16, kHasBase, kSrcBF16 | kHasBase};
  for (int flags : every_flags) {
    const void* fn;
    if (capacity == 1) {
      fn = instance<1>(payload, flags);
      *param_bytes = static_cast<int>(sizeof(QuantTable<1>));
    } else if (capacity == 16) {
      fn = instance<16>(payload, flags);
      *param_bytes = static_cast<int>(sizeof(QuantTable<16>));
    } else {
      fn = instance<kCapacity>(payload, flags);
      *param_bytes = static_cast<int>(sizeof(QuantTable<kCapacity>));
    }
    const void* narrow = capacity == 1    ? narrow_instance<1>(payload, flags)
                         : capacity == 16 ? narrow_instance<16>(payload, flags)
                                          : narrow_instance<kCapacity>(payload, flags);
    const void* both[] = {fn, narrow};
    for (const void* f : both) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, f);
      if (err != cudaSuccess) return static_cast<int>(err);
      *registers = attr.numRegs > *registers ? attr.numRegs : *registers;
      const int local = static_cast<int>(attr.localSizeBytes);
      *local_bytes = local > *local_bytes ? local : *local_bytes;
    }
  }
  return 0;
}
