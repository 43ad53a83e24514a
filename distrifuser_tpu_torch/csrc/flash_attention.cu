// Flash attention for Hopper (sm_90a): non-causal multi-head SDPA over
// [B, L, C] tensors, bf16 in and out, fp32 logits and softmax state.
//
// Replaces the Pallas TPU kernel distrifuser_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_sdpa through pl.pallas_call).  Same
// arithmetic: logits s = (q . k) * scale in fp32; KV columns at or beyond
// the real length get the logit -1e30; an online softmax keeps the running
// max m, normalizer l and output accumulator in fp32; p = exp(s - m) is
// rounded to bf16 before the P.V product (fp32 accumulation); the output
// acc / l is rounded to bf16.
//
// Design for the GPU rather than the TPU grid:
// * one block per (query tile, batch*head); the TPU's sequential third grid
//   axis becomes a loop over KV tiles inside the block, so the softmax state
//   never leaves the SM;
// * heads are read in place through strides: head h of a [B, L, C] tensor is
//   columns h*D .. h*D+D-1, so neither the fused to_kv output nor q is
//   copied into a [B*H, L, D] layout;
// * ragged edges are masked here: query rows >= Lq load zeros and are not
//   stored, KV rows >= kv_len load zeros and get the -1e30 logit, and KV
//   tiles wholly past kv_len are skipped (they add exactly nothing to the
//   padded computation's m, l or acc);
// * QK^T and PV run on the tensor cores through WMMA 16x16x16 bf16
//   fragments with fp32 accumulation; Q, K, V, the logits S, the bf16 P and
//   the fp32 accumulator O live in shared memory.
//
// What bounds it: at the UNet's shapes (d = 64, L = 1024..4096) the work is
// operations (the QK^T and PV products), at 77 text tokens it is bytes.
// This first version keeps O in shared memory and loads tiles with plain
// 16-byte loads (no cp.async/TMA, no wgmma), so it is well below both
// bounds; PERF.md keeps its measured times.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask logit

// shared-memory leading dimensions, padded against bank conflicts; every
// WMMA tile pointer stays 32-byte aligned (16 rows * ld * elem is a multiple
// of 32 bytes, column offsets are multiples of 16 elements)
__host__ __device__ constexpr int ld_bf16(int cols) { return cols + 8; }
__host__ __device__ constexpr int ld_f32(int cols) { return cols + 4; }
__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

struct SmemLayout {
  size_t q, k, v, s, p, o, m, l, corr, total;
};

__host__ __device__ inline SmemLayout smem_layout(int bq, int bk, int d) {
  SmemLayout L;
  size_t off = 0;
  L.q = off; off = align128(off + size_t(bq) * ld_bf16(d) * 2);
  L.k = off; off = align128(off + size_t(bk) * ld_bf16(d) * 2);
  L.v = off; off = align128(off + size_t(bk) * ld_bf16(d) * 2);
  L.s = off; off = align128(off + size_t(bq) * ld_f32(bk) * 4);
  L.p = off; off = align128(off + size_t(bq) * ld_bf16(bk) * 2);
  L.o = off; off = align128(off + size_t(bq) * ld_f32(d) * 4);
  L.m = off; off = align128(off + size_t(bq) * 4);
  L.l = off; off = align128(off + size_t(bq) * 4);
  L.corr = off; off = align128(off + size_t(bq) * 4);
  L.total = off;
  return L;
}

// rows x d bf16 tile from global (row stride `rs` elements, 16-byte aligned
// rows) into shared memory; rows >= valid are zero-filled
__device__ inline void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                 int rows, int valid, int d, long long rs) {
  const int vec_per_row = d / 8;  // 8 bf16 = 16 bytes
  const int ldd = ld_bf16(d);
  for (int i = threadIdx.x; i < rows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * rs + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int heads, int lq, int kv_len,
                 int d, long long q_bs, long long q_rs, long long k_bs,
                 long long k_rs, long long v_bs, long long v_rs,
                 long long o_bs, long long o_rs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(BQ, BK, d);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, lq - q0);
  const int ldd = ld_bf16(d);
  const int ldo = ld_f32(d);
  const int lds = ld_f32(BK);
  const int ldp = ld_bf16(BK);

  const __nv_bfloat16* qg = q + b * q_bs + (long long)q0 * q_rs + h * d;
  const __nv_bfloat16* kg = k + b * k_bs + h * d;
  const __nv_bfloat16* vg = v + b * v_bs + h * d;

  load_tile(Qs, qg, BQ, q_valid, d, q_rs);
  for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
    Os[(i / d) * ldo + (i % d)] = 0.f;
  }
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int k_valid = min(BK, kv_len - k0);
    __syncthreads();  // previous tile's readers of Ks/Vs/Ps are done
    load_tile(Ks, kg + (long long)k0 * k_rs, BK, k_valid, d, k_rs);
    load_tile(Vs, vg + (long long)k0 * v_rs, BK, k_valid, d, v_rs);
    __syncthreads();

    // S = Q K^T (fp32), 16x16 output tiles spread over the warps
    constexpr int kSTiles = (BQ / 16) * (BK / 16);
    for (int tile = warp; tile < kSTiles; tile += kWarps) {
      const int ti = tile / (BK / 16);
      const int tj = tile % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + ti * 16 * ldd + kk, ldd);
        wmma::load_matrix_sync(fb, Ks + tj * 16 * ldd + kk, ldd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * lds + tj * 16, acc, lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row; rescale that row of O by corr
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) {
        const float s = c < k_valid ? Ss[r * lds + c] * scale : kNegInf;
        Ss[r * lds + c] = s;
        mx = fmaxf(mx, s);
      }
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(Ss[r * lds + c] - m_new);
        sum += p;
        Ps[r * ldp + c] = __float2bfloat16(p);
      }
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < d; c += 32) {
        Os[r * ldo + c] *= corr;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // O += P V (fp32 accumulator round-trips through shared memory)
    const int o_tiles = (BQ / 16) * (d / 16);
    for (int tile = warp; tile < o_tiles; tile += kWarps) {
      const int ti = tile / (d / 16);
      const int tn = tile % (d / 16);
      float* optr = Os + ti * 16 * ldo + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, optr, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + ti * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(fb, Vs + kk * ldd + tn * 16, ldd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // out = acc / l, rounded to bf16; pad query rows are not stored
  __nv_bfloat16* og = o + b * o_bs + (long long)q0 * o_rs + h * d;
  for (int i = threadIdx.x; i < q_valid * d; i += kThreads) {
    const int r = i / d;
    const int c = i % d;
    og[r * o_rs + c] = __float2bfloat16(Os[r * ldo + c] / l_s[r]);
  }
}

template <int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int heads, int lq, int kv_len, int d, long long q_bs,
                   long long q_rs, long long k_bs, long long k_rs,
                   long long v_bs, long long v_rs, long long o_bs,
                   long long o_rs, float scale, cudaStream_t stream) {
  const size_t smem = smem_layout(BQ, BK, d).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, b * heads);
  flash_fwd_kernel<BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      heads, lq, kv_len, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are bf16 device
// pointers; strides are in elements; d must be a multiple of 16 and at most
// 512, rows 16-byte aligned (checked by the Python wrapper).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_sdpa_bf16(const void* q, const void* k, const void* v,
                               void* o, int b, int heads, int lq, int kv_len,
                               int d, long long q_bs, long long q_rs,
                               long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, long long o_bs, long long o_rs,
                               float scale, void* stream) {
  if (d % 16 != 0 || d <= 0 || d > 512 || lq <= 0 || kv_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 256) {
    return static_cast<int>(launch<64, 64>(q, k, v, o, b, heads, lq, kv_len, d,
                                           q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                           o_bs, o_rs, scale, s));
  }
  return static_cast<int>(launch<32, 32>(q, k, v, o, b, heads, lq, kv_len, d,
                                         q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                         o_bs, o_rs, scale, s));
}
