// Spatial self-attention forward, softmax(q k^T / sqrt(D)) v, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_attention_kernel_tm` (token-minor blocks)
// and `_attention_kernel` (token-major blocks) reached through
// `fused_attention` in synt_isic_tpu/ops/pallas/attention.py, with both of
// their knobs, and the profiling kernel `grouped_attention` of
// scripts/profile_attn_grouped.py. One kernel serves both layouts: q, k, v
// and out are each given as a base pointer plus (b, h, t, d) element
// strides, so the UNet's attention block hands over the (B, T, C)
// projection outputs unchanged (the head split is pointer arithmetic) and
// the result lands directly in (B, T, C).
//
// Design. The TPU kernel keeps the whole (T, T) f32 logits tile in VMEM
// (4 MB at T=1024); a Hopper block has at most 227 KB of shared memory, so
// this kernel never forms the tile. One block handles kBlockQ query rows of
// G heads of one batch entry, one thread per (row, head): the thread keeps
// its q row, an f32 accumulator of D values, a running max and a running
// sum in registers, and walks the keys in tiles staged (as f32) in shared
// memory, with an online softmax. The sum divides the accumulator at the
// end. No size gate is needed: any T works.
//
// Head grouping (`heads_per_program` = G, the TPU kernel's G heads per grid
// program): the block has kBlockQ * G threads and stages the key/value tile
// of all G heads at once. In the (B, T, C) layout the G * D channels of one
// token are contiguous, so the tile loads are coalesced runs of G * D
// elements instead of D. Every thread runs exactly the arithmetic of the
// G = 1 kernel for its (row, head), key by key in the same order, so the
// output is bit-identical for every G (the TPU's contract for the knob).
// The tile holds kTileK keys, chosen so the tile stays at 32 KB or less;
// the results do not depend on the tile size.
//
// Exact path. Deviation from the TPU kernel: there the normalised
// probabilities are cast to v's dtype before P.V; here unnormalised f32
// weights multiply v and the normalisation comes last. Only rounding
// changes: about 1e-6 in f32 and bf16-level in bf16. On request (a non-null
// `lse`) it also writes each row's base-2 log-sum-exp m + log2(l), f32 in
// (B, H, T), which the bf16 backward (`attention_bwd.cu`) reads in place of
// recomputing it; the output does not depend on whether it is written.
//
// Fast-math path (`fast_math`, attention.py:43-49 and :74-80): the shifted
// logit is rounded to bf16 and exponentiated in bf16, the bf16 weights are
// summed in f32 and multiply v in an f32 accumulator, and the division comes
// after P.V, as on the TPU. Keys go in pairs, the two shifted logits rounded
// to bf16 by one conversion. The bf16 exponential is the correctly rounded
// one, as `jnp.exp` of a bf16 array computes it through f32: the f32
// special-function exponential `ex2.approx.ftz.f32` (relative error about
// 2^-22) of the bf16 value, with log2(e) folded into the scale, then one
// round-to-nearest to bf16; it misses only for a value within 2^-22 of a
// bf16 rounding midpoint. sm_90 also has `ex2.approx.ftz.bf16x2`, but its
// maximum relative error is 2^-7 (PTX ISA), two bf16 ulps, which puts the
// output farther from this rounding than exact attention is, and the SASS
// of sm_90a runs it as two MUFU.EX2.BF16, one per half, so the
// special-function units take one exponential per lane either way.
// Deviations from the TPU kernel, which rounds the natural-log logit minus
// the row's global max to bf16 and takes `exp` of it: (1) the value rounded
// to bf16 is the base-2 logit (log2(e) folded into the scale in f32), so the
// rounding falls on other values; (2) it is shifted by the running max (over
// the pairs seen so far), not the row's global max, and the rescale factor
// applied to the sum and accumulator when the max moves stays f32. Both
// change bf16 rounding only. `attention_fast_math_kernel_order` in
// ops/attention.py is the plain PyTorch version of this rounding.
//
// Bound on the H100 at the main path's largest call, B=8, H=32, T=1024, D=8:
// 2*2*B*H*T^2*D = 8.6 GFLOP (8.7 us at 989 TFLOP/s bf16) and 16.8 MB moved in
// bf16 (5.0 us at 3.35 TB/s). It also takes B*H*T^2 = 2.7e8 exponentials,
// about 64 us on the special-function units at one exponential per lane
// (16 per clock per SM, bf16 or f32), so with D=8 the exponentials, not the
// products, are the real limit. This version runs the dot products on the
// CUDA cores, which is what its time is spent on; tensor-core MMA is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one thread per (row, head)
constexpr float kLog2e = 1.4426950408889634f;

// keys per staged tile: 128, or fewer so that the f32 k and v tiles of G
// heads stay within 32 KB of static shared memory (even, for the key pairs)
template <int D, int G>
struct TileKeys {
  static constexpr int value = 4096 / (G * D) < 128 ? 4096 / (G * D) : 128;
};

struct Strides {
  int64_t b, h, t, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x of two bf16 values, each correctly rounded to bf16 (see the top of
// the file): the f32 special-function exponential, then round-to-nearest
__device__ __forceinline__ float2 exp2_bf16x2(__nv_bfloat162 x) {
  const float2 xf = __bfloat1622float2(x);
  float a, b;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(a) : "f"(xf.x));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(b) : "f"(xf.y));
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

template <int D>
__device__ __forceinline__ float dot(const float* qr, const float* kr) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
  return s;
}

// One fast-math step over the keys k0 (and k1 when Pair): bf16 exponentials
// of the shifted base-2 logits, rounded to bf16 together; f32 sum and
// accumulator; an f32 rescale when the running max moves.
template <int D, bool Pair>
__device__ __forceinline__ void fast_math_step(const float* qr, const float* k0,
                                               const float* k1, const float* v0,
                                               const float* v1, float& m, float& l,
                                               float* acc) {
  const float s0 = dot<D>(qr, k0);
  const float s1 = Pair ? dot<D>(qr, k1) : -INFINITY;
  const float mx = fmaxf(s0, s1);
  if (mx > m) {
    const float c = exp2f(m - mx);  // f32, as on the exact path
    l *= c;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= c;
    m = mx;
  }
  const float2 p = exp2_bf16x2(__floats2bfloat162_rn(s0 - m, s1 - m));
  l += p.x;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = fmaf(p.x, v0[d], acc[d]);
  if (Pair) {
    l += p.y;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p.y, v1[d], acc[d]);
  }
}

template <int D, typename T, int G, bool FastMath>
__global__ void __launch_bounds__(kBlockQ * G)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int heads, int seq_len,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale_log2) {
  constexpr int kTileK = TileKeys<D, G>::value;
  constexpr int kWidth = G * D;  // staged channels per key: G heads of D
  __shared__ float k_tile[kTileK][kWidth];
  __shared__ float v_tile[kTileK][kWidth];

  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int g = threadIdx.x / kBlockQ;  // this thread's head within the group
  const int64_t h = h0 + g;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlockQ + threadIdx.x % kBlockQ;
  const bool active = row < seq_len;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h0 * sk.h;
  const T* vb = v + b * sv.b + h0 * sv.h;

  // logits in base 2: (q . k) * scale * log2(e), so exp(x) becomes exp2(x)
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(qb[row * sq.t + d * sq.d]) * scale_log2 : 0.f;
  }

  float m = -INFINITY;  // running max of the base-2 logits
  float l = 0.f;        // running sum of exp2(logit - m)
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kTileK) {
    const int n = min(kTileK, seq_len - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < n * kWidth; i += kBlockQ * G) {
      const int64_t j = i / kWidth;
      const int64_t c = i % kWidth;
      const int64_t gh = c / D;
      const int64_t d = c % D;
      k_tile[j][c] = to_f32(kb[(k0 + j) * sk.t + gh * sk.h + d * sk.d]);
      v_tile[j][c] = to_f32(vb[(k0 + j) * sv.t + gh * sv.h + d * sv.d]);
    }
    __syncthreads();
    if (!active) continue;
    if constexpr (!FastMath) {
      for (int j = 0; j < n; ++j) {
        const float s = dot<D>(qr, &k_tile[j][g * D]);
        if (s > m) {
          // rescale what was summed under the old max; on the first key
          // m = -inf, so c = 0 and the zero-initialised state stays zero
          const float c = exp2f(m - s);
          l *= c;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] *= c;
          m = s;
        }
        const float p = exp2f(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][g * D + d], acc[d]);
      }
    } else {
      // keys in pairs (kTileK is even, so pairs never straddle tiles); a
      // lone last key (odd T) pairs with -inf, whose weight is exactly 0
      const float* kg = &k_tile[0][g * D];
      const float* vg = &v_tile[0][g * D];
      int j = 0;
      for (; j + 1 < n; j += 2) {
        fast_math_step<D, true>(qr, kg + j * kWidth, kg + (j + 1) * kWidth,
                                vg + j * kWidth, vg + (j + 1) * kWidth, m, l, acc);
      }
      if (j < n) {
        fast_math_step<D, false>(qr, kg + j * kWidth, nullptr, vg + j * kWidth,
                                 nullptr, m, l, acc);
      }
    }
  }

  if (active) {
    T* ob = o + b * so.b + h * so.h + row * so.t;
    if constexpr (FastMath) {
#pragma unroll
      for (int d = 0; d < D; ++d) ob[d * so.d] = from_f32<T>(acc[d] / l);
    } else {
      const float inv = 1.f / l;
#pragma unroll
      for (int d = 0; d < D; ++d) ob[d * so.d] = from_f32<T>(acc[d] * inv);
      if (lse != nullptr) lse[(b * heads + h) * seq_len + row] = m + log2f(l);
    }
  }
}

template <int D, typename T, int G, bool FastMath>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int heads, int seq_len,
                   const int64_t* st, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, heads / G, batch);
  attention_fwd_kernel<D, T, G, FastMath><<<grid, kBlockQ * G, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads, seq_len, sq,
      sk, sv, so, scale * kLog2e);
  return cudaGetLastError();
}

template <int D, typename T, int G>
cudaError_t launch_math(bool fast_math, const void* q, const void* k, const void* v,
                        void* o, float* lse, int batch, int heads, int seq_len,
                        const int64_t* st, float scale, cudaStream_t s) {
  return fast_math
      ? launch<D, T, G, true>(q, k, v, o, nullptr, batch, heads, seq_len, st, scale, s)
      : launch<D, T, G, false>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
}

template <int D, typename T>
cudaError_t launch_group(int group, bool fast_math, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch, int heads,
                         int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch_math<D, T, 1>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 2: return launch_math<D, T, 2>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 4: return launch_math<D, T, 4>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 8: return launch_math<D, T, 8>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, (b, h, t, d)
// for q, k, v and out in that order. heads_per_program: 1, 2, 4 or 8, and it
// must divide heads. fast_math: 0 or 1. lse: null, or (exact path only) a
// contiguous f32 (batch, heads, seq_len) output for each row's base-2
// log-sum-exp. Returns a cudaError_t; an unsupported head_dim, dtype or
// group, or lse with fast_math, returns cudaErrorInvalidValue without
// launching.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int batch, int heads,
                             int seq_len, int head_dim, int dtype,
                             const int64_t* strides, float scale,
                             int heads_per_program, int fast_math,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = heads_per_program;
  if (seq_len <= 0 || batch <= 0 || heads <= 0 || g <= 0 || heads % g != 0)
    return cudaErrorInvalidValue;
  const bool fm = fast_math != 0;
  if (fm && lse != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 8)
    return launch_group<8, float>(g, fm, q, k, v, o, lse, batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 8)
    return launch_group<8, __nv_bfloat16>(g, fm, q, k, v, o, lse, batch, heads, seq_len, strides, scale, s);
  if (dtype == 0 && head_dim == 4)
    return launch_group<4, float>(g, fm, q, k, v, o, lse, batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 4)
    return launch_group<4, __nv_bfloat16>(g, fm, q, k, v, o, lse, batch, heads, seq_len, strides, scale, s);
  return cudaErrorInvalidValue;
}
