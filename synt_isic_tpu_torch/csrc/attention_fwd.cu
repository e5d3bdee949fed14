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
// The TPU kernel keeps the whole (T, T) f32 logits tile in VMEM (4 MB at
// T=1024); a Hopper block has at most 227 KB of shared memory, so neither
// kernel below forms the tile: both walk the keys in tiles staged in shared
// memory with an online softmax (a running max m and sum l per row, the
// accumulator rescaled in f32 when m moves, divided by l at the end), so
// any T works. On request (a non-null `lse`, exact maths only) they also
// write each row's base-2 log-sum-exp m + log2(l), f32 in (B, H, T), which
// the bf16 backward (`attention_bwd.cu`) reads in place of recomputing it;
// the output does not depend on whether it is written.
//
// Head grouping (`heads_per_program` = G, the TPU kernel's G heads per grid
// program): a block covers G heads and stages the key/value tile of all G at
// once (in the (B, T, C) layout the G * D channels of one token are
// contiguous). Every thread or warp runs exactly the arithmetic of the
// G = 1 kernel for its rows and head, so the output and lse are
// bit-identical for every G (the TPU's contract for the knob); no result
// depends on the tile size the staging uses.
//
// Fast math (`fast_math`, attention.py:43-49 and :74-80): the shifted logit
// is rounded to bf16 and exponentiated in bf16, the bf16 weights are summed
// in f32 and multiply v in an f32 accumulator, and the division comes after
// P.V, as on the TPU. The bf16 exponential is the correctly rounded one, as
// `jnp.exp` of a bf16 array computes it through f32: the f32
// special-function exponential `ex2.approx.ftz.f32` (relative error about
// 2^-22) of the bf16 value, with log2(e) folded into the scale, then one
// round-to-nearest to bf16; it misses only for a value within 2^-22 of a
// bf16 rounding midpoint. sm_90 also has `ex2.approx.ftz.bf16x2`, but its
// maximum relative error is 2^-7 (PTX ISA), two bf16 ulps, which puts the
// output farther from this rounding than exact attention is, so it is not
// used. Deviations from the TPU kernel, which rounds the natural-log logit
// minus the row's global max to bf16 and takes `exp` of it: (1) the value
// rounded to bf16 is the base-2 logit (log2(e) folded into the scale in
// f32), so the rounding falls on other values; (2) it is shifted by the
// running max, not the row's global max, and the rescale factor applied to
// the sum and accumulator when the max moves stays f32. Both change bf16
// rounding only. The running max moves once per group of keys: 2 keys on
// the CUDA-core kernel, one staged tile of 64 on the tensor-core kernels.
// `attention_fast_math_kernel_order(q, k, v, step, tf32x3)` in
// ops/attention.py is the plain PyTorch version of this rounding, for either
// group size (`tf32x3`: the f32 tensor-core kernel's logits and tile max).
//
// bf16, head_dim 8: the tensor-core kernel (the trainer's and the library
// generator's configuration).
//   Bound on the H100 at the main path's largest call, B=8, H=32, T=1024,
//   D=8: the two T x T contractions are 4*B*H*T^2*D = 8.6 GFLOP, 8.7 us on
//   the tensor cores (989 TFLOP/s bf16); q, k, v read once and out written
//   once are 16.8 MB, 5.0 us at 3.35 TB/s; the B*H*T^2 = 2.7e8
//   exponentials take 64 us on the special-function units (16 per clock per
//   SM). So the exponentials are the limit, and the design keeps everything
//   else off the special-function units' way: the products run on the
//   tensor cores, and each (i, j) pair costs one MUFU.EX2 and a few f32
//   instructions, with the 32 warps an SM holds keeping the units busy.
//   Fragments, as B1's dq launch in `attention_bwd.cu` (helpers in
//   tensor_core.cuh): one warp owns 16 query rows of one head, 4 warps per
//   head, 64 rows x G heads per block, at most 64 registers a thread. K and
//   V are staged in tiles of 64 keys by `cp.async`, double-buffered, 16 bytes
//   (one row of one head) per copy, so each row of k and v must start on 16
//   bytes with its 8 channels contiguous (the wrapper copies any other
//   layout first; q is read from its own strides and out written to them).
//   S = Q K^T is `mma.sync` m16n8k8 with D = 8 unpadded, q's A fragment from
//   registers and K's B fragments by `ldmatrix`; O += P V is m16n8k16, the
//   k16 A fragment being two adjacent n8 fragments of P rounded to bf16 in
//   registers, V's B fragment by `ldmatrix.trans`.
//   Per tile the kernel takes two passes over the staged keys: the first
//   forms S only for each row's tile max (reduced over the row's 4 lanes),
//   then m, l and the accumulator are rescaled once (one exponential per
//   row and tile, which the row's 4 lanes each take: 2 per lane beside the
//   tile's 32); the second forms S again (the tensor cores are idle enough
//   that recomputing costs less than holding 64 keys of S, 32 registers, in
//   a 64-register budget) and takes p = 2^(s * scale * log2(e) - m), one
//   fma and one MUFU.EX2 per pair. Keys past T are masked (s = -inf) on the
//   last tile only; rows past T are neither stored nor given an lse.
//   Exact: l sums the f32 p values, not their bf16 roundings, so that
//   m + log2(l) is the f32 softmax's log-sum-exp that the backward rebuilds
//   its f32 probabilities from (within f32 summation order of
//   `attention_lse_reference`); bf16 roundings would put up to 2^-9
//   relative error into each term. Fast math: p is already bf16, and the
//   row sums come from the tensor cores as P times a column of ones, in f32.
//   Deviations, rounding only: P is rounded to bf16 before P.V, relative to
//   the running max and unnormalised, and the division by l comes last; the
//   TPU kernel rounds the normalised probabilities to bf16
//   (attention.py:81-83); the products accumulate in f32 on the tensor
//   cores.
//
// f32, head_dim 8: the 3xTF32 tensor-core kernel, exact maths (the console
// CLI's and the conditional generator's configuration) and fast math (an f32
// `ModelManager` with `set_attention_tuning(fast_math=True)`); every G, so that
// G > 1 runs the arithmetic of G = 1.
//   Bound on the H100 at (8, 32, 1024, 8): products accurate to f32 run on
//   the tensor cores in three TF32 passes, 3 x 8.6 GFLOP at 494.7 TFLOP/s
//   (dense TF32) = 52 us; q, k, v and out in f32 are 33.6 MB, 10 us; the
//   2.7e8 exponentials take 64 us on the special-function units. So, as in
//   bf16, the exponentials are the limit, and everything else is kept off
//   their way: one MUFU.EX2 per (i, j) and no data-dependent branch per key.
//   Layout as the bf16 kernel: one warp per 16 query rows of one head, 4 warps
//   per head, 64 rows x G heads per block, at most 64 registers a thread. K
//   and V come in f32 tiles of 64 keys by `cp.async`, double-buffered, two
//   16-byte copies per key row of one head (so each row of k and v must start
//   on 16 bytes with its 8 channels contiguous; the wrapper copies any other
//   layout first); the block then splits each staged tile once into TF32 hi
//   and lo parts in shared memory (16 KB x G of dynamic shared memory in all),
//   so no warp splits K or V in its inner loop.
//   Products: `mma.sync` m16n8k8 with TF32 operands (D = 8 unpadded as k8 for
//   S = Q K^T; 8 keys as k8 for O += P V), each operand split into hi, its
//   TF32 rounding to nearest with ties away (as `cvt.rna.tf32.f32`, here two
//   integer instructions), and lo = x - hi, of which the tensor cores read the
//   top 19 bits; three products per 8 keys, lo.hi + hi.lo + hi.hi, the small
//   terms first. q is scaled to base-2 logits in f32 (1/sqrt(D) * log2(e))
//   and split once, in registers; P is split in registers.
//   Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4): A holds
//   rows g, g + 8 at columns t and t + 4, B rows t and t + 4 of column g, C
//   rows g, g + 8 at columns 2t and 2t + 1. S's accumulator thus holds keys
//   2t, 2t + 1 where P's A fragment wants columns t, t + 4: no shuffle, the
//   keys are permuted instead. S's B column n reads key n ^ ((n >> 2) & 1)
//   of its 8, so the accumulator's columns (2t, 2t + 1) hold keys 2t + w and
//   2t + 1 - w (w = (t >> 1) & 1), which become P's columns t and t + 4;
//   V's B fragment reads keys 2t + w and 2t + 1 - w of channel g. With V's
//   rows stored as they come, those reads hit 32 banks; K's reads (keys
//   n and n + 4 would share banks) do so because the two 16-byte chunks of
//   keys 4-7 of every 8 are stored swapped.
//   Softmax in base 2, one pass per tile: p = 2^(s - m), one FADD and one
//   MUFU.EX2 per pair, against a running shift m that needs no pass of its
//   own: the tile max of one TF32 pass (hi.hi) on the first tile, then, after
//   a tile whose row sum passes 2^16, m + log2 of that sum (within 6 of the
//   tile's max), so the weights stay under 2^16. The shift cancels in the
//   softmax; it changes rounding only. A tile whose row sums would
//   pass 2^40 against it (logits that jump by more than about 40 within a
//   row; a warp-wide vote) is done again after moving the shift to that
//   one-pass tile max. Each tile's P V gathers in its own accumulator and is
//   added in f32 at the end: the tensor cores' f32 sums truncate, and a
//   chain of 24 products, not one of every key's, carries that error. l sums
//   the f32 p (the lse is the f32 softmax's).
//   Deviations from the TPU kernel (attention.py:28-56, exact f32), rounding
//   only (`attention_tf32x3_kernel_order` in ops/attention.py is this
//   arithmetic in plain PyTorch, all but the redone tiles): each product is
//   carried to about 2^-21 of it (lo truncated, lo.lo dropped), the sums in
//   f32 in the tensor cores' order; the weights are taken against a running
//   shift, not the row's max; unnormalised weights multiply v and the
//   division comes last. At randn inputs the result lies within about 5e-7
//   of float64 attention on the CPU model, as f32 does; one TF32 pass would
//   miss the 2e-5 tolerance 15-30 times over.
//   Fast math (`FastMath`), the same kernel with the weights rounded: the
//   bound is the same 64 us of exponentials (products: 5 TF32 passes, plus
//   one for the max, 6 x 4.3 GFLOP = 52 us at the dense TF32 rate). S is
//   formed in three TF32 passes as above: the bf16 rounding of the shifted
//   logit magnifies an error of S, and at one pass (about 2^-11 relative) a
//   large share of the weights would round to another bf16 value, as far
//   from the fast-math rounding as exact attention lies. The shift is the
//   running max, as on the bf16 kernel, so that the value rounded to bf16
//   is s - m with m a max the plain rounding order reproduces: each tile
//   first takes its max from the one-pass hi.hi product (`tile_max_tf32`,
//   within about 2^-10 of S, so s - m may be a little above 0) and moves m,
//   l and the accumulator onto it in f32. Then per 8 keys: x = bf16(s - m),
//   p = bf16(ex2(x)) (the correctly rounded bf16 exponential of the top of
//   the file); p is bf16-valued, so it is exact in TF32, its lo part is
//   zero, and P V takes two products, P.v_lo + P.v_hi, into the tile's own
//   accumulator; l sums the bf16 p in f32, per lane, then over the row's 4
//   lanes. The division comes last; no lse is written. Its plain rounding
//   order is `attention_fast_math_kernel_order(..., step=64, tf32x3=True)`.
//
// head_dim 4 (f32 and bf16, exact and fast math): the CUDA-core kernel, one
// thread per (row, head), everything f32 inside. No configuration of the
// model has head_dim 4 (the UNet's `attention_head_dim` is 8); it serves
// small test configurations. A block handles kBlockQ
// query rows of G heads; the thread keeps its q row, an f32 accumulator of
// D values, a running max and a running sum in registers, and walks the
// keys in tiles staged as f32, at most 32 KB. Fast math takes keys in pairs,
// the two shifted logits rounded to bf16 by one conversion. Deviation from
// the TPU kernel on the exact path: unnormalised f32 weights multiply v and
// the normalisation comes last; nothing is rounded until the store. Only
// rounding changes: about 1e-6 in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one thread per (row, head)

constexpr float kLog2e = 1.4426950408889634f;

// keys per staged tile: 128, or fewer so that the f32 k and v tiles of G
// heads stay within 32 KB of static shared memory (even, for the key pairs)
template <int D, int G>
struct TileKeys {
  static constexpr int value = 4096 / (G * D) < 128 ? 4096 / (G * D) : 128;
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

template <int D, typename T, bool FastMath>
cudaError_t launch_group(int group, const void* q, const void* k, const void* v, void* o,
                         float* lse, int batch, int heads, int seq_len, const int64_t* st,
                         float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch<D, T, 1, FastMath>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 2: return launch<D, T, 2, FastMath>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 4: return launch<D, T, 4, FastMath>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 8: return launch<D, T, 8, FastMath>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, typename T>
cudaError_t launch_math(int group, bool fast_math, const void* q, const void* k,
                        const void* v, void* o, float* lse, int batch, int heads,
                        int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  return fast_math
      ? launch_group<D, T, true>(group, q, k, v, o, nullptr, batch, heads, seq_len, st, scale, s)
      : launch_group<D, T, false>(group, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
}

// ---------------------------------------------------------------------------
// bf16, D = 8: the tensor-core kernel (see the top of the file)
// ---------------------------------------------------------------------------

// S = Q K^T for one warp's 16 rows and keys [16 s, 16 s + 16) of the staged
// tile, as two C fragments: sc[0..3] keys +0..7, sc[4..7] keys +8..15. With
// Mask, keys at or past `keys` get s = -inf, so their weight is 0.
template <bool Mask>
__device__ __forceinline__ void qk_step(const uint4* kt, int s, const uint32_t* qa,
                                        int keys, float* sc) {
  const int lane = threadIdx.x % 32;
  uint32_t kb[2];
  ldsm_x2(kb, kt + s * 16 + lane % 16);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float* f = sc + 4 * c;
    f[0] = f[1] = f[2] = f[3] = 0.f;
    mma_k8(f, qa, kb[c]);
    if (Mask) {
      const int key = s * 16 + c * 8 + 2 * (lane % 4);
      if (key >= keys) f[0] = f[2] = -INFINITY;
      if (key + 1 >= keys) f[1] = f[3] = -INFINITY;
    }
  }
}

// One staged key tile for one warp's 16 query rows (row a = lane/4 and row
// b = row a + 8): the tile's max, the rescale, then P and O += P V, 16 keys
// a step. m[r] is row r's running max of the base-2 logits; l and acc are C
// fragments (l[0..1] and acc[0..1] row a, l[2..3] and acc[2..3] row b). On
// the exact path l[i] is this lane's partial sum of its keys' f32 weights;
// with fast math every column of l is the whole row's sum of the bf16
// weights, from the tensor cores.
template <bool FastMath, bool Mask>
__device__ __forceinline__ void fwd_tile(const uint4* kt, const uint4* vt, const uint32_t* qa,
                                         float scale_log2, int keys, float* m, float* l,
                                         float* acc) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int s = 0; s < kTcTile / 16; ++s) {
    float sc[8];
    qk_step<Mask>(kt, s, qa, keys, sc);
    mx[0] = fmaxf(mx[0], fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[4], sc[5])));
    mx[1] = fmaxf(mx[1], fmaxf(fmaxf(sc[2], sc[3]), fmaxf(sc[6], sc[7])));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // max(s) * scale = max(s * scale) exactly, the scale being positive
    const float mnew = fmaxf(m[r], mx[r] * scale_log2);
    // rescale what was summed under the old max; on the first tile
    // m = -inf, so c = 0 and the zero-initialised state stays zero
    const float c = mnew > m[r] ? ex2(m[r] - mnew) : 1.f;
    m[r] = mnew;
    // __fmul_rn is never contracted into an fma with the sums that follow,
    // so the rounding does not depend on how the compiler unrolls and
    // schedules each G instance (G = 1 and G > 1 must agree bit for bit)
#pragma unroll
    for (int i = 2 * r; i < 2 * r + 2; ++i) {
      l[i] = __fmul_rn(l[i], c);
      acc[i] = __fmul_rn(acc[i], c);
    }
  }
  const uint32_t ones[2] = {0x3f803f80u, 0x3f803f80u};   // bf16 1.0 pairs
  // two steps at a time: fully unrolled, the steps' fragments spill at the
  // 64-register cap
#pragma unroll 2
  for (int s = 0; s < kTcTile / 16; ++s) {
    float sc[8];
    qk_step<Mask>(kt, s, qa, keys, sc);
    uint32_t pa[4];   // P as the k16 A fragment: rows a, b at keys +0..7, then +8..15
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* f = sc + 4 * c;
      if (FastMath) {
        // the shifted base-2 logits rounded to bf16, then their correctly
        // rounded bf16 exponentials
        const uint32_t xa = pack_bf16(fmaf(f[0], scale_log2, -m[0]), fmaf(f[1], scale_log2, -m[0]));
        const uint32_t xb = pack_bf16(fmaf(f[2], scale_log2, -m[1]), fmaf(f[3], scale_log2, -m[1]));
        pa[2 * c] = pack_bf16(ex2(lo_f32(xa)), ex2(hi_f32(xa)));
        pa[2 * c + 1] = pack_bf16(ex2(lo_f32(xb)), ex2(hi_f32(xb)));
      } else {
        const float p[4] = {ex2(fmaf(f[0], scale_log2, -m[0])), ex2(fmaf(f[1], scale_log2, -m[0])),
                            ex2(fmaf(f[2], scale_log2, -m[1])), ex2(fmaf(f[3], scale_log2, -m[1]))};
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] += p[i];
        pa[2 * c] = pack_bf16(p[0], p[1]);
        pa[2 * c + 1] = pack_bf16(p[2], p[3]);
      }
    }
    uint32_t vT[2];
    ldsm_x2_trans(vT, vt + s * 16 + lane % 16);
    mma_k16(acc, pa, vT);                // O += P V
    if (FastMath) mma_k16(l, pa, ones);  // l += P 1
  }
}

template <int G, bool FastMath>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int heads, int seq_len, Strides sq,
                        Strides sk, Strides sv, Strides so, float scale_log2) {
  __shared__ uint4 k_tile[2][G * kTcTile];
  __shared__ uint4 v_tile[2][G * kTcTile];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;          // this warp's head within the group
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ra = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int rb = ra + 8;
  const bool oka = ra < seq_len;
  const bool okb = rb < seq_len;

  // q's A fragment (rows a and b, channels 2 tig and +1)
  const bf16* qh = q + b * sq.b + h * sq.h;
  const uint32_t qa[2] = {load_pair(qh, sq, ra, 2 * tig, oka), load_pair(qh, sq, rb, 2 * tig, okb)};

  float m[2] = {-INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* kb = k + b * sk.b + h0 * sk.h;
  const bf16* vb = v + b * sv.b + h0 * sv.h;
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage_rows<G>(k_tile[0], v_tile[0], kb, vb, sk, sv, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {   // the next tile streams in while this one is used
      stage_rows<G>(k_tile[buf ^ 1], v_tile[buf ^ 1], kb, vb, sk, sv, (t + 1) * kTcTile,
                    seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int keys = seq_len - t * kTcTile;
    if (keys >= kTcTile) {
      fwd_tile<FastMath, false>(&k_tile[buf][g * kTcTile], &v_tile[buf][g * kTcTile], qa,
                                scale_log2, keys, m, l, acc);
    } else {
      fwd_tile<FastMath, true>(&k_tile[buf][g * kTcTile], &v_tile[buf][g * kTcTile], qa,
                               scale_log2, keys, m, l, acc);
    }
    __syncthreads();       // every warp is done with buf before it is refilled
  }

  float la = l[0];
  float lb = l[2];
  if (!FastMath) {         // the lane's partial sums, then the row's 4 lanes
    la += l[1];
    lb += l[3];
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      la += __shfl_xor_sync(0xffffffffu, la, x);
      lb += __shfl_xor_sync(0xffffffffu, lb, x);
    }
  }
  bf16* oh = o + b * so.b + h * so.h;
  if (oka) {
    oh[ra * so.t + 2 * tig * so.d] = __float2bfloat16(acc[0] / la);
    oh[ra * so.t + (2 * tig + 1) * so.d] = __float2bfloat16(acc[1] / la);
  }
  if (okb) {
    oh[rb * so.t + 2 * tig * so.d] = __float2bfloat16(acc[2] / lb);
    oh[rb * so.t + (2 * tig + 1) * so.d] = __float2bfloat16(acc[3] / lb);
  }
  if (lse != nullptr && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (oka) lse[stat + ra] = m[0] + log2f(la);
    if (okb) lse[stat + rb] = m[1] + log2f(lb);
  }
}

template <int G, bool FastMath>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                      int batch, int heads, int seq_len, const int64_t* st, float scale,
                      cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  if (!rows16<bf16>(k, sk) || !rows16<bf16>(v, sv)) return cudaErrorInvalidValue;
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  attention_fwd_tc_kernel<G, FastMath><<<grid, 32 * kTcWarps * G, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, heads, seq_len, sq, sk, sv, so, scale * kLog2e);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_tc_math(bool fast_math, const void* q, const void* k, const void* v,
                           void* o, float* lse, int batch, int heads, int seq_len,
                           const int64_t* st, float scale, cudaStream_t s) {
  return fast_math
      ? launch_tc<G, true>(q, k, v, o, nullptr, batch, heads, seq_len, st, scale, s)
      : launch_tc<G, false>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
}

cudaError_t launch_tc_group(int group, bool fast_math, const void* q, const void* k,
                            const void* v, void* o, float* lse, int batch, int heads,
                            int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch_tc_math<1>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 2: return launch_tc_math<2>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 4: return launch_tc_math<4>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 8: return launch_tc_math<8>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32, D = 8, exact: the 3xTF32 tensor-core kernel (see the top of the file)
// ---------------------------------------------------------------------------

// This lane's reads of one staged tile, as offsets in floats from the head's
// K or V tile, for slice 0 (slice s adds 64 s): K[n ^ ((n >> 2) & 1)][tig]
// and [tig + 4] for S's B column n = gid (the chunk swap of keys 4-7 undone);
// V[2 tig + w][gid] and V[2 tig + 1 - w][gid] for P V's B fragment.
struct Tf32Lane {
  int k0, k1, v0, v1;
  __device__ __forceinline__ Tf32Lane() {
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int sw = (gid >> 2) & 1;
    const int key = gid ^ sw;
    const int w = (tig >> 1) & 1;
    k0 = key * 8 + 4 * sw + tig;
    k1 = key * 8 + 4 * (sw ^ 1) + tig;
    v0 = (2 * tig + w) * 8 + gid;
    v1 = (2 * tig + 1 - w) * 8 + gid;
  }
};

// Keys at or past `keys` get s = -inf (weight 0): c[0], c[2] hold key
// 8 s + 2 tig + w, c[1], c[3] key 8 s + 2 tig + 1 - w (w = (tig >> 1) & 1).
__device__ __forceinline__ void mask_keys(int s, int keys, float* c) {
  const int tig = threadIdx.x % 4;
  const int w = (tig >> 1) & 1;
  if (8 * s + 2 * tig + w >= keys) c[0] = c[2] = -INFINITY;
  if (8 * s + 2 * tig + 1 - w >= keys) c[1] = c[3] = -INFINITY;
}

// S = Q K^T in base 2 for one warp's 16 rows and the 8 keys of slice s of the
// staged tile, as one C fragment (c[0..1] row a, c[2..3] row b, keys as in
// mask_keys): three TF32 products, the small terms first.
template <bool Mask>
__device__ __forceinline__ void qk_tf32(const uint32_t* kh, const uint32_t* kl,
                                        const Tf32Lane& ln, int s, const uint32_t* qhi,
                                        const uint32_t* qlo, int keys, float* c) {
  const uint32_t khi[2] = {kh[ln.k0 + 64 * s], kh[ln.k1 + 64 * s]};
  const uint32_t klo[2] = {kl[ln.k0 + 64 * s], kl[ln.k1 + 64 * s]};
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_tf32(c, qlo, khi);
  mma_tf32(c, qhi, klo);
  mma_tf32(c, qhi, khi);
  if (Mask) mask_keys(s, keys, c);
}

// The row maxima of one TF32 product of the hi parts (within about 2^-10 of
// S) over the staged tile, for one warp's rows a and b, reduced over each
// row's 4 lanes.
template <bool Mask>
__device__ __forceinline__ void tile_max_tf32(const uint32_t* kh, const Tf32Lane& ln,
                                              const uint32_t* qhi, int keys, float* mx) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int s = 0; s < kTcTile / 8; ++s) {
    const uint32_t kb[2] = {kh[ln.k0 + 64 * s], kh[ln.k1 + 64 * s]};
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c, qhi, kb);
    if (Mask) mask_keys(s, keys, c);
    mx[0] = fmaxf(mx[0], fmaxf(c[0], c[1]));
    mx[1] = fmaxf(mx[1], fmaxf(c[2], c[3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// P = 2^(S - m) and P V over the staged tile for one warp's 16 query rows, 8
// keys a step: lt[r] gets the row's sum of its f32 weights (reduced over its
// 4 lanes), pv the tile's P V (a C fragment, its own accumulator: the tensor
// cores' f32 sums truncate, so a chain of 24 products, not one of every
// key's, carries that error). With FastMath the shifted logit s - m is
// rounded to bf16 and its correctly rounded bf16 exponential taken; a bf16
// weight is exact in TF32 (its lo part is zero), so P V takes two products,
// P.v_lo + P.v_hi, and lt sums the bf16 weights in f32.
template <bool FastMath, bool Mask>
__device__ __forceinline__ void tile_pv_tf32(const uint32_t* kh, const uint32_t* kl,
                                             const uint32_t* vh, const uint32_t* vl,
                                             const Tf32Lane& ln, const uint32_t* qhi,
                                             const uint32_t* qlo, int keys, const float* m,
                                             float* lt, float* pv) {
  lt[0] = lt[1] = 0.f;
  pv[0] = pv[1] = pv[2] = pv[3] = 0.f;
  // two steps a turn: fully unrolled, the steps' fragments spill at the
  // 64-register cap
#pragma unroll 2
  for (int s = 0; s < kTcTile / 8; ++s) {
    float c[4];
    qk_tf32<Mask>(kh, kl, ln, s, qhi, qlo, keys, c);
    if (FastMath) {
      // rows a (xa) and b (xb), keys of c[0] and c[2] in the low halves
      const uint32_t xa = pack_bf16(__fsub_rn(c[0], m[0]), __fsub_rn(c[1], m[0]));
      const uint32_t xb = pack_bf16(__fsub_rn(c[2], m[1]), __fsub_rn(c[3], m[1]));
      const uint32_t pa = pack_bf16(ex2(lo_f32(xa)), ex2(hi_f32(xa)));
      const uint32_t pb = pack_bf16(ex2(lo_f32(xb)), ex2(hi_f32(xb)));
      lt[0] = __fadd_rn(lt[0], __fadd_rn(lo_f32(pa), hi_f32(pa)));
      lt[1] = __fadd_rn(lt[1], __fadd_rn(lo_f32(pb), hi_f32(pb)));
      // P's A fragment as f32 bit patterns: rows a, b at column tig, then at tig + 4
      const uint32_t pf[4] = {pa << 16, pb << 16, pa & 0xffff0000u, pb & 0xffff0000u};
      const uint32_t vhi[2] = {vh[ln.v0 + 64 * s], vh[ln.v1 + 64 * s]};
      const uint32_t vlo[2] = {vl[ln.v0 + 64 * s], vl[ln.v1 + 64 * s]};
      mma_tf32(pv, pf, vlo);   // P V, the small term first
      mma_tf32(pv, pf, vhi);
    } else {
      const float p[4] = {ex2(__fsub_rn(c[0], m[0])), ex2(__fsub_rn(c[1], m[0])),
                          ex2(__fsub_rn(c[2], m[1])), ex2(__fsub_rn(c[3], m[1]))};
      lt[0] = __fadd_rn(lt[0], __fadd_rn(p[0], p[1]));
      lt[1] = __fadd_rn(lt[1], __fadd_rn(p[2], p[3]));
      // P's A fragment: rows a, b at column tig (c[0], c[2]), then at tig + 4
      uint32_t phi[4], plo[4];
      split_tf32(p[0], phi[0], plo[0]);
      split_tf32(p[2], phi[1], plo[1]);
      split_tf32(p[1], phi[2], plo[2]);
      split_tf32(p[3], phi[3], plo[3]);
      const uint32_t vhi[2] = {vh[ln.v0 + 64 * s], vh[ln.v1 + 64 * s]};
      const uint32_t vlo[2] = {vl[ln.v0 + 64 * s], vl[ln.v1 + 64 * s]};
      mma_tf32(pv, plo, vhi);   // P V, the small terms first
      mma_tf32(pv, phi, vlo);
      mma_tf32(pv, phi, vhi);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 1));
    lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 2));
  }
}

// Bring row r's sum l[r] and accumulator (acc[2r], acc[2r + 1]) from shift
// m[r] onto mnew >= m[r]. __fmul_rn is never contracted into an fma with the
// sums that follow, so no G instance rounds otherwise than G = 1.
__device__ __forceinline__ void shift_to(int r, float mnew, float* m, float* l, float* acc) {
  // on the first tile m = -inf, so c = 0 and the zero state stays zero
  const float c = mnew > m[r] ? ex2(m[r] - mnew) : 1.f;
  m[r] = mnew;
  l[r] = __fmul_rn(l[r], c);
  acc[2 * r] = __fmul_rn(acc[2 * r], c);
  acc[2 * r + 1] = __fmul_rn(acc[2 * r + 1], c);
}

// One staged key tile for one warp's 16 query rows. The weights are taken
// against a running shift m that needs no pass over the tile: on the first
// tile, and on a tile whose row sums would pass 2^40 against it (then, or on
// inf or NaN, the tile is done again), m first moves to the tile's max from
// one TF32 pass (tile_max_tf32); after a tile whose row sum passes 2^16, m
// moves to m + log2 of that sum (within 6 of the tile's max, as a tile has
// 64 keys), so the weights stay under 2^16. With FastMath the shift is the
// running max instead, the value the bf16 rounding is taken against: m moves
// to the one-pass tile max on every tile (the weights then stay near or
// under 1). m, l (row sums) and acc are per row as in shift_to, the same in
// each row's 4 lanes.
template <bool FastMath, bool Mask>
__device__ __forceinline__ void fwd_tile_tf32(const uint32_t* kh, const uint32_t* kl,
                                              const uint32_t* vh, const uint32_t* vl,
                                              const Tf32Lane& ln, const uint32_t* qhi,
                                              const uint32_t* qlo, int keys, bool first,
                                              float* m, float* l, float* acc) {
  float lt[2], pv[4];
  bool need_max = first || FastMath;
  for (;;) {
    if (need_max) {
      float mx[2];
      tile_max_tf32<Mask>(kh, ln, qhi, keys, mx);
      shift_to(0, fmaxf(m[0], mx[0]), m, l, acc);
      shift_to(1, fmaxf(m[1], mx[1]), m, l, acc);
    }
    tile_pv_tf32<FastMath, Mask>(kh, kl, vh, vl, ln, qhi, qlo, keys, m, lt, pv);
    // !(x <= 2^40) also holds for inf and NaN
    const bool wide = !(lt[0] <= 0x1p40f) || !(lt[1] <= 0x1p40f);
    if (need_max || !__any_sync(0xffffffffu, wide)) break;
    need_max = true;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], lt[r]);
    acc[2 * r] = __fadd_rn(acc[2 * r], pv[2 * r]);
    acc[2 * r + 1] = __fadd_rn(acc[2 * r + 1], pv[2 * r + 1]);
    if (!FastMath && lt[r] > 0x1p16f) shift_to(r, __fadd_rn(m[r], __log2f(lt[r])), m, l, acc);
  }
}

template <int G, bool FastMath>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int heads, int seq_len, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale_log2) {
  // two buffers of G heads' K tiles as staged, two of their V tiles, then
  // the current tile's K hi, K lo, V hi and V lo parts
  extern __shared__ float4 tf32_tiles[];
  constexpr int kChunks = G * 2 * kTcTile;   // 16-byte chunks per tile of G heads
  float4* k_tile = tf32_tiles;
  float4* v_tile = tf32_tiles + 2 * kChunks;
  float4* parts = tf32_tiles + 4 * kChunks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;          // this warp's head within the group
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ra = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int rb = ra + 8;
  const bool oka = ra < seq_len;
  const bool okb = rb < seq_len;

  // q's A fragment (rows a, b at channel tig, then at tig + 4), scaled to
  // base-2 logits in f32 and split into TF32 hi and lo parts once
  const float* qh = q + b * sq.b + h * sq.h;
  const float qx[4] = {oka ? qh[ra * sq.t + tig * sq.d] : 0.f,
                       okb ? qh[rb * sq.t + tig * sq.d] : 0.f,
                       oka ? qh[ra * sq.t + (tig + 4) * sq.d] : 0.f,
                       okb ? qh[rb * sq.t + (tig + 4) * sq.d] : 0.f};
  uint32_t qhi[4], qlo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__fmul_rn(qx[i], scale_log2), qhi[i], qlo[i]);

  const Tf32Lane lane_reads;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* kb = k + b * sk.b + h0 * sk.h;
  const float* vb = v + b * sv.b + h0 * sv.h;
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  // K with its chunk swap (S's reads), V as it comes (P V's reads)
  stage_rows_f32<G, false>(k_tile, v_tile, kb, vb, sk, sv, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {   // the next tile streams in while this one is used
      stage_rows_f32<G, false>(k_tile + (buf ^ 1) * kChunks, v_tile + (buf ^ 1) * kChunks,
                               kb, vb, sk, sv, (t + 1) * kTcTile, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // buf has landed for every thread, and every warp is done with the
    // previous tile's parts
    __syncthreads();
    split_tile(k_tile + buf * kChunks, v_tile + buf * kChunks, parts, parts + kChunks,
               parts + 2 * kChunks, parts + 3 * kChunks);
    __syncthreads();
    const uint32_t* head = reinterpret_cast<const uint32_t*>(parts + g * 2 * kTcTile);
    constexpr int kPart = 4 * kChunks;   // words from one part to the next
    const int keys = seq_len - t * kTcTile;
    if (keys >= kTcTile) {
      fwd_tile_tf32<FastMath, false>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                     lane_reads, qhi, qlo, keys, t == 0, m, l, acc);
    } else {
      fwd_tile_tf32<FastMath, true>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                    lane_reads, qhi, qlo, keys, t == 0, m, l, acc);
    }
  }

  const float la = l[0];
  const float lb = l[1];
  float* oh = o + b * so.b + h * so.h;
  if (oka) {
    oh[ra * so.t + 2 * tig * so.d] = acc[0] / la;
    oh[ra * so.t + (2 * tig + 1) * so.d] = acc[1] / la;
  }
  if (okb) {
    oh[rb * so.t + 2 * tig * so.d] = acc[2] / lb;
    oh[rb * so.t + (2 * tig + 1) * so.d] = acc[3] / lb;
  }
  if (lse != nullptr && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (oka) lse[stat + ra] = m[0] + log2f(la);
    if (okb) lse[stat + rb] = m[1] + log2f(lb);
  }
}

template <int G, bool FastMath>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int batch, int heads, int seq_len, const int64_t* st, float scale,
                        cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  if (!rows16<float>(k, sk) || !rows16<float>(v, sv)) return cudaErrorInvalidValue;
  // K and V as staged, double-buffered, and the tile's four parts
  constexpr int kBytes = 8 * G * 2 * kTcTile * 16;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(attention_fwd_tf32_kernel<G, FastMath>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  attention_fwd_tf32_kernel<G, FastMath><<<grid, 32 * kTcWarps * G, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, heads, seq_len, sq, sk, sv, so, scale * kLog2e);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_tf32_math(bool fast_math, const void* q, const void* k, const void* v,
                             void* o, float* lse, int batch, int heads, int seq_len,
                             const int64_t* st, float scale, cudaStream_t s) {
  return fast_math
      ? launch_tf32<G, true>(q, k, v, o, nullptr, batch, heads, seq_len, st, scale, s)
      : launch_tf32<G, false>(q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
}

cudaError_t launch_tf32_group(int group, bool fast_math, const void* q, const void* k,
                              const void* v, void* o, float* lse, int batch, int heads,
                              int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch_tf32_math<1>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 2: return launch_tf32_math<2>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 4: return launch_tf32_math<4>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    case 8: return launch_tf32_math<8>(fast_math, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch's shape, types and knobs, packed once per checked layout by
// ops/attention.py (`_FwdArgs` there: the same fields in the same order).
// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, (b, h, t, d)
// for q, k, v and out in that order. heads_per_program: 1, 2, 4 or 8, and it
// must divide heads. fast_math: 0 or 1.
struct FwdArgs {
  int64_t strides[16];
  int32_t batch, heads, seq_len, head_dim, dtype, heads_per_program, fast_math;
  float scale;
};

// lse: null, or (exact path only) a contiguous f32 (batch, heads, seq_len)
// output for each row's base-2 log-sum-exp. Returns a cudaError_t; an
// unsupported head_dim, dtype or group, or lse with fast_math, returns
// cudaErrorInvalidValue without launching. head_dim 8 (the tensor-core
// kernels, both dtypes, exact and fast math) also needs each row of k and v
// to start on 16 bytes with its channels contiguous.
extern "C" int attention_fwd(const FwdArgs* a, const void* q, const void* k, const void* v,
                             void* o, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = a->heads_per_program;
  const int batch = a->batch, heads = a->heads, seq_len = a->seq_len;
  const int64_t* st = a->strides;
  const float scale = a->scale;
  if (seq_len <= 0 || batch <= 0 || heads <= 0 || g <= 0 || heads % g != 0)
    return cudaErrorInvalidValue;
  const bool fm = a->fast_math != 0;
  if (fm && lse != nullptr) return cudaErrorInvalidValue;
  if (a->dtype == 0 && a->head_dim == 8)
    return launch_tf32_group(g, fm, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
  if (a->dtype == 1 && a->head_dim == 8)
    return launch_tc_group(g, fm, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
  if (a->dtype == 0 && a->head_dim == 4)
    return launch_math<4, float>(g, fm, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
  if (a->dtype == 1 && a->head_dim == 4)
    return launch_math<4, __nv_bfloat16>(g, fm, q, k, v, o, lse, batch, heads, seq_len, st, scale, s);
  return cudaErrorInvalidValue;
}
