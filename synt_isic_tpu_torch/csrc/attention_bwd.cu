// Spatial self-attention backward, (dq, dk, dv) of softmax(q k^T / sqrt(D)) v,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attention_bwd_kernel` reached through
// `fused_attention_bwd` (and, as the VJP of `fused_attention_trainable`) in
// synt_isic_tpu/ops/pallas/attention.py. As there, the probabilities are
// recomputed from q and k, and no (T, T) tensor reaches device memory. As in
// the forward (`attention_fwd.cu`), every tensor comes as a base pointer plus
// (b, h, t, d) element strides, so the UNet's (B, T, C) projection views go in
// and the gradients land in (B, T, C) views without a copy; the staged
// tensors go by `cp.async` in the largest unit their layout allows, or an
// element at a time (`stage_unit` in tensor_core.cuh), so no layout is copied
// first.
//
// Every head_dim D >= 1 runs on the tensor cores, in both dtypes: up to 64
// the kernels are templates on a staged width Dp of 8, 16, 32 or 64 (the
// least one >= D), above 64 the wide kernels walk the head in chunks of 64
// channels; a head's channels past D are zero-filled where they are staged
// or loaded (exact in every product, tensor_core.cuh), the scale 1/sqrt(D)
// of the true D. Routes, as in the forward: the wide kernels above 64
// channels (one head a block, below), the Wide instances at D 16, 32, 64
// (any G' the launcher is given), the head_dim-8 kernels (namespace d8) at
// D 8, the general staging at G' = 1 for the rest.
//
// The TPU kernel holds the (T, T) probs, dp and ds of one head in VMEM (about
// 10 MB at T=1024); a Hopper block has at most 227 KB of shared memory. So
// both versions below are the FlashAttention-2 split into two launches, a dq
// launch over query rows and a dk/dv launch over key rows, each walking the
// other side in tiles of 64 staged in shared memory. Neither uses atomics, so
// the result is deterministic. Head grouping (`heads_per_program` = G, the
// TPU kernel's G heads per grid program, attention.py:149-151, 158, 190-218)
// changes only which heads a block covers and stages the other side's rows
// of all G heads at once (in the (B, T, C) layout the G * D channels of one
// token are contiguous); each head's arithmetic is the G = 1 sequence, so dq,
// dk and dv are bit-identical for every G. G' (the heads a block runs) is
// instantiated where G' * Dp <= 64; the wrapper runs any G that divides the
// heads as G / G' consecutive groups of G' (`block_group`).
//
// Inputs besides q, k, v, do: the exact forward's output o (in the primal
// dtype) and each query row's base-2 log-sum-exp lse (f32), which
// `attention_fwd.cu` writes on request and `FusedAttention` saves; so each
// (i, j) pair takes two exponentials in all (one per launch).
//   1. dq (16 query rows per warp): delta_i = do_i . o_i from the saved
//      output, written to an f32 scratch; then per key tile
//      p = 2^(s * scale * log2(e) - lse_i), ds = p (dp - delta_i) scale,
//      dq += ds k. Keys past T are masked on the last tile only.
//   2. dk, dv (16 key rows per warp): per query tile (q, do, lse, delta
//      staged; past T lse = +inf, so p = 0, and delta = 0), the same p and
//      ds, transposed, then dv += p do and dk += ds q.
//
// bf16: the tensor-core kernels (the trainer's configuration).
//   Fragments: one warp owns 16 rows; `mma.sync` bf16 products with f32
//   accumulation. Dp/8 k-steps of m16n8k8 compute S = Q K^T and dP = dO V^T
//   (dq launch) or S^T = K Q^T and dP^T = V dO^T (dk/dv launch); m16n8k16
//   into Dp/8 n-tiles computes dQ += dS K, dV += P^T dO and dK += dS^T Q, the
//   k16 A fragment being two adjacent n8 accumulator fragments rounded to
//   bf16 in registers, as in FlashAttention-2. The B operands come from the
//   staged tiles (double-buffered, rows Bf16Tile<Dp>::kStride chunks apart)
//   by `ldmatrix` (`.trans` where the product needs the transposed layout).
//   Rounding points, as on the TPU where the tensor cores make it natural:
//   P is rounded to bf16 before dv and before ds is formed
//   (attention.py:168, 175-177); ds is rounded to bf16 before dq and dk
//   (:178-183), with the scale applied before that rounding, as there;
//   products accumulate in f32 and dq, dk, dv are rounded to bf16 once.
//   Deviations, each changing rounding only (`attention_bwd_kernel_order` in
//   ops/attention.py is this order in plain PyTorch): (1) P comes from the
//   forward's log-sum-exp in base 2 (log2(e) folded into the scale in f32,
//   the shift fused into one f32 fma, `ex2.approx.ftz.f32` with relative
//   error about 2^-22) instead of a normalised f32 softmax; (2) the row term
//   is FlashAttention-2's delta_i = do_i . o_i from the bf16 output, equal
//   to the TPU's rowsum(dp * P) in exact arithmetic; (3) ds is
//   P * fma(dp, scale, -delta * scale), where the TPU forms
//   P * (dp - row) * scale.
//   Occupancy: 4 warps per head and block; at most 128 registers a thread
//   at Dp 8 to 32, 255 at Dp 64 (dK and dV's accumulators grow with Dp).
//
// f32: the 3xTF32 tensor-core kernels (`train --no-bf16`).
//   The same split, inputs and launches as bf16 (o is the f32 output), with
//   every product accurate to f32: `mma.sync` m16n8k8 with TF32 operands,
//   each operand split into hi, its TF32 rounding to nearest (ties away), and
//   lo = x - hi, three products per step, lo.hi + hi.lo + hi.hi, the small
//   terms first (term by term over the Dp/8 k-steps of a product over
//   channels, `mma3_k`; `split_tf32` in tensor_core.cuh, as the f32 forward
//   does). All five products need the three: with any one of them at one or
//   two TF32 passes the gradients miss 5e-5 max|g| of the f32 reference 4-50
//   times at randn inputs (CPU model of this order). The warp's own rows'
//   operands (q and do in the dq launch, k in the dk/dv launch) are split once
//   in registers; v's split fragments and each thread's f32 totals live in
//   the thread's own shared-memory slots. The staged tiles of the other side
//   (k, v; q, do) come raw in f32, and the block splits each tile once into
//   hi and lo parts in shared memory (Tf32Tile: rows Dp + 4 words apart),
//   while the next raw tile streams in. P = 2^(s * scale * log2(e) - lse)
//   with `ex2.approx`, the shift one fma; delta = do . o in f32 from the
//   saved f32 output; dS = P (dP - delta); dq and dk are scaled by 1/sqrt(D)
//   at the store. Nothing is rounded below f32.
//   Fragments (m16n8k8 .tf32; g = lane / 4, t = lane % 4): A holds columns
//   t and t + 4, C columns 2t and 2t + 1, so a C fragment (S, dP; S^T, dP^T)
//   is not the A fragment of the next product as in bf16. As in the f32
//   forward, the k order of the next product is permuted instead: the C
//   fragment's columns 2t, 2t + 1 (rows 2t, 2t + 1 of the other side) become
//   the A fragment's columns t, t + 4 of dS (dQ += dS K), P^T (dV += P^T dO)
//   and dS^T (dK += dS^T Q), whose B fragments read those rows. The tensor
//   cores truncate their f32 sums, so each tile's dq (dk, dv) gathers in its
//   own accumulator (a chain of 24 products) and is added to the total in
//   f32. Past T, as in bf16.
//   Registers: at most 128 at Dp 8 and 16, 255 at Dp 32 and 64 (the split
//   fragments of the warp's own rows and the tile's accumulators grow with
//   Dp).
//   Per 16 rows x 8 keys a warp issues 9 Dp/8 TF32 products in the dq launch
//   and 12 Dp/8 in the dk/dv launch: the FA2 split without atomics recomputes
//   S and dP there, so 21 where the bound below counts 15, on `mma.sync`,
//   which does not reach the dense TF32 rate that `wgmma` does.
//   Deviation from the TPU kernel, rounding only
//   (`attention_bwd_tf32x3_kernel_order` in ops/attention.py is this order in
//   plain PyTorch): the products as above; P from the forward's base-2
//   log-sum-exp and delta from its f32 output, as in bf16; the scale last.
//
// Bound on the H100 at the training path's calls, B=16, T=1024, H*D = 256:
// the five T x T contractions are 10*B*H*T^2*D = 43 GFLOP at every D, 0.043
// ms in bf16 on the tensor cores (989 TFLOP/s) and 0.26 ms in f32 as three
// TF32 passes (494.7 TFLOP/s dense TF32); q, k, v, do read once and dq, dk,
// dv written once are 58.7 MB in bf16 (0.018 ms at 3.35 TB/s), twice that in
// f32. One pass of the B*H*T^2 recomputed exponentials takes 0.128 * (8 / D)
// ms on the special-function units (16 per clock per SM); the kernels take
// two passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wide.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// blocks per SM at G = 1 for a staged width Dp, which caps the registers a
// thread at 65536 / (128 * blocks): 128, or 255 where the accumulators and
// split fragments need them (Dp 8 runs here only at G = 1, for heads narrower
// than 8 or rows that are not 16-byte units)
__host__ __device__ constexpr int bf16_blocks(int dp) { return dp == 64 ? 2 : 4; }
__host__ __device__ constexpr int tf32_blocks(int dp) { return dp <= 16 ? 4 : 2; }

// Stage the lse and delta of query rows [r0, r0 + kTcTile) of G heads into
// lt[g * kTcTile + r] and dt[...]; past seq_len lse = +inf (so p = 0) and
// delta = 0.
template <int G>
__device__ __forceinline__ void stage_stats(float* lt, float* dt, const float* lseb,
                                            const float* deltab, int r0, int seq_len) {
  constexpr int kChunks = G * kTcTile;
  const bool second = threadIdx.x >= kChunks;
  const int c = second ? threadIdx.x - kChunks : threadIdx.x;
  const int64_t gh = c / kTcTile;
  const int row = r0 + c % kTcTile;
  float* dst = (second ? dt : lt) + c;
  if (row < seq_len) {
    cp_async4(dst, (second ? deltab : lseb) + gh * seq_len + row);
  } else {
    *dst = second ? 0.f : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (see the top of the file)
// ---------------------------------------------------------------------------

// One C fragment of S = X Y^T: one warp's 16 rows (X's A fragments xa over
// Dp/8 k-steps) against the 8 rows [row0, row0 + 8) of the staged tile yt
// (rows kS chunks apart), one half of a 16-row step at a time, so that S and
// dP of one half, not of the step, are live at once.
template <int Dp>
__device__ __forceinline__ void bf16_rows_product(const uint4* yt, int row0,
                                                  const uint32_t (*xa)[2], float* c) {
  constexpr int kS = Bf16Tile<Dp>::kStride;
  const int lane = threadIdx.x % 32;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    mma_k8(c, xa[j], ldsm_x1(yt + (row0 + lane % 8) * kS + j));
  }
}

// acc[n] += a Y for the 16 rows [16 s, 16 s + 16) of the staged tile yt, the
// k16 A fragment a over those rows, Dp/8 n-tiles of 8 channels
template <int Dp>
__device__ __forceinline__ void bf16_channels_product(const uint4* yt, int s, const uint32_t* a,
                                                      float (*acc)[4]) {
  constexpr int kS = Bf16Tile<Dp>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    uint32_t yT[2];
    ldsm_x2_trans(yT, yt + (s * 16 + lane % 16) * kS + n);
    mma_k16(acc[n], a, yT);
  }
}

// One staged key tile for one warp's 16 query rows: 16 keys a step, S and
// dP in two n8 halves, dS then dQ += dS K. Row a is the lane's row lane/4,
// row b the one 8 below; `dsa` and `dsb` are their delta * scale.
template <int Dp, bool Mask>
__device__ __forceinline__ void dq_tile(const uint4* kt, const uint4* vt,
                                        const uint32_t (*qa)[2], const uint32_t (*da)[2],
                                        float lsea, float lseb, float dsa, float dsb,
                                        float scale, float scale_log2, int keys,
                                        float (*acc)[4]) {
  const int tig = threadIdx.x % 4;
#pragma unroll (Dp == 8 ? 4 : 1)
  for (int s = 0; s < kTcTile / 16; ++s) {
    uint32_t ds[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float f[4], d[4];
      bf16_rows_product<Dp>(kt, s * 16 + c * 8, qa, f);   // S = Q K^T, 16 rows x 8 keys
      bf16_rows_product<Dp>(vt, s * 16 + c * 8, da, d);   // dP = dO V^T
      float p[4] = {ex2(fmaf(f[0], scale_log2, -lsea)), ex2(fmaf(f[1], scale_log2, -lsea)),
                    ex2(fmaf(f[2], scale_log2, -lseb)), ex2(fmaf(f[3], scale_log2, -lseb))};
      if (Mask) {
        const int key = s * 16 + c * 8 + 2 * tig;
        if (key >= keys) p[0] = p[2] = 0.f;
        if (key + 1 >= keys) p[1] = p[3] = 0.f;
      }
      const uint32_t pa = pack_bf16(p[0], p[1]);
      const uint32_t pb = pack_bf16(p[2], p[3]);
      ds[2 * c] = pack_bf16(lo_f32(pa) * fmaf(d[0], scale, -dsa),
                            hi_f32(pa) * fmaf(d[1], scale, -dsa));
      ds[2 * c + 1] = pack_bf16(lo_f32(pb) * fmaf(d[2], scale, -dsb),
                                hi_f32(pb) * fmaf(d[3], scale, -dsb));
    }
    bf16_channels_product<Dp>(kt, s, ds, acc);   // dQ += dS K
  }
}

// Launch 1 (bf16): dq, and each query row's delta = do . o.
template <int Dp, int G, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(bf16_blocks(Dp), G))
attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const bf16* __restrict__ o, const float* __restrict__ lse,
                           bf16* __restrict__ dq, float* __restrict__ delta, int heads,
                           int seq_len, int head_dim, Strides sq, Strides sk, Strides sv,
                           Strides sdo, Strides so, Strides sdq, int unit_k, int unit_v,
                           float scale, float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kS = Bf16Tile<Dp>::kStride;
  constexpr int kTile = G * kTcTile * kS;
  extern __shared__ uint4 bf16_tiles[];   // K [2][kTile], then V [2][kTile]
  uint4* k_tile = bf16_tiles;
  uint4* v_tile = bf16_tiles + 2 * kTile;

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

  // A fragments of q and do (rows a and b, channels 8j + 2 tig and +1), and
  // delta = do . o over the row's channels: 2 a k-step here, then the row's
  // 4 lanes
  const bf16* qh = q + b * sq.b + h * sq.h;
  const bf16* doh = dout + b * sdo.b + h * sdo.h;
  const bf16* oh = o + b * so.b + h * so.h;
  uint32_t qa[Dp / 8][2], da[Dp / 8][2];
  float dla = 0.f, dlb = 0.f;
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    qa[j][0] = load_pair(qh, sq, ra, c, oka, head_dim);
    qa[j][1] = load_pair(qh, sq, rb, c, okb, head_dim);
    da[j][0] = load_pair(doh, sdo, ra, c, oka, head_dim);
    da[j][1] = load_pair(doh, sdo, rb, c, okb, head_dim);
    const uint32_t oa = load_pair(oh, so, ra, c, oka, head_dim);
    const uint32_t ob = load_pair(oh, so, rb, c, okb, head_dim);
    dla = fmaf(hi_f32(da[j][0]), hi_f32(oa), fmaf(lo_f32(da[j][0]), lo_f32(oa), dla));
    dlb = fmaf(hi_f32(da[j][1]), hi_f32(ob), fmaf(lo_f32(da[j][1]), lo_f32(ob), dlb));
  }
#pragma unroll
  for (int m = 1; m < 4; m *= 2) {
    dla += __shfl_xor_sync(0xffffffffu, dla, m);
    dlb += __shfl_xor_sync(0xffffffffu, dlb, m);
  }
  const int64_t stat = (b * heads + h) * seq_len;
  const float lsea = oka ? lse[stat + ra] : 0.f;
  const float lseb = okb ? lse[stat + rb] : 0.f;
  if (tig == 0) {
    if (oka) delta[stat + ra] = dla;
    if (okb) delta[stat + rb] = dlb;
  }

  float acc[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* kb = k + b * sk.b + h0 * sk.h;
  const bf16* vb = v + b * sv.b + h0 * sv.h;
  // the second tensor's units from half way, so that at Dp 8 each thread
  // stages one row of one of the two
  const int second = (threadIdx.x + 16 * kTcWarps * G) % (32 * kTcWarps * G);
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage<bf16, Dp, G, kS, Wide>(k_tile, kb, sk, unit_k, 0, seq_len, head_dim, threadIdx.x);
  stage<bf16, Dp, G, kS, Wide>(v_tile, vb, sv, unit_v, 0, seq_len, head_dim, second);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {   // the next tile streams in while this one is used
      stage<bf16, Dp, G, kS, Wide>(k_tile + (buf ^ 1) * kTile, kb, sk, unit_k, (t + 1) * kTcTile,
                             seq_len, head_dim, threadIdx.x);
      stage<bf16, Dp, G, kS, Wide>(v_tile + (buf ^ 1) * kTile, vb, sv, unit_v, (t + 1) * kTcTile,
                             seq_len, head_dim, second);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* kt = k_tile + buf * kTile + g * kTcTile * kS;
    const uint4* vt = v_tile + buf * kTile + g * kTcTile * kS;
    const int keys = seq_len - t * kTcTile;
    if (keys >= kTcTile) {
      dq_tile<Dp, false>(kt, vt, qa, da, lsea, lseb, dla * scale, dlb * scale, scale,
                         scale_log2, keys, acc);
    } else {
      dq_tile<Dp, true>(kt, vt, qa, da, lsea, lseb, dla * scale, dlb * scale, scale,
                        scale_log2, keys, acc);
    }
    __syncthreads();       // every warp is done with buf before it is refilled
  }

  bf16* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) dqh[ra * sdq.t + c * sdq.d] = __float2bfloat16(acc[n][0]);
    if (oka && c + 1 < head_dim) dqh[ra * sdq.t + (c + 1) * sdq.d] = __float2bfloat16(acc[n][1]);
    if (okb && c < head_dim) dqh[rb * sdq.t + c * sdq.d] = __float2bfloat16(acc[n][2]);
    if (okb && c + 1 < head_dim) dqh[rb * sdq.t + (c + 1) * sdq.d] = __float2bfloat16(acc[n][3]);
  }
}

// Launch 2 (bf16): dk and dv. Each warp holds 16 key rows and walks the
// query tiles (q, do, lse, delta), 16 queries a step: S^T = K Q^T and
// dP^T = V dO^T land as the A fragments of dV += P^T dO and dK += dS^T Q.
template <int Dp, int G, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(bf16_blocks(Dp), G))
attention_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int heads, int seq_len, int head_dim,
                             Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                             Strides sdv, int unit_q, int unit_do, float scale,
                             float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kS = Bf16Tile<Dp>::kStride;
  constexpr int kTile = G * kTcTile * kS;
  constexpr int kStats = G * kTcTile;
  // Q [2][kTile], dO [2][kTile], then lse [2][kStats] and delta [2][kStats]
  extern __shared__ uint4 bf16_tiles[];
  uint4* q_tile = bf16_tiles;
  uint4* do_tile = bf16_tiles + 2 * kTile;
  float* l_tile = reinterpret_cast<float*>(bf16_tiles + 4 * kTile);
  float* d_tile = l_tile + 2 * kStats;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ja = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int jb = ja + 8;
  const bool oka = ja < seq_len;
  const bool okb = jb < seq_len;

  const bf16* kh = k + b * sk.b + h * sk.h;
  const bf16* vh = v + b * sv.b + h * sv.h;
  uint32_t ka[Dp / 8][2], va[Dp / 8][2];
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    ka[j][0] = load_pair(kh, sk, ja, c, oka, head_dim);
    ka[j][1] = load_pair(kh, sk, jb, c, okb, head_dim);
    va[j][0] = load_pair(vh, sv, ja, c, oka, head_dim);
    va[j][1] = load_pair(vh, sv, jb, c, okb, head_dim);
  }

  float dka[Dp / 8][4], dva[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const bf16* qb = q + b * sq.b + h0 * sq.h;
  const bf16* dob = dout + b * sdo.b + h0 * sdo.h;
  const float* lseb = lse + (b * heads + h0) * seq_len;   // G heads' rows follow
  const float* deltab = delta + (b * heads + h0) * seq_len;
  // the second tensor's units from half way, so that at Dp 8 each thread
  // stages one row of one of the two
  const int second = (threadIdx.x + 16 * kTcWarps * G) % (32 * kTcWarps * G);
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage<bf16, Dp, G, kS, Wide>(q_tile, qb, sq, unit_q, 0, seq_len, head_dim, threadIdx.x);
  stage<bf16, Dp, G, kS, Wide>(do_tile, dob, sdo, unit_do, 0, seq_len, head_dim, second);
  stage_stats<G>(l_tile, d_tile, lseb, deltab, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage<bf16, Dp, G, kS, Wide>(q_tile + (buf ^ 1) * kTile, qb, sq, unit_q, (t + 1) * kTcTile,
                             seq_len, head_dim, threadIdx.x);
      stage<bf16, Dp, G, kS, Wide>(do_tile + (buf ^ 1) * kTile, dob, sdo, unit_do,
                             (t + 1) * kTcTile, seq_len, head_dim, second);
      stage_stats<G>(l_tile + (buf ^ 1) * kStats, d_tile + (buf ^ 1) * kStats, lseb, deltab,
                     (t + 1) * kTcTile, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* qt = q_tile + buf * kTile + g * kTcTile * kS;
    const uint4* dt = do_tile + buf * kTile + g * kTcTile * kS;
    const float* lt = l_tile + buf * kStats + g * kTcTile;
    const float* dlt = d_tile + buf * kStats + g * kTcTile;
#pragma unroll (Dp == 8 ? 4 : 1)
    for (int s = 0; s < kTcTile / 16; ++s) {
      uint32_t pt[4], ds[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float f[4], d[4];
        bf16_rows_product<Dp>(qt, s * 16 + c * 8, ka, f);   // S^T = K Q^T, 16 keys x 8 queries
        bf16_rows_product<Dp>(dt, s * 16 + c * 8, va, d);   // dP^T = V dO^T
        const int col = s * 16 + c * 8 + 2 * tig;   // this lane's two queries
        const float2 l = *reinterpret_cast<const float2*>(lt + col);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
        const float dsx = dl.x * scale;
        const float dsy = dl.y * scale;
        pt[2 * c] = pack_bf16(ex2(fmaf(f[0], scale_log2, -l.x)),
                              ex2(fmaf(f[1], scale_log2, -l.y)));
        pt[2 * c + 1] = pack_bf16(ex2(fmaf(f[2], scale_log2, -l.x)),
                                  ex2(fmaf(f[3], scale_log2, -l.y)));
        ds[2 * c] = pack_bf16(lo_f32(pt[2 * c]) * fmaf(d[0], scale, -dsx),
                              hi_f32(pt[2 * c]) * fmaf(d[1], scale, -dsy));
        ds[2 * c + 1] = pack_bf16(lo_f32(pt[2 * c + 1]) * fmaf(d[2], scale, -dsx),
                                  hi_f32(pt[2 * c + 1]) * fmaf(d[3], scale, -dsy));
      }
      bf16_channels_product<Dp>(dt, s, pt, dva);   // dV += P^T dO
      bf16_channels_product<Dp>(qt, s, ds, dka);   // dK += dS^T Q
    }
    __syncthreads();
  }

  bf16* dkh = dk + b * sdk.b + h * sdk.h;
  bf16* dvh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int c = 8 * n + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? ja : jb;
      if (!(r == 0 ? oka : okb)) continue;
      if (c < head_dim) {
        dkh[row * sdk.t + c * sdk.d] = __float2bfloat16(dka[n][2 * r]);
        dvh[row * sdv.t + c * sdv.d] = __float2bfloat16(dva[n][2 * r]);
      }
      if (c + 1 < head_dim) {
        dkh[row * sdk.t + (c + 1) * sdk.d] = __float2bfloat16(dka[n][2 * r + 1]);
        dvh[row * sdv.t + (c + 1) * sdv.d] = __float2bfloat16(dva[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 tensor-core kernels (see the top of the file)
// ---------------------------------------------------------------------------

// This lane's word offsets in a head's TF32 part (Tf32Tile<Dp>, rows kWords
// apart) for the 8-row slice 0 and channel block 0 (slice s adds
// 8 s kWords, channel block j adds 8 j): t0, row g at channel t (and t + 4 at
// t0 + 4), a B fragment of the tile transposed (k = channel, n = row: S =
// Q K^T and dP = dO V^T, S^T and dP^T); r0, row 2t at channel g (and row
// 2t + 1 at r0 + kWords), a B fragment of the tile as it is (k = row in the
// order a C fragment holds it, n = channel: dQ += dS K, dV += P^T dO,
// dK += dS^T Q). Both read 32 banks.
template <int Dp>
struct BwdLane {
  int t0, r0;
  __device__ __forceinline__ BwdLane() {
    const int lane = threadIdx.x % 32;
    t0 = (lane / 4) * Tf32Tile<Dp>::kWords + lane % 4;
    r0 = 2 * (lane % 4) * Tf32Tile<Dp>::kWords + lane / 4;
  }
};

// The split A fragment of a 16 x 8 operand that a C fragment c holds: c's
// columns 2 tig and 2 tig + 1 are the operand's columns tig and tig + 4 (the
// permuted k order), so a = {c[0], c[2], c[1], c[3]}.
__device__ __forceinline__ void split_as_a(const float* c, uint32_t* hi, uint32_t* lo) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// Four words from shared memory at every call (volatile: the compiler may
// not keep them in registers across a loop instead)
__device__ __forceinline__ void lds128(uint32_t* r, const uint4* p) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// Add a tile's accumulator (a C fragment) into this lane's f32 total, kept
// in shared memory (its own slot: no other thread reads it), so that a
// tile's accumulator and the total do not both hold registers
__device__ __forceinline__ void add_to_total(float4* total, const float* part) {
  float4 t = *total;
  t.x = __fadd_rn(t.x, part[0]);
  t.y = __fadd_rn(t.y, part[1]);
  t.z = __fadd_rn(t.z, part[2]);
  t.w = __fadd_rn(t.w, part[3]);
  *total = t;
}

// One staged key tile (K and V hi and lo parts) for one warp's 16 query
// rows, 8 keys a step: S and dP, then dS = P (dP - delta) with
// P = 2^(S * scale * log2(e) - lse) (nla, nlb: -lse of rows a and b), then
// dQ += dS K into Dp/8 n-tiles. The tile's dQ gathers in its own accumulator,
// added to the total (n-tile n at total[n * kThreads]) in f32: the tensor
// cores' f32 sums truncate, so a chain of 24 products, not one of every
// key's, carries that error. Keys at or past `keys` get dS = 0.
template <int Dp, int kThreads, bool Mask>
__device__ __forceinline__ void dq_tile_tf32(const uint32_t* kh, const uint32_t* kl,
                                             const uint32_t* vh, const uint32_t* vl,
                                             const BwdLane<Dp>& ln, const uint32_t (*qhi)[4],
                                             const uint32_t (*qlo)[4], const uint32_t (*dhi)[4],
                                             const uint32_t (*dlo)[4], float nla, float nlb,
                                             float dla, float dlb, float scale_log2, int keys,
                                             float4* total) {
  constexpr int kW = Tf32Tile<Dp>::kWords;
  const int tig = threadIdx.x % 4;
  float part[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll (Dp == 8 ? 4 : 1)
  for (int s = 0; s < kTcTile / 8; ++s) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    mma3_k<Dp / 8>(c, qhi, qlo, kh, kl, ln.t0 + 8 * s * kW);    // S = Q K^T
    mma3_k<Dp / 8>(dp, dhi, dlo, vh, vl, ln.t0 + 8 * s * kW);   // dP = dO V^T
    // c[0], c[2] hold key 8 s + 2 tig, c[1], c[3] key 8 s + 2 tig + 1
    float ds[4] = {__fmul_rn(ex2(fmaf(c[0], scale_log2, nla)), __fsub_rn(dp[0], dla)),
                   __fmul_rn(ex2(fmaf(c[1], scale_log2, nla)), __fsub_rn(dp[1], dla)),
                   __fmul_rn(ex2(fmaf(c[2], scale_log2, nlb)), __fsub_rn(dp[2], dlb)),
                   __fmul_rn(ex2(fmaf(c[3], scale_log2, nlb)), __fsub_rn(dp[3], dlb))};
    if (Mask) {
      if (8 * s + 2 * tig >= keys) ds[0] = ds[2] = 0.f;
      if (8 * s + 2 * tig + 1 >= keys) ds[1] = ds[3] = 0.f;
    }
    uint32_t hi[4], lo[4];
    split_as_a(ds, hi, lo);
    const int o = ln.r0 + 8 * s * kW;
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
      mma3(part[n], hi, lo, kh, kl, o + 8 * n, o + 8 * n + kW);   // dQ += dS K
    }
  }
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) add_to_total(total + n * kThreads, part[n]);
}

// Launch 1 (f32): dq, and each query row's delta = do . o.
template <int Dp, int G, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(tf32_blocks(Dp), G))
attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ o, const float* __restrict__ lse,
                             float* __restrict__ dq, float* __restrict__ delta, int heads,
                             int seq_len, int head_dim, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides so, Strides sdq, int unit_k, int unit_v,
                             float scale, float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kRawTile = G * kTcTile * Tf32Tile<Dp>::kRaw;   // 16-byte chunks
  constexpr int kPart = G * kTcTile * Tf32Tile<Dp>::kWords;    // words per part
  constexpr int kThreads = 32 * kTcWarps * G;
  // G heads' raw K tile, their raw V tile, the K hi, K lo, V hi and V lo
  // parts of the tile the warps work on, then each thread's dq totals (Dp/8
  // n-tiles, kThreads apart)
  extern __shared__ float4 tf32_tiles[];
  uint4* k_raw = reinterpret_cast<uint4*>(tf32_tiles);
  uint4* v_raw = k_raw + kRawTile;
  uint32_t* parts = reinterpret_cast<uint32_t*>(v_raw + kRawTile);
  float4* total = reinterpret_cast<float4*>(parts + 4 * kPart) + threadIdx.x;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) total[n * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);

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

  // A fragments of q and do, split into TF32 hi and lo parts once, and
  // delta = do . o in f32 from the saved output: channels 8j + tig and
  // 8j + tig + 4 of each k-step here, then over the row's 4 lanes
  uint32_t qhi[Dp / 8][4], qlo[Dp / 8][4], dhi[Dp / 8][4], dlo[Dp / 8][4];
  float dla = 0.f, dlb = 0.f;
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    float x[4], ox[4];
    load_a(q + b * sq.b + h * sq.h, sq, ra, oka, okb, j, head_dim, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], qhi[j][i], qlo[j][i]);
    load_a(dout + b * sdo.b + h * sdo.h, sdo, ra, oka, okb, j, head_dim, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], dhi[j][i], dlo[j][i]);
    load_a(o + b * so.b + h * so.h, so, ra, oka, okb, j, head_dim, ox);
    dla = fmaf(x[2], ox[2], fmaf(x[0], ox[0], dla));
    dlb = fmaf(x[3], ox[3], fmaf(x[1], ox[1], dlb));
  }
#pragma unroll
  for (int m = 1; m < 4; m *= 2) {
    dla = __fadd_rn(dla, __shfl_xor_sync(0xffffffffu, dla, m));
    dlb = __fadd_rn(dlb, __shfl_xor_sync(0xffffffffu, dlb, m));
  }
  const int64_t stat = (b * heads + h) * seq_len;
  const float nla = oka ? -lse[stat + ra] : 0.f;
  const float nlb = okb ? -lse[stat + rb] : 0.f;
  if (tig == 0) {
    if (oka) delta[stat + ra] = dla;
    if (okb) delta[stat + rb] = dlb;
  }

  const BwdLane<Dp> lane_reads;
  const float* kb = k + b * sk.b + h0 * sk.h;
  const float* vb = v + b * sv.b + h0 * sv.h;
  constexpr int kRawStride = Tf32Tile<Dp>::kRaw;
  // the second tensor's units from half way, so that at Dp 8 each thread
  // stages one row of one of the two
  const int second = (threadIdx.x + 16 * kTcWarps * G) % (32 * kTcWarps * G);
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage<float, Dp, G, kRawStride, Wide>(k_raw, kb, sk, unit_k, 0, seq_len, head_dim, threadIdx.x);
  stage<float, Dp, G, kRawStride, Wide>(v_raw, vb, sv, unit_v, 0, seq_len, head_dim, second);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    // the raw tile has landed for every thread, and every warp is done with
    // the previous tile's parts
    __syncthreads();
    split_tile<Dp, G>(reinterpret_cast<const float4*>(k_raw), reinterpret_cast<float4*>(parts),
                      reinterpret_cast<float4*>(parts + kPart));
    split_tile<Dp, G>(reinterpret_cast<const float4*>(v_raw),
                      reinterpret_cast<float4*>(parts + 2 * kPart),
                      reinterpret_cast<float4*>(parts + 3 * kPart));
    __syncthreads();
    if (t + 1 < tiles) {   // the next raw tile streams in while the parts are used
      stage<float, Dp, G, kRawStride, Wide>(k_raw, kb, sk, unit_k, (t + 1) * kTcTile, seq_len,
                                      head_dim, threadIdx.x);
      stage<float, Dp, G, kRawStride, Wide>(v_raw, vb, sv, unit_v, (t + 1) * kTcTile, seq_len,
                                      head_dim, second);
      cp_async_commit();
    }
    const uint32_t* head = parts + g * kTcTile * Tf32Tile<Dp>::kWords;
    const int keys = seq_len - t * kTcTile;
    if (keys >= kTcTile) {
      dq_tile_tf32<Dp, kThreads, false>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                        lane_reads, qhi, qlo, dhi, dlo, nla, nlb, dla, dlb,
                                        scale_log2, keys, total);
    } else {
      dq_tile_tf32<Dp, kThreads, true>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                       lane_reads, qhi, qlo, dhi, dlo, nla, nlb, dla, dlb,
                                       scale_log2, keys, total);
    }
  }

  float* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const float4 acc = total[n * kThreads];
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) dqh[ra * sdq.t + c * sdq.d] = __fmul_rn(acc.x, scale);
    if (oka && c + 1 < head_dim) dqh[ra * sdq.t + (c + 1) * sdq.d] = __fmul_rn(acc.y, scale);
    if (okb && c < head_dim) dqh[rb * sdq.t + c * sdq.d] = __fmul_rn(acc.z, scale);
    if (okb && c + 1 < head_dim) dqh[rb * sdq.t + (c + 1) * sdq.d] = __fmul_rn(acc.w, scale);
  }
}

// One staged query tile (Q and dO hi and lo parts, and the (-lse, delta)
// pairs of its queries: this lane's two queries of step s, 8 s + 2 tig and
// 8 s + 2 tig + 1, are the float4 stats[4 s + tig]) for one warp's 16 key
// rows, 8 queries a step: S^T, P^T, dV += P^T dO, dP^T,
// dS^T = P^T (dP^T - delta), dK += dS^T Q, the tile's dV and dK each in
// their own accumulators (Dp/8 n-tiles), added to the totals (as in
// dq_tile_tf32). v's split A fragment of k-step j comes from this thread's
// slots vfrag[2 j kThreads] (hi) and vfrag[(2 j + 1) kThreads] (lo) at each
// step, which keeps it out of the registers. Queries past T have lse = +inf
// (P = 0) and delta = 0.
template <int Dp, int kThreads>
__device__ __forceinline__ void dkdv_tile_tf32(const uint32_t* qh, const uint32_t* ql,
                                               const uint32_t* dh, const uint32_t* dl,
                                               const float4* stats, const BwdLane<Dp>& ln,
                                               const uint32_t (*khi)[4],
                                               const uint32_t (*klo)[4], const uint4* vfrag,
                                               float scale_log2, float4* dk_total,
                                               float4* dv_total) {
  constexpr int kW = Tf32Tile<Dp>::kWords;
  const int tig = threadIdx.x % 4;
  float pk[Dp / 8][4], pv[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    pk[n][0] = pk[n][1] = pk[n][2] = pk[n][3] = 0.f;
    pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
  }
#pragma unroll (Dp == 8 ? 4 : 1)
  for (int s = 0; s < kTcTile / 8; ++s) {
    const int ot = ln.t0 + 8 * s * kW;
    const int orow = ln.r0 + 8 * s * kW;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma3_k<Dp / 8>(c, khi, klo, qh, ql, ot);   // S^T = K Q^T
    // -lse and delta of c[0], c[2]'s query (x, y) and of c[1], c[3]'s (z, w)
    const float4 st = stats[4 * s + tig];
    float p[4] = {ex2(fmaf(c[0], scale_log2, st.x)), ex2(fmaf(c[1], scale_log2, st.z)),
                  ex2(fmaf(c[2], scale_log2, st.x)), ex2(fmaf(c[3], scale_log2, st.z))};
    uint32_t hi[4], lo[4];
    split_as_a(p, hi, lo);
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
      mma3(pv[n], hi, lo, dh, dl, orow + 8 * n, orow + 8 * n + kW);   // dV += P^T dO
    }
    // dP^T = V dO^T, term by term over the k-steps (lo.hi, hi.lo, hi.hi),
    // v's parts read from the slots where they are needed
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (Dp == 8) {
      uint32_t vhi[4], vlo[4];
      lds128(vhi, vfrag);
      lds128(vlo, vfrag + kThreads);
      mma3(dp, vhi, vlo, dh, dl, ot, ot + 4);
    } else {
#pragma unroll
      for (int term = 0; term < 3; ++term) {
#pragma unroll
        for (int j = 0; j < Dp / 8; ++j) {
          uint32_t va[4];
          lds128(va, vfrag + (2 * j + (term == 0 ? 1 : 0)) * kThreads);
          const uint32_t* bp = term == 1 ? dl : dh;
          const uint32_t bb[2] = {bp[ot + 8 * j], bp[ot + 8 * j + 4]};
          mma_tf32(dp, va, bb);
        }
      }
    }
    p[0] = __fmul_rn(p[0], __fsub_rn(dp[0], st.y));
    p[1] = __fmul_rn(p[1], __fsub_rn(dp[1], st.w));
    p[2] = __fmul_rn(p[2], __fsub_rn(dp[2], st.y));
    p[3] = __fmul_rn(p[3], __fsub_rn(dp[3], st.w));
    split_as_a(p, hi, lo);
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
      mma3(pk[n], hi, lo, qh, ql, orow + 8 * n, orow + 8 * n + kW);   // dK += dS^T Q
    }
  }
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    add_to_total(dk_total + n * kThreads, pk[n]);
    add_to_total(dv_total + n * kThreads, pv[n]);
  }
}

// Launch 2 (f32): dk and dv. Each warp holds 16 key rows (k split in
// registers, v in shared memory) and walks the query tiles (q, do, lse,
// delta).
template <int Dp, int G, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(tf32_blocks(Dp), G))
attention_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, int heads, int seq_len, int head_dim,
                               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                               Strides sdv, int unit_q, int unit_do, float scale,
                               float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kRawTile = G * kTcTile * Tf32Tile<Dp>::kRaw;
  constexpr int kPart = G * kTcTile * Tf32Tile<Dp>::kWords;
  constexpr int kStats = G * kTcTile;
  constexpr int kThreads = 32 * kTcWarps * G;
  constexpr int kNT = Dp / 8;
  // G heads' raw Q and dO tiles, the Q hi, Q lo, dO hi and dO lo parts of
  // the tile the warps work on; each thread's dk and dv totals and v's split
  // A fragments (Dp/8 n-tiles or k-steps, kThreads apart); then the current
  // tile's (-lse, delta) pairs and the staged lse and delta
  extern __shared__ float4 tf32_tiles[];
  uint4* q_raw = reinterpret_cast<uint4*>(tf32_tiles);
  uint4* do_raw = q_raw + kRawTile;
  uint32_t* parts = reinterpret_cast<uint32_t*>(do_raw + kRawTile);
  float4* dk_total = reinterpret_cast<float4*>(parts + 4 * kPart) + threadIdx.x;
  float4* dv_total = dk_total + kNT * kThreads;
  uint4* vfrag = reinterpret_cast<uint4*>(dv_total + kNT * kThreads);
  float2* cur = reinterpret_cast<float2*>(reinterpret_cast<float4*>(parts + 4 * kPart)
                                          + 4 * kNT * kThreads);
  float* l_raw = reinterpret_cast<float*>(cur + kStats);
  float* d_raw = l_raw + kStats;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    dk_total[n * kThreads] = dv_total[n * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ja = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int jb = ja + 8;
  const bool oka = ja < seq_len;
  const bool okb = jb < seq_len;

  // A fragments of k and v, split into TF32 hi and lo parts once; v's go to
  // this thread's slots
  uint32_t khi[kNT][4], klo[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    float x[4];
    load_a(k + b * sk.b + h * sk.h, sk, ja, oka, okb, j, head_dim, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], khi[j][i], klo[j][i]);
    load_a(v + b * sv.b + h * sv.h, sv, ja, oka, okb, j, head_dim, x);
    uint4 vh, vl;
    split_tf32(x[0], vh.x, vl.x);
    split_tf32(x[1], vh.y, vl.y);
    split_tf32(x[2], vh.z, vl.z);
    split_tf32(x[3], vh.w, vl.w);
    vfrag[2 * j * kThreads] = vh;
    vfrag[(2 * j + 1) * kThreads] = vl;
  }

  const BwdLane<Dp> lane_reads;
  const float* qb = q + b * sq.b + h0 * sq.h;
  const float* dob = dout + b * sdo.b + h0 * sdo.h;
  const float* lseb = lse + (b * heads + h0) * seq_len;   // G heads' rows follow
  const float* deltab = delta + (b * heads + h0) * seq_len;
  constexpr int kRawStride = Tf32Tile<Dp>::kRaw;
  // the second tensor's units from half way, so that at Dp 8 each thread
  // stages one row of one of the two
  const int second = (threadIdx.x + 16 * kTcWarps * G) % (32 * kTcWarps * G);
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage<float, Dp, G, kRawStride, Wide>(q_raw, qb, sq, unit_q, 0, seq_len, head_dim, threadIdx.x);
  stage<float, Dp, G, kRawStride, Wide>(do_raw, dob, sdo, unit_do, 0, seq_len, head_dim, second);
  stage_stats<G>(l_raw, d_raw, lseb, deltab, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    split_tile<Dp, G>(reinterpret_cast<const float4*>(q_raw), reinterpret_cast<float4*>(parts),
                      reinterpret_cast<float4*>(parts + kPart));
    split_tile<Dp, G>(reinterpret_cast<const float4*>(do_raw),
                      reinterpret_cast<float4*>(parts + 2 * kPart),
                      reinterpret_cast<float4*>(parts + 3 * kPart));
    // one of the tile's 2 kStats statistics per thread, as (-lse, delta)
    // pairs in query order
    {
      const int c = threadIdx.x < kStats ? threadIdx.x : threadIdx.x - kStats;
      float* pair = reinterpret_cast<float*>(cur + c);
      if (threadIdx.x < kStats) {
        pair[0] = -l_raw[c];
      } else {
        pair[1] = d_raw[c];
      }
    }
    __syncthreads();
    if (t + 1 < tiles) {   // the next raw tile streams in while the parts are used
      stage<float, Dp, G, kRawStride, Wide>(q_raw, qb, sq, unit_q, (t + 1) * kTcTile, seq_len,
                                      head_dim, threadIdx.x);
      stage<float, Dp, G, kRawStride, Wide>(do_raw, dob, sdo, unit_do, (t + 1) * kTcTile, seq_len,
                                      head_dim, second);
      stage_stats<G>(l_raw, d_raw, lseb, deltab, (t + 1) * kTcTile, seq_len);
      cp_async_commit();
    }
    const uint32_t* head = parts + g * kTcTile * Tf32Tile<Dp>::kWords;
    dkdv_tile_tf32<Dp, kThreads>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                 reinterpret_cast<const float4*>(cur + g * kTcTile), lane_reads,
                                 khi, klo, vfrag, scale_log2, dk_total, dv_total);
  }

  float* dkh = dk + b * sdk.b + h * sdk.h;
  float* dvh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float4 dka = dk_total[n * kThreads];
    const float4 dva = dv_total[n * kThreads];
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) {
      dkh[ja * sdk.t + c * sdk.d] = __fmul_rn(dka.x, scale);
      dvh[ja * sdv.t + c * sdv.d] = dva.x;
    }
    if (oka && c + 1 < head_dim) {
      dkh[ja * sdk.t + (c + 1) * sdk.d] = __fmul_rn(dka.y, scale);
      dvh[ja * sdv.t + (c + 1) * sdv.d] = dva.y;
    }
    if (okb && c < head_dim) {
      dkh[jb * sdk.t + c * sdk.d] = __fmul_rn(dka.z, scale);
      dvh[jb * sdv.t + c * sdv.d] = dva.z;
    }
    if (okb && c + 1 < head_dim) {
      dkh[jb * sdk.t + (c + 1) * sdk.d] = __fmul_rn(dka.w, scale);
      dvh[jb * sdv.t + (c + 1) * sdv.d] = dva.w;
    }
  }
}

// ---------------------------------------------------------------------------
// head_dim 8 at full width: the head_dim-8 kernels (namespace d8)
// ---------------------------------------------------------------------------
//
// A call at head_dim 8 whose staged rows go in 16-byte units (every dense
// and (B, T, C) layout) runs these, the head_dim-8 kernels the templates
// above were grown from, unchanged: at Dp 8 the templates ran 5-12% slower
// and spilled at the 64 registers a thread that G = 8 (1024 threads a
// block) allows. The arithmetic is the templates' at Dp 8 (one k-step, one
// n-tile); the f32 tiles keep their chunk swap instead of the padded rows.
namespace d8 {

// blocks per SM at G = 1 (G heads per block: 1/G of them), so that 32 warps
// per SM hide the special-function units' latency; it caps registers at 64
constexpr int kTcBlocksPerSM = 8;

// ---------------------------------------------------------------------------
// bf16, D = 8: the tensor-core kernels (see the top of the file)
// ---------------------------------------------------------------------------

// One staged key tile for one warp's 16 query rows: 16 keys a step, S and
// dP in two n8 halves, dS then dQ += dS K. Row a is the lane's row lane/4,
// row b the one 8 below; `dsa` and `dsb` are their delta * scale.
template <bool Mask>
__device__ __forceinline__ void dq_tile(const uint4* kt, const uint4* vt,
                                        const uint32_t* qa, const uint32_t* da,
                                        float lsea, float lseb, float dsa, float dsb,
                                        float scale, float scale_log2, int keys,
                                        float* acc) {
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
#pragma unroll
  for (int s = 0; s < kTcTile / 16; ++s) {
    uint32_t kb[2], vb[2], kT[2], ds[4];
    ldsm_x2(kb, kt + s * 16 + lane % 16);
    ldsm_x2(vb, vt + s * 16 + lane % 16);
    ldsm_x2_trans(kT, kt + s * 16 + lane % 16);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k8(sc, qa, kb[c]);   // S = Q K^T, 16 rows x 8 keys
      mma_k8(dp, da, vb[c]);   // dP = dO V^T
      float p[4] = {ex2(fmaf(sc[0], scale_log2, -lsea)), ex2(fmaf(sc[1], scale_log2, -lsea)),
                    ex2(fmaf(sc[2], scale_log2, -lseb)), ex2(fmaf(sc[3], scale_log2, -lseb))};
      if (Mask) {
        const int key = s * 16 + c * 8 + 2 * tig;
        if (key >= keys) p[0] = p[2] = 0.f;
        if (key + 1 >= keys) p[1] = p[3] = 0.f;
      }
      const uint32_t pa = pack_bf16(p[0], p[1]);
      const uint32_t pb = pack_bf16(p[2], p[3]);
      ds[2 * c] = pack_bf16(lo_f32(pa) * fmaf(dp[0], scale, -dsa),
                            hi_f32(pa) * fmaf(dp[1], scale, -dsa));
      ds[2 * c + 1] = pack_bf16(lo_f32(pb) * fmaf(dp[2], scale, -dsb),
                                hi_f32(pb) * fmaf(dp[3], scale, -dsb));
    }
    mma_k16(acc, ds, kT);      // dQ += dS K
  }
}

// Launch 1 (bf16, D = 8): dq, and each query row's delta = do . o.
template <int G>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_bwd_dq_tc_d8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const bf16* __restrict__ o, const float* __restrict__ lse,
                           bf16* __restrict__ dq, float* __restrict__ delta, int heads,
                           int seq_len, Strides sq, Strides sk, Strides sv, Strides sdo,
                           Strides so, Strides sdq, float scale, float scale_log2) {
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

  // A fragments of q and do (rows a and b, channels 2 tig and +1), and o
  const bf16* qh = q + b * sq.b + h * sq.h;
  const bf16* doh = dout + b * sdo.b + h * sdo.h;
  const bf16* oh = o + b * so.b + h * so.h;
  const uint32_t qa[2] = {load_pair(qh, sq, ra, 2 * tig, oka), load_pair(qh, sq, rb, 2 * tig, okb)};
  const uint32_t da[2] = {load_pair(doh, sdo, ra, 2 * tig, oka),
                          load_pair(doh, sdo, rb, 2 * tig, okb)};
  const uint32_t oa[2] = {load_pair(oh, so, ra, 2 * tig, oka), load_pair(oh, so, rb, 2 * tig, okb)};

  // delta = do . o over the row's 8 channels: 2 here, then the row's 4 lanes
  float dla = fmaf(hi_f32(da[0]), hi_f32(oa[0]), lo_f32(da[0]) * lo_f32(oa[0]));
  float dlb = fmaf(hi_f32(da[1]), hi_f32(oa[1]), lo_f32(da[1]) * lo_f32(oa[1]));
#pragma unroll
  for (int m = 1; m < 4; m *= 2) {
    dla += __shfl_xor_sync(0xffffffffu, dla, m);
    dlb += __shfl_xor_sync(0xffffffffu, dlb, m);
  }
  const int64_t stat = (b * heads + h) * seq_len;
  const float lsea = oka ? lse[stat + ra] : 0.f;
  const float lseb = okb ? lse[stat + rb] : 0.f;
  if (tig == 0) {
    if (oka) delta[stat + ra] = dla;
    if (okb) delta[stat + rb] = dlb;
  }

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
      dq_tile<false>(&k_tile[buf][g * kTcTile], &v_tile[buf][g * kTcTile], qa, da, lsea,
                     lseb, dla * scale, dlb * scale, scale, scale_log2, keys, acc);
    } else {
      dq_tile<true>(&k_tile[buf][g * kTcTile], &v_tile[buf][g * kTcTile], qa, da, lsea,
                    lseb, dla * scale, dlb * scale, scale, scale_log2, keys, acc);
    }
    __syncthreads();       // every warp is done with buf before it is refilled
  }

  bf16* dqh = dq + b * sdq.b + h * sdq.h;
  if (oka) {
    dqh[ra * sdq.t + 2 * tig * sdq.d] = __float2bfloat16(acc[0]);
    dqh[ra * sdq.t + (2 * tig + 1) * sdq.d] = __float2bfloat16(acc[1]);
  }
  if (okb) {
    dqh[rb * sdq.t + 2 * tig * sdq.d] = __float2bfloat16(acc[2]);
    dqh[rb * sdq.t + (2 * tig + 1) * sdq.d] = __float2bfloat16(acc[3]);
  }
}

// Launch 2 (bf16, D = 8): dk and dv. Each warp holds 16 key rows and walks
// the query tiles (q, do, lse, delta), 16 queries a step: S^T = K Q^T and
// dP^T = V dO^T land as the A fragments of dV += P^T dO and dK += dS^T Q.
template <int G>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_bwd_dkdv_tc_d8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int heads, int seq_len, Strides sq,
                             Strides sk, Strides sv, Strides sdo, Strides sdk,
                             Strides sdv, float scale, float scale_log2) {
  __shared__ uint4 q_tile[2][G * kTcTile];
  __shared__ uint4 do_tile[2][G * kTcTile];
  __shared__ __align__(8) float l_tile[2][G * kTcTile];
  __shared__ __align__(8) float d_tile[2][G * kTcTile];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ja = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int jb = ja + 8;
  const bool oka = ja < seq_len;
  const bool okb = jb < seq_len;

  const bf16* kh = k + b * sk.b + h * sk.h;
  const bf16* vh = v + b * sv.b + h * sv.h;
  const uint32_t ka[2] = {load_pair(kh, sk, ja, 2 * tig, oka), load_pair(kh, sk, jb, 2 * tig, okb)};
  const uint32_t va[2] = {load_pair(vh, sv, ja, 2 * tig, oka), load_pair(vh, sv, jb, 2 * tig, okb)};

  float dka[4] = {0.f, 0.f, 0.f, 0.f};
  float dva[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* qb = q + b * sq.b + h0 * sq.h;
  const bf16* dob = dout + b * sdo.b + h0 * sdo.h;
  const float* lseb = lse + (b * heads + h0) * seq_len;   // G heads' rows follow
  const float* deltab = delta + (b * heads + h0) * seq_len;
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage_rows<G>(q_tile[0], do_tile[0], qb, dob, sq, sdo, 0, seq_len);
  stage_stats<G>(l_tile[0], d_tile[0], lseb, deltab, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_rows<G>(q_tile[buf ^ 1], do_tile[buf ^ 1], qb, dob, sq, sdo, (t + 1) * kTcTile,
                    seq_len);
      stage_stats<G>(l_tile[buf ^ 1], d_tile[buf ^ 1], lseb, deltab, (t + 1) * kTcTile,
                     seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* qt = &q_tile[buf][g * kTcTile];
    const uint4* dt = &do_tile[buf][g * kTcTile];
    const float* lt = &l_tile[buf][g * kTcTile];
    const float* dlt = &d_tile[buf][g * kTcTile];
#pragma unroll
    for (int s = 0; s < kTcTile / 16; ++s) {
      uint32_t qb2[2], db2[2], qT[2], dT[2], pt[4], ds[4];
      ldsm_x2(qb2, qt + s * 16 + lane % 16);
      ldsm_x2(db2, dt + s * 16 + lane % 16);
      ldsm_x2_trans(qT, qt + s * 16 + lane % 16);
      ldsm_x2_trans(dT, dt + s * 16 + lane % 16);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        float dpt[4] = {0.f, 0.f, 0.f, 0.f};
        mma_k8(st, ka, qb2[c]);    // S^T = K Q^T, 16 keys x 8 queries
        mma_k8(dpt, va, db2[c]);   // dP^T = V dO^T
        const int col = s * 16 + c * 8 + 2 * tig;   // this lane's two queries
        const float2 l = *reinterpret_cast<const float2*>(lt + col);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
        const float dsx = dl.x * scale;
        const float dsy = dl.y * scale;
        pt[2 * c] = pack_bf16(ex2(fmaf(st[0], scale_log2, -l.x)),
                              ex2(fmaf(st[1], scale_log2, -l.y)));
        pt[2 * c + 1] = pack_bf16(ex2(fmaf(st[2], scale_log2, -l.x)),
                                  ex2(fmaf(st[3], scale_log2, -l.y)));
        ds[2 * c] = pack_bf16(lo_f32(pt[2 * c]) * fmaf(dpt[0], scale, -dsx),
                              hi_f32(pt[2 * c]) * fmaf(dpt[1], scale, -dsy));
        ds[2 * c + 1] = pack_bf16(lo_f32(pt[2 * c + 1]) * fmaf(dpt[2], scale, -dsx),
                                  hi_f32(pt[2 * c + 1]) * fmaf(dpt[3], scale, -dsy));
      }
      mma_k16(dva, pt, dT);   // dV += P^T dO
      mma_k16(dka, ds, qT);   // dK += dS^T Q
    }
    __syncthreads();
  }

  bf16* dkh = dk + b * sdk.b + h * sdk.h;
  bf16* dvh = dv + b * sdv.b + h * sdv.h;
  if (oka) {
    dkh[ja * sdk.t + 2 * tig * sdk.d] = __float2bfloat16(dka[0]);
    dkh[ja * sdk.t + (2 * tig + 1) * sdk.d] = __float2bfloat16(dka[1]);
    dvh[ja * sdv.t + 2 * tig * sdv.d] = __float2bfloat16(dva[0]);
    dvh[ja * sdv.t + (2 * tig + 1) * sdv.d] = __float2bfloat16(dva[1]);
  }
  if (okb) {
    dkh[jb * sdk.t + 2 * tig * sdk.d] = __float2bfloat16(dka[2]);
    dkh[jb * sdk.t + (2 * tig + 1) * sdk.d] = __float2bfloat16(dka[3]);
    dvh[jb * sdv.t + 2 * tig * sdv.d] = __float2bfloat16(dva[2]);
    dvh[jb * sdv.t + (2 * tig + 1) * sdv.d] = __float2bfloat16(dva[3]);
  }
}

template <int G>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const void* o, void* dq, void* dk, void* dv, const float* lse,
                      float* delta, int batch, int heads, int seq_len, const int64_t* st,
                      float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sdo{st[12], st[13], st[14], st[15]};
  const Strides sdq{st[16], st[17], st[18], st[19]};
  const Strides sdk{st[20], st[21], st[22], st[23]};
  const Strides sdv{st[24], st[25], st[26], st[27]};
  const Strides so{st[28], st[29], st[30], st[31]};
  if (!rows16<bf16>(q, sq) || !rows16<bf16>(k, sk) || !rows16<bf16>(v, sv)
      || !rows16<bf16>(dout, sdo)
      || o == nullptr || lse == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  const float scale_log2 = scale * kLog2e;
  attention_bwd_dq_tc_d8_kernel<G><<<grid, 32 * kTcWarps * G, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(o), lse, static_cast<bf16*>(dq), delta, heads, seq_len,
      sq, sk, sv, sdo, so, sdq, scale, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_tc_d8_kernel<G><<<grid, 32 * kTcWarps * G, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, seq_len, sq, sk, sv, sdo,
      sdk, sdv, scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_tc_group(int group, const void* q, const void* k, const void* v,
                            const void* dout, const void* o, void* dq, void* dk, void* dv,
                            const float* lse, float* delta, int batch, int heads,
                            int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch_tc<1>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 2: return launch_tc<2>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 4: return launch_tc<4>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 8: return launch_tc<8>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32, D = 8: the 3xTF32 tensor-core kernels (see the top of the file)
// ---------------------------------------------------------------------------

// This lane's reads of one staged f32 tile (both tensors staged with the
// chunk swap, stage_rows_f32<G, true>), as word offsets in the head's part
// for slice 0 (slice s adds 64 s). t0, t1: a B fragment of the tile
// transposed (k = channel, n = row), rows n ^ ((n >> 2) & 1) at channels tig
// and tig + 4 of column n = gid, for S = Q K^T and dP = dO V^T (S^T, dP^T).
// r0, r1: a B fragment of the tile as it is (k = row in the permuted order,
// n = channel), rows 2 tig + w and 2 tig + 1 - w (w = (tig >> 1) & 1) at
// channel gid, for dQ += dS K (dV += P^T dO, dK += dS^T Q). Both read 32
// banks.
struct BwdLane {
  int t0, t1, r0, r1;
  __device__ __forceinline__ BwdLane() {
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int sw = (gid >> 2) & 1;
    const int row = gid ^ sw;
    const int w = (tig >> 1) & 1;   // rows 4-7 (stored swapped) when w = 1
    t0 = row * 8 + 4 * sw + tig;
    t1 = row * 8 + 4 * (sw ^ 1) + tig;
    r0 = (2 * tig + w) * 8 + (gid ^ (4 * w));
    r1 = (2 * tig + 1 - w) * 8 + (gid ^ (4 * w));
  }
};

// x at rows ra and ra + 8 (zeros where not ok), channels tig and tig + 4:
// the values of an A fragment in its order
__device__ __forceinline__ void load_a(const float* xh, Strides s, int ra, bool oka, bool okb,
                                       float* x) {
  const int tig = threadIdx.x % 4;
  x[0] = oka ? xh[ra * s.t + tig * s.d] : 0.f;
  x[1] = okb ? xh[(ra + 8) * s.t + tig * s.d] : 0.f;
  x[2] = oka ? xh[ra * s.t + (tig + 4) * s.d] : 0.f;
  x[3] = okb ? xh[(ra + 8) * s.t + (tig + 4) * s.d] : 0.f;
}

// One staged key tile (K and V hi and lo parts) for one warp's 16 query
// rows, 8 keys a step: S and dP, then dS = P (dP - delta) with
// P = 2^(S * scale * log2(e) - lse) (nla, nlb: -lse of rows a and b), then
// dQ += dS K. The tile's dQ gathers in its own accumulator, added to the
// total in f32: the tensor cores' f32 sums truncate, so a chain of 24
// products, not one of every key's, carries that error. Keys at or past
// `keys` get dS = 0.
template <bool Mask>
__device__ __forceinline__ void dq_tile_tf32(const uint32_t* kh, const uint32_t* kl,
                                             const uint32_t* vh, const uint32_t* vl,
                                             const BwdLane& ln, const uint32_t* qhi,
                                             const uint32_t* qlo, const uint32_t* dhi,
                                             const uint32_t* dlo, float nla, float nlb,
                                             float dla, float dlb, float scale_log2, int keys,
                                             float4* total) {
  const int tig = threadIdx.x % 4;
  const int w = (tig >> 1) & 1;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = 0; s < kTcTile / 8; ++s) {
    const int o = 64 * s;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(c, qhi, qlo, kh, kl, ln.t0 + o, ln.t1 + o);    // S = Q K^T
    mma3(dp, dhi, dlo, vh, vl, ln.t0 + o, ln.t1 + o);   // dP = dO V^T
    // c[0], c[2] hold key 8 s + 2 tig + w, c[1], c[3] key 8 s + 2 tig + 1 - w
    float ds[4] = {__fmul_rn(ex2(fmaf(c[0], scale_log2, nla)), __fsub_rn(dp[0], dla)),
                   __fmul_rn(ex2(fmaf(c[1], scale_log2, nla)), __fsub_rn(dp[1], dla)),
                   __fmul_rn(ex2(fmaf(c[2], scale_log2, nlb)), __fsub_rn(dp[2], dlb)),
                   __fmul_rn(ex2(fmaf(c[3], scale_log2, nlb)), __fsub_rn(dp[3], dlb))};
    if (Mask) {
      if (8 * s + 2 * tig + w >= keys) ds[0] = ds[2] = 0.f;
      if (8 * s + 2 * tig + 1 - w >= keys) ds[1] = ds[3] = 0.f;
    }
    uint32_t hi[4], lo[4];
    split_as_a(ds, hi, lo);
    mma3(part, hi, lo, kh, kl, ln.r0 + o, ln.r1 + o);   // dQ += dS K
  }
  add_to_total(total, part);
}

// Launch 1 (f32, D = 8): dq, and each query row's delta = do . o.
template <int G>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_bwd_dq_tf32_d8_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ o, const float* __restrict__ lse,
                             float* __restrict__ dq, float* __restrict__ delta, int heads,
                             int seq_len, Strides sq, Strides sk, Strides sv, Strides sdo,
                             Strides so, Strides sdq, float scale, float scale_log2) {
  // two buffers of G heads' K tiles as staged, two of their V tiles, the
  // current tile's K hi, K lo, V hi and V lo parts, then each thread's dq
  // total
  extern __shared__ float4 tf32_tiles[];
  constexpr int kChunks = G * 2 * kTcTile;   // 16-byte chunks per tile of G heads
  float4* k_tile = tf32_tiles;
  float4* v_tile = tf32_tiles + 2 * kChunks;
  float4* parts = tf32_tiles + 4 * kChunks;
  float4* total = tf32_tiles + 8 * kChunks + threadIdx.x;
  *total = make_float4(0.f, 0.f, 0.f, 0.f);

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

  // A fragments of q and do, split into TF32 hi and lo parts once
  float x[4], ox[4];
  uint32_t qhi[4], qlo[4], dhi[4], dlo[4];
  load_a(q + b * sq.b + h * sq.h, sq, ra, oka, okb, x);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], qhi[i], qlo[i]);
  load_a(dout + b * sdo.b + h * sdo.h, sdo, ra, oka, okb, x);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], dhi[i], dlo[i]);

  // delta = do . o in f32 from the saved output: channels tig and tig + 4
  // here, then over the row's 4 lanes
  load_a(o + b * so.b + h * so.h, so, ra, oka, okb, ox);
  float dla = fmaf(x[2], ox[2], __fmul_rn(x[0], ox[0]));
  float dlb = fmaf(x[3], ox[3], __fmul_rn(x[1], ox[1]));
#pragma unroll
  for (int m = 1; m < 4; m *= 2) {
    dla = __fadd_rn(dla, __shfl_xor_sync(0xffffffffu, dla, m));
    dlb = __fadd_rn(dlb, __shfl_xor_sync(0xffffffffu, dlb, m));
  }
  const int64_t stat = (b * heads + h) * seq_len;
  const float nla = oka ? -lse[stat + ra] : 0.f;
  const float nlb = okb ? -lse[stat + rb] : 0.f;
  if (tig == 0) {
    if (oka) delta[stat + ra] = dla;
    if (okb) delta[stat + rb] = dlb;
  }

  const BwdLane lane_reads;
  const float* kb = k + b * sk.b + h0 * sk.h;
  const float* vb = v + b * sv.b + h0 * sv.h;
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage_rows_f32<G, true>(k_tile, v_tile, kb, vb, sk, sv, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {   // the next tile streams in while this one is used
      stage_rows_f32<G, true>(k_tile + (buf ^ 1) * kChunks, v_tile + (buf ^ 1) * kChunks,
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
      dq_tile_tf32<false>(head, head + kPart, head + 2 * kPart, head + 3 * kPart, lane_reads,
                          qhi, qlo, dhi, dlo, nla, nlb, dla, dlb, scale_log2, keys, total);
    } else {
      dq_tile_tf32<true>(head, head + kPart, head + 2 * kPart, head + 3 * kPart, lane_reads,
                         qhi, qlo, dhi, dlo, nla, nlb, dla, dlb, scale_log2, keys, total);
    }
  }

  const float4 acc = *total;
  float* dqh = dq + b * sdq.b + h * sdq.h;
  if (oka) {
    dqh[ra * sdq.t + 2 * tig * sdq.d] = __fmul_rn(acc.x, scale);
    dqh[ra * sdq.t + (2 * tig + 1) * sdq.d] = __fmul_rn(acc.y, scale);
  }
  if (okb) {
    dqh[rb * sdq.t + 2 * tig * sdq.d] = __fmul_rn(acc.z, scale);
    dqh[rb * sdq.t + (2 * tig + 1) * sdq.d] = __fmul_rn(acc.w, scale);
  }
}

// One staged query tile (Q and dO hi and lo parts, and (-lse, delta) of its
// queries, stored in the permuted order: this lane's two queries of step s,
// 8 s + 2 tig + w and 8 s + 2 tig + 1 - w, are the float4 stats[4 s + tig])
// for one warp's 16 key rows, 8 queries a step: S^T, P^T, dV += P^T dO,
// dP^T, dS^T = P^T (dP^T - delta), dK += dS^T Q, the tile's dV and dK each
// in its own accumulator, added to the totals (as in dq_tile_tf32). v's
// split A fragment comes from this thread's slots vfrag[0] (hi) and
// vfrag[kThreads] (lo) at each step, which keeps the loop within 64
// registers. Queries past T have lse = +inf (P = 0) and delta = 0.
template <int kThreads>
__device__ __forceinline__ void dkdv_tile_tf32(const uint32_t* qh, const uint32_t* ql,
                                               const uint32_t* dh, const uint32_t* dl,
                                               const float4* stats, const BwdLane& ln,
                                               const uint32_t* khi, const uint32_t* klo,
                                               const uint4* vfrag, float scale_log2,
                                               float4* dk_total, float4* dv_total) {
  const int tig = threadIdx.x % 4;
  float pk[4] = {0.f, 0.f, 0.f, 0.f};
  float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = 0; s < kTcTile / 8; ++s) {
    const int o = 64 * s;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(c, khi, klo, qh, ql, ln.t0 + o, ln.t1 + o);    // S^T = K Q^T
    // -lse and delta of c[0], c[2]'s query (x, y) and of c[1], c[3]'s (z, w)
    const float4 st = stats[4 * s + tig];
    float p[4] = {ex2(fmaf(c[0], scale_log2, st.x)), ex2(fmaf(c[1], scale_log2, st.z)),
                  ex2(fmaf(c[2], scale_log2, st.x)), ex2(fmaf(c[3], scale_log2, st.z))};
    uint32_t hi[4], lo[4];
    split_as_a(p, hi, lo);
    mma3(pv, hi, lo, dh, dl, ln.r0 + o, ln.r1 + o);     // dV += P^T dO
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t vhi[4], vlo[4];
    lds128(vhi, vfrag);
    lds128(vlo, vfrag + kThreads);
    mma3(dp, vhi, vlo, dh, dl, ln.t0 + o, ln.t1 + o);   // dP^T = V dO^T
    p[0] = __fmul_rn(p[0], __fsub_rn(dp[0], st.y));
    p[1] = __fmul_rn(p[1], __fsub_rn(dp[1], st.w));
    p[2] = __fmul_rn(p[2], __fsub_rn(dp[2], st.y));
    p[3] = __fmul_rn(p[3], __fsub_rn(dp[3], st.w));
    split_as_a(p, hi, lo);
    mma3(pk, hi, lo, qh, ql, ln.r0 + o, ln.r1 + o);     // dK += dS^T Q
  }
  add_to_total(dk_total, pk);
  add_to_total(dv_total, pv);
}

// Launch 2 (f32, D = 8): dk and dv. Each warp holds 16 key rows (k split in
// registers, v in shared memory) and walks the query tiles (q, do, lse,
// delta).
template <int G>
__global__ void __launch_bounds__(32 * kTcWarps * G, kTcBlocksPerSM / G)
attention_bwd_dkdv_tf32_d8_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, int heads, int seq_len, Strides sq,
                               Strides sk, Strides sv, Strides sdo, Strides sdk,
                               Strides sdv, float scale, float scale_log2) {
  // two buffers of G heads' Q tiles as staged, two of their dO tiles, the
  // current tile's Q hi, Q lo, dO hi and dO lo parts; each thread's dk and
  // dv totals and v's split A fragment (hi, lo); then the staged lse and
  // delta (two buffers each) and the current tile's (-lse, delta) pairs
  extern __shared__ float4 tf32_tiles[];
  constexpr int kChunks = G * 2 * kTcTile;
  constexpr int kStats = G * kTcTile;
  constexpr int kThreads = 32 * kTcWarps * G;
  float4* q_tile = tf32_tiles;
  float4* do_tile = tf32_tiles + 2 * kChunks;
  float4* parts = tf32_tiles + 4 * kChunks;
  float4* dk_total = tf32_tiles + 8 * kChunks + threadIdx.x;
  float4* dv_total = dk_total + kThreads;
  uint4* vfrag = reinterpret_cast<uint4*>(dk_total + 2 * kThreads);
  float* l_raw = reinterpret_cast<float*>(tf32_tiles + 8 * kChunks + 4 * kThreads);
  float* d_raw = l_raw + 2 * kStats;
  float2* cur = reinterpret_cast<float2*>(l_raw + 4 * kStats);
  *dk_total = *dv_total = make_float4(0.f, 0.f, 0.f, 0.f);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kTcWarps;
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t h = h0 + g;
  const int ja = blockIdx.x * kTcRows + (warp % kTcWarps) * 16 + lane / 4;
  const int jb = ja + 8;
  const bool oka = ja < seq_len;
  const bool okb = jb < seq_len;

  // A fragments of k and v, split into TF32 hi and lo parts once; v's go to
  // this thread's slots
  float x[4];
  uint32_t khi[4], klo[4];
  load_a(k + b * sk.b + h * sk.h, sk, ja, oka, okb, x);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], khi[i], klo[i]);
  load_a(v + b * sv.b + h * sv.h, sv, ja, oka, okb, x);
  uint4 vh, vl;
  split_tf32(x[0], vh.x, vl.x);
  split_tf32(x[1], vh.y, vl.y);
  split_tf32(x[2], vh.z, vl.z);
  split_tf32(x[3], vh.w, vl.w);
  vfrag[0] = vh;
  vfrag[kThreads] = vl;

  const BwdLane lane_reads;
  const float* qb = q + b * sq.b + h0 * sq.h;
  const float* dob = dout + b * sdo.b + h0 * sdo.h;
  const float* lseb = lse + (b * heads + h0) * seq_len;   // G heads' rows follow
  const float* deltab = delta + (b * heads + h0) * seq_len;
  const int tiles = (seq_len + kTcTile - 1) / kTcTile;
  stage_rows_f32<G, true>(q_tile, do_tile, qb, dob, sq, sdo, 0, seq_len);
  stage_stats<G>(l_raw, d_raw, lseb, deltab, 0, seq_len);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_rows_f32<G, true>(q_tile + (buf ^ 1) * kChunks, do_tile + (buf ^ 1) * kChunks,
                              qb, dob, sq, sdo, (t + 1) * kTcTile, seq_len);
      stage_stats<G>(l_raw + (buf ^ 1) * kStats, d_raw + (buf ^ 1) * kStats, lseb, deltab,
                     (t + 1) * kTcTile, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    split_tile(q_tile + buf * kChunks, do_tile + buf * kChunks, parts, parts + kChunks,
               parts + 2 * kChunks, parts + 3 * kChunks);
    // one of the tile's 2 kStats statistics per thread, as (-lse, delta)
    // pairs, query j of every 8 at j ^ ((j >> 2) & 1) (dkdv_tile_tf32)
    {
      const int c = threadIdx.x < kStats ? threadIdx.x : threadIdx.x - kStats;
      float* pair = reinterpret_cast<float*>(cur + (c ^ ((c >> 2) & 1)));
      if (threadIdx.x < kStats) {
        pair[0] = -l_raw[buf * kStats + c];
      } else {
        pair[1] = d_raw[buf * kStats + c];
      }
    }
    __syncthreads();
    const uint32_t* head = reinterpret_cast<const uint32_t*>(parts + g * 2 * kTcTile);
    constexpr int kPart = 4 * kChunks;
    dkdv_tile_tf32<kThreads>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                             reinterpret_cast<const float4*>(cur + g * kTcTile), lane_reads,
                             khi, klo, vfrag, scale_log2, dk_total, dv_total);
  }

  const float4 dka = *dk_total;
  const float4 dva = *dv_total;
  float* dkh = dk + b * sdk.b + h * sdk.h;
  float* dvh = dv + b * sdv.b + h * sdv.h;
  if (oka) {
    dkh[ja * sdk.t + 2 * tig * sdk.d] = __fmul_rn(dka.x, scale);
    dkh[ja * sdk.t + (2 * tig + 1) * sdk.d] = __fmul_rn(dka.y, scale);
    dvh[ja * sdv.t + 2 * tig * sdv.d] = dva.x;
    dvh[ja * sdv.t + (2 * tig + 1) * sdv.d] = dva.y;
  }
  if (okb) {
    dkh[jb * sdk.t + 2 * tig * sdk.d] = __fmul_rn(dka.z, scale);
    dkh[jb * sdk.t + (2 * tig + 1) * sdk.d] = __fmul_rn(dka.w, scale);
    dvh[jb * sdv.t + 2 * tig * sdv.d] = dva.z;
    dvh[jb * sdv.t + (2 * tig + 1) * sdv.d] = dva.w;
  }
}

template <int G>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* dout,
                        const void* o, void* dq, void* dk, void* dv, const float* lse,
                        float* delta, int batch, int heads, int seq_len, const int64_t* st,
                        float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sdo{st[12], st[13], st[14], st[15]};
  const Strides sdq{st[16], st[17], st[18], st[19]};
  const Strides sdk{st[20], st[21], st[22], st[23]};
  const Strides sdv{st[24], st[25], st[26], st[27]};
  const Strides so{st[28], st[29], st[30], st[31]};
  if (!rows16<float>(q, sq) || !rows16<float>(k, sk) || !rows16<float>(v, sv)
      || !rows16<float>(dout, sdo) || o == nullptr || lse == nullptr)
    return cudaErrorInvalidValue;
  // the staged tiles of two tensors, double-buffered, and their four parts,
  // and each thread's totals (dq; dk and dv); the dk/dv launch also keeps
  // v's split fragment and stages lse and delta (two buffers, and the
  // current tile's pairs)
  constexpr int kThreads = 32 * kTcWarps * G;
  constexpr int kTileBytes = 8 * G * 2 * kTcTile * 16;
  constexpr int kDqBytes = kTileBytes + kThreads * 16;
  constexpr int kDkdvBytes = kTileBytes + 4 * kThreads * 16 + 6 * G * kTcTile * 4;
  if (kDkdvBytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_tf32_d8_kernel<G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kDqBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(attention_bwd_dkdv_tf32_d8_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvBytes);
    }
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  const float scale_log2 = scale * kLog2e;
  attention_bwd_dq_tf32_d8_kernel<G><<<grid, 32 * kTcWarps * G, kDqBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(o), lse, static_cast<float*>(dq), delta, heads, seq_len,
      sq, sk, sv, sdo, so, sdq, scale, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_tf32_d8_kernel<G><<<grid, 32 * kTcWarps * G, kDkdvBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), heads, seq_len, sq, sk, sv, sdo,
      sdk, sdv, scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_tf32_group(int group, const void* q, const void* k, const void* v,
                              const void* dout, const void* o, void* dq, void* dk, void* dv,
                              const float* lse, float* delta, int batch, int heads,
                              int seq_len, const int64_t* st, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch_tf32<1>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 2: return launch_tf32<2>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 4: return launch_tf32<4>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 8: return launch_tf32<8>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace d8

// ---------------------------------------------------------------------------
// heads wider than 64 channels: the wide kernels
// ---------------------------------------------------------------------------
//
// attention_bwd_dq_wide_kernel<T, NC> and attention_bwd_dkdv_wide_kernel<T,
// NC> replace, for heads of 65 channels and more in both dtypes, the Pallas
// kernel `_attention_bwd_kernel` (synt_isic_tpu/ops/pallas/attention.py:149)
// at any head_dim, with the arithmetic and rounding points of the templates
// above (`attention_bwd_kernel_order`, `attention_bwd_tf32x3_kernel_order`):
// two exponentials per (i, j) from the saved lse (one a launch), no atomics.
//   Bound on the H100 at (8, 256/D, 1024, D): the five T x T products are
//   21.5 GFLOP at every D, 0.0217 ms in bf16 on the tensor cores and 0.130
//   ms in f32 as three TF32 passes (494.7 TFLOP/s); q, k, v, do read once and
//   dq, dk, dv written once are 25.2 MB in bf16, 0.0075 ms. So the products
//   bound it.
//   What the earlier wide kernels lost, and what this design does about it: (1)
//   a block covered one 64-channel chunk of a gradient and formed S and dP
//   over every channel for it, 2 or 4 times at D 128 and 256, with their
//   exponentials: here a block of 8 warps (wide.cuh) owns 64 rows of one head
//   and 64 NC channels of its gradients (NC = 2, 4 or 8 for dq, 2 or 4 for dk
//   and dv, which keep two gradients; a wider head runs channel groups of
//   blocks), forms S and dP once per tile of the other side over every
//   channel chunk (the warps of a row group split the tile's 64 rows in
//   halves) and hands dS (dq; P^T and dS^T for dk, dv) to the warps that own
//   the other channels through 64 x 64 tiles in shared memory; (2) it read its
//   own rows' fragments (q, do; k, v) from device memory at every k-step of
//   every tile: here they are staged once per block (f32 up to 4 chunks a
//   tensor, bf16 up to 8; a wider head's further channels from device
//   memory); (3) its f32 kernels staged one tile at a time: here every
//   chunk of the other side comes through a ring of 3 stages, by TMA where
//   every stride is a multiple of 16 bytes, else by `cp.async`. The dq
//   launch streams per key tile K's chunks (S), V's (dP) and K's again for
//   its group (dQ += dS K); the dk/dv launch per query tile Q's (S^T), dO's
//   (dP^T), dO's for its group (dV += P^T dO) and Q's (dK += dS^T Q), the
//   tile's lse and delta beside them. (4) The products: bf16 on `wgmma`
//   m64n32k16 (S, dP, S^T and dP^T from the own chunk and the other side's,
//   both K-major; dQ += dS K, dV += P^T dO and dK += dS^T Q from the 64 x 64
//   tile, stored as a swizzled chunk, and the other side's chunk as an
//   MN-major operand, warpgroup hf taking half hf of the tile's columns in
//   the first and of each chunk's channels in the second; wide.cuh); f32
//   3xTF32 on `mma.sync` (attention_fwd.cu's wide kernel says why). f32:
//   each tile's dq, dk, dv chunk gathers in its own accumulator, added to
//   the total in f32 (the tensor cores' f32 sums truncate), as the templates
//   do; dq and dk times 1/sqrt(D) at the store. bf16: P rounded to bf16, dS = bf16(P (dP scale -
//   delta scale)), the gradients accumulated in f32 and rounded once.
//   Registers: dq 16 NC a thread, dk and dv 32 NC, beside S's and dP's 16
//   each and a chunk's partial sums 16; one block an SM (the own rows of two
//   tensors and two tiles leave no room for a second at NC 2).

// c += X Y^T over one chunk (own rows X from `xs`, or from device memory)
template <typename T>
__device__ __forceinline__ void rows_product(float (*c)[4], const uint8_t* xs, int la,
                                             const T* x, Strides sx, int row0, int seq_len,
                                             int head_dim, int cx, const uint8_t* ys, int hf) {
  if constexpr (std::is_same<T, float>::value) {
    wide::tf32_rows(c, c, false, xs, la, x, sx, row0 + la, seq_len, head_dim, cx, 1.f, ys, hf);
  } else {
    wide::bf16_rows(c, xs, x, sx, row0 + la, seq_len, head_dim, cx, ys, hf);
  }
}

// Launch 1 (wide): dq of this block's channel group, and each query row's
// delta = do . o (written by group 0).
template <typename T, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const T* __restrict__ o, const float* __restrict__ lse,
                             T* __restrict__ dq, float* __restrict__ delta, int heads, int groups,
                             int seq_len, int head_dim, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides so, Strides sdq, int unit_q, int unit_k,
                             int unit_v, int unit_do, int own_chunks, int tma, float scale,
                             float scale_log2, const __grid_constant__ wide::Maps maps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kCB = wide::chunk_bytes<T>();
  extern __shared__ uint8_t wide_dq_smem[];
  const wide::Smem sm = wide::smem_layout<T>(wide_dq_smem, 2 * own_chunks, 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int rg = warp % 4;
  const int hf = warp / 4;
  const int la = 16 * rg + lane / 4;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y / groups;
  const int group = blockIdx.y % groups;
  const int q0 = blockIdx.x * wide::kRows;
  const int ra = q0 + la;
  const int chunks = (head_dim + wide::kChunk - 1) / wide::kChunk;
  const int c0 = group * NC;
  const int nc = min(NC, chunks - c0);
  const int per_tile = 2 * chunks + nc;   // K (S), V (dP), K of this group (dQ)
  const int tiles = (seq_len + wide::kTile - 1) / wide::kTile;
  const int total = tiles * per_tile;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;

  const int64_t k_t = sk.t, k_d = sk.d, v_t = sv.t, v_d = sv.d;
  auto load_item = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int t = i / per_tile;
    const int j = i % per_tile;
    const bool is_v = j >= chunks && j < 2 * chunks;
    const int c = j < chunks ? j : is_v ? j - chunks : c0 + j - 2 * chunks;
    if (bar != nullptr) wg::mbar_expect(bar, kCB);
    wide::stage_chunk<T>(dst, &maps.m[is_v ? 2 : 1], bar, is_v ? vh : kh, is_v ? v_t : k_t,
                         is_v ? v_d : k_d, is_v ? unit_v : unit_k, wide::kTile * t, seq_len,
                         wide::kChunk * c, head_dim, h, b);
  };
  wide::start<T>(sm, own_chunks, 2, tma, maps, 0, 3, qh, doh, sq, sdo, unit_q, unit_do, q0, h,
                 b, seq_len, head_dim, total, load_item);

  // delta = do . o over the row's channels from device memory: 2 a k-step
  // here (bf16 pairs; f32 channels t and t + 4), then over the row's 4 lanes
  float dl[2] = {0.f, 0.f};
  const T* ohd = o + b * so.b + h * so.h;
  for (int j = 0; j < (head_dim + 7) / 8; ++j) {
    if constexpr (kF32) {
      float x[4], ox[4];
      load_a(doh, sdo, ra, ra < seq_len, ra + 8 < seq_len, j, head_dim, x);
      load_a(ohd, so, ra, ra < seq_len, ra + 8 < seq_len, j, head_dim, ox);
      dl[0] = fmaf(x[2], ox[2], fmaf(x[0], ox[0], dl[0]));
      dl[1] = fmaf(x[3], ox[3], fmaf(x[1], ox[1], dl[1]));
    } else {
      const int c = 8 * j + 2 * tig;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = ra + 8 * r < seq_len;
        const uint32_t d = load_pair(doh, sdo, ra + 8 * r, c, ok, head_dim);
        const uint32_t oo = load_pair(ohd, so, ra + 8 * r, c, ok, head_dim);
        dl[r] = fmaf(hi_f32(d), hi_f32(oo), fmaf(lo_f32(d), lo_f32(oo), dl[r]));
      }
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    dl[0] = kF32 ? __fadd_rn(dl[0], __shfl_xor_sync(0xffffffffu, dl[0], x))
                 : dl[0] + __shfl_xor_sync(0xffffffffu, dl[0], x);
    dl[1] = kF32 ? __fadd_rn(dl[1], __shfl_xor_sync(0xffffffffu, dl[1], x))
                 : dl[1] + __shfl_xor_sync(0xffffffffu, dl[1], x);
  }
  const int64_t stat = (b * heads + h) * seq_len;
  float nl[2], ds_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    nl[r] = row < seq_len ? -lse[stat + row] : 0.f;
    ds_row[r] = kF32 ? dl[r] : dl[r] * scale;   // bf16: delta * scale
    if (group == 0 && hf == 0 && tig == 0 && row < seq_len) delta[stat + row] = dl[r];
  }

  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;
  }
  int item = 0;
  for (int t = 0; t < tiles; ++t) {
    const int keys = seq_len - t * wide::kTile;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {   // S = Q K^T
      const uint8_t* kc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
      rows_product<T>(s, c < own_chunks ? sm.own + c * kCB : nullptr, la, qh, sq, q0,
                      seq_len, head_dim, c, kc, hf);
    }
    for (int c = 0; c < chunks; ++c) {   // dP = dO V^T
      const uint8_t* vc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
      rows_product<T>(dp, c < own_chunks ? sm.own + (own_chunks + c) * kCB : nullptr, la, doh,
                      sdo, q0, seq_len, head_dim, c, vc, hf);
    }
    // dS = P (dP - delta), P = 2^(S scale log2(e) - lse); keys past T: dS = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 32 * hf + 8 * i + 2 * tig;
      float p[4], ds[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[i][e], scale_log2, nl[e / 2]));
        if (key + (e & 1) >= keys) p[e] = 0.f;
      }
      uint32_t pa = 0u, pb = 0u;
      if constexpr (kF32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = __fmul_rn(p[e], __fsub_rn(dp[i][e], ds_row[e / 2]));
      } else {
        const uint32_t qa = pack_bf16(p[0], p[1]);
        const uint32_t qb = pack_bf16(p[2], p[3]);
        pa = pack_bf16(lo_f32(qa) * fmaf(dp[i][0], scale, -ds_row[0]),
                       hi_f32(qa) * fmaf(dp[i][1], scale, -ds_row[0]));
        pb = pack_bf16(lo_f32(qb) * fmaf(dp[i][2], scale, -ds_row[1]),
                       hi_f32(qb) * fmaf(dp[i][3], scale, -ds_row[1]));
      }
      wide::tile_store<T>(sm.tile, la, key, ds, pa, pb);
    }
    wide::tile_ready<T>(rg);
#pragma unroll
    for (int c = 0; c < NC; ++c) {   // dQ += dS K, this group's chunks
      if (c < nc) {
        const uint8_t* kc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
        wide::channels_product<T>(acc[c], sm.tile, la, kc, hf);
      }
    }
  }

  T* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= nc) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int ch = wide::kChunk * (c0 + c) + 32 * hf + 8 * n + 2 * tig;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ra + 8 * r;
        if (row >= seq_len) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ch + e >= head_dim) continue;
          const float x = acc[c][n][2 * r + e];
          dqh[row * sdq.t + (ch + e) * sdq.d] = wide::from_f32<T>(kF32 ? __fmul_rn(x, scale) : x);
        }
      }
    }
  }
}

// Launch 2 (wide): dk and dv of this block's channel group. The block's own
// rows are 64 keys; it walks the query tiles (q, do, lse, delta).
template <typename T, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
attention_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int heads, int groups,
                               int seq_len, int head_dim, Strides sq, Strides sk, Strides sv,
                               Strides sdo, Strides sdk, Strides sdv, int unit_q, int unit_k,
                               int unit_v, int unit_do, int own_chunks, int tma, float scale,
                               float scale_log2, const __grid_constant__ wide::Maps maps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kCB = wide::chunk_bytes<T>();
  extern __shared__ uint8_t wide_dkdv_smem[];
  const wide::Smem sm = wide::smem_layout<T>(wide_dkdv_smem, 2 * own_chunks, 2);
  uint8_t* pt_tile = sm.tile;                        // P^T
  uint8_t* ds_tile = sm.tile + wide::p_bytes<T>();   // dS^T

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int rg = warp % 4;
  const int hf = warp / 4;
  const int la = 16 * rg + lane / 4;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y / groups;
  const int group = blockIdx.y % groups;
  const int k0 = blockIdx.x * wide::kRows;
  const int ja = k0 + la;
  const int chunks = (head_dim + wide::kChunk - 1) / wide::kChunk;
  const int c0 = group * NC;
  const int nc = min(NC, chunks - c0);
  // Q (S^T), dO (dP^T), dO of this group (dV), Q of this group (dK)
  const int per_tile = 2 * chunks + 2 * nc;
  const int tiles = (seq_len + wide::kTile - 1) / wide::kTile;
  const int total = tiles * per_tile;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const float* lseh = lse + (b * heads + h) * seq_len;
  const float* deltah = delta + (b * heads + h) * seq_len;

  const int64_t q_t = sq.t, q_d = sq.d, do_t = sdo.t, do_d = sdo.d;
  auto load_item = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int t = i / per_tile;
    const int j = i % per_tile;
    const bool is_do = (j >= chunks && j < 2 * chunks + nc);
    const int c = j < chunks ? j : j < 2 * chunks ? j - chunks
                : j < 2 * chunks + nc ? c0 + j - 2 * chunks : c0 + j - 2 * chunks - nc;
    if (bar != nullptr) wg::mbar_expect(bar, kCB);
    wide::stage_chunk<T>(dst, &maps.m[is_do ? 3 : 0], bar, is_do ? doh : qh, is_do ? do_t : q_t,
                         is_do ? do_d : q_d, is_do ? unit_do : unit_q, wide::kTile * t, seq_len,
                         wide::kChunk * c, head_dim, h, b);
  };
  wide::start<T>(sm, own_chunks, 2, tma, maps, 1, 2, kh, vh, sk, sv, unit_k, unit_v, k0, h,
                 b, seq_len, head_dim, total, load_item);

  float dka[NC][4][4], dva[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      dka[c][n][0] = dka[c][n][1] = dka[c][n][2] = dka[c][n][3] = 0.f;
      dva[c][n][0] = dva[c][n][1] = dva[c][n][2] = dva[c][n][3] = 0.f;
    }
  }
  int item = 0;
  for (int t = 0; t < tiles; ++t) {
    // the tile's lse (+inf past T: P = 0) and delta (0 past T), buffer t % 2;
    // the ring's next __syncthreads makes them visible
    float* lt = sm.stats + (t & 1) * 2 * wide::kTile;
    float* dlt = lt + wide::kTile;
    if (threadIdx.x < 2 * wide::kTile) {
      const int i = threadIdx.x % wide::kTile;
      const int row = t * wide::kTile + i;
      if (threadIdx.x < wide::kTile) {
        lt[i] = row < seq_len ? lseh[row] : INFINITY;
      } else {
        dlt[i] = row < seq_len ? deltah[row] : 0.f;
      }
    }
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {   // S^T = K Q^T
      const uint8_t* qc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
      rows_product<T>(s, c < own_chunks ? sm.own + c * kCB : nullptr, la, kh, sk, k0,
                      seq_len, head_dim, c, qc, hf);
    }
    for (int c = 0; c < chunks; ++c) {   // dP^T = V dO^T
      const uint8_t* dc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
      rows_product<T>(dp, c < own_chunks ? sm.own + (own_chunks + c) * kCB : nullptr, la, vh,
                      sv, k0, seq_len, head_dim, c, dc, hf);
    }
    // P^T = 2^(S^T scale log2(e) - lse_j), dS^T = P^T (dP^T - delta_j) for
    // this lane's queries 32 hf + 8 i + 2 t and + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 32 * hf + 8 * i + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
      float p[4] = {ex2(fmaf(s[i][0], scale_log2, -l2.x)), ex2(fmaf(s[i][1], scale_log2, -l2.y)),
                    ex2(fmaf(s[i][2], scale_log2, -l2.x)), ex2(fmaf(s[i][3], scale_log2, -l2.y))};
      if constexpr (kF32) {
        wide::tile_store<T>(pt_tile, la, col, p, 0u, 0u);
        float ds[4] = {__fmul_rn(p[0], __fsub_rn(dp[i][0], d2.x)),
                       __fmul_rn(p[1], __fsub_rn(dp[i][1], d2.y)),
                       __fmul_rn(p[2], __fsub_rn(dp[i][2], d2.x)),
                       __fmul_rn(p[3], __fsub_rn(dp[i][3], d2.y))};
        wide::tile_store<T>(ds_tile, la, col, ds, 0u, 0u);
      } else {
        const float dsx = d2.x * scale;
        const float dsy = d2.y * scale;
        const uint32_t pa = pack_bf16(p[0], p[1]);
        const uint32_t pb = pack_bf16(p[2], p[3]);
        wide::tile_store<T>(pt_tile, la, col, p, pa, pb);
        wide::tile_store<T>(ds_tile, la, col, p,
                      pack_bf16(lo_f32(pa) * fmaf(dp[i][0], scale, -dsx),
                                hi_f32(pa) * fmaf(dp[i][1], scale, -dsy)),
                      pack_bf16(lo_f32(pb) * fmaf(dp[i][2], scale, -dsx),
                                hi_f32(pb) * fmaf(dp[i][3], scale, -dsy)));
      }
    }
    wide::tile_ready<T>(rg);
#pragma unroll
    for (int c = 0; c < NC; ++c) {   // dV += P^T dO
      if (c < nc) {
        const uint8_t* dc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
        wide::channels_product<T>(dva[c], pt_tile, la, dc, hf);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {   // dK += dS^T Q
      if (c < nc) {
        const uint8_t* qc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
        wide::channels_product<T>(dka[c], ds_tile, la, qc, hf);
      }
    }
  }

  T* dkh = dk + b * sdk.b + h * sdk.h;
  T* dvh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= nc) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int ch = wide::kChunk * (c0 + c) + 32 * hf + 8 * n + 2 * tig;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ja + 8 * r;
        if (row >= seq_len) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ch + e >= head_dim) continue;
          const float x = dka[c][n][2 * r + e];
          dkh[row * sdk.t + (ch + e) * sdk.d] = wide::from_f32<T>(kF32 ? __fmul_rn(x, scale) : x);
          dvh[row * sdv.t + (ch + e) * sdv.d] = wide::from_f32<T>(dva[c][n][2 * r + e]);
        }
      }
    }
  }
}

// Both launches of the wide kernels at their NC: the tensor maps (TMA where
// all four staged tensors have one), the shared memory, the grid (one block
// per 64 rows, head and channel group), cudaGetLastError after each.
template <typename T, int NQ, int NKV>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const void* o, void* dq, void* dk, void* dv, const float* lse,
                        float* delta, int batch, int heads, int seq_len, int head_dim,
                        const int64_t* st, const int* units, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sdo{st[12], st[13], st[14], st[15]};
  const Strides sdq{st[16], st[17], st[18], st[19]};
  const Strides sdk{st[20], st[21], st[22], st[23]};
  const Strides sdv{st[24], st[25], st[26], st[27]};
  const Strides so{st[28], st[29], st[30], st[31]};
  const int chunks = (head_dim + wide::kChunk - 1) / wide::kChunk;
  const int own = min(chunks, wide::own_max<T>(2));
  const float scale_log2 = scale * kLog2e;
  wide::Maps maps = {};
  const bool tma = wide::tensor_map<T>(&maps.m[0], q, sq, batch, heads, seq_len, head_dim)
                   && wide::tensor_map<T>(&maps.m[1], k, sk, batch, heads, seq_len, head_dim)
                   && wide::tensor_map<T>(&maps.m[2], v, sv, batch, heads, seq_len, head_dim)
                   && wide::tensor_map<T>(&maps.m[3], dout, sdo, batch, heads, seq_len, head_dim);
  const int rows = (seq_len + wide::kRows - 1) / wide::kRows;
  cudaError_t err;
  {
    const int groups = (chunks + NQ - 1) / NQ;
    const int bytes = wide::shared_bytes<T>(2 * own, 1);
    auto* kernel = attention_bwd_dq_wide_kernel<T, NQ>;
    if ((err = allow_shared(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<dim3(rows, heads * groups, batch), wide::kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const T*>(o), lse, static_cast<T*>(dq), delta,
        heads, groups, seq_len, head_dim, sq, sk, sv, sdo, so, sdq, units[0], units[1], units[2],
        units[3], own, tma ? 1 : 0, scale, scale_log2, maps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int groups = (chunks + NKV - 1) / NKV;
  const int bytes = wide::shared_bytes<T>(2 * own, 2);
  auto* kernel = attention_bwd_dkdv_wide_kernel<T, NKV>;
  if ((err = allow_shared(kernel, bytes)) != cudaSuccess) return err;
  kernel<<<dim3(rows, heads * groups, batch), wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), heads,
      groups, seq_len, head_dim, sq, sk, sv, sdo, sdk, sdv, units[0], units[1], units[2], units[3],
      own, tma ? 1 : 0, scale, scale_log2, maps);
  return cudaGetLastError();
}

// the wide launches at the head's chunks: dq's NC of 2, 4 or 8, dk/dv's of 2
// or 4
template <typename T>
cudaError_t launch_wide_chunks(const void* q, const void* k, const void* v, const void* dout,
                               const void* o, void* dq, void* dk, void* dv, const float* lse,
                               float* delta, int batch, int heads, int seq_len, int head_dim,
                               const int64_t* st, const int* units, float scale,
                               cudaStream_t s) {
  switch (wide::group_chunks(head_dim)) {
    case 2: return launch_wide<T, 2, 2>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                        seq_len, head_dim, st, units, scale, s);
    case 4: return launch_wide<T, 4, 4>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                        seq_len, head_dim, st, units, scale, s);
    default: return launch_wide<T, 8, 4>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                         seq_len, head_dim, st, units, scale, s);
  }
}

// Both launches of the bf16 or the f32 kernels at <Dp, G>: each staged
// tensor's unit, the shared memory, the grid, cudaGetLastError after each.
template <typename T, int Dp, int G, bool Wide>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, void* dq, void* dk, void* dv, const float* lse, float* delta,
                   int batch, int heads, int seq_len, int head_dim, const int64_t* st,
                   const int* units, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sdo{st[12], st[13], st[14], st[15]};
  const Strides sdq{st[16], st[17], st[18], st[19]};
  const Strides sdk{st[20], st[21], st[22], st[23]};
  const Strides sdv{st[24], st[25], st[26], st[27]};
  const Strides so{st[28], st[29], st[30], st[31]};
  const int unit_q = units[0], unit_k = units[1], unit_v = units[2], unit_do = units[3];
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  constexpr int kThreads = 32 * kTcWarps * G;
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    // two tensors' tiles, double-buffered; the dk/dv launch also stages lse
    // and delta (two buffers each)
    constexpr int kDqBytes = 4 * G * kTcTile * Bf16Tile<Dp>::kStride * 16;
    constexpr int kDkdvBytes = kDqBytes + 4 * G * kTcTile * 4;
    auto* dq_kernel = attention_bwd_dq_tc_kernel<Dp, G, Wide>;
    auto* dkdv_kernel = attention_bwd_dkdv_tc_kernel<Dp, G, Wide>;
    if ((err = allow_shared(dq_kernel, kDqBytes)) != cudaSuccess) return err;
    if ((err = allow_shared(dkdv_kernel, kDkdvBytes)) != cudaSuccess) return err;
    dq_kernel<<<grid, kThreads, kDqBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const bf16*>(o), lse,
        static_cast<bf16*>(dq), delta, heads, seq_len, head_dim, sq, sk, sv, sdo, so, sdq,
        unit_k, unit_v, scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dkdv_kernel<<<grid, kThreads, kDkdvBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), heads, seq_len, head_dim, sq, sk, sv, sdo, sdk, sdv, unit_q,
        unit_do, scale, scale_log2);
  } else {
    // two raw tiles and four parts; each thread's totals (dq; dk and dv),
    // and in the dk/dv launch v's split fragments and the statistics
    constexpr int kTileBytes =
        G * kTcTile * 16 * (2 * Tf32Tile<Dp>::kRaw + 4 * Tf32Tile<Dp>::kStride);
    constexpr int kDqBytes = kTileBytes + (Dp / 8) * kThreads * 16;
    constexpr int kDkdvBytes = kTileBytes + 4 * (Dp / 8) * kThreads * 16 + G * kTcTile * 16;
    auto* dq_kernel = attention_bwd_dq_tf32_kernel<Dp, G, Wide>;
    auto* dkdv_kernel = attention_bwd_dkdv_tf32_kernel<Dp, G, Wide>;
    if ((err = allow_shared(dq_kernel, kDqBytes)) != cudaSuccess) return err;
    if ((err = allow_shared(dkdv_kernel, kDkdvBytes)) != cudaSuccess) return err;
    dq_kernel<<<grid, kThreads, kDqBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(o), lse, static_cast<float*>(dq), delta, heads, seq_len,
        head_dim, sq, sk, sv, sdo, so, sdq, unit_k, unit_v, scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dkdv_kernel<<<grid, kThreads, kDkdvBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq_len, head_dim, sq, sk, sv,
        sdo, sdk, sdv, unit_q, unit_do, scale, scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int group, const void* q, const void* k, const void* v,
                         const void* dout, const void* o, void* dq, void* dk, void* dv,
                         const float* lse, float* delta, int batch, int heads, int seq_len,
                         int head_dim, const int64_t* st, float scale, cudaStream_t s) {
  const int units[4] = {stage_unit<T>(q, Strides{st[0], st[1], st[2], st[3]}, head_dim),
                        stage_unit<T>(k, Strides{st[4], st[5], st[6], st[7]}, head_dim),
                        stage_unit<T>(v, Strides{st[8], st[9], st[10], st[11]}, head_dim),
                        stage_unit<T>(dout, Strides{st[12], st[13], st[14], st[15]}, head_dim)};
  // every staged row in 16-byte units and the head at its staged width: the
  // Wide instances, at every G; else the general staging, at G = 1 only
  const bool wide = units[0] == 4 && units[1] == 4 && units[2] == 4 && units[3] == 4
                    && head_dim == padded_head_dim(head_dim);
  if (head_dim < 1) return cudaErrorInvalidValue;
  if (head_dim > kMaxMmaWidth) {   // the wide kernels, one head per block
    if (group != 1) return cudaErrorInvalidValue;
    return launch_wide_chunks<T>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads, seq_len,
                                 head_dim, st, units, scale, s);
  }
  if (!wide && group != 1) return cudaErrorInvalidValue;
  if (wide && head_dim == 8) {   // the head_dim-8 kernels, namespace d8
    if constexpr (std::is_same<T, bf16>::value) {
      return d8::launch_tc_group(group, q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                 seq_len, st, scale, s);
    } else {
      return d8::launch_tf32_group(group, q, k, v, dout, o, dq, dk, dv, lse, delta, batch,
                                   heads, seq_len, st, scale, s);
    }
  }
  return dispatch_width(head_dim, group, [&](auto dp, auto g) {
    constexpr int Dp = decltype(dp)::value;
    constexpr int G = decltype(g)::value;
    if constexpr (Dp != 8) {
      if (wide) {
        return launch<T, Dp, G, true>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                      seq_len, head_dim, st, units, scale, s);
      }
    }
    if constexpr (G == 1) {
      return launch<T, Dp, 1, false>(q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                                     seq_len, head_dim, st, units, scale, s);
    }
    return cudaErrorInvalidValue;
  });
}

}  // namespace

// The launch's shape, types and knobs, packed once per checked layout by
// ops/attention.py (`_BwdArgs` there: the same fields in the same order).
// dtype: 0 = float32, 1 = bfloat16. strides: 32 element strides, (b, h, t, d)
// for q, k, v, dout, dq, dk, dv and o in that order. head_dim: >= 1.
// heads_per_program: the heads one block runs, G' (`block_group`): 1, 2, 4
// or 8 with G' * (the staged width, 8, 16, 32 or 64) <= 64 on a layout of
// 16-byte rows, 1 for the wide kernels, and it must divide heads.
struct BwdArgs {
  int64_t strides[32];
  int32_t batch, heads, seq_len, head_dim, dtype, heads_per_program;
  float scale;
};

// o is the forward's output (in the primal dtype) and lse its base-2
// log-sum-exp, f32 (batch, heads, seq_len) contiguous, both read; delta, of
// the same shape, is scratch, written by the first launch and read by the
// second. Any strides are taken for the rest. Returns a cudaError_t; an
// unsupported head_dim, dtype or group, or no o or lse, returns
// cudaErrorInvalidValue without launching.
extern "C" int attention_bwd(const BwdArgs* a, const void* q, const void* k, const void* v,
                             const void* dout, const void* o, void* dq, void* dk,
                             void* dv, float* lse, float* delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = a->heads_per_program;
  const int batch = a->batch, heads = a->heads, seq_len = a->seq_len;
  if (seq_len <= 0 || batch <= 0 || heads <= 0 || g <= 0 || heads % g != 0
      || o == nullptr || lse == nullptr)
    return cudaErrorInvalidValue;
  if (a->dtype == 0)
    return launch_typed<float>(g, q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                               seq_len, a->head_dim, a->strides, a->scale, s);
  if (a->dtype == 1)
    return launch_typed<bf16>(g, q, k, v, dout, o, dq, dk, dv, lse, delta, batch, heads,
                              seq_len, a->head_dim, a->strides, a->scale, s);
  return cudaErrorInvalidValue;
}
