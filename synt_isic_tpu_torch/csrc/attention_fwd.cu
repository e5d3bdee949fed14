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
// Every head_dim D >= 1 runs on the tensor cores, in both dtypes, as the
// Pallas kernel takes any D: up to 256 the kernels are templates on a staged
// width Dp of 8, 16, 32, 64, 128 or 256 (the least one >= D), above 64 (f32)
// or 256 (bf16) the wide kernel walks the head in chunks of 64 channels; a
// head's channels past D are zero-filled where the kernel stages or loads
// them (tensor_core.cuh: zero channels are exact in every product), the
// scale 1/sqrt(D) of the true D. Routes: bf16 at Dp 16 to 256, the
// warpgroup-product kernel (`attention_fwd_wgmma_kernel`, below), one head a
// block, any layout; f32 above 64 channels and bf16 above 256, the wide
// kernel (`attention_fwd_wide_kernel`, below), one head a block, any layout;
// otherwise a head at its staged width whose rows stage in 16-byte units
// (every dense and (B, T, C) layout at D 16, 32, 64) runs the Wide instances
// at any G the launcher is given; D 8 at full width runs the head_dim-8
// kernels (namespace d8, below), at any G; any other call (D under its
// width, or rows in smaller units) runs the general staging at G = 1,
// bit-identical to every G by the contract below.
//
// The TPU kernel keeps the whole (T, T) f32 logits tile in VMEM (4 MB at
// T=1024); a Hopper block has at most 227 KB of shared memory, so neither
// kernel below forms the tile: both walk the keys in tiles of 64 staged in
// shared memory with an online softmax (a running max m and sum l per row,
// the accumulator rescaled in f32 when m moves, divided by l at the end), so
// any T works. On request (a non-null `lse`, exact maths only) they also
// write each row's base-2 log-sum-exp m + log2(l), f32 in (B, H, T), which
// the backward (`attention_bwd.cu`) reads in place of recomputing it; the
// output does not depend on whether it is written.
//
// Head grouping (`heads_per_program` = G, the TPU kernel's G heads per grid
// program): a block covers G' heads and stages the key/value tile of all G'
// at once (in the (B, T, C) layout the G' * D channels of one token are
// contiguous). Every warp runs exactly the arithmetic of the G' = 1 kernel
// for its rows and head, so the output and lse are bit-identical for every G
// (the TPU's contract for the knob). G' is instantiated where G' * Dp <= 64
// (D 8 x G' 8 is the widest staged row) and must divide the heads; the
// wrapper (`block_group` in ops/attention.py) runs any G that divides the
// heads as G / G' consecutive groups of the widest G' that divides G, in one
// launch (blockIdx.y walks the groups); the `wgmma` and wide kernels take
// G' = 1. Any other G' returns cudaErrorInvalidValue.
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
// running max, which moves once per staged tile of 64 keys, not the row's
// global max, and the rescale factor applied to the sum and accumulator when
// the max moves stays f32. Both change bf16 rounding only.
// `attention_fast_math_kernel_order(q, k, v, 64, tf32x3)` in ops/attention.py
// is the plain PyTorch version of this rounding (`tf32x3`: the f32 kernel's
// logits and tile max).
//
// Staging (both dtypes): K and V come by `cp.async` in units of 16 bytes
// where a row of a head starts on 16 bytes with D * size a multiple of 16,
// else in units of 8 or 4 bytes, else (bf16 at an odd D or an unaligned
// row, or channels that are not contiguous) an element at a time; the
// launcher picks each tensor's unit from its address and strides
// (`stage_unit`), so no layout is copied first. q is read from its own
// strides and out written to them. The bf16 `wgmma` kernel stages by TMA
// where every stride is a multiple of 16 bytes, by `cp.async` as above
// otherwise (see it below).
//
// bf16 at Dp 8 (head_dim 8 at full width runs namespace d8 below; this
// template runs heads narrower than 8 and layouts that are not 16-byte rows),
// the `mma.sync` tensor-core kernel; at Dp 16 to 256 the `wgmma` kernel
// below, faster at every such width on the H100 (PERF.md §6), runs instead.
//   Bound on the H100 at the main path's calls, B=8, T=1024, H*D = 256: the
//   two T x T contractions are 4*B*H*T^2*D = 8.6 GFLOP at every D, 8.7 us on
//   the tensor cores (989 TFLOP/s bf16); q, k, v read once and out written
//   once are 16.8 MB, 5.0 us at 3.35 TB/s; the B*H*T^2 exponentials take
//   0.0642 * (8 / D) ms on the special-function units (16 per clock per SM):
//   0.128 ms at D 4, 0.064 at D 8, 0.016 at D 32. So the exponentials set
//   the bound up to D 32 and the products (with the bytes) at D 64, and the
//   design keeps everything else off the special-function units' way: the
//   products run on the tensor cores, and each (i, j) pair costs one MUFU.EX2
//   and a few f32 instructions. One warp owns 16 query rows of one head, 4
//   warps per head, 64 rows x G heads per block. K and V are staged in tiles
//   of 64 keys, double-buffered, rows Bf16Tile<Dp>::kStride chunks apart.
//   S = Q K^T is Dp/8 k-steps of `mma.sync` m16n8k8, q's A fragments from
//   registers and K's B fragments by `ldmatrix`; O += P V is m16n8k16 into
//   Dp/8 n-tiles, the k16 A fragment being two adjacent n8 fragments of P
//   rounded to bf16 in registers, V's B fragments by `ldmatrix.trans`.
//   Per tile the kernel takes two passes over the staged keys: the first
//   forms S only for each row's tile max (reduced over the row's 4 lanes),
//   then m, l and the accumulator are rescaled once (one exponential per
//   row and tile); the second forms S again (recomputing costs less than
//   holding 64 keys of S in registers) and takes p = 2^(s * scale * log2(e)
//   - m), one fma and one MUFU.EX2 per pair. Keys past T are masked (s =
//   -inf) on the last tile only; rows past T are neither stored nor given an
//   lse. Exact: l sums the f32 p values, not their bf16 roundings, so that
//   m + log2(l) is the f32 softmax's log-sum-exp that the backward rebuilds
//   its f32 probabilities from (within f32 summation order of
//   `attention_lse_reference`). Fast math: p is already bf16, and the row
//   sums come from the tensor cores as P times a column of ones, in f32.
//   Deviations, rounding only: P is rounded to bf16 before P.V, relative to
//   the running max and unnormalised, and the division by l comes last; the
//   TPU kernel rounds the normalised probabilities to bf16
//   (attention.py:81-83); the products accumulate in f32 on the tensor
//   cores. Registers: 128 a thread (instantiated at Dp 8 only).
//
// f32: the 3xTF32 tensor-core kernel, exact maths (the console CLI's and the
// conditional generator's configuration) and fast math (an f32
// `ModelManager` with `set_attention_tuning(fast_math=True)`).
//   Bound on the H100 at (8, 256/D, 1024, D): products accurate to f32 run
//   on the tensor cores in three TF32 passes, 3 x 8.6 GFLOP at 494.7
//   TFLOP/s (dense TF32) = 52 us at every D; q, k, v and out in f32 are
//   33.6 MB, 10 us; the exponentials as above. So the exponentials set the
//   bound at D 4 and 8, the products from D 16 on; one MUFU.EX2 per (i, j)
//   and no data-dependent branch per key.
//   Layout as the bf16 kernel: one warp per 16 query rows of one head, 4
//   warps per head, 64 rows x G heads per block. K and V come in raw f32
//   tiles of 64 keys; the block splits each staged tile once into TF32 hi
//   and lo parts in shared memory (Tf32Tile: rows Dp + 4 words apart), and
//   the next raw tile streams in while the warps work on the parts, so no
//   warp splits K or V in its inner loop.
//   Products: `mma.sync` m16n8k8 with TF32 operands, each operand split into
//   hi, its TF32 rounding to nearest with ties away (as `cvt.rna.tf32.f32`,
//   here two integer instructions), and lo = x - hi, of which the tensor
//   cores read the top 19 bits; three products per step, lo.hi + hi.lo +
//   hi.hi, the small terms first: S = Q K^T over Dp/8 k-steps term by term
//   (`mma3_k`), O += P V into Dp/8 n-tiles per 8 keys. q is scaled to base-2
//   logits in f32 (1/sqrt(D) * log2(e)) and split once, in registers; P is
//   split in registers.
//   Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4): A holds
//   rows g, g + 8 at columns t and t + 4, B rows t and t + 4 of column g, C
//   rows g, g + 8 at columns 2t and 2t + 1. S's accumulator thus holds keys
//   2t, 2t + 1, which P's A fragment takes as its columns t and t + 4 (the
//   k order of P V permuted, no shuffle): V's B fragment reads keys 2t and
//   2t + 1 of channel g, and K's reads key g at channels t and t + 4; with a
//   part's rows Dp + 4 words apart both hit 32 banks.
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
//   Fast math (`FastMath`), the same kernel with the weights rounded. S is
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
//   Registers: 128 a thread at Dp 8 and 16, 255 at Dp 32 and 64 (q's split
//   fragments, the accumulator and the tile's P V grow with Dp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "wide.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// blocks per SM at G = 1 for a staged width Dp, which caps the registers a
// thread at 65536 / (128 * blocks): 128, or 255 where the accumulators and
// q's split fragments need them (Dp 8 runs here only at G = 1, for heads
// narrower than 8 or rows that are not 16-byte units)
__host__ __device__ constexpr int fwd_blocks(int dp) { return dp == 64 ? 2 : 4; }
__host__ __device__ constexpr int tf32_blocks(int dp) { return dp <= 16 ? 4 : 2; }

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (see the top of the file)
// ---------------------------------------------------------------------------

// S = Q K^T for one warp's 16 rows and keys [16 s, 16 s + 16) of the staged
// tile (rows kS chunks apart), as two C fragments: sc[0..3] keys +0..7,
// sc[4..7] keys +8..15, over Dp/8 k-steps. With Mask, keys at or past `keys`
// get s = -inf, so their weight is 0.
template <int Dp, bool Mask>
__device__ __forceinline__ void qk_step(const uint4* kt, int s, const uint32_t (*qa)[2],
                                        int keys, float* sc) {
  constexpr int kS = Bf16Tile<Dp>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    uint32_t kb[2];
    ldsm_x2(kb, kt + (s * 16 + lane % 16) * kS + j);
    mma_k8(sc, qa[j], kb[0]);
    mma_k8(sc + 4, qa[j], kb[1]);
  }
  if (Mask) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = s * 16 + c * 8 + 2 * (lane % 4);
      if (key >= keys) sc[4 * c] = sc[4 * c + 2] = -INFINITY;
      if (key + 1 >= keys) sc[4 * c + 1] = sc[4 * c + 3] = -INFINITY;
    }
  }
}

// One staged key tile for one warp's 16 query rows (row a = lane/4 and row
// b = row a + 8): the tile's max, the rescale, then P and O += P V, 16 keys
// a step. m[r] is row r's running max of the base-2 logits; l and each
// n-tile of acc are C fragments ([0..1] row a, [2..3] row b). On the exact
// path l[i] is this lane's partial sum of its keys' f32 weights; with fast
// math every column of l is the whole row's sum of the bf16 weights, from
// the tensor cores.
template <int Dp, bool FastMath, bool Mask>
__device__ __forceinline__ void fwd_tile(const uint4* kt, const uint4* vt,
                                         const uint32_t (*qa)[2], float scale_log2, int keys,
                                         float* m, float* l, float (*acc)[4]) {
  constexpr int kS = Bf16Tile<Dp>::kStride;
  const int lane = threadIdx.x % 32;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int s = 0; s < kTcTile / 16; ++s) {
    float sc[8];
    qk_step<Dp, Mask>(kt, s, qa, keys, sc);
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
#pragma unroll
      for (int n = 0; n < Dp / 8; ++n) acc[n][i] = __fmul_rn(acc[n][i], c);
    }
  }
  const uint32_t ones[2] = {0x3f803f80u, 0x3f803f80u};   // bf16 1.0 pairs
  // two steps at a time: fully unrolled, the steps' fragments spill at the
  // register cap
#pragma unroll 2
  for (int s = 0; s < kTcTile / 16; ++s) {
    float sc[8];
    qk_step<Dp, Mask>(kt, s, qa, keys, sc);
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
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
      uint32_t vT[2];
      ldsm_x2_trans(vT, vt + (s * 16 + lane % 16) * kS + n);
      mma_k16(acc[n], pa, vT);             // O += P V, channels 8n..8n+7
    }
    if (FastMath) mma_k16(l, pa, ones);    // l += P 1
  }
}

template <int Dp, int G, bool FastMath, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(fwd_blocks(Dp), G))
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int heads, int seq_len, int head_dim,
                        Strides sq, Strides sk, Strides sv, Strides so, int unit_k,
                        int unit_v, float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kS = Bf16Tile<Dp>::kStride;
  constexpr int kTile = G * kTcTile * kS;   // 16-byte chunks per tile of G heads
  // two buffers of G heads' K tiles, then two of their V tiles
  extern __shared__ uint4 bf16_tiles[];
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

  // q's A fragments (rows a and b, channels 8j + 2 tig and +1 of k-step j)
  const bf16* qh = q + b * sq.b + h * sq.h;
  uint32_t qa[Dp / 8][2];
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    qa[j][0] = load_pair(qh, sq, ra, 8 * j + 2 * tig, oka, head_dim);
    qa[j][1] = load_pair(qh, sq, rb, 8 * j + 2 * tig, okb, head_dim);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
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
      fwd_tile<Dp, FastMath, false>(kt, vt, qa, scale_log2, keys, m, l, acc);
    } else {
      fwd_tile<Dp, FastMath, true>(kt, vt, qa, scale_log2, keys, m, l, acc);
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
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) oh[ra * so.t + c * so.d] = __float2bfloat16(acc[n][0] / la);
    if (oka && c + 1 < head_dim) oh[ra * so.t + (c + 1) * so.d] = __float2bfloat16(acc[n][1] / la);
    if (okb && c < head_dim) oh[rb * so.t + c * so.d] = __float2bfloat16(acc[n][2] / lb);
    if (okb && c + 1 < head_dim) oh[rb * so.t + (c + 1) * so.d] = __float2bfloat16(acc[n][3] / lb);
  }
  if (lse != nullptr && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (oka) lse[stat + ra] = m[0] + log2f(la);
    if (okb) lse[stat + rb] = m[1] + log2f(lb);
  }
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 tensor-core kernel (see the top of the file)
// ---------------------------------------------------------------------------

// This lane's word offsets in a head's TF32 part (Tf32Tile<Dp>, rows kWords
// apart) for the 8-row slice 0 and channel block 0 (slice s adds
// 8 s kWords, channel block j adds 8 j): t0, row g at channel t (and t + 4 at
// t0 + 4), a B fragment of the tile transposed (k = channel, n = row: K's
// for S = Q K^T); r0, row 2t at channel g (and row 2t + 1 at r0 + kWords), a
// B fragment of the tile as it is (k = row in the order S's C fragment holds
// it, n = channel: V's for O += P V).
template <int Dp>
struct Tf32Lane {
  int t0, r0;
  __device__ __forceinline__ Tf32Lane() {
    const int lane = threadIdx.x % 32;
    t0 = (lane / 4) * Tf32Tile<Dp>::kWords + lane % 4;
    r0 = 2 * (lane % 4) * Tf32Tile<Dp>::kWords + lane / 4;
  }
};

// Keys at or past `keys` get s = -inf (weight 0): c[0], c[2] hold key
// 8 s + 2 tig, c[1], c[3] key 8 s + 2 tig + 1.
__device__ __forceinline__ void mask_keys(int s, int keys, float* c) {
  const int key = 8 * s + 2 * (threadIdx.x % 4);
  if (key >= keys) c[0] = c[2] = -INFINITY;
  if (key + 1 >= keys) c[1] = c[3] = -INFINITY;
}

// S = Q K^T in base 2 for one warp's 16 rows and the 8 keys of slice s of the
// staged tile, as one C fragment (c[0..1] row a, c[2..3] row b, keys as in
// mask_keys): three TF32 products per k-step, term by term.
template <int Dp, bool Mask>
__device__ __forceinline__ void qk_tf32(const uint32_t* kh, const uint32_t* kl,
                                        const Tf32Lane<Dp>& ln, int s,
                                        const uint32_t (*qhi)[4], const uint32_t (*qlo)[4],
                                        int keys, float* c) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma3_k<Dp / 8>(c, qhi, qlo, kh, kl, ln.t0 + 8 * s * Tf32Tile<Dp>::kWords);
  if (Mask) mask_keys(s, keys, c);
}

// The row maxima of one TF32 product of the hi parts (within about 2^-10 of
// S) over the staged tile, for one warp's rows a and b, reduced over each
// row's 4 lanes.
template <int Dp, bool Mask>
__device__ __forceinline__ void tile_max_tf32(const uint32_t* kh, const Tf32Lane<Dp>& ln,
                                              const uint32_t (*qhi)[4], int keys, float* mx) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int s = 0; s < kTcTile / 8; ++s) {
    const int o = ln.t0 + 8 * s * Tf32Tile<Dp>::kWords;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j) {
      const uint32_t kb[2] = {kh[o + 8 * j], kh[o + 8 * j + 4]};
      mma_tf32(c, qhi[j], kb);
    }
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
// 4 lanes), pv the tile's P V (a C fragment per n-tile, its own accumulator:
// the tensor cores' f32 sums truncate, so a chain of 24 products, not one of
// every key's, carries that error). With FastMath the shifted logit s - m is
// rounded to bf16 and its correctly rounded bf16 exponential taken; a bf16
// weight is exact in TF32 (its lo part is zero), so P V takes two products,
// P.v_lo + P.v_hi, and lt sums the bf16 weights in f32.
template <int Dp, bool FastMath, bool Mask>
__device__ __forceinline__ void tile_pv_tf32(const uint32_t* kh, const uint32_t* kl,
                                             const uint32_t* vh, const uint32_t* vl,
                                             const Tf32Lane<Dp>& ln, const uint32_t (*qhi)[4],
                                             const uint32_t (*qlo)[4], int keys, const float* m,
                                             float* lt, float (*pv)[4]) {
  constexpr int kW = Tf32Tile<Dp>::kWords;
  lt[0] = lt[1] = 0.f;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
  // two steps a turn: fully unrolled, the steps' fragments spill at the
  // register cap
#pragma unroll 2
  for (int s = 0; s < kTcTile / 8; ++s) {
    float c[4];
    qk_tf32<Dp, Mask>(kh, kl, ln, s, qhi, qlo, keys, c);
    const int o = ln.r0 + 8 * s * kW;
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
#pragma unroll
      for (int n = 0; n < Dp / 8; ++n) {
        const uint32_t vhi[2] = {vh[o + 8 * n], vh[o + 8 * n + kW]};
        const uint32_t vlo[2] = {vl[o + 8 * n], vl[o + 8 * n + kW]};
        mma_tf32(pv[n], pf, vlo);   // P V, the small term first
        mma_tf32(pv[n], pf, vhi);
      }
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
#pragma unroll
      for (int n = 0; n < Dp / 8; ++n) {
        mma3(pv[n], phi, plo, vh, vl, o + 8 * n, o + 8 * n + kW);   // P V
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 1));
    lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 2));
  }
}

// Bring row r's sum l[r] and accumulator (acc[n][2r], acc[n][2r + 1]) from
// shift m[r] onto mnew >= m[r]. __fmul_rn is never contracted into an fma
// with the sums that follow, so no G instance rounds otherwise than G = 1.
template <int Dp>
__device__ __forceinline__ void shift_to(int r, float mnew, float* m, float* l,
                                         float (*acc)[4]) {
  // on the first tile m = -inf, so c = 0 and the zero state stays zero
  const float c = mnew > m[r] ? ex2(m[r] - mnew) : 1.f;
  m[r] = mnew;
  l[r] = __fmul_rn(l[r], c);
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    acc[n][2 * r] = __fmul_rn(acc[n][2 * r], c);
    acc[n][2 * r + 1] = __fmul_rn(acc[n][2 * r + 1], c);
  }
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
template <int Dp, bool FastMath, bool Mask>
__device__ __forceinline__ void fwd_tile_tf32(const uint32_t* kh, const uint32_t* kl,
                                              const uint32_t* vh, const uint32_t* vl,
                                              const Tf32Lane<Dp>& ln, const uint32_t (*qhi)[4],
                                              const uint32_t (*qlo)[4], int keys, bool first,
                                              float* m, float* l, float (*acc)[4]) {
  float lt[2], pv[Dp / 8][4];
  bool need_max = first || FastMath;
  for (;;) {
    if (need_max) {
      float mx[2];
      tile_max_tf32<Dp, Mask>(kh, ln, qhi, keys, mx);
      shift_to<Dp>(0, fmaxf(m[0], mx[0]), m, l, acc);
      shift_to<Dp>(1, fmaxf(m[1], mx[1]), m, l, acc);
    }
    tile_pv_tf32<Dp, FastMath, Mask>(kh, kl, vh, vl, ln, qhi, qlo, keys, m, lt, pv);
    // !(x <= 2^40) also holds for inf and NaN
    const bool wide = !(lt[0] <= 0x1p40f) || !(lt[1] <= 0x1p40f);
    if (need_max || !__any_sync(0xffffffffu, wide)) break;
    need_max = true;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], lt[r]);
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
      acc[n][2 * r] = __fadd_rn(acc[n][2 * r], pv[n][2 * r]);
      acc[n][2 * r + 1] = __fadd_rn(acc[n][2 * r + 1], pv[n][2 * r + 1]);
    }
    if (!FastMath && lt[r] > 0x1p16f) {
      shift_to<Dp>(r, __fadd_rn(m[r], __log2f(lt[r])), m, l, acc);
    }
  }
}

template <int Dp, int G, bool FastMath, bool Wide>
__global__ void __launch_bounds__(32 * kTcWarps * G, min_blocks(tf32_blocks(Dp), G))
attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int heads, int seq_len, int head_dim,
                          Strides sq, Strides sk, Strides sv, Strides so, int unit_k,
                          int unit_v, float scale_log2) {
  if constexpr (Wide) head_dim = Dp;   // a Wide head fills its staged width
  constexpr int kRawTile = G * kTcTile * Tf32Tile<Dp>::kRaw;   // 16-byte chunks
  constexpr int kPart = G * kTcTile * Tf32Tile<Dp>::kWords;    // words per part
  // G heads' raw K tile, their raw V tile, then the K hi, K lo, V hi and V
  // lo parts of the tile the warps work on
  extern __shared__ float4 tf32_tiles[];
  uint4* k_raw = reinterpret_cast<uint4*>(tf32_tiles);
  uint4* v_raw = k_raw + kRawTile;
  uint32_t* parts = reinterpret_cast<uint32_t*>(v_raw + kRawTile);

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

  // q's A fragments (rows a, b at channel 8j + tig, then at 8j + tig + 4),
  // scaled to base-2 logits in f32 and split into TF32 hi and lo parts once
  const float* qh = q + b * sq.b + h * sq.h;
  uint32_t qhi[Dp / 8][4], qlo[Dp / 8][4];
#pragma unroll
  for (int j = 0; j < Dp / 8; ++j) {
    float qx[4];
    load_a(qh, sq, ra, oka, okb, j, head_dim, qx);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__fmul_rn(qx[i], scale_log2), qhi[j][i], qlo[j][i]);
  }

  const Tf32Lane<Dp> lane_reads;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
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
      fwd_tile_tf32<Dp, FastMath, false>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                         lane_reads, qhi, qlo, keys, t == 0, m, l, acc);
    } else {
      fwd_tile_tf32<Dp, FastMath, true>(head, head + kPart, head + 2 * kPart, head + 3 * kPart,
                                        lane_reads, qhi, qlo, keys, t == 0, m, l, acc);
    }
  }

  const float la = l[0];
  const float lb = l[1];
  float* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) oh[ra * so.t + c * so.d] = acc[n][0] / la;
    if (oka && c + 1 < head_dim) oh[ra * so.t + (c + 1) * so.d] = acc[n][1] / la;
    if (okb && c < head_dim) oh[rb * so.t + c * so.d] = acc[n][2] / lb;
    if (okb && c + 1 < head_dim) oh[rb * so.t + (c + 1) * so.d] = acc[n][3] / lb;
  }
  if (lse != nullptr && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (oka) lse[stat + ra] = m[0] + log2f(la);
    if (okb) lse[stat + rb] = m[1] + log2f(lb);
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
attention_fwd_tc_d8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  attention_fwd_tc_d8_kernel<G, FastMath><<<grid, 32 * kTcWarps * G, 0, stream>>>(
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
attention_fwd_tf32_d8_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
    const cudaError_t err = cudaFuncSetAttribute(attention_fwd_tf32_d8_kernel<G, FastMath>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  attention_fwd_tf32_d8_kernel<G, FastMath><<<grid, 32 * kTcWarps * G, kBytes, stream>>>(
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

}  // namespace d8

// ---------------------------------------------------------------------------
// bf16 at staged widths 16 to 256: the warpgroup-product kernel
// ---------------------------------------------------------------------------
//
// attention_fwd_wgmma_kernel<Dp, FastMath, Tma> replaces, for bf16 heads of 9
// to 256 channels, the Pallas kernels `_attention_kernel_tm` and
// `_attention_kernel` (synt_isic_tpu/ops/pallas/attention.py:28, 58) with
// both knobs and the optional base-2 log-sum-exp.
//   Bound on the H100 at (8, 256/D, 1024, D), the main path's 256 channels
//   in heads of D: the two T x T products are 8.6 GFLOP at every D, 0.0087 ms
//   at 989 TFLOP/s; q, k, v and out are 16.8 MB, 0.005 ms at 3.35 TB/s; the
//   B*H*T^2 exponentials on the special-function units take 0.0321 ms at D 16
//   and 0.0160 at D 32, 0.0080 at 64, 0.0040 at 128, 0.0020 at 256. So the
//   exponentials bound D 16 and 32, the products D 64 and up.
//   Design: one warpgroup (4 warps, 128 threads) per 64 query rows of one
//   head, two of them per block from Dp 32 to 128 (`wgmma_consumers`). The Q
//   tiles and a ring of two stages of 64-key K and V tiles sit in shared
//   memory in the swizzled layout the descriptors read (wgmma.cuh). Where
//   every stride of q, k and v is a multiple of 16 bytes (every dense and
//   (B, T, C) layout) the tiles come by TMA (Tma: one thread starts the
//   copies of tile t + 1 while tile t is used, an mbarrier per stage counts
//   the bytes, the copies zero-fill rows past T and channels past D); any
//   other layout stages by `cp.async` in the largest unit it allows, down to
//   one element. Per tile: S = Q K^T by Dp/16 `wgmma` m64n64k16 (Q and K
//   K-major from shared memory), 32 f32 registers a thread; the online
//   softmax in those registers (the row's max over its 4 lanes, the rescale
//   of m, l and O by one exponential per row, then one MUFU.EX2 per (i, j));
//   P rounded to bf16 pairs in registers is the A fragment of O += P V, 4
//   `wgmma` m64nDpk16 with V's tile read MN-major through the transpose bit.
//   O stays in Dp/2 f32 registers a thread (128 at Dp 256). The key tile
//   stays 64 keys, so the running max moves once per 64 keys as
//   `fast_math_step` says, and the rounding points are the mma.sync
//   template's: exact, l sums the f32 weights and P is rounded to bf16 for
//   P V; fast math, the base-2 logit minus the running max rounded to bf16,
//   its correctly rounded bf16 exponential, l the f32 sum of those bf16
//   weights; the division last. Rows past T are not stored, keys past T get
//   s = -inf on the last tile only. G > 1 runs as G consecutive groups of
//   one head (a block per head).
//   Measured (chip_smoke.py `--wgmma-ablation`, PERF.md): staging K and V by
//   `cp.async` from every thread cost a third of the time at D 64 to 256;
//   TMA took it off. Overlapping a tile's softmax with the previous tile's
//   P V inside a warpgroup (S_t started with P_{t-1} V_{t-1} behind it) gave
//   no measurable gain and is not used.
// warpgroups per block: each owns 64 query rows, all share the K and V
// ring; one at Dp 16, where the exponentials bound the kernel and more
// blocks keep more of them in flight, and at Dp 256, where one block fills
// an SM and (8, 1, 1024, 256) would give 132 SMs 64 blocks of two
template <int Dp>
__host__ __device__ constexpr int wgmma_consumers() { return Dp <= 16 || Dp >= 256 ? 1 : 2; }
template <int Dp>
__host__ __device__ constexpr int wgmma_threads() { return wgmma_consumers<Dp>() * wg::kThreads; }
// blocks per SM for __launch_bounds__: a 128-register cap up to Dp 32, 255
// from Dp 64 on (O's Dp / 2 accumulators, S's 32 and two sets of P's 16)
template <int Dp>
__host__ __device__ constexpr int wgmma_blocks() { return Dp <= 32 ? 512 / wgmma_threads<Dp>() : 1; }

// the Q tiles, two stages of K and V after up to 1 KB of alignment, then the
// TMA route's three mbarriers (Q, the two stages)
template <int Dp>
constexpr int wgmma_shared_bytes() {
  return wg::kAlign + (wgmma_consumers<Dp>() + 4) * wg::Tile<Dp>::kBytes + 3 * 8;
}

// The online softmax of one tile's S (64 rows x 64 keys, register 4 i + c of
// the lane's rows a (c < 2) and b at key 8 i + 2 tig + c % 2) in its
// registers: keys at or past `keys` masked, each row's max over its 4 lanes,
// m and l moved onto it (c[r] the factor O must be rescaled by), P rounded to
// bf16 as the A fragments of the 4 k-steps of 16 keys (k-step kk takes keys
// 16 kk .. 16 kk + 15, registers 8 kk .. 8 kk + 7), l summing this lane's
// weights (f32, or with FastMath the bf16 weights).
template <bool FastMath>
__device__ __forceinline__ void wgmma_softmax(float (&s)[32], int keys, float scale_log2,
                                              float* m, float* l, float* c,
                                              uint32_t (&pa)[4][4]) {
  const int tig = threadIdx.x % 4;
  if (keys < wg::kKeys) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = 8 * i + 2 * tig;
      if (key >= keys) s[4 * i] = s[4 * i + 2] = -INFINITY;
      if (key + 1 >= keys) s[4 * i + 1] = s[4 * i + 3] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // max(s) * scale = max(s * scale) exactly, the scale being positive
    const float mnew = fmaxf(m[r], mx * scale_log2);
    // rescale what was summed under the old max; on the first tile
    // m = -inf, so c = 0 and the zero-initialised state stays zero
    c[r] = mnew > m[r] ? ex2(m[r] - mnew) : 1.f;
    m[r] = mnew;
    l[r] = __fmul_rn(l[r], c[r]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* f = s + 8 * kk + 4 * half;
      if (FastMath) {
        // the shifted base-2 logits rounded to bf16, then their correctly
        // rounded bf16 exponentials
        const uint32_t xa = pack_bf16(fmaf(f[0], scale_log2, -m[0]), fmaf(f[1], scale_log2, -m[0]));
        const uint32_t xb = pack_bf16(fmaf(f[2], scale_log2, -m[1]), fmaf(f[3], scale_log2, -m[1]));
        const uint32_t pa_ = pack_bf16(ex2(lo_f32(xa)), ex2(hi_f32(xa)));
        const uint32_t pb_ = pack_bf16(ex2(lo_f32(xb)), ex2(hi_f32(xb)));
        l[0] += lo_f32(pa_) + hi_f32(pa_);
        l[1] += lo_f32(pb_) + hi_f32(pb_);
        pa[kk][2 * half] = pa_;
        pa[kk][2 * half + 1] = pb_;
      } else {
        const float p[4] = {ex2(fmaf(f[0], scale_log2, -m[0])), ex2(fmaf(f[1], scale_log2, -m[0])),
                            ex2(fmaf(f[2], scale_log2, -m[1])), ex2(fmaf(f[3], scale_log2, -m[1]))};
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        pa[kk][2 * half] = pack_bf16(p[0], p[1]);
        pa[kk][2 * half + 1] = pack_bf16(p[2], p[3]);
      }
    }
  }
}

template <int Dp, bool FastMath, bool Tma>
__global__ void __launch_bounds__(wgmma_threads<Dp>(), wgmma_blocks<Dp>())
attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int heads, int seq_len, int head_dim,
                           Strides sq, Strides sk, Strides sv, Strides so, int unit_q,
                           int unit_k, int unit_v, float scale_log2,
                           const __grid_constant__ wg::TmaMaps maps) {
  constexpr int kBytes = wg::Tile<Dp>::kBytes;
  constexpr int kConsumers = wgmma_consumers<Dp>();
  constexpr int kThreads = wgmma_threads<Dp>();
  extern __shared__ uint8_t wgmma_tiles[];
  uint8_t* q_tiles = wgmma_tiles + (wg::kAlign - smem_addr(wgmma_tiles) % wg::kAlign) % wg::kAlign;
  // stage s of the ring: K at kv_ring + 2 s kBytes, V after it
  uint8_t* kv_ring = q_tiles + kConsumers * kBytes;
  // TMA: the Q tiles' barrier, then one per stage of the ring
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_ring + 4 * kBytes);
  uint64_t* kv_full = q_full + 1;

  const int group = threadIdx.x / wg::kThreads;   // this thread's warpgroup
  const int warp = (threadIdx.x % wg::kThreads) / 32;
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int q0 = (blockIdx.x * kConsumers + group) * wg::kRows;
  const int ra = q0 + warp * 16 + lane / 4;
  const int rb = ra + 8;
  uint8_t* q_tile = q_tiles + group * kBytes;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int tiles = (seq_len + wg::kKeys - 1) / wg::kKeys;
  // the K and V of tile t into stage t % 2: by TMA, thread 0 starting and the
  // stage's barrier counting the bytes; else by `cp.async`, every thread
  const int64_t k_t = sk.t, k_d = sk.d, v_t = sv.t, v_d = sv.d;
  auto load_tile = [&](int t) {
    uint8_t* dst = kv_ring + t % 2 * 2 * kBytes;
    if constexpr (Tma) {
      wg::mbar_expect(kv_full + t % 2, 2 * kBytes);
      wg::tma_tile<bf16, 2 * Dp>(dst, &maps.k, kv_full + t % 2, 0, t * wg::kKeys, h, b);
      wg::tma_tile<bf16, 2 * Dp>(dst + kBytes, &maps.v, kv_full + t % 2, 0, t * wg::kKeys, h, b);
    } else {
      wg::stage<bf16, 2 * Dp>(dst, kb, k_t, k_d, unit_k, t * wg::kKeys, seq_len, 0, head_dim,
                              threadIdx.x, kThreads);
      wg::stage<bf16, 2 * Dp>(dst + kBytes, vb, v_t, v_d, unit_v, t * wg::kKeys, seq_len, 0,
                              head_dim, threadIdx.x, kThreads);
    }
  };
  if constexpr (Tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) wg::mbar_init(q_full + i);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      wg::mbar_expect(q_full, kConsumers * kBytes);
      for (int g = 0; g < kConsumers; ++g) {
        wg::tma_tile<bf16, 2 * Dp>(q_tiles + g * kBytes, &maps.q, q_full, 0,
                                   (blockIdx.x * kConsumers + g) * wg::kRows, h, b);
      }
      load_tile(0);
    }
  } else {
    // each warpgroup stages its own Q tile, all threads the first K and V
    wg::stage<bf16, 2 * Dp>(q_tile, q + b * sq.b + h * sq.h, sq.t, sq.d, unit_q, q0, seq_len, 0,
                            head_dim, threadIdx.x % wg::kThreads, wg::kThreads);
    load_tile(0);
    cp_async_commit();
  }

  const uint32_t q_addr = smem_addr(q_tile);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this lane's partial row sums (rows a and b)
  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    // tile t + 1 streams in while tile t is used, into the stage that tile
    // t - 1 left before the barrier that ended it
    if constexpr (Tma) {
      if (threadIdx.x == 0 && t + 1 < tiles) load_tile(t + 1);
      if (t == 0) wg::mbar_wait(q_full, 0);
      wg::mbar_wait(kv_full + t % 2, (t / 2) & 1);
    } else {
      if (t + 1 < tiles) load_tile(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
      wg::fence_async_shared();
      __syncthreads();
    }
    const uint32_t k_addr = smem_addr(kv_ring + t % 2 * 2 * kBytes);
    const uint32_t v_addr = k_addr + kBytes;

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_operands(s);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      wg::wgmma_ss_n64(s, wg::k_major<Dp>(q_addr, kk), wg::k_major<Dp>(k_addr, kk), kk > 0);
    }
    wg::commit();
    wg::wait_group<0>();
    wg::fence_operands(s);

    // the softmax in S's registers, O onto the tile's max, then O += P V
    float c[2];
    uint32_t pa[4][4];
    wgmma_softmax<FastMath>(s, seq_len - t * wg::kKeys, scale_log2, m, l, c, pa);
#pragma unroll
    for (int n = 0; n < Dp / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * n + 2 * r] = __fmul_rn(acc[4 * n + 2 * r], c[r]);
        acc[4 * n + 2 * r + 1] = __fmul_rn(acc[4 * n + 2 * r + 1], c[r]);
      }
    }
    wg::fence_operands(acc);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::wgmma_pv<Dp>(acc, pa[kk], wg::mn_major<Dp>(v_addr, kk));
    wg::commit();
    wg::wait_group<0>();
    wg::fence_operands(acc);
    wg::fence_operands(pa);
    __syncthreads();       // every warp is done with the stage before it is refilled
  }

  float la = l[0];
  float lb = l[1];
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {   // the row's 4 lanes
    la += __shfl_xor_sync(0xffffffffu, la, x);
    lb += __shfl_xor_sync(0xffffffffu, lb, x);
  }
  const bool oka = ra < seq_len;
  const bool okb = rb < seq_len;
  bf16* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (oka && c < head_dim) oh[ra * so.t + c * so.d] = __float2bfloat16(acc[4 * n] / la);
    if (oka && c + 1 < head_dim) oh[ra * so.t + (c + 1) * so.d] = __float2bfloat16(acc[4 * n + 1] / la);
    if (okb && c < head_dim) oh[rb * so.t + c * so.d] = __float2bfloat16(acc[4 * n + 2] / lb);
    if (okb && c + 1 < head_dim) oh[rb * so.t + (c + 1) * so.d] = __float2bfloat16(acc[4 * n + 3] / lb);
  }
  if (lse != nullptr && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (oka) lse[stat + ra] = m[0] + log2f(la);
    if (okb) lse[stat + rb] = m[1] + log2f(lb);
  }
}

template <int Dp, bool FastMath>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int batch, int heads, int seq_len, int head_dim, const int64_t* st,
                         const int* units, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  constexpr int kBytes = wgmma_shared_bytes<Dp>();
  constexpr int kRows = wgmma_consumers<Dp>() * wg::kRows;
  const dim3 grid((seq_len + kRows - 1) / kRows, heads, batch);
  // TMA where all three tensors have a map, else `cp.async`
  wg::TmaMaps maps = {};
  const bool tma = wg::tensor_map<bf16, 2 * Dp>(&maps.q, q, sq, batch, heads, seq_len, head_dim)
                   && wg::tensor_map<bf16, 2 * Dp>(&maps.k, k, sk, batch, heads, seq_len, head_dim)
                   && wg::tensor_map<bf16, 2 * Dp>(&maps.v, v, sv, batch, heads, seq_len, head_dim);
  auto* kernel = tma ? attention_fwd_wgmma_kernel<Dp, FastMath, true>
                     : attention_fwd_wgmma_kernel<Dp, FastMath, false>;
  const cudaError_t err = allow_shared(kernel, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgmma_threads<Dp>(), kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, heads, seq_len, head_dim, sq, sk, sv, so, units[0], units[1],
      units[2], scale * kLog2e, maps);
  return cudaGetLastError();
}

template <bool FastMath>
cudaError_t launch_wgmma_width(const void* q, const void* k, const void* v, void* o, float* lse,
                               int batch, int heads, int seq_len, int head_dim,
                               const int64_t* st, const int* units, float scale,
                               cudaStream_t s) {
  switch (padded_head_dim(head_dim)) {
    case 16: return launch_wgmma<16, FastMath>(q, k, v, o, lse, batch, heads, seq_len, head_dim, st, units, scale, s);
    case 32: return launch_wgmma<32, FastMath>(q, k, v, o, lse, batch, heads, seq_len, head_dim, st, units, scale, s);
    case 64: return launch_wgmma<64, FastMath>(q, k, v, o, lse, batch, heads, seq_len, head_dim, st, units, scale, s);
    case 128: return launch_wgmma<128, FastMath>(q, k, v, o, lse, batch, heads, seq_len, head_dim, st, units, scale, s);
    case 256: return launch_wgmma<256, FastMath>(q, k, v, o, lse, batch, heads, seq_len, head_dim, st, units, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// heads wider than 64 channels (f32), and than 256 (bf16): the wide kernel
// ---------------------------------------------------------------------------
//
// attention_fwd_wide_kernel<T, NC, FastMath> replaces, for f32 heads of 65
// channels and more and bf16 heads of 257 and more, the Pallas kernels
// `_attention_kernel_tm` and `_attention_kernel`
// (synt_isic_tpu/ops/pallas/attention.py:28, 58), with both knobs and the
// optional base-2 log-sum-exp, at any head_dim (wide.cuh has the layout).
//   Bound on the H100 at (8, 256/D, 1024, D): the two T x T products in f32
//   (three TF32 passes) are 3 x 8.6 GFLOP at every D, 0.052 ms at 494.7
//   TFLOP/s dense TF32, above the 33.6 MB of q, k, v and out (0.010 ms) and
//   the exponentials (0.004 ms at D 128); the same at (4, 1, 1024, 512). So
//   the products bound it.
//   What the earlier wide kernel lost, and what this design does about it:
//   (1) it formed S = Q K^T once per 64-channel chunk of O, 2 or 4 times at
//   D 128 and 256, and took the exponentials as often: here a block of 8
//   warps owns 64 query rows and all of O's channels (up to 64 NC of them,
//   NC = 2, 4 or 8 by D; a wider head runs ceil(D / 64 NC) channel groups of
//   blocks), forms S once per key tile over every channel chunk (the warps of
//   a row group split the tile's 64 keys in halves of 32), takes each (i, j)'s
//   exponential once, and hands P to the warps that own the other channels
//   through a 64 x 64 tile in shared memory; warp w then runs P V for its
//   row group and half w / 4 (32 channels) of every chunk. (2) It read q's
//   fragments from device memory at every k-step of every key tile: here q's
//   rows are staged once per block (scaled to base-2 logits in f32 in place,
//   f32 up to 8 chunks, bf16 up to 16; a wider head's further channels come
//   from device memory). (3) It staged K and V one tile at a time, with no
//   second stage: here K's and V's chunks come through a ring of 3 stages of
//   one chunk (16 KB f32, 8 KB bf16), by TMA where every stride is a
//   multiple of 16 bytes, else by `cp.async`, so copies overlap the products.
//   (4) The products: bf16 on `wgmma` m64n32k16 (warpgroup hf = warps 4 hf
//   to 4 hf + 3 forms S for keys 32 hf to 32 hf + 31 from q's chunk and K's,
//   both K-major in shared memory, and P V for channels 32 hf to 32 hf + 31
//   of each chunk from the P tile, stored as a swizzled chunk, and V's chunk
//   as an MN-major operand; wide.cuh); f32 3xTF32, P V on `mma.sync` with V
//   split into TF32 parts as it is read, S at NC 4 (D 129-256) on TF32
//   `wgmma` m64n32k8 from split copies (q's parts once per block, each K
//   chunk's once per tile, lo beside hi in shared memory), at NC 2 and 8 on
//   `mma.sync`. `wgmma` takes TF32 operands K-major only, so P V would need
//   a transposed split copy of each V chunk; that is not built. Measured
//   (H100 80GB HBM3, 700 W, `chip_smoke.py --kernel-table`, the two in the
//   same turns, medians of 3): S on `wgmma` at (8,1,1024,256) 0.2294 ms
//   against 0.2543 on `mma.sync`; at (8,2,1024,128) (NC 2) 0.2635 against
//   0.2057, the split copies taking the second block an SM; above 256
//   channels they do not fit beside q's chunks.
//   Rounding, as the f32 kernel above (`attention_tf32x3_kernel_order`,
//   `fast_math_kernel_order`): tiles of 64 keys; S in 3xTF32 (lo.hi, hi.lo,
//   hi.hi per k-step; q scaled in f32 before its split); the weights against
//   a running shift, on the first tile the tile's one-pass (hi.hi) max, after
//   a tile whose row sum passes 2^16 the shift plus log2 of that sum; a tile
//   whose row sums would pass 2^40 is done again against the max of its S
//   (the 3xTF32 logits, still in registers: no second pass over K); each
//   tile's P V gathers in its own accumulator, added in f32. Fast math: the
//   one-pass tile max on every tile, bf16(2^bf16(s - m)), P V as P.v_lo +
//   P.v_hi. A row's sums over its keys are the two halves' sums added in
//   f32, half 0 first. bf16 (heads above 256; narrower ones run `wgmma`
//   above): the `wgmma` kernel's rounding, the running max moved on every
//   tile, 2^(s * scale * log2(e) - m), P rounded to bf16 for P V, l the f32
//   sum of the f32 weights (fast math: of the bf16 weights), the division
//   last. Rows past T are not stored, keys past T get s = -inf on the last
//   tile. A block runs one head, so any G is bit-identical to G 1.
//   Registers: O is 64 x 64 NC f32 over 256 threads, 16 NC a thread, beside
//   S's 16 and a chunk's P V 16; NC 2 runs two blocks an SM.
template <typename T, int NC, bool FastMath>
__global__ void __launch_bounds__(wide::kThreads, NC <= 2 ? 2 : 1)
attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int heads, int groups, int seq_len, int head_dim, Strides sq,
                          Strides sk, Strides sv, Strides so, int unit_q, int unit_k, int unit_v,
                          int own_chunks, int tma, float scale_log2,
                          const __grid_constant__ wide::Maps maps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kCB = wide::chunk_bytes<T>();
  extern __shared__ uint8_t wide_fwd_smem[];
  // f32 at NC 4: S on TF32 `wgmma` from split copies, q's lo parts after its
  // chunks, then one chunk for a K chunk's lo parts
  constexpr bool kWgS = kF32 && NC == 4;
  const wide::Smem sm = wide::smem_layout<T>(wide_fwd_smem, kWgS ? 2 * own_chunks + 1 : own_chunks,
                                             1);
  uint8_t* own_lo = sm.own + own_chunks * kCB;
  uint8_t* k_lo = sm.own + 2 * own_chunks * kCB;
  float* xch = sm.xch;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int rg = warp % 4;                  // row group: rows 16 rg .. 16 rg + 15
  const int hf = warp / 4;                  // half of the keys and of each chunk's channels
  const int la = 16 * rg + g;               // the lane's rows la and la + 8 in the block
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y / groups;
  const int group = blockIdx.y % groups;
  const int q0 = blockIdx.x * wide::kRows;
  const int ra = q0 + la;
  const int chunks = (head_dim + wide::kChunk - 1) / wide::kChunk;
  const int c0 = group * NC;                // the block's first chunk of O
  const int nc = min(NC, chunks - c0);
  const int per_tile = chunks + nc;         // K's chunks, then V's of this group
  const int tiles = (seq_len + wide::kTile - 1) / wide::kTile;
  const int total = tiles * per_tile;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;

  const int64_t k_t = sk.t, k_d = sk.d, v_t = sv.t, v_d = sv.d;
  auto load_item = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int t = i / per_tile;
    const int j = i % per_tile;
    const bool is_k = j < chunks;
    const int c = is_k ? j : c0 + j - chunks;
    if (bar != nullptr) wg::mbar_expect(bar, kCB);
    wide::stage_chunk<T>(dst, &maps.m[is_k ? 1 : 2], bar, is_k ? kh : vh, is_k ? k_t : v_t,
                         is_k ? k_d : v_d, is_k ? unit_k : unit_v, wide::kTile * t, seq_len,
                         wide::kChunk * c, head_dim, h, b);
  };
  wide::start<T>(sm, own_chunks, 1, tma, maps, 0, 0, qh, qh, sq, sq, unit_q, unit_q, q0, h, b,
                 seq_len, head_dim, total, load_item);
  if constexpr (kF32) {   // q to base-2 logits in f32, in place, before its split
    if (!tma) cp_async_wait<wide::kStages - 1>();   // the own rows' group
    __syncthreads();
    float* f = reinterpret_cast<float*>(sm.own);
    for (int i = threadIdx.x; i < own_chunks * kCB / 4; i += wide::kThreads) {
      f[i] = __fmul_rn(f[i], scale_log2);
      if constexpr (kWgS) {
        uint32_t hi, lo;
        split_tf32(f[i], hi, lo);
        f[i] = __uint_as_float(hi);
        reinterpret_cast<uint32_t*>(own_lo)[i] = lo;
      }
    }
    if constexpr (kWgS) {
      wg::fence_async_shared();
      __syncthreads();
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;
  }
  // rescale row r's sum and O from the shift m[r] to mnew >= m[r] (on the
  // first tile m = -inf: factor 0, and the zero state stays zero)
  auto shift_to = [&](int r, float mnew) {
    const float f = mnew > m[r] ? ex2(m[r] - mnew) : 1.f;
    m[r] = mnew;
    l[r] = __fmul_rn(l[r], f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[c][n][2 * r] = __fmul_rn(acc[c][n][2 * r], f);
        acc[c][n][2 * r + 1] = __fmul_rn(acc[c][n][2 * r + 1], f);
      }
    }
  };
  int item = 0;
  for (int t = 0; t < tiles; ++t) {
    const int keys = seq_len - t * wide::kTile;
    bool need_max = !kF32 || FastMath || t == 0;
    // S over every chunk: the row group's 16 rows x this half's 32 keys
    float s[4][4], sh[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      sh[i][0] = sh[i][1] = sh[i][2] = sh[i][3] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
      const uint8_t* kc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
      const uint8_t* xs = c < own_chunks ? sm.own + c * kCB : nullptr;
      if constexpr (kWgS) {
        wide::split_chunk(const_cast<uint8_t*>(kc), k_lo);
        wg::fence_async_shared();
        __syncthreads();
        wide::tf32_rows_wg(s, sh, need_max, sm.own + c * kCB, own_lo + c * kCB, kc, k_lo, hf);
      } else if constexpr (kF32) {
        wide::tf32_rows(s, sh, need_max, xs, la, qh, sq, ra, seq_len, head_dim, c, scale_log2,
                        kc, hf);
      } else {
        wide::bf16_rows(s, xs, qh, sq, ra, seq_len, head_dim, c, kc, hf);
      }
    }
    if (keys < wide::kTile) {   // keys past T: s = -inf, weight 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 32 * hf + 8 * i + 2 * tig;
        if (key >= keys) s[i][0] = s[i][2] = sh[i][0] = sh[i][2] = -INFINITY;
        if (key + 1 >= keys) s[i][1] = s[i][3] = sh[i][1] = sh[i][3] = -INFINITY;
      }
    }
    // the row max over this half's keys, over the row's 4 lanes, then both halves
    auto row_max = [&](float (*x)[4], float* mx, float* buf) {
      mx[0] = mx[1] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(x[i][0], x[i][1]));
        mx[1] = fmaxf(mx[1], fmaxf(x[i][2], x[i][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      wide::pair_combine(buf, rg, hf, la, mx, true);
    };
    if (need_max) {
      float mx[2];
      row_max(kF32 ? sh : s, mx, xch);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // bf16: max(s) * scale = max(s * scale) exactly, the scale being positive
        shift_to(r, fmaxf(m[r], kF32 ? mx[r] : mx[r] * scale_log2));
      }
    }
    // P (written to the tile as it is formed, again if the tile is redone;
    // the other warp of the row group reads it after the pair barrier below)
    float lt[2];
    for (;;) {
      lt[0] = lt[1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = kF32 ? __fsub_rn(s[i][e], m[e / 2]) : fmaf(s[i][e], scale_log2, -m[e / 2]);
          if (FastMath) {   // the shifted logit rounded to bf16, its bf16 exponential
            p[e] = __bfloat162float(__float2bfloat16(ex2(__bfloat162float(__float2bfloat16(x)))));
          } else {
            p[e] = ex2(x);
          }
        }
        lt[0] = __fadd_rn(lt[0], __fadd_rn(p[0], p[1]));
        lt[1] = __fadd_rn(lt[1], __fadd_rn(p[2], p[3]));
        // rows la, la + 8 at keys 32 hf + 8 i + 2 tig and + 1
        wide::tile_store<T>(sm.tile, la, 32 * hf + 8 * i + 2 * tig, p, pack_bf16(p[0], p[1]),
                            pack_bf16(p[2], p[3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 1));
        lt[r] = __fadd_rn(lt[r], __shfl_xor_sync(0xffffffffu, lt[r], 2));
      }
      wide::pair_combine(xch + 2 * wide::kRows, rg, hf, la, lt, false);
      if (!kF32 || need_max) break;
      // !(x <= 2^40) also holds for inf and NaN; both warps of the row group
      // hold the same sums, so they decide alike
      const bool wide_sum = !(lt[0] <= 0x1p40f) || !(lt[1] <= 0x1p40f);
      if (!__any_sync(0xffffffffu, wide_sum)) break;
      float mx[2];
      row_max(s, mx, xch + 4 * wide::kRows);
      shift_to(0, fmaxf(m[0], mx[0]));
      shift_to(1, fmaxf(m[1], mx[1]));
      need_max = true;
    }
    l[0] = __fadd_rn(l[0], lt[0]);
    l[1] = __fadd_rn(l[1], lt[1]);
    wide::tile_ready<T>(rg);
    // O += P V over this group's chunks, 32 channels of each a warp
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        const uint8_t* vc = wide::ring_next<T>(item++, total, tma, sm.ring, sm.bars, load_item);
        wide::channels_product<T, FastMath>(acc[c], sm.tile, la, vc, hf);
      }
    }
    if (kF32 && !FastMath) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (lt[r] > 0x1p16f) shift_to(r, __fadd_rn(m[r], __log2f(lt[r])));
      }
    }
  }

  T* oh = o + b * so.b + h * so.h;
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
        if (ch < head_dim) oh[row * so.t + ch * so.d] = wide::from_f32<T>(acc[c][n][2 * r] / l[r]);
        if (ch + 1 < head_dim) {
          oh[row * so.t + (ch + 1) * so.d] = wide::from_f32<T>(acc[c][n][2 * r + 1] / l[r]);
        }
      }
    }
  }
  if (lse != nullptr && group == 0 && hf == 0 && tig == 0) {
    const int64_t stat = (b * heads + h) * seq_len;
    if (ra < seq_len) lse[stat + ra] = m[0] + log2f(l[0]);
    if (ra + 8 < seq_len) lse[stat + ra + 8] = m[1] + log2f(l[1]);
  }
}

template <typename T, int NC, bool FastMath>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                        int batch, int heads, int seq_len, int head_dim, const int64_t* st,
                        const int* units, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  const int chunks = (head_dim + wide::kChunk - 1) / wide::kChunk;
  const int groups = (chunks + NC - 1) / NC;
  const int own = min(chunks, wide::own_max<T>(1));
  // f32 at NC 4 (S on TF32 `wgmma`): q's lo parts and a K chunk's beside q
  const bool wg_s = std::is_same<T, float>::value && NC == 4;
  const int bytes = wide::shared_bytes<T>(wg_s ? 2 * own + 1 : own, 1);
  // TMA where all three tensors have a map, else `cp.async`
  wide::Maps maps = {};
  const bool tma = wide::tensor_map<T>(&maps.m[0], q, sq, batch, heads, seq_len, head_dim)
                   && wide::tensor_map<T>(&maps.m[1], k, sk, batch, heads, seq_len, head_dim)
                   && wide::tensor_map<T>(&maps.m[2], v, sv, batch, heads, seq_len, head_dim);
  auto* kernel = attention_fwd_wide_kernel<T, NC, FastMath>;
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + wide::kRows - 1) / wide::kRows, heads * groups, batch);
  kernel<<<grid, wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, groups, seq_len, head_dim, sq, sk, sv, so, units[0],
      units[1], units[2], own, tma ? 1 : 0, scale * kLog2e, maps);
  return cudaGetLastError();
}

// The wide forward at the head's NC, exact or fast math (no lse with fast
// math); bf16 runs it only above 256 channels, so at NC 8
template <typename T>
cudaError_t launch_wide_math(bool fast_math, const void* q, const void* k, const void* v, void* o,
                             float* lse, int batch, int heads, int seq_len, int head_dim,
                             const int64_t* st, const int* units, float scale, cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    return fast_math ? launch_wide<T, NC, true>(q, k, v, o, nullptr, batch, heads, seq_len,
                                                head_dim, st, units, scale, s)
                     : launch_wide<T, NC, false>(q, k, v, o, lse, batch, heads, seq_len,
                                                 head_dim, st, units, scale, s);
  };
  if constexpr (std::is_same<T, bf16>::value) {
    return run(IntC<8>{});
  } else {
    switch (wide::group_chunks(head_dim)) {
      case 2: return run(IntC<2>{});
      case 4: return run(IntC<4>{});
      default: return run(IntC<8>{});
    }
  }
}

// One launch of the bf16 or the f32 kernel at <Dp, G, FastMath>: each staged
// tensor's unit, the shared memory, the grid, then cudaGetLastError.
template <typename T, int Dp, int G, bool FastMath, bool Wide>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int heads, int seq_len, int head_dim, const int64_t* st, int unit_k,
                   int unit_v, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  const dim3 grid((seq_len + kTcRows - 1) / kTcRows, heads / G, batch);
  constexpr int kThreads = 32 * kTcWarps * G;
  if constexpr (std::is_same<T, bf16>::value) {
    // K and V, double-buffered
    constexpr int kBytes = 4 * G * kTcTile * Bf16Tile<Dp>::kStride * 16;
    auto* kernel = attention_fwd_tc_kernel<Dp, G, FastMath, Wide>;
    const cudaError_t err = allow_shared(kernel, kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, heads, seq_len, head_dim, sq, sk, sv, so, unit_k, unit_v,
        scale * kLog2e);
  } else {
    // raw K and V, and the four parts
    constexpr int kBytes = G * kTcTile * 16 * (2 * Tf32Tile<Dp>::kRaw + 4 * Tf32Tile<Dp>::kStride);
    auto* kernel = attention_fwd_tf32_kernel<Dp, G, FastMath, Wide>;
    const cudaError_t err = allow_shared(kernel, kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, heads, seq_len, head_dim, sq, sk, sv, so, unit_k, unit_v,
        scale * kLog2e);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(bool fast_math, int group, const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch, int heads, int seq_len, int head_dim,
                         const int64_t* st, float scale, cudaStream_t s) {
  if (head_dim < 1) return cudaErrorInvalidValue;
  const int unit_k = stage_unit<T>(k, Strides{st[4], st[5], st[6], st[7]}, head_dim);
  const int unit_v = stage_unit<T>(v, Strides{st[8], st[9], st[10], st[11]}, head_dim);
  // every staged row in 16-byte units and the head at its staged width: the
  // Wide instances, at every G; else the general staging, at G = 1 only
  const bool wide = unit_k == 4 && unit_v == 4 && head_dim == padded_head_dim(head_dim);
  float* stats = fast_math ? nullptr : lse;
  // the warpgroup-product kernel (bf16, 9 to kMaxWgmmaWidth channels) and the
  // wide kernel (f32 above kMaxMmaWidth, bf16 above kMaxWgmmaWidth): one head
  // per block, any layout
  const bool one_head = std::is_same<T, bf16>::value ? head_dim > 8 : head_dim > kMaxMmaWidth;
  if (one_head) {
    if (group != 1) return cudaErrorInvalidValue;
    const int units[3] = {stage_unit<T>(q, Strides{st[0], st[1], st[2], st[3]}, head_dim),
                          unit_k, unit_v};
    if constexpr (std::is_same<T, bf16>::value) {
      if (head_dim <= kMaxWgmmaWidth) {
        return fast_math ? launch_wgmma_width<true>(q, k, v, o, nullptr, batch, heads, seq_len,
                                                    head_dim, st, units, scale, s)
                         : launch_wgmma_width<false>(q, k, v, o, lse, batch, heads, seq_len,
                                                     head_dim, st, units, scale, s);
      }
    }
    return launch_wide_math<T>(fast_math, q, k, v, o, stats, batch, heads, seq_len, head_dim, st,
                               units, scale, s);
  }
  if (!wide && group != 1) return cudaErrorInvalidValue;
  if (wide && head_dim == 8) {   // the head_dim-8 kernels, namespace d8
    if constexpr (std::is_same<T, bf16>::value) {
      return d8::launch_tc_group(group, fast_math, q, k, v, o, lse, batch, heads, seq_len, st,
                                 scale, s);
    } else {
      return d8::launch_tf32_group(group, fast_math, q, k, v, o, lse, batch, heads, seq_len, st,
                                   scale, s);
    }
  }
  return dispatch_width(head_dim, group, [&](auto dp, auto g) {
    constexpr int Dp = decltype(dp)::value;
    constexpr int G = decltype(g)::value;
    // bf16 reaches here at Dp 8 only (head_dim <= 8 in a layout that is not
    // 16-byte rows)
    if constexpr (std::is_same<T, bf16>::value && Dp != 8) {
      return cudaErrorInvalidValue;
    } else {
      if constexpr (Dp != 8) {
        if (wide) {
          return fast_math
              ? launch<T, Dp, G, true, true>(q, k, v, o, stats, batch, heads, seq_len, head_dim,
                                             st, unit_k, unit_v, scale, s)
              : launch<T, Dp, G, false, true>(q, k, v, o, stats, batch, heads, seq_len, head_dim,
                                              st, unit_k, unit_v, scale, s);
        }
      }
      if constexpr (G == 1) {
        return fast_math ? launch<T, Dp, 1, true, false>(q, k, v, o, stats, batch, heads, seq_len,
                                                         head_dim, st, unit_k, unit_v, scale, s)
                         : launch<T, Dp, 1, false, false>(q, k, v, o, stats, batch, heads,
                                                          seq_len, head_dim, st, unit_k, unit_v,
                                                          scale, s);
      }
      return cudaErrorInvalidValue;
    }
  });
}

}  // namespace

// The launch's shape, types and knobs, packed once per checked layout by
// ops/attention.py (`_FwdArgs` there: the same fields in the same order).
// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, (b, h, t, d)
// for q, k, v and out in that order. head_dim: >= 1. heads_per_program:
// the heads one block runs, G' (`block_group`): 1, 2, 4 or 8 with G' * (the
// staged width, 8, 16, 32 or 64) <= 64 on a layout of 16-byte rows, 1 for
// the `wgmma` and wide kernels, and it must divide heads. fast_math: 0 or 1.
struct FwdArgs {
  int64_t strides[16];
  int32_t batch, heads, seq_len, head_dim, dtype, heads_per_program, fast_math;
  float scale;
};

// lse: null, or (exact path only) a contiguous f32 (batch, heads, seq_len)
// output for each row's base-2 log-sum-exp. Returns a cudaError_t; an
// unsupported head_dim, dtype or group, or lse with fast_math, returns
// cudaErrorInvalidValue without launching. Any strides are taken.
extern "C" int attention_fwd(const FwdArgs* a, const void* q, const void* k, const void* v,
                             void* o, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = a->heads_per_program;
  const int batch = a->batch, heads = a->heads, seq_len = a->seq_len;
  if (seq_len <= 0 || batch <= 0 || heads <= 0 || g <= 0 || heads % g != 0)
    return cudaErrorInvalidValue;
  const bool fm = a->fast_math != 0;
  if (fm && lse != nullptr) return cudaErrorInvalidValue;
  if (a->dtype == 0)
    return launch_typed<float>(fm, g, q, k, v, o, lse, batch, heads, seq_len, a->head_dim,
                               a->strides, a->scale, s);
  if (a->dtype == 1)
    return launch_typed<bf16>(fm, g, q, k, v, o, lse, batch, heads, seq_len, a->head_dim,
                              a->strides, a->scale, s);
  return cudaErrorInvalidValue;
}
