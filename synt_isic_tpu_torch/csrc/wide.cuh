// Building blocks of the wide attention kernels (`attention_fwd_wide_kernel`
// in attention_fwd.cu, `attention_bwd_{dq,dkdv}_wide_kernel` in
// attention_bwd.cu), which take every head_dim D above 64 (and the bf16
// forward above 256): a block of 8 warps owns 64 rows of one head and forms
// S = X Y^T (and dP) once per tile of 64 rows of the other side for all of
// the head's channels, then splits the channels of the product that gives
// channels among its warps.
//
// Channels go in chunks of 64 (kChunk). A chunk of 64 rows is staged in
// shared memory as 128-byte lines in the 128-byte swizzle TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B): a block of 64 rows x 128 bytes (8 KB; a
// bf16 chunk is one block, an f32 chunk two, channels 0-31 and 32-63), the
// 16-byte unit u of row r at r * 128 + 16 (u ^ (r % 8)). Both routes fill
// that layout: TMA (one thread, completion on an mbarrier) where every
// stride of the tensor is a multiple of 16 bytes, else `cp.async` from every
// thread in the unit `stage_unit` picks (16, 8 or 4 bytes, or a bf16 element
// through a register); rows past T and channels past D are zeros either way.
//
// A block stages its own rows (q; q and dO; k and v) once, up to own_max
// chunks a tensor (`own_max`), and reads the channels of a wider head from
// device memory; the other side's chunks come through a ring of kStages
// stages, one chunk a stage, in the order the block uses them (its `load_item`
// function maps an item number to a tensor, a tile and a chunk), the next
// kStages - 1 in flight while one is used. Warp w covers rows 16 (w % 4) to
// 16 (w % 4) + 15 (its row group) and half w / 4 of the other side's 64 rows
// in a product over channels, half w / 4 (32 channels) of each chunk in a
// product that gives channels. The P or dS tile of 64 x 64 goes through
// shared memory to the warps that own the other half of its columns.
//
// f32 runs 3xTF32 on `mma.sync` (m16n8k8 .tf32, g = lane / 4, t = lane % 4):
// the two warps of a row group meet at a named barrier of 64 threads to
// combine their halves' row statistics and to hand over the P or dS tile of
// their rows (rows kP32 words apart). A row group's rows 16 w' + g and + 8
// share r % 8 = g, so an A fragment's words (channels 8 j + t and + 4) and a
// B fragment's (row 8 s + g, the same channels) fall on 32 banks; the B
// fragment of a product that gives channels reads rows 8 s + 2 t and + 1 (the
// k order permuted as the C fragment of S holds P, as in the mma.sync
// templates) at channel 8 n + g, again 32 banks.
//
// bf16 runs on `wgmma` (wgmma.cuh): warps 4 hf to 4 hf + 3 are warpgroup hf,
// whose warp w % 4 holds rows 16 (w % 4) + g and + 8 of a product's 64 rows,
// as in the row groups above, and its m64n32 accumulator holds columns 8 i +
// 2 t and + 1 of half hf in registers 4 i to 4 i + 3, as the four m16n8 C
// fragments of `mma.sync` do. A product over channels is m64n32k16 with both
// operands K-major in shared memory (the own rows' chunk as A, rows 32 hf to
// 32 hf + 31 of the other side's chunk as B; own rows read from device memory
// go in as the A fragment in registers); a product that gives channels takes
// the 64 x 64 tile (stored like a chunk, 128-byte swizzle, K-major) as A and
// channels 32 hf to 32 hf + 31 of the other side's chunk as B through the
// transpose bit (MN-major, 64 bytes into each 128-byte line). Both warpgroups
// write the tile and both read all of it, so it is handed over at a barrier of
// the block, after a proxy fence.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {
namespace wide {

constexpr int kRows = 64;       // own rows per block
constexpr int kTile = 64;       // rows of the other side per tile
constexpr int kChunk = 64;      // channels per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;      // ring stages
constexpr int kBlock = 8192;    // bytes of a swizzled block, 64 rows x 128 bytes
constexpr int kAlign = 1024;    // the 128-byte swizzle's repeat

template <typename T>
__host__ __device__ constexpr int chunk_bytes() { return kRows * kChunk * static_cast<int>(sizeof(T)); }

// bytes of a staged chunk's row: 128 in bf16, 256 in f32
template <typename T>
__host__ __device__ constexpr int row_bytes() { return kChunk * static_cast<int>(sizeof(T)); }

// the P or dS tile of 64 rows x 64 keys: f32 rows kP32 words apart, bf16 one
// swizzled block, as a chunk
constexpr int kP32 = 68;
template <typename T>
__host__ __device__ constexpr int p_bytes() { return sizeof(T) == 4 ? kRows * kP32 * 4 : kBlock; }

// chunks of a tensor's own rows a block stages, by dtype and the number of
// own tensors (1: q; 2: q and dO, or k and v), within 227 KB beside the ring
// and the tiles
template <typename T>
__host__ __device__ constexpr int own_max(int tensors) {
  return (sizeof(T) == 4 ? 8 : 16) / tensors;
}

// the block's dynamic shared memory: alignment slack, own rows, the ring,
// `tiles` P/dS tiles, the row-statistics exchange (4 x 2 x 64 floats), two
// buffers of two 64-float statistics (the dk/dv launch's lse and delta) and
// the ring's and own rows' mbarriers
template <typename T>
__host__ __device__ constexpr int shared_bytes(int own_chunks, int tiles) {
  return kAlign + (own_chunks + kStages) * chunk_bytes<T>() + tiles * p_bytes<T>() + 2048 + 1024
         + 8 * (kStages + 1);
}

// f32 to the kernel's output type (bf16: rounded to nearest even)
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// chunks of O (or of a gradient) a block covers, NC: 2, 4 or 8 by the
// head's chunks of 64 channels (the dk/dv launch takes at most 4)
inline int group_chunks(int head_dim) {
  const int chunks = (head_dim + kChunk - 1) / kChunk;
  return chunks <= 2 ? 2 : chunks <= 4 ? 4 : 8;
}

// byte offset of byte b (< 128) of row r in a swizzled block
__device__ __forceinline__ int swz(int r, int b) { return r * 128 + (b ^ ((r & 7) << 4)); }

// the tensor maps of a launch's staged tensors (q, k, v; or q, k, v, dO)
struct Maps {
  CUtensorMap m[4];
};

// Stage rows [r0, r0 + 64) and channels [c0, c0 + 64) of one head into a
// swizzled chunk: by TMA (`map`, the bytes counted on `bar`, whose expected
// count the caller sets) where bar is not null, else by `cp.async` from every
// thread (x: the head's row 0, channel 0; st, sd its strides; 2^unit_log2-byte
// units); rows past seq_len and channels past head_dim zeros either way.
template <typename T>
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            const T* x, int64_t st, int64_t sd, int unit_log2,
                                            int r0, int seq_len, int c0, int head_dim, int h,
                                            int b) {
  if (bar != nullptr) {
    wg::tma_tile<T, row_bytes<T>()>(dst, map, bar, c0, r0, h, b);
  } else {
    wg::stage<T, row_bytes<T>()>(dst, x, st, sd, unit_log2, r0, seq_len, c0, head_dim,
                                 threadIdx.x, kThreads);
  }
}

// the tensor map of one (B, H, T, D) tensor for `stage_chunk` (false: none,
// stage by `cp.async`)
template <typename T>
bool tensor_map(CUtensorMap* map, const void* x, const Strides& s, int batch, int heads,
                int seq_len, int head_dim) {
  return wg::tensor_map<T, row_bytes<T>()>(map, x, s, batch, heads, seq_len, head_dim);
}

// The ring: item i (the block's i-th chunk of the other side, in the order
// it uses them) in stage i % kStages. `ring_start` puts items 0 to kStages -
// 2 in flight; `ring_next(i)` returns item i's stage once it has landed for
// every thread, after starting item i + kStages - 1 in the stage that item
// i - 1 left (every thread is past item i - 1 by then). By TMA one thread
// starts each item and stage s's mbarrier counts its bytes (phase (i /
// kStages) & 1); by `cp.async` every thread stages its units of each item, a
// commit group per item, and a __syncthreads makes them visible (bf16 after
// a proxy fence: `wgmma` reads through the async proxy). `load_item(i,
// stage, bar)` stages item i (bar: null on the `cp.async` route). A stage
// holds one chunk of T.
template <typename T, typename Load>
__device__ __forceinline__ void ring_start(int total, bool tma, uint8_t* stages, uint64_t* full,
                                           Load&& load_item) {
  constexpr int stage_bytes = chunk_bytes<T>();
  for (int i = 0; i < kStages - 1; ++i) {
    if (tma) {
      if (threadIdx.x == 0 && i < total) load_item(i, stages + i * stage_bytes, full + i);
    } else {
      if (i < total) load_item(i, stages + i * stage_bytes, nullptr);
      cp_async_commit();
    }
  }
}

template <typename T, typename Load>
__device__ __forceinline__ const uint8_t* ring_next(int i, int total, bool tma, uint8_t* stages,
                                                    uint64_t* full, Load&& load_item) {
  constexpr int stage_bytes = chunk_bytes<T>();
  const int ahead = i + kStages - 1;
  const int s = ahead % kStages;
  if (tma) {
    __syncthreads();
    if (threadIdx.x == 0 && ahead < total) load_item(ahead, stages + s * stage_bytes, full + s);
    wg::mbar_wait(full + i % kStages, (i / kStages) & 1);
  } else {
    cp_async_wait<kStages - 2>();
    if constexpr (!std::is_same<T, float>::value) wg::fence_async_shared();
    __syncthreads();
    if (ahead < total) load_item(ahead, stages + s * stage_bytes, nullptr);
    cp_async_commit();
  }
  return stages + (i % kStages) * stage_bytes;
}

// the two warps of row group rg (warps rg and rg + 4) meet: named barrier
// rg + 1 of 64 threads
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(rg + 1) : "memory");
}

// Combine a per-row statistic of the two warps of a row group (v[0] row a,
// v[1] row b, the same in the row's 4 lanes) through buf[2][64]: both warps
// end with the max, or the f32 sum half 0 + half 1, so with the same bits.
__device__ __forceinline__ void pair_combine(float* buf, int rg, int hf, int la, float* v,
                                             bool max) {
  if (threadIdx.x % 4 == 0) {
    buf[hf * kRows + la] = v[0];
    buf[hf * kRows + la + 8] = v[1];
  }
  pair_sync(rg);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = buf[la + 8 * r];
    const float y = buf[kRows + la + 8 * r];
    v[r] = max ? fmaxf(x, y) : __fadd_rn(x, y);
  }
}

// ---------------------------------------------------------------------------
// f32 (3xTF32 on `mma.sync`)
// ---------------------------------------------------------------------------

// This lane's byte offset in a swizzled f32 chunk of row r (r % 8 = g) at
// channel 8 j + t + 4 e (j the k-step, 0-7; e 0 or 1)
__device__ __forceinline__ int f32_off(int r, int j, int e) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  return (j >> 2) * kBlock + r * 128 + 4 * t + 16 * ((2 * (j & 3) + e) ^ g);
}

// c[s] += X Y^T over one chunk, 3xTF32 per k-step (lo.hi, hi.lo, hi.hi): the
// row group's 16 rows of X (rows la and la + 8 of the swizzled chunk `xs` of
// own rows, or, where xs is null, rows ra, ra + 8 of x from device memory at
// channels from 64 cx on, times `mul` in f32) against the half's 32 rows of
// the chunk `ys` (rows 32 hf + 8 s + g), 4 C fragments; with `hi_only` also
// ch[s] += the one-pass hi.hi product.
__device__ __forceinline__ void tf32_rows(float (*c)[4], float (*ch)[4], bool hi_only,
                                          const uint8_t* xs, int la, const float* x,
                                          Strides sx, int ra, int seq_len, int head_dim,
                                          int cx, float mul, const uint8_t* ys, int hf) {
  const int g = (threadIdx.x % 32) / 4;
#pragma unroll 2
  for (int j = 0; j < 8; ++j) {
    float a[4];
    if (xs != nullptr) {
      a[0] = *reinterpret_cast<const float*>(xs + f32_off(la, j, 0));
      a[1] = *reinterpret_cast<const float*>(xs + f32_off(la + 8, j, 0));
      a[2] = *reinterpret_cast<const float*>(xs + f32_off(la, j, 1));
      a[3] = *reinterpret_cast<const float*>(xs + f32_off(la + 8, j, 1));
    } else {
      load_a(x, sx, ra, ra < seq_len, ra + 8 < seq_len, 8 * cx + j, head_dim, a);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = __fmul_rn(a[i], mul);
    }
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int row = 32 * hf + 8 * s + g;
      uint32_t bhi[2], blo[2];
      split_tf32(*reinterpret_cast<const float*>(ys + f32_off(row, j, 0)), bhi[0], blo[0]);
      split_tf32(*reinterpret_cast<const float*>(ys + f32_off(row, j, 1)), bhi[1], blo[1]);
      mma_tf32(c[s], alo, bhi);
      mma_tf32(c[s], ahi, blo);
      mma_tf32(c[s], ahi, bhi);
      if (hi_only) mma_tf32(ch[s], ahi, bhi);
    }
  }
}

// part[n] += P Y over one chunk for the row group's 16 rows: P (64 columns)
// from the f32 tile `pt` (rows kP32 words apart; the lane's columns 8 s + 2 t
// and + 1 are the A fragment's t and t + 4), Y the chunk `ys` (rows 8 s + 2 t
// and + 1 at channels 32 hf + 8 n + g), 3xTF32 per step (lo.hi, hi.lo,
// hi.hi), or with `bf16_p` (P bf16-valued, exact in TF32, its lo part zero)
// P.y_lo + P.y_hi.
template <bool BF16P>
__device__ __forceinline__ void tf32_channels(float (*part)[4], const float* pt, int la,
                                              const uint8_t* ys, int hf) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  constexpr int kP = kP32;
#pragma unroll 2
  for (int s = 0; s < 8; ++s) {
    const float2 pa = *reinterpret_cast<const float2*>(pt + la * kP + 8 * s + 2 * t);
    const float2 pb = *reinterpret_cast<const float2*>(pt + (la + 8) * kP + 8 * s + 2 * t);
    const float a[4] = {pa.x, pb.x, pa.y, pb.y};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
    const int r0 = 8 * s + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int b = 32 * n + 4 * g;
      uint32_t bhi[2], blo[2];
      split_tf32(*reinterpret_cast<const float*>(ys + hf * kBlock + swz(r0, b)), bhi[0], blo[0]);
      split_tf32(*reinterpret_cast<const float*>(ys + hf * kBlock + swz(r0 + 1, b)), bhi[1],
                 blo[1]);
      if (!BF16P) mma_tf32(part[n], alo, bhi);
      mma_tf32(part[n], ahi, blo);
      mma_tf32(part[n], ahi, bhi);
    }
  }
}

// Split a swizzled f32 chunk into its TF32 parts (`split_tf32`): hi in
// place, lo into `lo` (the same layout), every thread a share; the caller
// fences and syncs.
__device__ __forceinline__ void split_chunk(uint8_t* x, uint8_t* lo) {
  for (int i = threadIdx.x; i < chunk_bytes<float>() / 16; i += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(x)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// c += X Y^T over one chunk on `wgmma` m64n32k8 .tf32 for warpgroup hf, as
// `tf32_rows` sums it (per k-step of 8 channels lo.hi, hi.lo, hi.hi), from
// split chunks (xh, xl: the own rows'; yh, yl: the other side's, rows 32 hf
// on), with `hi_only` also ch += hi.hi
__device__ __forceinline__ void tf32_rows_wg(float (*c)[4], float (*ch)[4], bool hi_only,
                                             const uint8_t* xh, const uint8_t* xl,
                                             const uint8_t* yh, const uint8_t* yl, int hf) {
  float (&d)[16] = *reinterpret_cast<float (*)[16]>(c);
  float (&e)[16] = *reinterpret_cast<float (*)[16]>(ch);
  const uint32_t ah = smem_addr(xh), al = smem_addr(xl);
  const uint32_t bh = smem_addr(yh) + 32 * hf * 128, bl = smem_addr(yl) + 32 * hf * 128;
  wg::fence_operands(d);
  wg::fence_operands(e);
  wg::arrive();
#pragma unroll 1
  for (int kk = 0; kk < 8; ++kk) {
    wg::wgmma_tf32_n32(d, wg::k_major<128>(al, kk), wg::k_major<128>(bh, kk));
    wg::wgmma_tf32_n32(d, wg::k_major<128>(ah, kk), wg::k_major<128>(bl, kk));
    wg::wgmma_tf32_n32(d, wg::k_major<128>(ah, kk), wg::k_major<128>(bh, kk));
    if (hi_only) wg::wgmma_tf32_n32(e, wg::k_major<128>(ah, kk), wg::k_major<128>(bh, kk));
  }
  wg::commit();
  wg::wait_group<0>();
  wg::fence_operands(d);
  wg::fence_operands(e);
}

// ---------------------------------------------------------------------------
// bf16 (`wgmma` m64n32k16, warpgroup hf)
// ---------------------------------------------------------------------------

// c += X Y^T over one chunk: the 64 rows of X (own rows: the swizzled chunk
// `xs`, or where xs is null this warp's rows ra, ra + 8 from device memory at
// channels from 64 cx on, as the A fragment in registers) against rows 32 hf
// to 32 hf + 31 of the chunk `ys`, 4 k-steps of 16 channels; c the m64n32
// accumulator as four m16n8 C fragments.
__device__ __forceinline__ void bf16_rows(float (*c)[4], const uint8_t* xs, const bf16* x,
                                          Strides sx, int ra, int seq_len, int head_dim, int cx,
                                          const uint8_t* ys, int hf) {
  float (&d)[16] = *reinterpret_cast<float (*)[16]>(c);
  const uint32_t y = smem_addr(ys) + 32 * hf * 128;
  if (xs != nullptr) {
    const uint32_t x = smem_addr(xs);
    wg::fence_operands(d);
    wg::arrive();
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      wg::wgmma_ss_n32<0>(d, wg::k_major<64>(x, kk), wg::k_major<64>(y, kk));
    }
    wg::commit();
    wg::wait_group<0>();
    wg::fence_operands(d);
    return;
  }
  // one k-step at a time, so that its A fragment holds 4 registers
  const int ch = 64 * cx + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[1][4] = {{load_pair(x, sx, ra, ch + 16 * kk, ra < seq_len, head_dim),
                         load_pair(x, sx, ra + 8, ch + 16 * kk, ra + 8 < seq_len, head_dim),
                         load_pair(x, sx, ra, ch + 16 * kk + 8, ra < seq_len, head_dim),
                         load_pair(x, sx, ra + 8, ch + 16 * kk + 8, ra + 8 < seq_len, head_dim)}};
    wg::fence_operands(d);
    wg::arrive();
    wg::wgmma_rs_n32<0>(d, a[0], wg::k_major<64>(y, kk));
    wg::commit();
    wg::wait_group<0>();
    wg::fence_operands(d);
    wg::fence_operands(a);
  }
}

// acc += P Y over one chunk: P the 64 x 64 bf16 tile (K-major), Y channels
// 32 hf to 32 hf + 31 of the chunk `ys` (its rows the k dimension), 4
// k-steps of 16 rows of Y.
__device__ __forceinline__ void bf16_channels(float (*acc)[4], const uint8_t* tile,
                                              const uint8_t* ys, int hf) {
  float (&d)[16] = *reinterpret_cast<float (*)[16]>(acc);
  const uint32_t p = smem_addr(tile);
  const uint32_t y = smem_addr(ys) + 64 * hf;
  wg::fence_operands(d);
  wg::arrive();
#pragma unroll 1
  for (int kk = 0; kk < 4; ++kk) {
    wg::wgmma_ss_n32<1>(d, wg::k_major<64>(p, kk), wg::mn_major<64>(y, kk));
  }
  wg::commit();
  wg::wait_group<0>();
  wg::fence_operands(d);
}

// ---------------------------------------------------------------------------
// a block's shared memory, its start, and the steps every wide kernel shares
// ---------------------------------------------------------------------------

// The layout of `shared_bytes`: own rows (own_total chunks: one or two
// tensors), the ring, `tiles` P/dS tiles, the row-statistics exchange (4 x 2
// x 64 floats), the dk/dv launch's statistics (256 floats), the mbarriers
// (the ring's stages, then the own rows')
struct Smem {
  uint8_t* own;
  uint8_t* ring;
  uint8_t* tile;
  float* xch;
  float* stats;
  uint64_t* bars;
};

template <typename T>
__device__ __forceinline__ Smem smem_layout(uint8_t* base, int own_total, int tiles) {
  Smem m;
  m.own = base + (kAlign - smem_addr(base) % kAlign) % kAlign;
  m.ring = m.own + own_total * chunk_bytes<T>();
  m.tile = m.ring + kStages * chunk_bytes<T>();
  m.xch = reinterpret_cast<float*>(m.tile + tiles * p_bytes<T>());
  m.stats = m.xch + 4 * 2 * kRows;
  m.bars = reinterpret_cast<uint64_t*>(m.stats + 256);
  return m;
}

// Stage the block's own rows of `tensors` (1 or 2) tensors, own_chunks
// chunks each (x0, then x1: maps m0, m1, strides s0, s1, units u0, u1; rows
// [r0, r0 + 64) of head h of batch b) and start the ring: by TMA (thread 0,
// the own rows counted on bars[kStages]; returns once they have landed) or
// by `cp.async` (the own rows a commit group ahead of the ring's, which
// `ring_next(0)` waits for).
template <typename T, typename Load>
__device__ __forceinline__ void start(const Smem& sm, int own_chunks, int tensors, bool tma,
                                      const Maps& maps, int m0, int m1, const T* x0, const T* x1,
                                      Strides s0, Strides s1, int u0, int u1, int r0, int h, int b,
                                      int seq_len, int head_dim, int total, Load&& load_item) {
  constexpr int kCB = chunk_bytes<T>();
  if (tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= kStages; ++i) wg::mbar_init(sm.bars + i);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      wg::mbar_expect(sm.bars + kStages, tensors * own_chunks * kCB);
      for (int x = 0; x < tensors; ++x) {
        for (int c = 0; c < own_chunks; ++c) {
          stage_chunk<T>(sm.own + (x * own_chunks + c) * kCB, &maps.m[x == 0 ? m0 : m1],
                         sm.bars + kStages, x0, 0, 0, 0, r0, seq_len, kChunk * c, head_dim, h, b);
        }
      }
    }
    ring_start<T>(total, true, sm.ring, sm.bars, load_item);
    wg::mbar_wait(sm.bars + kStages, 0);
  } else {
    for (int x = 0; x < tensors; ++x) {
      for (int c = 0; c < own_chunks; ++c) {
        stage_chunk<T>(sm.own + (x * own_chunks + c) * kCB, nullptr, nullptr, x == 0 ? x0 : x1,
                       x == 0 ? s0.t : s1.t, x == 0 ? s0.d : s1.d, x == 0 ? u0 : u1, r0, seq_len,
                       kChunk * c, head_dim, h, b);
      }
    }
    cp_async_commit();
    ring_start<T>(total, false, sm.ring, sm.bars, load_item);
  }
}

// Put a C fragment's pairs (rows la, la + 8 at columns col and col + 1) into
// a P/dS tile: f32 as they are (v), bf16 as the packed pairs given (pa, pb)
// at their swizzled places
template <typename T>
__device__ __forceinline__ void tile_store(uint8_t* tile, int la, int col, const float* v,
                                           uint32_t pa, uint32_t pb) {
  if constexpr (std::is_same<T, float>::value) {
    float* pt = reinterpret_cast<float*>(tile);
    constexpr int kP = kP32;
    *reinterpret_cast<float2*>(pt + la * kP + col) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(pt + (la + 8) * kP + col) = make_float2(v[2], v[3]);
  } else {
    *reinterpret_cast<uint32_t*>(tile + swz(la, 2 * col)) = pa;
    *reinterpret_cast<uint32_t*>(tile + swz(la + 8, 2 * col)) = pb;
  }
}

// The P/dS tiles written (this row group's rows by both its warps): f32 at
// the row group's pair barrier (its two warps read only their rows); bf16,
// whose products read all 64 rows through the async proxy, after a proxy
// fence at a barrier of the block
template <typename T>
__device__ __forceinline__ void tile_ready(int rg) {
  if constexpr (std::is_same<T, float>::value) {
    pair_sync(rg);
  } else {
    wg::fence_async_shared();
    __syncthreads();
  }
}

// acc (+)= TILE Y over one chunk for this warp's rows and this half's 32
// channels: f32 into the chunk's own partial sums (the tensor cores' f32
// sums truncate, so a tile's chain stays short), added to acc in f32, with
// BF16P (a tile of bf16-valued weights) by `tf32_channels<true>`; bf16 into
// acc on `wgmma`
template <typename T, bool BF16P = false>
__device__ __forceinline__ void channels_product(float (*acc)[4], const uint8_t* tile, int la,
                                                 const uint8_t* ys, int hf) {
  if constexpr (std::is_same<T, float>::value) {
    float part[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
    tf32_channels<BF16P>(part, reinterpret_cast<const float*>(tile), la, ys, hf);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], part[n][e]);
    }
  } else {
    bf16_channels(acc, tile, ys, hf);
  }
}

}  // namespace wide
}  // namespace
