// Building blocks of the head_dim-8 attention kernels on Hopper's tensor
// cores (`attention_fwd.cu`, `attention_bwd.cu`): `cp.async` staging of
// 16-byte chunks, `ldmatrix` fragments, `mma.sync` products with f32
// accumulation (bf16 operands, or TF32 operands split in two for f32
// accuracy), and the special-function exponential. Fragment layouts are the
// PTX ISA's for m16n8k8 and m16n8k16: lane l holds rows l/4 and l/4 + 8 of a
// 16-row A or C fragment; of a C fragment columns 2(l%4) and +1, of a bf16
// A fragment the same pairs, of a TF32 A fragment (m16n8k8) columns l%4 and
// l%4 + 4, and of a TF32 B fragment rows l%4 and l%4 + 4 of column l/4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t b, h, t, d;
};

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;              // warps per head and block, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;   // rows per block and head
constexpr int kTcTile = 64;              // rows of the other side per staged tile
// blocks per SM at G = 1 (G heads per block: 1/G of them), so that 32 warps
// per SM hide the special-function units' latency; it caps registers at 64
constexpr int kTcBlocksPerSM = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Two 8x8 bf16 matrices from shared memory, their rows addressed by lanes
// 0-7 and 8-15: as stored (each lane gets row lane/4, columns 2(lane%4) and
// +1), or transposed (column lane/4, rows 2(lane%4) and +1).
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c += a b on the tensor cores, bf16 in, f32 accumulated: a 16 x 8 (k8) or
// 16 x 16 (k16) row-major A fragment, an 8 x 8 or 16 x 8 B fragment
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on the tensor cores, TF32 in, f32 accumulated: a 16 x 8 row-major
// A fragment (a[0..3]: rows l/4, l/4 + 8 at column l%4, then both at l%4 + 4)
// and an 8 x 8 B fragment (b[0..1]: rows l%4 and l%4 + 4 of column l/4)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// finite x rounded to TF32 (10 mantissa bits) to nearest, ties away from
// zero, as `cvt.rna.tf32.f32` rounds it: half a TF32 ulp added to the
// magnitude bits, the 13 low bits cleared (two integer instructions, where
// the cvt also tests for inf and NaN, which no operand here is)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x) rounded to nearest, lo = x - hi (exact) with its
// 13 low bits cleared, as the tensor cores read an operand anyway (so the
// compiler drops the clearing where lo goes straight to an mma). lo is under
// 2^-11 |x| and loses under 2^-10 of itself, so hi * hi' + hi * lo' + lo * hi'
// carries the f32 product to about 2^-21 of it (lo * lo' is under 2^-22).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// two f32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// channels (d, d + 1) of one row as a bf16 pair, zeros for a row past the end
__device__ __forceinline__ uint32_t load_pair(const bf16* base, Strides s, int row,
                                              int d, bool ok) {
  if (!ok) return 0u;
  const bf16* p = base + row * s.t + d * s.d;
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[s.d];
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows [r0, r0 + kTcTile) of G heads (from head h0 on, at xb and yb)
// of x and y into xt[g * kTcTile + r] and yt[...], 16 bytes (one row of one
// head) per cp.async, one per thread; rows past seq_len are zeros.
template <int G>
__device__ __forceinline__ void stage_rows(uint4* xt, uint4* yt, const bf16* xb,
                                           const bf16* yb, Strides sx, Strides sy,
                                           int r0, int seq_len) {
  constexpr int kChunks = G * kTcTile;
  static_assert(2 * kChunks == 32 * kTcWarps * G, "one chunk per thread");
  const bool second = threadIdx.x >= kChunks;
  const int c = second ? threadIdx.x - kChunks : threadIdx.x;
  const int64_t gh = c / kTcTile;
  const int row = r0 + c % kTcTile;
  uint4* dst = (second ? yt : xt) + c;
  if (row < seq_len) {
    cp_async16(dst, second ? yb + row * sy.t + gh * sy.h : xb + row * sx.t + gh * sx.h);
  } else {
    *dst = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Stage rows [r0, r0 + kTcTile) of G heads of f32 x and y (from head h0 on,
// at xb and yb) into xt[g * 2 kTcTile + ...] and yt[...]: a row of one head is
// 8 floats, two 16-byte chunks, one chunk of each tensor per thread. Chunk c
// of row j lands at j * 2 + (c ^ ((j >> 2) & 1)) in xt, and likewise in yt if
// SwapY (else at j * 2 + c): the chunk swap of rows 4-7 of every 8 lets the
// reads of a B fragment of the transposed tile (rows n ^ ((n >> 2) & 1) at
// channels l%4 and l%4 + 4, for column n = l/4) hit 32 banks, where two rows 4
// apart would share banks unswizzled. Rows past seq_len are zeros.
template <int G, bool SwapY>
__device__ __forceinline__ void stage_rows_f32(float4* xt, float4* yt, const float* xb,
                                               const float* yb, Strides sx, Strides sy,
                                               int r0, int seq_len) {
  static_assert(2 * kTcTile == 32 * kTcWarps, "one chunk of x and one of y per thread");
  const int c = threadIdx.x;
  const int64_t gh = c / (2 * kTcTile);
  const int row = (c % (2 * kTcTile)) / 2;
  const int half = c % 2;
  const int swapped = gh * 2 * kTcTile + row * 2 + (half ^ ((row >> 2) & 1));
  float4* xd = xt + swapped;
  float4* yd = yt + (SwapY ? swapped : c);
  if (r0 + row < seq_len) {
    cp_async16(xd, xb + (r0 + row) * sx.t + gh * sx.h + 4 * half);
    cp_async16(yd, yb + (r0 + row) * sy.t + gh * sy.h + 4 * half);
  } else {
    *xd = *yd = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Split the staged f32 tile of G heads (raw x and y, 2 kTcTile chunks each per
// head) into TF32 hi and lo parts, chunk for chunk, one chunk of each tensor
// per thread: done once per block and tile, so that no warp splits a staged
// operand in its inner loop.
__device__ __forceinline__ void split_tile(const float4* raw_x, const float4* raw_y,
                                           float4* xhi, float4* xlo, float4* yhi,
                                           float4* ylo) {
  const int c = threadIdx.x;
  const float4 xv = raw_x[c];
  const float4 yv = raw_y[c];
  uint4 h, l;
  split_tf32(xv.x, h.x, l.x);
  split_tf32(xv.y, h.y, l.y);
  split_tf32(xv.z, h.z, l.z);
  split_tf32(xv.w, h.w, l.w);
  reinterpret_cast<uint4*>(xhi)[c] = h;
  reinterpret_cast<uint4*>(xlo)[c] = l;
  split_tf32(yv.x, h.x, l.x);
  split_tf32(yv.y, h.y, l.y);
  split_tf32(yv.z, h.z, l.z);
  split_tf32(yv.w, h.w, l.w);
  reinterpret_cast<uint4*>(yhi)[c] = h;
  reinterpret_cast<uint4*>(ylo)[c] = l;
}

// cp.async stages 16-byte chunks: each row of x (elements of type T) must
// start on 16 bytes with its 8 channels contiguous
template <typename T>
bool rows16(const void* x, const Strides& s) {
  constexpr int64_t n = 16 / sizeof(T);   // elements per 16 bytes
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && s.d == 1 && s.t % n == 0
         && s.h % n == 0 && s.b % n == 0;
}

}  // namespace
