// Building blocks of the attention kernels on Hopper's tensor cores
// (`attention_fwd.cu`, `attention_bwd.cu`; the wide kernels' own in
// wide.cuh) at every head_dim D >= 1: a head runs at a staged width Dp of 8,
// 16, 32, 64, 128 or 256 channels (above that, in the wide kernels, chunks
// of 64), the least one >= D, its channels past D zero-filled where the
// kernel stages or
// loads them. Zero channels are exact in every product: a zero column of q, k,
// do or v adds an exact 0 to each sum over channels (each TF32 part of a zero
// is zero), and a product that gives channels (P V, dS K, P^T dO, dS^T Q) gives
// its columns past D from zero rows of V, K, dO or Q, never stored.
//
// Here: the staging of rows into shared memory (`cp.async` in units of 16, 8
// or 4 bytes, or a bf16 element at a time through a register; channels past D
// and rows past T zeros), `ldmatrix` fragments, `mma.sync` products with f32
// accumulation (bf16 operands, or TF32 operands split in two for f32
// accuracy), the special-function exponential, and the launchers' dispatch
// over (Dp, G). Fragment layouts are the PTX ISA's for m16n8k8 and m16n8k16:
// lane l holds rows l/4 and l/4 + 8 of a 16-row A or C fragment; of a C
// fragment columns 2(l%4) and +1, of a bf16 A fragment the same pairs, of a
// TF32 A fragment (m16n8k8) columns l%4 and l%4 + 4, and of a TF32 B fragment
// rows l%4 and l%4 + 4 of column l/4. A product over channels (S = Q K^T,
// dP = dO V^T and their transposes) takes Dp/8 k-steps of 8 channels into one
// C fragment; a product that gives channels takes Dp/8 n-tiles of 8 channels,
// each its own C fragment of f32 accumulators, all from the warp's one A
// fragment (P, P^T, dS or dS^T), each with its own B fragment. The `mma.sync`
// templates take Dp up to 64 (kMaxMmaWidth); wider heads run the wide
// kernels (wide.cuh), which split the channels among a block's warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Strides {
  int64_t b, h, t, d;
};

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;              // warps per head and block, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;   // rows per block and head
constexpr int kTcTile = 64;              // rows of the other side per staged tile
constexpr int kMaxWgmmaWidth = 256;      // the widest head of the bf16 `wgmma` forward
constexpr int kMaxMmaWidth = 64;         // the widest staged head of the mma.sync templates
constexpr int kMaxGroupWidth = 64;       // G * Dp at most: D 8 x G 8

// the staged width of a head of head_dim channels
__host__ __device__ constexpr int padded_head_dim(int head_dim) {
  return head_dim <= 8 ? 8 : head_dim <= 16 ? 16 : head_dim <= 32 ? 32 : head_dim <= 64 ? 64
         : head_dim <= 128 ? 128 : 256;
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// __launch_bounds__'s blocks per SM for G heads a block, from `per_sm` at
// G = 1 (the register cap is 65536 / (128 * per_sm) at every G), at least 1
__host__ __device__ constexpr int min_blocks(int per_sm, int g) {
  return per_sm / g > 0 ? per_sm / g : 1;
}

// Row stride of a staged bf16 tile, in 16-byte chunks: a row's Dp/8 chunks,
// and one more where there are several, so that the stride is odd and the 8
// rows an `ldmatrix` reads (16 bytes each) fall in 8 distinct groups of 4
// banks.
template <int Dp>
struct Bf16Tile {
  static constexpr int kStride = Dp == 8 ? 1 : Dp / 8 + 1;
};

// f32 tiles: staged raw with rows of Dp/4 chunks, then split into TF32 parts
// whose rows are Dp + 4 words apart (Dp/4 + 1 chunks), so that both B
// fragment reads of a part (row l/4 at channels l%4 and l%4 + 4; rows 2(l%4)
// and +1 at channel l/4) hit 32 banks.
template <int Dp>
struct Tf32Tile {
  static constexpr int kRaw = Dp / 4;
  static constexpr int kStride = Dp / 4 + 1;
  static constexpr int kWords = 4 * kStride;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Stage rows [r0, r0 + kTcTile) of G heads of x (xb: the first head's rows)
// into tile: row r of head g at 16-byte chunk (g * kTcTile + r) * Stride, its
// channels [0, head_dim) from x in units of 2^unit_log2 bytes (`stage_unit`),
// channels [head_dim, Dp) and rows past seq_len zeros. A unit lies wholly
// inside or outside the head (it divides head_dim * sizeof(T)); above one
// element, the channels are contiguous. Units of 16, 8 and 4 bytes go by
// `cp.async`, a bf16 element through a register. The block's threads take
// the units from `first` on, one thread's stride apart. Wide (a head at its
// staged width, every unit 16 bytes: every dense and (B, T, C) layout at
// head_dim 16, 32 or 64) takes a loop whose bounds the compiler knows; else
// one general loop serves every unit (a uniform branch at the copy).
template <typename T, int Dp, int G, int Stride, bool Wide>
__device__ __forceinline__ void stage(uint4* tile, const T* xb, const Strides& s, int unit_log2,
                                      int r0, int seq_len, int head_dim, int first) {
  constexpr int kRowLog2 = log2_of(Dp * static_cast<int>(sizeof(T)));
  constexpr int kElemLog2 = sizeof(T) == 2 ? 1 : 2;
  constexpr int kThreads = 32 * kTcWarps * G;
  if constexpr (Wide) {
    constexpr int kPerRow = (1 << kRowLog2) / 16;        // 16-byte units per row
    constexpr int kElems = 16 / static_cast<int>(sizeof(T));
    for (int i = first; i < G * kTcTile * kPerRow; i += kThreads) {
      const int rh = i / kPerRow;
      const int e = (i % kPerRow) * kElems;
      const int row = r0 + rh % kTcTile;
      uint4* dst = tile + rh * Stride + i % kPerRow;
      if (row < seq_len && e < head_dim) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(dst)), "l"(xb + row * s.t + (rh / kTcTile) * s.h + e));
      } else {
        *dst = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const int per_row_log2 = kRowLog2 - unit_log2;       // units per row of a head
    const int units = (G * kTcTile) << per_row_log2;
    for (int i = first; i < units; i += kThreads) {
      const int rh = i >> per_row_log2;                   // g * kTcTile + r
      const int u = i & ((1 << per_row_log2) - 1);
      const int e = u << (unit_log2 - kElemLog2);         // the unit's first channel
      const int row = r0 + rh % kTcTile;
      char* dst = reinterpret_cast<char*>(tile + rh * Stride) + (u << unit_log2);
      const uint32_t d = smem_addr(dst);
      if (row < seq_len && e < head_dim) {
        const T* src = xb + row * s.t + (rh / kTcTile) * s.h + e * s.d;
        switch (unit_log2) {
          case 4:
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
            break;
          case 3:
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d), "l"(src));
            break;
          case 2:
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
            break;
          default:
            *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
        }
      } else {
        switch (unit_log2) {
          case 4: *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u); break;
          case 3: *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u); break;
          case 2: *reinterpret_cast<uint32_t*>(dst) = 0u; break;
          default: *reinterpret_cast<uint16_t*>(dst) = 0;
        }
      }
    }
  }
}

// log2 of the unit a tensor's rows are staged in: the largest of 16, 8 and 4
// bytes that its address, its t, h and b strides and a head's head_dim
// channels are all multiples of, where its channels are contiguous; else one
// element (any strides, a broadcast tensor too).
template <typename T>
int stage_unit(const void* x, const Strides& s, int head_dim) {
  constexpr int64_t kSize = sizeof(T);
  constexpr int kElemLog2 = kSize == 2 ? 1 : 2;
  if (s.d != 1) return kElemLog2;
  const uint64_t bits = reinterpret_cast<uintptr_t>(x) | static_cast<uint64_t>(s.t * kSize)
                        | static_cast<uint64_t>(s.h * kSize) | static_cast<uint64_t>(s.b * kSize)
                        | static_cast<uint64_t>(head_dim * kSize);
  for (int u = 4; u > kElemLog2; --u) {
    if (bits % (1u << u) == 0) return u;
  }
  return kElemLog2;
}

// f(Dp, G) as std::integral_constants for a call's head_dim and G: Dp the
// staged width up to kMaxMmaWidth, G * Dp <= kMaxGroupWidth, G in (1, 2, 4,
// 8); any other call returns cudaErrorInvalidValue without launching
template <int N>
using IntC = std::integral_constant<int, N>;

template <typename F>
cudaError_t dispatch_width(int head_dim, int group, F&& f) {
  if (head_dim < 1 || head_dim > kMaxMmaWidth) return cudaErrorInvalidValue;
  switch (padded_head_dim(head_dim)) {
    case 8:
      switch (group) {
        case 1: return f(IntC<8>{}, IntC<1>{});
        case 2: return f(IntC<8>{}, IntC<2>{});
        case 4: return f(IntC<8>{}, IntC<4>{});
        case 8: return f(IntC<8>{}, IntC<8>{});
      }
      break;
    case 16:
      switch (group) {
        case 1: return f(IntC<16>{}, IntC<1>{});
        case 2: return f(IntC<16>{}, IntC<2>{});
        case 4: return f(IntC<16>{}, IntC<4>{});
      }
      break;
    case 32:
      switch (group) {
        case 1: return f(IntC<32>{}, IntC<1>{});
        case 2: return f(IntC<32>{}, IntC<2>{});
      }
      break;
    case 64:
      if (group == 1) return f(IntC<64>{}, IntC<1>{});
      break;
  }
  return cudaErrorInvalidValue;
}

// One 8x8 bf16 matrix from shared memory, its rows addressed by lanes 0-7,
// as stored (each lane gets row lane/4, columns 2(lane%4) and +1)
__device__ __forceinline__ uint32_t ldsm_x1(const void* p) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(smem_addr(p)));
  return r;
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

// c += a b in 3xTF32 over KS k-steps of 8 channels, term by term: lo.hi over
// every k-step, then hi.lo, then hi.hi (the small terms first). a: the split
// A fragments in registers; b: the B fragment of k-step j at word offsets
// o + 8 j and o + 8 j + 4 of the hi and lo parts (a part's row at channels
// l%4 and l%4 + 4).
template <int KS>
__device__ __forceinline__ void mma3_k(float* c, const uint32_t (*ahi)[4],
                                       const uint32_t (*alo)[4], const uint32_t* bh,
                                       const uint32_t* bl, int o) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t b[2] = {bh[o + 8 * j], bh[o + 8 * j + 4]};
    mma_tf32(c, alo[j], b);
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t b[2] = {bl[o + 8 * j], bl[o + 8 * j + 4]};
    mma_tf32(c, ahi[j], b);
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t b[2] = {bh[o + 8 * j], bh[o + 8 * j + 4]};
    mma_tf32(c, ahi[j], b);
  }
}

// c += a b in 3xTF32 for one 8-row k-step, lo.hi + hi.lo + hi.hi: a's split
// A fragment in registers, b's B fragment at word offsets o0 and o1 of the hi
// and lo parts
__device__ __forceinline__ void mma3(float* c, const uint32_t* ahi, const uint32_t* alo,
                                     const uint32_t* bh, const uint32_t* bl, int o0, int o1) {
  const uint32_t bhi[2] = {bh[o0], bh[o1]};
  const uint32_t blo[2] = {bl[o0], bl[o1]};
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
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

// channels (d, d + 1) of one row as a bf16 pair, zeros for a row past the
// end (ok false) and for channels past the head's head_dim
__device__ __forceinline__ uint32_t load_pair(const bf16* base, Strides s, int row, int d,
                                              bool ok, int head_dim) {
  const bf16* p = base + row * s.t + d * s.d;
  const uint32_t lo = ok && d < head_dim ? __bfloat16_as_ushort(p[0]) : 0u;
  const uint32_t hi = ok && d + 1 < head_dim ? __bfloat16_as_ushort(p[s.d]) : 0u;
  return lo | (hi << 16);
}

// one f32 channel of one row, zero for a row past the end or a channel past
// head_dim
__device__ __forceinline__ float load_f32(const float* base, Strides s, int row, int d, bool ok,
                                          int head_dim) {
  return ok && d < head_dim ? base[row * s.t + d * s.d] : 0.f;
}

// The values of k-step j's TF32 A fragment of x at rows ra and ra + 8
// (zeros where not ok): channels 8 j + l%4 and 8 j + l%4 + 4, in its order
__device__ __forceinline__ void load_a(const float* xh, Strides s, int ra, bool oka, bool okb,
                                       int j, int head_dim, float* x) {
  const int c = 8 * j + threadIdx.x % 4;
  x[0] = load_f32(xh, s, ra, c, oka, head_dim);
  x[1] = load_f32(xh, s, ra + 8, c, okb, head_dim);
  x[2] = load_f32(xh, s, ra, c + 4, oka, head_dim);
  x[3] = load_f32(xh, s, ra + 8, c + 4, okb, head_dim);
}

// Split the raw f32 tile of G heads (rows of Dp/4 chunks) into its TF32 hi
// and lo parts (rows of Dp/4 + 1 chunks, Tf32Tile), chunk for chunk: done once
// per block and tile, so that no warp splits a staged operand in its inner
// loop.
template <int Dp, int G>
__device__ __forceinline__ void split_tile(const float4* raw, float4* hi, float4* lo) {
  constexpr int kRaw = Tf32Tile<Dp>::kRaw;
  constexpr int kChunks = G * kTcTile * kRaw;
  for (int c = threadIdx.x; c < kChunks; c += 32 * kTcWarps * G) {
    const float4 x = raw[c];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    const int dst = (c / kRaw) * Tf32Tile<Dp>::kStride + c % kRaw;
    reinterpret_cast<uint4*>(hi)[dst] = h;
    reinterpret_cast<uint4*>(lo)[dst] = l;
  }
}

// Dynamic shared memory of `bytes` for `kernel`, opted in above 48 KB
template <typename K>
cudaError_t allow_shared(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The head_dim-8 kernels of `attention_fwd.cu` and `attention_bwd.cu` at
// full width (namespace d8): their staging of 16-byte rows and loads.
namespace d8 {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
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

}  // namespace d8

}  // namespace
