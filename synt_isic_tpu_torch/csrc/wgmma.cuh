// Hopper's warpgroup products (`wgmma`) for the bf16 attention forward
// (`attention_fwd_wgmma_kernel` in attention_fwd.cu) and the wide kernels'
// bf16 products (wide.cuh): shared-memory matrix descriptors, the
// 128/64/32-byte swizzled tile layout they read, the staging of rows into it
// (by the Tensor Memory Accelerator, TMA, with an mbarrier, where every
// stride is a multiple of 16 bytes; else by `cp.async`; f32 rows too, for the
// wide kernels' 3xTF32 products), and the products they run.
//
// A staged tile holds 64 rows (queries or keys) of one head at a staged width
// Dp of 16 to 256 bf16 channels (a row of 2 Dp bytes; the wide kernels stage
// 64 channels a tile, 128 bytes in bf16 and 256 in f32). Its rows are lines
// of kLine = min(2 Dp, 128) bytes: at Dp 16 and 32 one line is the whole row (32 or 64 bytes), from Dp
// 64 on a row is Dp / 64 lines, one in each column block of 64 channels, the
// blocks 64 * 128 bytes apart. Within a block, the 16-byte chunk c of row r
// sits at r * kLine + (c ^ swz(r)), the swizzle of CUTLASS's Swizzle<B, 4, 3>
// for B = log2(kLine / 16): the chunk index XOR address bits 7 and up, so the
// 8 rows of a core matrix fall in distinct banks. Such a tile is read as
//   * a K-major operand (Q as A, K as B of S = Q K^T: channels are the k
//     dimension): k-step kk starts 32 kk bytes into its block's lines, 8-row
//     groups 8 * kLine bytes apart (SBO); and as
//   * an MN-major operand through the descriptor's transpose bit (V as B of
//     O += P V, stored [key][channel]: keys are the k dimension): k-step kk
//     starts 16 kk lines down, 8-key groups 8 * kLine bytes apart (SBO), the
//     64-channel column blocks 64 * kLine bytes apart (LBO).
// The tile's base is 1024-byte aligned, so every descriptor's swizzle phase
// is 0. Fragments (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup holds
// rows 16 w + l/4 and 16 w + l/4 + 8 (l the lane); of the f32 accumulator,
// register 4 i + {0, 1} the first row at columns 8 i + 2 (l%4) + {0, 1}, 4 i
// + {2, 3} the second; of the bf16 A fragment from registers, a[0] the first
// row at k 2 (l%4) + {0, 1}, a[1] the second, a[2] and a[3] the same at k + 8:
// the accumulator of S over 16 keys, rounded to bf16 pairs, is P's A fragment.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {
namespace wg {

constexpr int kRows = 64;       // query rows per warpgroup of 128 threads
constexpr int kKeys = 64;       // keys per staged tile
constexpr int kThreads = 128;
constexpr int kAlign = 1024;    // the 128-byte swizzle's repeat

template <int Dp>
struct Tile {
  static constexpr int kLine = 2 * Dp < 128 ? 2 * Dp : 128;   // bytes of a swizzled line
  static constexpr int kBlock = 64 * kLine;                   // bytes of a column block
  static constexpr int kBytes = 64 * 2 * Dp;                  // bytes of the tile
  static constexpr int kSwizzleBits = log2_of(kLine / 16);    // 3, 2 or 1
  // the descriptor's layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kLine == 128 ? 1 : kLine == 64 ? 2 : 3;
};

// the byte offset in a tile of byte b of row r (b < 2 Dp): the 16-byte
// chunk XOR bits 7 and up of the line's offset in its column block (whose
// 64 kLine bytes leave bits 7 to 9 of a block's offset zero)
template <int Dp>
__device__ __forceinline__ int swizzled(int r, int b) {
  using T = Tile<Dp>;
  const int line = r * T::kLine;
  return (b / T::kLine) * T::kBlock + line
         + ((b % T::kLine) ^ (((line >> 7) & ((1 << T::kSwizzleBits) - 1)) << 4));
}

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode; base offset 0
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 | layout << 62;
}

// k-step kk (32 bytes: 16 bf16 or 8 f32 channels) of a K-major tile at
// shared address `tile`
template <int Dp>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  using T = Tile<Dp>;
  const int b = 32 * kk;
  return desc(tile + (b / T::kLine) * T::kBlock + b % T::kLine, 16, 8 * T::kLine, T::kLayout);
}

// k-step kk (16 keys) of an MN-major tile at shared address `tile`
template <int Dp>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  using T = Tile<Dp>;
  return desc(tile + 16 * kk * T::kLine, T::kBlock, 8 * T::kLine, T::kLayout);
}

// Stage rows [r0, r0 + 64) of one head (x: its row 0, channel 0; st, sd its
// row and channel strides) into a swizzled tile of RowBytes-byte rows (the
// layout of Tile<RowBytes / 2>), channels [c0, c0 + RowBytes / sizeof(T)) in
// units of 2^unit_log2 bytes (`stage_unit`: 16, 8 and 4 by `cp.async`, 2
// through a register), channels past head_dim and rows past seq_len zeros, by
// `threads` threads from thread `first` on. A unit lies within one 16-byte
// chunk, which the swizzle moves whole. (The strides come as scalars: a
// kernel's Strides parameter whose address a caller's lambda took would be
// copied to the stack.)
template <typename T, int RowBytes>
__device__ __forceinline__ void stage(uint8_t* tile, const T* x, int64_t st, int64_t sd,
                                      int unit_log2, int r0, int seq_len, int c0, int head_dim,
                                      int first, int threads) {
  constexpr int kRowLog2 = log2_of(RowBytes);
  const int per_row_log2 = kRowLog2 - unit_log2;
  for (int i = first; i < kRows << per_row_log2; i += threads) {
    const int r = i >> per_row_log2;
    const int bb = (i & ((1 << per_row_log2) - 1)) << unit_log2;   // byte within the row
    const int e = c0 + bb / static_cast<int>(sizeof(T));            // the unit's first channel
    uint8_t* dst = tile + swizzled<RowBytes / 2>(r, bb);
    const uint32_t d = smem_addr(dst);
    if (r0 + r < seq_len && e < head_dim) {
      const T* src = x + static_cast<int64_t>(r0 + r) * st + static_cast<int64_t>(e) * sd;
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

// this thread's shared-memory writes (cp.async and plain stores) made visible
// to the async proxy, which the warpgroup products read through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// before the first product of a batch: the registers it reads and writes are
// ready (wgmma.fence), then the products are started, committed as groups and
// waited for until at most N groups are in flight
__device__ __forceinline__ void arrive() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across the
// asynchronous products, and from reusing the registers of an A fragment
// from registers before the product that reads them is waited for (the asm
// statement reads them when it starts the product; the tensor cores read
// them later)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// d (+)= a b, m64n64k16, bf16 in, f32 accumulated: a and b from shared
// memory by descriptor, both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a b, m64n16k16, bf16 in, f32 accumulated: a from registers (the
// k16 A fragment of each warp's 16 rows), b from shared memory by
// descriptor, MN-major (stored [k][n], read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, m64n32k16, bf16 in, f32 accumulated: a from registers (the
// k16 A fragment of each warp's 16 rows), b from shared memory by
// descriptor, MN-major (TransB 1: stored [k][n], read through the transpose
// bit) or K-major (TransB 0)
template <int TransB = 1>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TransB));
}

// d += a b, m64n32k16, bf16 in, f32 accumulated: a and b from shared memory
// by descriptor, a K-major, b K-major (TransB 0) or MN-major (TransB 1)
template <int TransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TransB));
}

// d += a b, m64n64k16, bf16 in, f32 accumulated: a from registers (the
// k16 A fragment of each warp's 16 rows), b from shared memory by
// descriptor, MN-major (stored [k][n], read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, m64n128k16, bf16 in, f32 accumulated: a from registers (the
// k16 A fragment of each warp's 16 rows), b from shared memory by
// descriptor, MN-major (stored [k][n], read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, m64n256k16, bf16 in, f32 accumulated: a from registers (the
// k16 A fragment of each warp's 16 rows), b from shared memory by
// descriptor, MN-major (stored [k][n], read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// TMA: a tile staged by the Tensor Memory Accelerator where every stride of
// a tensor is a multiple of 16 bytes, completion counted on an mbarrier
// ---------------------------------------------------------------------------

// the tensor maps of q, k and v: 4-D (D, T, H, B), a box of one swizzled
// line's channels by 64 rows, in the swizzle the descriptors read
struct TmaMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, and `bytes` more to come from the copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// rows [r0, r0 + 64) of head h of batch b, channels from c0 on, into a
// swizzled tile of RowBytes-byte rows: one copy per column block of 128
// bytes (one for rows of 128 bytes or less), channels past D and rows past T
// zero-filled by the copy
template <typename T, int RowBytes>
__device__ __forceinline__ void tma_tile(uint8_t* tile, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int r0, int h, int b) {
  using L = Tile<RowBytes / 2>;
#pragma unroll
  for (int c = 0; c < RowBytes / L::kLine; ++c) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
                 :: "r"(smem_addr(tile + c * L::kBlock)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(smem_addr(bar)), "r"(c0 + c * L::kLine / static_cast<int>(sizeof(T))),
                    "r"(r0), "r"(h), "r"(b)
                 : "memory");
  }
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime, so that
// nothing links libcuda; null where no encoder is found
inline Encode encoder() {
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  return encode;
}

// The tensor map of one (B, H, T, D) tensor for `tma_tile` into tiles of
// RowBytes-byte rows: false where the layout has no map (an address or a
// stride in bytes not a multiple of 16, channels not contiguous) or no
// encoder is found; the kernel then stages by `cp.async`.
template <typename T, int RowBytes>
bool tensor_map(CUtensorMap* map, const void* x, const Strides& s, int batch, int heads,
                int seq_len, int head_dim) {
  constexpr int64_t kSize = sizeof(T);
  const Encode encode = encoder();
  const uint64_t bytes = static_cast<uint64_t>(s.t * kSize) | static_cast<uint64_t>(s.h * kSize)
                         | static_cast<uint64_t>(s.b * kSize) | reinterpret_cast<uintptr_t>(x);
  if (encode == nullptr || s.d != 1 || bytes % 16 != 0 || s.t <= 0 || s.h <= 0 || s.b <= 0) {
    return false;
  }
  using L = Tile<RowBytes / 2>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t * kSize),
                                 static_cast<cuuint64_t>(s.h * kSize),
                                 static_cast<cuuint64_t>(s.b * kSize)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kLine / kSize), 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::kLine == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::kLine == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, kSize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// d += a b, m64n32k8, tf32 in, f32 accumulated: a and b from shared memory
// by descriptor, both K-major (the only layout TF32 takes)
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// O += P V for one k-step, N = Dp output channels
template <int Dp>
__device__ __forceinline__ void wgmma_pv(float (&d)[Dp / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (Dp == 16) wgmma_rs_n16(d, a, b);
  if constexpr (Dp == 32) wgmma_rs_n32(d, a, b);
  if constexpr (Dp == 64) wgmma_rs_n64(d, a, b);
  if constexpr (Dp == 128) wgmma_rs_n128(d, a, b);
  if constexpr (Dp == 256) wgmma_rs_n256(d, a, b);
}

}  // namespace wg
}  // namespace
