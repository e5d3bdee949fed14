// Spatial self-attention forward, softmax(q k^T / sqrt(D)) v, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_attention_kernel_tm` (token-minor blocks)
// and `_attention_kernel` (token-major blocks) reached through
// `fused_attention` in synt_isic_tpu/ops/pallas/attention.py. One kernel
// serves both layouts: q, k, v and out are each given as a base pointer plus
// (b, h, t, d) element strides, so the UNet's attention block hands over the
// (B, T, C) projection outputs unchanged (the head split is pointer
// arithmetic) and the result lands directly in (B, T, C).
//
// Design. The TPU kernel keeps the whole (T, T) f32 logits tile in VMEM
// (4 MB at T=1024); a Hopper block has at most 227 KB of shared memory, so
// this kernel never forms the tile. One block handles kBlockQ query rows of
// one (batch, head), one thread per row: the thread keeps its q row, an f32
// accumulator of D values, a running max and a running sum in registers, and
// walks the keys in tiles of kBlockK staged (as f32) in shared memory, with
// an online softmax in f32. The sum divides the accumulator at the end.
// No size gate is needed: any T works.
//
// Deviation from the TPU kernel: there the normalised probabilities are cast
// to v's dtype before P.V; here unnormalised f32 weights multiply v and the
// normalisation comes last. Only rounding changes: about 1e-6 in f32 and
// bf16-level in bf16.
//
// Bound on the H100 at the main path's largest call, B=8, H=32, T=1024, D=8:
// 2*2*B*H*T^2*D = 8.6 GFLOP (8.7 us at 989 TFLOP/s bf16) and 16.8 MB moved in
// bf16 (5.0 us at 3.35 TB/s). It also takes B*H*T^2 = 2.7e8 exponentials,
// about 64 us on the special-function units (16 per clock per SM), so with
// D=8 the exponentials, not the products, are the real limit. This version
// runs the dot products on the CUDA cores; tensor-core MMA and a cheaper
// exponential are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kBlockK = 128;  // keys staged in shared memory per tile
constexpr float kLog2e = 1.4426950408889634f;

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

template <int D, typename T>
__global__ void __launch_bounds__(kBlockQ)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq_len,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale_log2) {
  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];

  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlockQ + threadIdx.x;
  const bool active = row < seq_len;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

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

  for (int k0 = 0; k0 < seq_len; k0 += kBlockK) {
    const int n = min(kBlockK, seq_len - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < n * D; i += kBlockQ) {
      const int64_t j = i / D;
      const int64_t d = i % D;
      k_tile[j][d] = to_f32(kb[(k0 + j) * sk.t + d * sk.d]);
      v_tile[j][d] = to_f32(vb[(k0 + j) * sv.t + d * sv.d]);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], k_tile[j][d], s);
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
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][d], acc[d]);
      }
    }
  }

  if (active) {
    const float inv = 1.f / l;
    T* ob = o + b * so.b + h * so.h + row * so.t;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[d * so.d] = from_f32<T>(acc[d] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int seq_len, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_fwd_kernel<D, T><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, sq, sk, sv, so,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, (b, h, t, d)
// for q, k, v and out in that order. Returns a cudaError_t; an unsupported
// head_dim or dtype returns cudaErrorInvalidValue without launching.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int batch, int heads, int seq_len,
                             int head_dim, int dtype, const int64_t* strides,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq_len <= 0 || batch <= 0 || heads <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 8)
    return launch<8, float>(q, k, v, o, batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 8)
    return launch<8, __nv_bfloat16>(q, k, v, o, batch, heads, seq_len, strides, scale, s);
  if (dtype == 0 && head_dim == 4)
    return launch<4, float>(q, k, v, o, batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 4)
    return launch<4, __nv_bfloat16>(q, k, v, o, batch, heads, seq_len, strides, scale, s);
  return cudaErrorInvalidValue;
}
