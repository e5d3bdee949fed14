// Spatial self-attention backward, (dq, dk, dv) of softmax(q k^T / sqrt(D)) v,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attention_bwd_kernel` reached through
// `fused_attention_bwd` (and, as the VJP of `fused_attention_trainable`) in
// synt_isic_tpu/ops/pallas/attention.py. As there, the probabilities are
// recomputed from q and k, and no (T, T) tensor reaches device memory. As in
// the forward (`attention_fwd.cu`), every tensor comes as a base pointer plus
// (b, h, t, d) element strides, so the UNet's (B, T, C) projection views go in
// and the gradients land in (B, T, C) views without a copy.
//
// Design. The TPU kernel holds the (T, T) probs, dp and ds of one head in
// VMEM (about 10 MB at T=1024); a Hopper block has at most 227 KB of shared
// memory. So this is the FlashAttention-2 split into two launches, each one
// thread per row, walking the other side in tiles staged (as f32) in shared
// memory. Neither uses atomics, so the result is deterministic.
//   1. dq: one thread per query row i. A first sweep over the keys is the
//      forward's online softmax: it gives the row's log-sum-exp and its f32
//      output o_i, and from them delta_i = do_i . o_i, which equals the TPU
//      kernel's row term rowsum(dp * P) in exact arithmetic (the saved,
//      primal-dtype output is not used, so no bf16 rounding enters delta).
//      A second sweep forms p = exp(s - lse), dp = do_i . v_j and
//      dq_i += p (dp - delta_i) k_j. The row's lse and delta go to an f32
//      scratch of B*H*T each.
//   2. dk, dv: one thread per key row j. It walks the queries with their q,
//      do, lse and delta in shared memory: dv_j += p do_i and
//      dk_j += p (dp - delta_i) q_i.
// Head grouping (`heads_per_program` = G, the TPU kernel's G heads per grid
// program, attention.py:149-151, 158, 190-218): both launches run blocks of
// kBlock * G threads, one per (row, head), and stage the other side's tiles
// of all G heads at once; in the (B, T, C) layout the G * D channels of one
// token are contiguous, so the staging loads are runs of G * D elements
// instead of D. As in the forward (`attention_fwd.cu`), every thread keeps
// exactly the G = 1 arithmetic for its (row, head), key (or query) by key in
// the same order, so dq, dk and dv are bit-identical for every G. The tile
// holds kTile keys, fewer at large G so the f32 tiles stay within 32 KB of
// static shared memory; each key's step depends on no tile boundary, so the
// results do not depend on the tile size.
// Everything is f32 inside whatever the input type. Deviation from the TPU
// kernel: there P is rounded to the primal dtype before dv and ds, and ds
// before dq and dk; here nothing is rounded until the stores. In f32 only the
// order of summation differs; in bf16 the results differ by that rounding.
//
// Bound on the H100 at the training path's largest call, B=8, H=32, T=1024,
// D=8 (scale by B): the five T x T contractions are 10*B*H*T^2*D = 21.5 GFLOP,
// 0.320 ms in f32 on the CUDA cores (67 TFLOP/s) and 0.022 ms in bf16 on the
// tensor cores (989 TFLOP/s); q, k, v, do read once and dq, dk, dv written
// once are 58.7 MB in f32 (0.018 ms at 3.35 TB/s). The B*H*T^2 recomputed
// exponentials take 0.064 ms on the special-function units. This version
// runs everything on the CUDA cores in f32 and recomputes each exponential
// three times (two sweeps in launch 1, one in launch 2), so it sits well
// above that bound; tensor-core MMA (D padded to 16 in registers) and one
// exponential per (i, j) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // rows per block and head, one thread per (row, head)
constexpr float kLog2e = 1.4426950408889634f;

// rows of the other side per staged tile: 128, or fewer so that the two f32
// tiles of G heads stay within 32 KB of static shared memory
template <int D, int G>
struct TileRows {
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

// Stage rows [r0, r0 + n) of G heads of x and y (from head h0 on) as f32:
// tile[r][g * D + d].
template <int D, int G, typename T>
__device__ __forceinline__ void stage(float* xt, float* yt, const T* xb, const T* yb,
                                      Strides sx, Strides sy, int r0, int n) {
  constexpr int kWidth = G * D;
  for (int i = threadIdx.x; i < n * kWidth; i += kBlock * G) {
    const int64_t r = i / kWidth;
    const int64_t c = i % kWidth;
    const int64_t gh = c / D;
    const int64_t d = c % D;
    xt[i] = to_f32(xb[(r0 + r) * sx.t + gh * sx.h + d * sx.d]);
    yt[i] = to_f32(yb[(r0 + r) * sy.t + gh * sy.h + d * sy.d]);
  }
}

// Launch 1: dq, and each query row's base-2 log-sum-exp and delta.
template <int D, typename T, int G>
__global__ void __launch_bounds__(kBlock * G)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ lse,
                        float* __restrict__ delta, int heads, int seq_len,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale, float scale_log2) {
  constexpr int kTile = TileRows<D, G>::value;
  constexpr int kWidth = G * D;  // staged channels per key: G heads of D
  __shared__ float k_tile[kTile][kWidth];
  __shared__ float v_tile[kTile][kWidth];

  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  // this thread's head within the group (0 at compile time for G = 1)
  const int g = G == 1 ? 0 : threadIdx.x / kBlock;
  const int64_t h = h0 + g;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlock
                      + (G == 1 ? threadIdx.x : threadIdx.x % kBlock);
  const bool active = row < seq_len;

  const T* kb = k + b * sk.b + h0 * sk.h;
  const T* vb = v + b * sv.b + h0 * sv.h;

  // logits in base 2: (q . k) * scale * log2(e), so exp(x) becomes exp2(x)
  float qr[D];
  float dor[D];
  {
    const T* qrow = q + b * sq.b + h * sq.h + row * sq.t;
    const T* dorow = dout + b * sdo.b + h * sdo.h + row * sdo.t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = active ? to_f32(qrow[d * sq.d]) * scale_log2 : 0.f;
      dor[d] = active ? to_f32(dorow[d * sdo.d]) : 0.f;
    }
  }

  // sweep 1: online softmax, as in the forward
  float m = -INFINITY;
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kTile) {
    const int n = min(kTile, seq_len - k0);
    __syncthreads();
    stage<D, G>(&k_tile[0][0], &v_tile[0][0], kb, vb, sk, sv, k0, n);
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float* kj = &k_tile[j][g * D];
        const float* vj = &v_tile[j][g * D];
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kj[d], s);
        if (s > m) {
          const float c = exp2f(m - s);
          l *= c;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] *= c;
          m = s;
        }
        const float p = exp2f(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
      }
    }
  }

  float lse2 = 0.f;
  float dl = 0.f;
  if (active) {
    lse2 = m + log2f(l);
#pragma unroll
    for (int d = 0; d < D; ++d) dl = fmaf(dor[d], acc[d], dl);
    dl /= l;  // do . o with o = acc / l
  }

  // sweep 2: dq_i = scale * sum_j p_ij (dp_ij - delta_i) k_j
  float dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dqa[d] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kTile) {
    const int n = min(kTile, seq_len - k0);
    __syncthreads();
    stage<D, G>(&k_tile[0][0], &v_tile[0][0], kb, vb, sk, sv, k0, n);
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float* kj = &k_tile[j][g * D];
        const float* vj = &v_tile[j][g * D];
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kj[d], s);
          dp = fmaf(dor[d], vj[d], dp);
        }
        const float ds = exp2f(s - lse2) * (dp - dl);
#pragma unroll
        for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, kj[d], dqa[d]);
      }
    }
  }

  if (active) {
    T* dqrow = dq + b * sdq.b + h * sdq.h + row * sdq.t;
#pragma unroll
    for (int d = 0; d < D; ++d) dqrow[d * sdq.d] = from_f32<T>(dqa[d] * scale);
    const int64_t r = (b * heads + h) * seq_len + row;
    lse[r] = lse2;
    delta[r] = dl;
  }
}

// Launch 2: dk and dv, one thread per (key row, head).
template <int D, typename T, int G>
__global__ void __launch_bounds__(kBlock * G)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int heads,
                          int seq_len, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, float scale,
                          float scale_log2) {
  constexpr int kTile = TileRows<D, G>::value;
  constexpr int kWidth = G * D;
  __shared__ float q_tile[kTile][kWidth];
  __shared__ float do_tile[kTile][kWidth];
  __shared__ float lse_tile[G][kTile];
  __shared__ float delta_tile[G][kTile];

  const int64_t b = blockIdx.z;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * G;
  // this thread's head within the group (0 at compile time for G = 1)
  const int g = G == 1 ? 0 : threadIdx.x / kBlock;
  const int64_t h = h0 + g;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlock
                      + (G == 1 ? threadIdx.x : threadIdx.x % kBlock);
  const bool active = row < seq_len;

  const T* qb = q + b * sq.b + h0 * sq.h;
  const T* dob = dout + b * sdo.b + h0 * sdo.h;
  const float* lseb = lse + (b * heads + h0) * seq_len;    // G heads' rows follow
  const float* deltab = delta + (b * heads + h0) * seq_len;

  // the key row carries the base-2 logit scale, the staged q rows do not
  float kr[D];
  float vr[D];
  {
    const T* krow = k + b * sk.b + h * sk.h + row * sk.t;
    const T* vrow = v + b * sv.b + h * sv.h + row * sv.t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = active ? to_f32(krow[d * sk.d]) * scale_log2 : 0.f;
      vr[d] = active ? to_f32(vrow[d * sv.d]) : 0.f;
    }
  }

  float dka[D];
  float dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < seq_len; q0 += kTile) {
    const int n = min(kTile, seq_len - q0);
    __syncthreads();
    stage<D, G>(&q_tile[0][0], &do_tile[0][0], qb, dob, sq, sdo, q0, n);
    for (int i = threadIdx.x; i < n * G; i += kBlock * G) {
      const int gh = i / n;
      const int r = i % n;
      lse_tile[gh][r] = lseb[gh * seq_len + q0 + r];
      delta_tile[gh][r] = deltab[gh * seq_len + q0 + r];
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < n; ++i) {
        const float* qi = &q_tile[i][g * D];
        const float* doi = &do_tile[i][g * D];
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qi[d], kr[d], s);
          dp = fmaf(doi[d], vr[d], dp);
        }
        const float p = exp2f(s - lse_tile[g][i]);
        const float ds = p * (dp - delta_tile[g][i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, doi[d], dva[d]);
          dka[d] = fmaf(ds, qi[d], dka[d]);
        }
      }
    }
  }

  if (active) {
    T* dkrow = dk + b * sdk.b + h * sdk.h + row * sdk.t;
    T* dvrow = dv + b * sdv.b + h * sdv.h + row * sdv.t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkrow[d * sdk.d] = from_f32<T>(dka[d] * scale);
      dvrow[d * sdv.d] = from_f32<T>(dva[d]);
    }
  }
}

template <int D, typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* delta, int batch, int heads, int seq_len,
                   const int64_t* st, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sdo{st[12], st[13], st[14], st[15]};
  const Strides sdq{st[16], st[17], st[18], st[19]};
  const Strides sdk{st[20], st[21], st[22], st[23]};
  const Strides sdv{st[24], st[25], st[26], st[27]};
  const dim3 grid((seq_len + kBlock - 1) / kBlock, heads / G, batch);
  const float scale_log2 = scale * kLog2e;
  attention_bwd_dq_kernel<D, T, G><<<grid, kBlock * G, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), lse, delta, heads, seq_len, sq, sk, sv, sdo, sdq,
      scale, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D, T, G><<<grid, kBlock * G, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), lse, delta, heads, seq_len,
      sq, sk, sv, sdo, sdk, sdv, scale, scale_log2);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_group(int group, const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk, void* dv,
                         float* lse, float* delta, int batch, int heads,
                         int seq_len, const int64_t* st, float scale,
                         cudaStream_t s) {
  switch (group) {
    case 1: return launch<D, T, 1>(q, k, v, dout, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 2: return launch<D, T, 2>(q, k, v, dout, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 4: return launch<D, T, 4>(q, k, v, dout, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    case 8: return launch<D, T, 8>(q, k, v, dout, dq, dk, dv, lse, delta, batch, heads, seq_len, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 28 element strides, (b, h, t, d)
// for q, k, v, dout, dq, dk and dv in that order. lse and delta: f32 scratch
// of batch*heads*seq_len each, written by the first launch and read by the
// second. heads_per_program: 1, 2, 4 or 8, and it must divide heads. Returns
// a cudaError_t; an unsupported head_dim, dtype or group returns
// cudaErrorInvalidValue without launching.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* lse, float* delta, int batch, int heads,
                             int seq_len, int head_dim, int dtype,
                             const int64_t* strides, float scale,
                             int heads_per_program, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = heads_per_program;
  if (seq_len <= 0 || batch <= 0 || heads <= 0 || g <= 0 || heads % g != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 8)
    return launch_group<8, float>(g, q, k, v, dout, dq, dk, dv, lse, delta,
                                  batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 8)
    return launch_group<8, __nv_bfloat16>(g, q, k, v, dout, dq, dk, dv, lse,
                                          delta, batch, heads, seq_len,
                                          strides, scale, s);
  if (dtype == 0 && head_dim == 4)
    return launch_group<4, float>(g, q, k, v, dout, dq, dk, dv, lse, delta,
                                  batch, heads, seq_len, strides, scale, s);
  if (dtype == 1 && head_dim == 4)
    return launch_group<4, __nv_bfloat16>(g, q, k, v, dout, dq, dk, dv, lse,
                                          delta, batch, heads, seq_len,
                                          strides, scale, s);
  return cudaErrorInvalidValue;
}
