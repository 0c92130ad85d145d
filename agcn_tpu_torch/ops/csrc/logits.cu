// Embedding-attention logits for NVIDIA Hopper (sm_90a).
//
//   S[b,k,v,w] = sum_{t,c} th[b,t,v,k,c] * ph[b,t,w,k,c] / divisor
//
// th, ph (B,T,V,K,Ce) in float or bf16, read through their strides (in
// elements), so the theta and phi views of the fused (B,T,V,2*K*Ce)
// embedding are read where they lie; S (B,K,V,V) in float, the sums in
// fp32.
//
// Replaces the TPU kernel agcn_tpu/ops/pallas/logits_kernel.py _kernel
// (reached through packed_logits and attention_logits_pallas). The TPU
// packs the K subsets' V rows at stride 32 into one 128 x 128 product per
// sample and keeps only its K diagonal V x V blocks: at K = 3, V = 25 that
// computes 16384 sums to keep 1875, and pads the contraction to a
// multiple of 128. Here only the K diagonal blocks are computed, on the
// unpadded contraction X = T * Ce.
//
// What bounds it on an H100: each call must read th and ph once
// (2 * B * T * V * K * Ce values) and write B*K*V*V floats, and do
// 2 * B * K * V * V * X flops: 2 * V / sizeof(type) = 12.5 flops per
// fp32 byte at V = 25, under the fp32 ridge of 20 (67 TFLOP/s outside the
// tensor cores over 3.35 TB/s): bound by bytes, in bf16 the more so.
//
// What the design does about it. Each input value is read from device
// memory once. A block of 128 threads owns one (sample b, subset k, span
// of the contraction): it stages 64 columns of the contraction at a time
// for all V rows of th and ph in shared memory (transposed, so that the
// product reads them as broadcasts) and accumulates a 32 x 32 tile of
// sums (V padded to 32 with zeros) as a 4 x 2 register tile per thread.
// At a served batch B*K is under the 132 SMs, so the contraction is split
// into `splits` spans, chosen by the wrapper from the shapes alone; the
// spans' fp32 partials are then summed by a second kernel in span order.
// No atomics: two calls on the same inputs give bitwise-equal results.
//
// C interface: agcn_logits(...) launches on the given stream of the
// current device and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VP = 32;        // joints, padded: one 32 x 32 tile of sums
constexpr int XC = 64;        // contraction columns staged per chunk
constexpr int LD = VP + 1;    // staged row stride: no bank conflicts
constexpr int THREADS = 128;
constexpr int COLS = 16;      // column groups of 2 (w); 8 row groups of 4 (v)
constexpr int TV = 4, TW = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Strides {
  long long b, t, v, k, c;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
logits_partial_kernel(const T* __restrict__ th, Strides sth,
                      const T* __restrict__ ph, Strides sph,
                      float* __restrict__ out, int B, int K, int V, int Ce,
                      int X, int span, float divisor) {
  __shared__ float th_s[XC * LD];  // th_s[x][v]
  __shared__ float ph_s[XC * LD];  // ph_s[x][w]

  const int s = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tw = tid % COLS;
  const int tv = tid / COLS;
  const T* th_bk = th + b * sth.b + k * sth.k;
  const T* ph_bk = ph + b * sph.b + k * sph.k;
  const int x_lo = s * span;
  const int x_hi = min(X, x_lo + span);

  float acc[TV][TW];
#pragma unroll
  for (int i = 0; i < TV; ++i) {
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[i][j] = 0.f;
  }

  for (int x0 = x_lo; x0 < x_hi; x0 += XC) {
    __syncthreads();  // the previous chunk's product has read th_s/ph_s
    // neighbouring threads take neighbouring columns x = (t, c): along c
    // the inputs are contiguous
    for (int i = tid; i < VP * XC; i += THREADS) {
      const int xl = i % XC;
      const int v = i / XC;
      const int x = x0 + xl;
      float a = 0.f, p = 0.f;
      if (v < V && x < x_hi) {
        const int t = x / Ce;
        const int c = x - t * Ce;
        a = to_f(th_bk[t * sth.t + v * sth.v + c * sth.c]);
        p = to_f(ph_bk[t * sph.t + v * sph.v + c * sph.c]);
      }
      th_s[xl * LD + v] = a;
      ph_s[xl * LD + v] = p;
    }
    __syncthreads();

#pragma unroll 8
    for (int xl = 0; xl < XC; ++xl) {
      float a[TV], p[TW];
#pragma unroll
      for (int i = 0; i < TV; ++i) a[i] = th_s[xl * LD + tv * TV + i];
#pragma unroll
      for (int j = 0; j < TW; ++j) p[j] = ph_s[xl * LD + tw * TW + j];
#pragma unroll
      for (int i = 0; i < TV; ++i) {
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[i][j] = fmaf(a[i], p[j], acc[i][j]);
      }
    }
  }

  // one span: the logits themselves; several: span s's fp32 partial,
  // laid out (splits, B, K, V, V)
  const bool whole = gridDim.x == 1;
  float* dst = out + (((size_t)s * B + b) * K + k) * V * V;
#pragma unroll
  for (int i = 0; i < TV; ++i) {
    const int v = tv * TV + i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int w = tw * TW + j;
      if (w < V) dst[v * V + w] = whole ? acc[i][j] / divisor : acc[i][j];
    }
  }
}

// S = (sum over the spans, in span order) / divisor
__global__ void logits_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int n,
                                     int splits, float divisor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * n + i];
  out[i] = sum / divisor;
}

template <typename T>
cudaError_t launch(const void* th, Strides sth, const void* ph, Strides sph,
                   float* out, float* partial, int B, int K, int V, int Ce,
                   int X, int splits, int span, float divisor,
                   cudaStream_t stream) {
  dim3 grid(splits, K, B);
  logits_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(th), sth, static_cast<const T*>(ph), sph,
      splits == 1 ? out : partial, B, K, V, Ce, X, span, divisor);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = B * K * V * V;
  logits_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, out, n, splits, divisor);
  return cudaGetLastError();
}

}  // namespace

extern "C" int agcn_logits(const void* th, const void* ph, void* out,
                           void* partial, long long th_sb, long long th_st,
                           long long th_sv, long long th_sk, long long th_sc,
                           long long ph_sb, long long ph_st, long long ph_sv,
                           long long ph_sk, long long ph_sc, int B, int Tn,
                           int V, int K, int Ce, int splits, int span,
                           int bf16, float divisor, void* stream) {
  // launches on the caller's current device, which owns `stream`
  if (V < 1 || V > VP || K < 1 || Ce < 1 || Tn < 1 || splits < 1 ||
      span < 1 || (long long)splits * span < (long long)Tn * Ce ||
      (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides sth{th_sb, th_st, th_sv, th_sk, th_sc};
  const Strides sph{ph_sb, ph_st, ph_sv, ph_sk, ph_sc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  const int X = Tn * Ce;
  if (bf16) {
    return (int)launch<__nv_bfloat16>(th, sth, ph, sph, o, p, B, K, V, Ce,
                                      X, splits, span, divisor, s);
  }
  return (int)launch<float>(th, sth, ph, sph, o, p, B, K, V, Ce, X, splits,
                            span, divisor, s);
}
