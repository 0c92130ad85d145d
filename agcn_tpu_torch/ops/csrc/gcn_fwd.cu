// Fused adaptive graph convolution, forward, for NVIDIA Hopper (sm_90a).
//
//   y[b,t,w,o] = sum_k sum_c agg_k[b,t,w,c] * W[k,c,o]
//   agg_k[b,t,w,c] = sum_v x[b,t,v,c] * a1[b,k,v,w]
//
// x (B,T,V,C), a1 (B,K,V,V) with layout a1[b,k,source,dest], W (K,C,Co),
// y (B,T,V,Co); x, W and y share one type (float or bf16), a1 is float or
// x's type. K = 3 spatial subsets.
//
// Replaces two TPU kernels of the JAX package:
//   agcn_tpu/ops/pallas/gcn_fused.py  _fwd_kernel (the per-subset aggregate
//     is rounded to x's type before the projection)  -> round_agg = 1
//   agcn_tpu/ops/pallas/gcn_kernel.py _kernel (the aggregate stays fp32)
//                                                    -> round_agg = 0
// Both accumulate the projection over c and k in fp32 and write y in x's
// type. In fp32 the two are the same function.
//
// What bounds it on an H100: per call it must move
//   (B*T*V*(C+Co) + B*K*V*V + K*C*Co) * sizeof(type)  bytes
// and do 2*B*T*K*V*C*(V+Co) flops. At the AGCN layer shapes with
// C, Co in 64..256 and V = 25 that is 67-211 flops per fp32 byte, above
// the fp32 ridge of 20 (67 TFLOP/s outside the tensor cores over
// 3.35 TB/s): fp32 calls are bound by operations, except the C = 3 entry
// layer (6 flops per byte), which is bound by bytes. In bf16 the bytes
// halve and the peak is the tensor cores' 989 TFLOP/s (ridge 295 flops
// per byte): bytes bound the C = 64 layers, operations the C = 256 ones.
// This kernel does all its math in fp32 on the CUDA cores, so its own
// ceiling is the fp32 rate for both types.
//
// What the design does about it: the aggregate never goes to device
// memory (as on the TPU, where it stayed in VMEM). One block of 128
// threads owns (sample b, 4 frames, 64 output channels). It stages a1[b]
// once, then walks the input channels in chunks of CC: it stages the x
// chunk and the W chunk in shared memory, forms the K aggregates of the
// chunk in shared memory (each thread one (k, t, c) column over all V
// destinations, the a1 row read as float4 broadcasts), and accumulates
// agg_k @ W_k into a 13x4 fp32 register tile per thread. y is written
// once. x is read once per 64-channel output tile. The math runs on the
// CUDA cores in fp32; wgmma/TMA pipelines are later work.
//
// Ragged edges (T not a multiple of 4, C not a multiple of CC, Co not a
// multiple of 64) are masked: staged values beyond the edge are zero and
// stores beyond it are skipped. No padding of T, C or Co is needed in
// device memory.
//
// C interface: agcn_gcn_fwd(...) launches on the given stream of the
// current device and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 3;             // spatial subsets
constexpr int TT = 4;            // frames per block
constexpr int OT = 64;           // output channels per block
constexpr int THREADS = 128;
constexpr int COL_GROUPS = OT / 4;                // 4 columns per thread
constexpr int ROW_GROUPS = THREADS / COL_GROUPS;  // 8

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared-memory layout, in floats, for V joints and an input-channel
// chunk of CC.
template <int V, int CC>
struct Layout {
  static constexpr int VP = (V + 3) / 4 * 4;       // a1 row, float4-padded
  static constexpr int ROWS = TT * V;              // (t, w) output rows
  static constexpr int RM = (ROWS + ROW_GROUPS - 1) / ROW_GROUPS;
  static constexpr int ROWS_P = RM * ROW_GROUPS;   // rows incl. zero pad
  static constexpr int LD = CC + 1;                // agg row stride: no
                                                   // bank conflicts
  static constexpr int A = K * V * VP;             // a_s[K][V][VP]
  static constexpr int X = TT * V * CC;            // x_s[TT][V][CC]
  static constexpr int AGG = (K * ROWS_P * LD + 3) / 4 * 4;  // agg_s[K][ROWS_P][LD]
  static constexpr int W = K * CC * OT;            // w_s[K][CC][OT]
  static constexpr size_t BYTES = sizeof(float) * (A + X + AGG + W);
};

template <typename T, typename TA, int V, int CC>
__global__ void __launch_bounds__(THREADS)
gcn_fwd_kernel(const T* __restrict__ x, const TA* __restrict__ a1,
               const T* __restrict__ w, T* __restrict__ y,
               int Tn, int C, int Co, int round_agg) {
  using L = Layout<V, CC>;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* x_s = a_s + L::A;
  float* agg_s = x_s + L::X;
  float* w_s = agg_s + L::AGG;

  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * OT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // a1[b] once per block, rows zero-padded to VP
  const TA* a_b = a1 + (size_t)b * K * V * V;
  for (int i = tid; i < L::A; i += THREADS) {
    const int col = i % L::VP;
    const int kv = i / L::VP;
    a_s[i] = col < V ? to_f(a_b[kv * V + col]) : 0.f;
  }
  // the pad rows of agg_s are read by the projection but never written
  for (int i = tid; i < K * (L::ROWS_P - L::ROWS) * L::LD; i += THREADS) {
    const int per = (L::ROWS_P - L::ROWS) * L::LD;
    agg_s[((i / per) * L::ROWS_P + L::ROWS) * L::LD + i % per] = 0.f;
  }

  const int cg = tid % COL_GROUPS;
  const int rg = tid / COL_GROUPS;
  float acc[L::RM][4];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const T* x_b = x + (size_t)b * Tn * V * C;
  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk's projection has read agg_s/w_s
    for (int i = tid; i < L::X; i += THREADS) {
      const int c = i % CC;
      const int tv = i / CC;
      const int t = t0 + tv / V;
      float val = 0.f;
      if (t < Tn && c0 + c < C) {
        val = to_f(x_b[((size_t)t * V + tv % V) * C + c0 + c]);
      }
      x_s[i] = val;
    }
    for (int i = tid; i < L::W; i += THREADS) {
      const int o = i % OT;
      const int kc = i / OT;
      const int c = c0 + kc % CC;
      float val = 0.f;
      if (c < C && o0 + o < Co) {
        val = to_f(w[((size_t)(kc / CC) * C + c) * Co + o0 + o]);
      }
      w_s[i] = val;
    }
    __syncthreads();

    // aggregate: agg_s[k][t*V + j][c] = sum_v x_s[t][v][c] * a_s[k][v][j]
    for (int item = tid; item < K * TT * CC; item += THREADS) {
      const int c = item % CC;
      const int t = (item / CC) % TT;
      const int k = item / (CC * TT);
      float s[L::VP];
#pragma unroll
      for (int j = 0; j < L::VP; ++j) s[j] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xv = x_s[(t * V + v) * CC + c];
        const float4* arow =
            reinterpret_cast<const float4*>(a_s + (k * V + v) * L::VP);
#pragma unroll
        for (int q = 0; q < L::VP / 4; ++q) {
          const float4 a4 = arow[q];
          s[4 * q + 0] += xv * a4.x;
          s[4 * q + 1] += xv * a4.y;
          s[4 * q + 2] += xv * a4.z;
          s[4 * q + 3] += xv * a4.w;
        }
      }
      float* dst = agg_s + (k * L::ROWS_P + t * V) * L::LD + c;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // gcn_fused semantics: the aggregate is rounded to x's type
        dst[j * L::LD] = round_agg ? to_f(from_f<T>(s[j])) : s[j];
      }
    }
    __syncthreads();

    // project: acc[row][col] += agg_k[row][c] * W_k[c][col]
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* agg_k = agg_s + (k * L::ROWS_P + rg) * L::LD;
#pragma unroll 4
      for (int c = 0; c < CC; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(
            w_s + (k * CC + c) * OT + cg * 4);
#pragma unroll
        for (int i = 0; i < L::RM; ++i) {
          const float av = agg_k[i * ROW_GROUPS * L::LD + c];
          acc[i][0] += av * wv.x;
          acc[i][1] += av * wv.y;
          acc[i][2] += av * wv.z;
          acc[i][3] += av * wv.w;
        }
      }
    }
  }

  T* y_b = y + (size_t)b * Tn * V * Co;
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int r = rg + i * ROW_GROUPS;
    const int t = t0 + r / V;
    if (r >= L::ROWS || t >= Tn) continue;
    T* dst = y_b + ((size_t)t * V + r % V) * Co + o0 + cg * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (o0 + cg * 4 + j < Co) dst[j] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, typename TA, int V, int CC>
cudaError_t launch(const void* x, const void* a1, const void* w, void* y,
                   int B, int Tn, int C, int Co, int round_agg,
                   cudaStream_t stream) {
  auto kern = gcn_fwd_kernel<T, TA, V, CC>;
  const size_t bytes = Layout<V, CC>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + TT - 1) / TT, (Co + OT - 1) / OT, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const TA*>(a1),
      static_cast<const T*>(w), static_cast<T*>(y), Tn, C, Co, round_agg);
  return cudaGetLastError();
}

template <typename T, typename TA, int V>
cudaError_t launch_cc(const void* x, const void* a1, const void* w, void* y,
                      int B, int Tn, int C, int Co, int round_agg,
                      cudaStream_t stream) {
  // narrow inputs (the C=3 entry layer) take a narrow chunk instead of
  // computing 29 channels of zeros out of 32
  if (C <= 8) {
    return launch<T, TA, V, 8>(x, a1, w, y, B, Tn, C, Co, round_agg, stream);
  }
  return launch<T, TA, V, 32>(x, a1, w, y, B, Tn, C, Co, round_agg, stream);
}

template <typename T, typename TA>
cudaError_t launch_v(const void* x, const void* a1, const void* w, void* y,
                     int B, int Tn, int V, int C, int Co, int round_agg,
                     cudaStream_t stream) {
  switch (V) {  // the joint counts of the AGCN skeletons (NTU, Kinetics)
    case 25:
      return launch_cc<T, TA, 25>(x, a1, w, y, B, Tn, C, Co, round_agg,
                                  stream);
    case 18:
      return launch_cc<T, TA, 18>(x, a1, w, y, B, Tn, C, Co, round_agg,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int agcn_gcn_fwd(const void* x, const void* a1, const void* w,
                            void* y, int B, int Tn, int V, int C, int Co,
                            int x_bf16, int a_bf16, int round_agg,
                            void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !a_bf16) {
    err = launch_v<float, float>(x, a1, w, y, B, Tn, V, C, Co, round_agg, s);
  } else if (x_bf16 && a_bf16) {
    err = launch_v<__nv_bfloat16, __nv_bfloat16>(x, a1, w, y, B, Tn, V, C,
                                                 Co, round_agg, s);
  } else if (x_bf16) {
    err = launch_v<__nv_bfloat16, float>(x, a1, w, y, B, Tn, V, C, Co,
                                         round_agg, s);
  } else {
    err = cudaErrorInvalidValue;  // fp32 x with bf16 a1 is not taken
  }
  return (int)err;
}
