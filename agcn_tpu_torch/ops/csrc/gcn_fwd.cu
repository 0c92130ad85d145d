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
//
// Two kernels:
//   gcn_fwd_mma_kernel: bf16 x and a1, both round_agg modes, on the tensor
//     cores: round_agg = 1 (the served forward and the dx of training) as
//     SPLIT = false, round_agg = 0 (gcn_kernel's fused_gcn) as SPLIT = true;
//   gcn_fwd_kernel: every other combination (fp32, bf16 x with fp32 a1),
//     all math in fp32 on the CUDA cores, so its ceiling is the fp32 rate
//     for both types.
//
// gcn_fwd_mma_kernel: in bf16 the function is two chained products of
// bf16 operands with fp32 sums, which nvcuda::wmma bf16 16x16x16 does
// with fp32 accumulators. One block of 256 threads (8 warps) owns
// (sample b, 4 frames, 64 output channels); its output rows are (t, w)
// with w padded to 32 per frame, a 128 x 64 tile, and each warp owns
// 32 x 32 of it (2 x 2 fragments). It stages aT_k[w][v] = a1[b,k,v,w]
// once, zero past V, so each aggregate is aT_k . x[t] (M = w, depth v,
// N = c), then walks C in chunks of 32 (16 when C <= 16): the chunk of x
// and of W is staged in shared memory (the next chunk's loads in flight
// in registers during the MMAs); the 12 (k, t) aggregates of the chunk,
// 48 16x16 tiles in a fixed assignment over the warps, go through a
// per-warp fp32 scratch tile, are rounded to bf16 (RN: the rounding
// point of _fwd_kernel, gcn_fused.py:58-60) into agg_s[k][t*32+w][c],
// and the projection adds agg_s[k] . W_k into the warp's fp32 fragments,
// which stay in registers across all chunks.
//
// SPLIT (round_agg = 0, the aggregate kept in fp32 as in _kernel,
// gcn_kernel.py:45-53): each fp32 aggregate value a is split into two
// bf16 parts, hi = bf16_rn(a) into agg_s and lo = bf16_rn(a - hi) into
// agg_lo_s, and the projection adds agg_s[k] . W_k and then
// agg_lo_s[k] . W_k for each 16-deep step. Since W is bf16, hi * W and
// lo * W are exact products, and |a - hi - lo| <= 2^-16 |a| against the
// 2^-9 to which y is rounded; every integer |n| < 2^17 is hi + lo exactly.
// The split doubles the projection's MMAs and adds agg_lo_s (K * 128 rows
// of CC + 8 bf16) to the block's shared memory. To stay within the 128
// registers of two blocks an SM without spilling, SPLIT loads each chunk
// at the top of its own iteration (no loads in flight during the MMAs)
// and keeps the projection's loop over k rolled.
//
// Rows of w >= V come out zero (aT's pad rows are zero); a warp whose
// tile lies past T or Co skips its MMAs. Every sum runs in an order fixed
// by the shapes, with no atomics, so two calls are bitwise equal.
//
// What the design does about it (gcn_fwd_kernel): the aggregate never
// goes to device memory (as on the TPU, where it stayed in VMEM). One
// block of 128
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
#include <mma.h>

#include <cstdint>

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

// ---- bf16 x and a1 on the tensor cores (round_agg = 0 as SPLIT) ----

namespace wmma = nvcuda::wmma;

constexpr int MMA_THREADS = 256;  // 8 warps: 4 along the rows, 2 along Co
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int VP = 32;            // joints padded to two 16-row tiles
constexpr int MMA_ROWS = TT * VP;  // (t, w) output rows of a block: 128
constexpr int A_LD = VP + 8;      // bf16 row stride of aT_s
constexpr int W_LD = OT + 8;      // bf16 row stride of w_s
constexpr int C_LD = OT + 4;      // fp32 row stride of the output tile

// Shared-memory layout, in bytes, for an input-channel chunk of CC; the
// +8 bf16 on each row keeps the fragment loads off one bank. agg_lo_s
// exists only with SPLIT.
template <int CC, bool SPLIT>
struct MmaLayout {
  static constexpr int LD = CC + 8;  // bf16 row stride of x_s and agg_s
  static constexpr int X_OFF = K * VP * A_LD * 2;        // aT_s[K][VP][A_LD]
  static constexpr int W_OFF = X_OFF + TT * VP * LD * 2;  // x_s[TT][VP][LD]
  static constexpr int AGG_OFF = W_OFF + K * CC * W_LD * 2;  // w_s[K][CC][W_LD]
  static constexpr int AGG_BYTES = K * MMA_ROWS * LD * 2;  // agg_s[K][ROWS][LD]
  static constexpr int AGG_LO_OFF = AGG_OFF + AGG_BYTES;
  static constexpr int S_OFF = AGG_LO_OFF + (SPLIT ? AGG_BYTES : 0);  // agg_lo_s
  static constexpr int STAGE = S_OFF + MMA_WARPS * 16 * 16 * 4;  // s_s[warps][16][16]
  static constexpr int OUT = MMA_ROWS * C_LD * 4;  // c_s[ROWS][C_LD], at the end
  static constexpr int BYTES = STAGE > OUT ? STAGE : OUT;
  static constexpr int XV = TT * VP * CC / 8;  // 8-bf16 vectors of a chunk of x
  static constexpr int WV = K * CC * OT / 8;   // and of W
  static constexpr int XR = (XV + MMA_THREADS - 1) / MMA_THREADS;  // per thread
  static constexpr int WR = (WV + MMA_THREADS - 1) / MMA_THREADS;
  static constexpr int TASKS = K * TT * 2 * (CC / 16);  // 16x16 aggregate tiles
  static_assert(X_OFF % 32 == 0 && W_OFF % 32 == 0 && AGG_OFF % 32 == 0 &&
                    AGG_LO_OFF % 32 == 0 && S_OFF % 32 == 0,
                "wmma tiles must start on 256-bit boundaries");
  static_assert(CC % 16 == 0, "chunks are whole 16-deep MMA steps");
};

// 8 bf16 of row `row` of the row-major (rows, n) matrix m from column
// `col` on: zeros for a row that is not `row_ok` or columns past n.
// `vec`: n % 8 == 0 and m 16-byte aligned, so the 8 load as one uint4.
// (The same helper as in gcn_bwd.cu: each source builds alone.)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ m,
                                       size_t row, bool row_ok, int col,
                                       int n, bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || col >= n) return out;
  const __nv_bfloat16* src = m + row * n + col;
  if (vec) return *reinterpret_cast<const uint4*>(src);
  unsigned int h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = col + i < n ? __bfloat16_as_ushort(src[i]) : 0u;
  }
  out.x = h[0] | (h[1] << 16);
  out.y = h[2] | (h[3] << 16);
  out.z = h[4] | (h[5] << 16);
  out.w = h[6] | (h[7] << 16);
  return out;
}

// two floats rounded to bf16 (RN), packed low then high
__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// 8 consecutive floats rounded to bf16 as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const float* __restrict__ src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

// what bf16 rounding leaves of v: v - bf16_rn(v), exact in fp32
__device__ __forceinline__ float residue(float v) {
  return v - __bfloat162float(__float2bfloat16_rn(v));
}

// pack8's twin for the split: the 8 residues, each rounded to bf16 (RN)
__device__ __forceinline__ uint4 pack8_lo(const float* __restrict__ src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  return make_uint4(pack2(residue(lo.x), residue(lo.y)),
                    pack2(residue(lo.z), residue(lo.w)),
                    pack2(residue(hi.x), residue(hi.y)),
                    pack2(residue(hi.z), residue(hi.w)));
}

// Two blocks per SM: registers, not shared memory (~69 KB a block, ~99 KB
// with SPLIT), set the limit. Without the bound ptxas takes 142 registers
// and one block fits; with three (80 registers) it spills, and both ran
// slower on the H100 (PERF.md section 6).
template <int V, int CC, bool SPLIT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
gcn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ a1,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int Tn, int C, int Co,
                   bool x_vec, bool w_vec, bool y_vec) {
  using L = MmaLayout<CC, SPLIT>;
  static_assert(V <= VP, "joints fit one 32-row tile");
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_mma + L::X_OFF);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_mma + L::W_OFF);
  __nv_bfloat16* agg_s =
      reinterpret_cast<__nv_bfloat16*>(smem_mma + L::AGG_OFF);
  __nv_bfloat16* agg_lo_s =
      reinterpret_cast<__nv_bfloat16*>(smem_mma + L::AGG_LO_OFF);
  float* c_s = reinterpret_cast<float*>(smem_mma);  // after the last chunk

  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * OT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = (warp % 4) * VP;  // the warp's 32 rows: frame warp % 4
  const int wo = (warp / 4) * 32;  // and 32 output channels
  // a warp whose tile lies past T or Co has nothing to add
  const bool active = t0 + warp % 4 < Tn && o0 + wo < Co;
  float* scratch = reinterpret_cast<float*>(smem_mma + L::S_OFF) + warp * 256;

  // aT_k[w][v] = a1[b, k, v, w], zero for v >= V or w >= V; w runs
  // fastest so that the reads of a1 coalesce
  const __nv_bfloat16* a_b = a1 + (size_t)b * K * V * V;
  for (int i = tid; i < K * VP * VP; i += MMA_THREADS) {
    const int wd = i % VP;
    const int v = (i / VP) % VP;
    const int k = i / (VP * VP);
    a_s[(k * VP + wd) * A_LD + v] =
        v < V && wd < V ? a_b[(k * V + v) * V + wd]
                        : __ushort_as_bfloat16((unsigned short)0);
  }

  // this thread's vectors of a chunk: x row (t, v) = vi / (CC / 8),
  // W row (k, c) = vi / (OT / 8); 8 channels each
  uint4 x_r[L::XR], w_r[L::WR];
  const size_t x_b = (size_t)b * Tn * V;  // x as a (B*T*V, C) matrix
  auto fetch = [&](int c0) {
#pragma unroll
    for (int j = 0; j < L::XR; ++j) {
      const int vi = tid + j * MMA_THREADS;
      const int t = vi / (CC / 8) / VP;
      const int v = vi / (CC / 8) % VP;
      x_r[j] = load8(x, x_b + (size_t)(t0 + t) * V + v,
                     vi < L::XV && t0 + t < Tn && v < V,
                     c0 + (vi % (CC / 8)) * 8, C, x_vec);
    }
#pragma unroll
    for (int j = 0; j < L::WR; ++j) {
      const int vi = tid + j * MMA_THREADS;
      const int k = vi / (OT / 8) / CC;
      const int c = vi / (OT / 8) % CC;
      w_r[j] = load8(w, (size_t)k * C + c0 + c, vi < L::WV && c0 + c < C,
                     o0 + (vi % (OT / 8)) * 8, Co, w_vec);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  // with SPLIT a chunk's loads are issued at the top of its own
  // iteration, not during the previous chunk's MMAs: the registers that
  // would hold them across the MMAs are what the split needs to stay
  // within 128 without spilling (PERF.md section 6)
  if constexpr (!SPLIT) fetch(0);
  for (int c0 = 0; c0 < C; c0 += CC) {
    if constexpr (SPLIT) fetch(c0);
    __syncthreads();  // the previous chunk's MMAs have read x_s, w_s, agg_s
#pragma unroll
    for (int j = 0; j < L::XR; ++j) {
      const int vi = tid + j * MMA_THREADS;
      if (vi < L::XV) {
        *reinterpret_cast<uint4*>(x_s + (vi / (CC / 8)) * L::LD +
                                  (vi % (CC / 8)) * 8) = x_r[j];
      }
    }
#pragma unroll
    for (int j = 0; j < L::WR; ++j) {
      const int vi = tid + j * MMA_THREADS;
      if (vi < L::WV) {
        *reinterpret_cast<uint4*>(w_s + (vi / (OT / 8)) * W_LD +
                                  (vi % (OT / 8)) * 8) = w_r[j];
      }
    }
    __syncthreads();
    if (!SPLIT && c0 + CC < C) fetch(c0 + CC);  // in flight during the MMAs

    // aggregate: agg_s[k][t*32 + w][c] = bf16(sum_v aT_k[w][v] x_s[t][v][c]),
    // with SPLIT agg_lo_s the same place of what that rounding left
    for (int task = warp; task < L::TASKS; task += MMA_WARPS) {
      const int ni = task % (CC / 16);
      const int mi = task / (CC / 16) % 2;
      const int t = task / (CC / 16 * 2) % TT;
      const int k = task / (CC / 16 * 2 * TT);
      if (t0 + t >= Tn) continue;  // rows past T are never stored
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
      wmma::fill_fragment(f, 0.f);
#pragma unroll
      for (int kk = 0; kk < VP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a_s + (k * VP + 16 * mi) * A_LD + kk,
                               A_LD);
        wmma::load_matrix_sync(fb, x_s + (t * VP + kk) * L::LD + 16 * ni,
                               L::LD);
        wmma::mma_sync(f, fa, fb, f);
      }
      wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
      __syncwarp();
      // lane: row lane / 2 of the tile, columns 8 * (lane % 2) .. +7
      const int at = (k * MMA_ROWS + t * VP + 16 * mi + lane / 2) * L::LD +
                     16 * ni + (lane % 2) * 8;
      const float* src = scratch + (lane / 2) * 16 + (lane % 2) * 8;
      *reinterpret_cast<uint4*>(agg_s + at) = pack8(src);
      if constexpr (SPLIT) {
        *reinterpret_cast<uint4*>(agg_lo_s + at) = pack8_lo(src);
      }
      __syncwarp();  // the scratch tile is free for the warp's next one
    }
    __syncthreads();

    // project: acc += agg_k[rows][c] . W_k[c][cols], summed over k; with
    // SPLIT each step adds the hi parts, then the lo parts on the same W
    // (the k loop rolled, again for the registers)
    if (active) {
#pragma unroll (SPLIT ? 1 : K)
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int kk = 0; kk < CC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(
                fa[i], agg_s + (k * MMA_ROWS + wr + 16 * i) * L::LD + kk,
                L::LD);
            wmma::load_matrix_sync(
                fb[i], w_s + (k * CC + kk) * W_LD + wo + 16 * i, W_LD);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
            }
          }
          if constexpr (SPLIT) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              wmma::load_matrix_sync(
                  fa[i], agg_lo_s + (k * MMA_ROWS + wr + 16 * i) * L::LD + kk,
                  L::LD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
              }
            }
          }
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the staging: c_s takes it
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(c_s + (wr + 16 * i) * C_LD + wo + 16 * j,
                                acc[i][j], C_LD, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  // y rows (t, w) with t < T, w < V, channels o < Co, 8 at a time
  __nv_bfloat16* y_b = y + (size_t)b * Tn * V * Co;
  for (int i = tid; i < MMA_ROWS * (OT / 8); i += MMA_THREADS) {
    const int r = i / (OT / 8);
    const int col = (i % (OT / 8)) * 8;
    const int t = t0 + r / VP;
    const int wd = r % VP;
    if (t >= Tn || wd >= V || o0 + col >= Co) continue;
    const float* src = c_s + r * C_LD + col;
    __nv_bfloat16* dst = y_b + ((size_t)t * V + wd) * Co + o0 + col;
    if (y_vec) {
      *reinterpret_cast<uint4*>(dst) = pack8(src);
    } else {
      for (int q = 0; q < 8 && o0 + col + q < Co; ++q) {
        dst[q] = __float2bfloat16_rn(src[q]);
      }
    }
  }
}

template <int V, int CC, bool SPLIT>
cudaError_t launch_mma(const void* x, const void* a1, const void* w,
                       void* y, int B, int Tn, int C, int Co,
                       cudaStream_t stream) {
  auto kern = gcn_fwd_mma_kernel<V, CC, SPLIT>;
  const int bytes = MmaLayout<CC, SPLIT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  dim3 grid((Tn + TT - 1) / TT, (Co + OT - 1) / OT, B);
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(a1),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      Tn, C, Co, C % 8 == 0 && aligned(x), Co % 8 == 0 && aligned(w),
      Co % 8 == 0 && aligned(y));
  return cudaGetLastError();
}

template <int V, bool SPLIT>
cudaError_t launch_mma_cc(const void* x, const void* a1, const void* w,
                          void* y, int B, int Tn, int C, int Co,
                          cudaStream_t stream) {
  // the C=3 entry layer takes one 16-deep chunk instead of 32
  if (C <= 16) {
    return launch_mma<V, 16, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
  }
  return launch_mma<V, 32, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
}

template <bool SPLIT>
cudaError_t launch_mma_v(const void* x, const void* a1, const void* w,
                         void* y, int B, int Tn, int V, int C, int Co,
                         cudaStream_t stream) {
  switch (V) {
    case 25:
      return launch_mma_cc<25, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
    case 18:
      return launch_mma_cc<18, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
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
  } else if (x_bf16 && a_bf16) {  // tensor cores
    err = round_agg ? launch_mma_v<false>(x, a1, w, y, B, Tn, V, C, Co, s)
                    : launch_mma_v<true>(x, a1, w, y, B, Tn, V, C, Co, s);
  } else if (x_bf16) {
    err = launch_v<__nv_bfloat16, float>(x, a1, w, y, B, Tn, V, C, Co,
                                         round_agg, s);
  } else {
    err = cudaErrorInvalidValue;  // fp32 x with bf16 a1 is not taken
  }
  return (int)err;
}
