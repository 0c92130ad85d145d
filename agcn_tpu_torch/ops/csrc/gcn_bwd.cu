// Fused adaptive graph convolution, weight and adjacency gradients, for
// NVIDIA Hopper (sm_90a).
//
// For y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] * a1[b,k,v,w] * W[k,c,o] and its
// cotangent g (B,T,V,Co):
//
//   dW[k,c,o]    = sum_{b,t,v} x[b,t,v,c] * u_k[b,t,v,o]
//   u_k[b,t,v,o] = sum_w g[b,t,w,o] * a1[b,k,v,w]     rounded to g's type
//   da1[b,k,v,w] = sum_{t,o} p_k[b,t,v,o] * g[b,t,w,o]
//   p_k[b,t,v,o] = sum_c x[b,t,v,c] * W[k,c,o]        rounded to x's type
//
// Sums in fp32; dW and da1 are written in the inputs' type: x, a1, g and
// W share one type (float or bf16); K = 3. The
// input gradient dx is not computed here: it is the forward kernel
// (gcn_fwd.cu) on (g, a1^T, W^T).
//
// Replaces the TPU kernel agcn_tpu/ops/pallas/gcn_fused.py _bwd_kernel
// (reached through _backward, used by _vjp_bwd), with its rounding points
// (gcn_fused.py:99-101 and :112-113).
//
// Order of the sums. The TPU kernel adds into dW across its whole
// (B, nT) grid and into da1 across the time tiles of a sample, which is
// safe there only because a TPU runs its grid in order. Here no block
// adds into another's output: each reduces over T inside itself, the
// per-group dW partials are summed by a second kernel in a fixed
// order, and every sum runs in an order fixed by the shapes alone. Two
// calls on the same inputs give bitwise-equal results.
//
// What bounds it on an H100: per call it must read x, g (B*T*V*(C+Co)
// values), a1 and W, and write dW and da1, and do
// 4*K*B*T*V*Co*(V+C) flops in bf16, where u and p are rounded. In fp32
// that rounding is the identity, so each gradient may take its narrower
// intermediate (x a1_k for u, g W_k^T for p), and the least is
// 4*K*B*T*V*(C*Co + V*min(C, Co)). At the AGCN training shapes that is,
// in fp32, 12 flops per byte at the C = 3 entry layer, below the fp32
// ridge of 20 (67 TFLOP/s outside the tensor cores over 3.35 TB/s), so
// bytes bound it, and 133-419 at the others, bound by operations. In
// bf16 it is 159-837 flops per byte against a ridge of 295 (989 TFLOP/s
// on the tensor cores): bytes bound the narrow layers, operations the
// wide ones.
//
// dW makes two passes through device memory in both types: u is formed
// once, then dW_k = x^T u_k is a GEMM over the rows r = (b, t, v):
//
//   gcn_u_kernel<T, V>: one block of 256 threads per (8 frames, sample).
//     a1 of the sample, all three subsets, sits in shared memory; each
//     thread holds the g column of one (frame, output-channel pair) in
//     registers and forms its u for every (k, v): fp32 sums in the order
//     w = 0 .. V-1, rounded to T once (the identity in fp32), into a
//     (K, B*T*V, Co) buffer of T. Bound by bytes: it reads g once and
//     writes 3x its size.
//   gcn_dw_mma_kernel (bf16): x^T u_k with nvcuda::wmma bf16 16x16x16
//     fragments and fp32 accumulators. One block of 4 warps per (64 input
//     x 64 output channels, subset k, group of rows); each warp owns a
//     32x32 quarter (2x2 fragments). The block walks its rows in chunks
//     of 32: an x chunk (read as x^T, col_major) and a u chunk
//     (row_major) staged in shared memory, rows padded by 8 bf16 against
//     bank conflicts, the next chunk's loads held in registers while the
//     current one is multiplied. Rows past the group's end and channels
//     past C or Co are zeros in shared memory (C=3 is padded to 64 that
//     way).
//   gcn_dw_fp32_kernel<CT, TM> (fp32): x^T u_k in exact fp32 FMAs on the
//     CUDA cores (the tensor cores' fp32 is TF32, which would miss the
//     fp32 bar). One block of 128 threads per (CT input x 64 output
//     channels, subset k, group of rows); CT = 64, or 8 for the C <= 8
//     entry layer. The block walks its rows in chunks of 32 through a
//     ring of three shared-memory slots filled by cp.async: two chunks
//     in flight while one is multiplied, one barrier a chunk, rows
//     padded by 4 floats, 16-byte copies where the width is a multiple
//     of 4 and the base aligned, else 4-byte ones; rows past the group's
//     end and channels past C or Co are zero-filled. Each thread keeps a
//     TM x 8 fp32 register tile (8 x 8 at CT = 64, 4 x 8 at CT = 8): per
//     row, TM/4 + 2 float4 loads from shared memory feed 8 TM FMAs. The
//     128 threads form row slices (2 at CT = 64, 8 at CT = 8), each a
//     fixed part of every chunk, summed in slice order at the end. The
//     grid puts the Co tile, the C tile and k fastest and the row group
//     slowest, so the blocks that read the same rows run together and
//     find them in L2 after their first read.
//
//   In both types a group is a range of whole 32-row chunks of the
//   B*T*V rows; the group count is chosen from the shapes so that about
//   1,056 blocks run (8 per SM). Each block writes one fp32 (C, Co)
//   partial.
//
//   gcn_dw_reduce_kernel: dW = sum over the groups, in group order,
//     rounded to dW's type once.
//
// da1 in fp32 runs on the CUDA cores in exact fp32 FMAs (TF32 would miss
// the fp32 bar):
//
//   gcn_da1_fp32_kernel<V, CC>: one block of 256 threads per (group of
//     frames, subset k, sample b). A group is a range of whole tiles of
//     the sample, a tile TT = 128 / V frames (5 at V = 25: 125 rows t V +
//     v; 7 at V = 18: 126 rows; 8 at V = 15: 120 rows); the group count
//     is chosen from the shapes
//     so that about 2,112 blocks run (8 per SM). Per tile and 64-channel o
//     chunk:
//       1. p = x_tile . W_k[:, chunk] over C in chunks of CC (16; 4 for
//          C <= 8, the C = 3 entry layer): x staged row-major (x_s[row]
//          [c]) and W_k (w_s[c][o]) by 16-byte cp.async where aligned,
//          both double-buffered, the next chunk's copies in flight during
//          the current one's FMAs; each thread keeps a 4 x 8 register tile
//          (four rows 32 apart x two column quads 32 channels apart): per
//          four channels, one float4 of x a row and two of W a channel,
//          12 loads for 128 FMAs. (x staged transposed instead, by 4-byte
//          copies scattered down the columns, gives the same 3 loads for
//          32 FMAs, but its four times as many copies made the kernel
//          slower on the H100.)
//       2. p stored into p_s[row][o] (rounded to x's type there: the
//          identity in fp32); g of the tile and chunk staged into
//          g_s[row][o] by cp.async issued before the C loop, in flight
//          during it;
//       3. da1 += p g^T per frame in VT x VT register tiles of (v, w): at
//          V = 25, 25 tiles of 5 x 5 x 10 slices (a slice: one frame x one
//          32-channel half) = 250 threads, per o quad five float4 of p
//          and five of g for 100 FMAs; at V = 18, 9 tiles of 6 x 6 x 28
//          slices (a frame x a 16-channel quarter) = 252 threads, 144 FMAs
//          for 12 loads; at V = 15, 9 tiles of 5 x 5 x 16 slices (a frame
//          x a 32-channel half) = 144 threads, V = 25's 100 FMAs for 10
//          loads (Da32Tile). The accumulators live for the whole block.
//     At the end the slices are summed in slice order through shared
//     memory (p_s and g_s reused) into the block's fp32 (V, V) partial
//     of a (B, K, G, V, V) buffer. Rows past T and channels past C or
//     Co are zero in shared memory; stores past them are skipped.
//     Shared memory (Da32Layout): 96,672 bytes at V = 25, CC = 16, so two
//     blocks fit an SM (__launch_bounds__(256, 2): 128 registers).
//   gcn_da1_reduce_kernel<float>: the group partials in group order.
//   What bounds it: in fp32 p's rounding is the identity, so da1_k =
//   sum_t x_t (g_t W_k^T)^T is the same function, and the least work
//   is 2 K B T V C Co + 2 K B T V^2 min(C, Co) flops: 8.66 ms a
//   training step at the fp32 peak. This kernel runs the p form,
//   2 K B T V Co (C + V) flops, 9.06 ms.
//
// da1 in bf16 is two chained products on the tensor cores (nvcuda::wmma
// bf16 16x16x16, fp32 accumulators), as gcn_fwd_mma_kernel chains the
// forward's:
//
//   gcn_da1_mma_kernel: one block of 8 warps per (group of frames,
//     subset k, sample b). A group is a range of whole 4-frame tiles of
//     the sample; the group count is chosen from the shapes so that
//     several waves of blocks fill the card. Each frame takes a 32-row
//     slot (v at rows f*32 + v, zero for v >= V), so a tile is 128 rows.
//     Per tile and 64-channel o chunk, warp w owns frame f = w % 4 and
//     the 32 channels 32 * (w / 4) of the chunk:
//       1. p = x_tile . W_k[:, chunk] over C in chunks of CC (16 for the
//          C = 3 entry layer, else 64; x and W staged in shared memory by
//          the whole block with cp.async, C padded with zeros); the
//          warp's 2 x 2 fp32 fragments go through a per-warp scratch
//          tile and are rounded to bf16 (RN) once into p_s: the rounding
//          point of _bwd_kernel (gcn_fused.py:112-113);
//       2. the warp stages its own (frame, w, 32 channels) of g in g_s,
//          rows w >= V zero, its loads in flight while p is rounded;
//       3. da1 += p_s[f] (32 x 32, row_major) . g_s[f]^T, the transposed
//          operand loaded col_major straight from g's (w, o) layout.
//     p_s and g_s regions are private to their warp, so steps 1-3 need
//     no block barrier. Each warp keeps one 32 x 32 fp32 accumulator for
//     the whole block; at the end the 8 are summed in warp order and the
//     block writes one fp32 (V, V) partial (rows and columns >= V
//     dropped) into a (B, K, G, V, V) buffer.
//     Registers: both accumulators (64 of the 128 that two blocks an SM
//     leave a thread) are live while x and W are staged; staging them
//     through registers spilled (72-80 bytes at CC = 64), cp.async takes
//     none, and g is loaded after the C loop, where x and W are done.
//   gcn_da1_reduce_kernel<bf16>: da1 = the sum of the group partials in
//     group order, rounded to bf16 once.
//   What bounds it: the function needs x and g read once, 0.77 ms a
//   training step at 3.35 TB/s; the MMAs it runs, padded (V to 32,
//   C = 3 to 16), are ~830 GFLOP a step, 0.84 ms at the bf16 peak. The
//   wmma fragment loads from shared memory and a barrier per C chunk
//   keep it well below that peak.
//
// Ragged edges (T not a multiple of the tile, C of the chunk, Co of 64)
// are masked: staged values beyond the edge are zero and stores beyond it
// are skipped.
//
// The kernels above are built for the tuned joint counts V = 15, 18 and
// 25. Every other V >= 1 (the JAX Pallas kernels take any V) runs two
// general kernels with V a run-time argument and fixed 32-joint tiles, so
// that shared memory does not grow with V, in exact fp32 FMAs on the
// CUDA cores in both types (each described where it is defined):
//   gcn_u_gen_kernel<T>: u, then the same dW GEMMs (gcn_dw_mma_kernel,
//     gcn_dw_fp32_kernel), which take V only through the B*T*V rows, and
//     the same reduce;
//   gcn_da1_gen_kernel<T>: the (B, K, G, V, V) partials by 32 x 32 tiles
//     of (v, w), 4-frame tiles grouped as above, then the same reduce.
// Same rules: no atomics, sums in an order fixed by the shapes.
//
// C interface, each on the given stream of the current device, returning
// the first CUDA error (0 on success):
//   agcn_gcn_bwd_dw launches the dW kernels (gcn_u_kernel, then
//     gcn_dw_fp32_kernel or in bf16 gcn_dw_mma_kernel) and the ordered
//     reduce; the caller allocates the (G, K, C, Co) fp32 partials and
//     the (K, B*T*V, Co) buffer of u in x's type.
//   agcn_gcn_bwd_da1 launches gcn_da1_fp32_kernel (fp32) or
//     gcn_da1_mma_kernel (bf16) into the caller's (B, K, G, V, V) fp32
//     partials, then the ordered reduce gcn_da1_reduce_kernel<T>.
//   agcn_gcn_bwd_da1_tiling says what agcn_gcn_bwd_da1 takes at (V, C)
//     in either type: the frames of a tile, which the caller's frame
//     groups split, the dynamic shared memory of a block, and the blocks
//     an SM of the current device holds (at an untuned V the general
//     kernel's: 4-frame tiles, 47,360 bytes).
// At an untuned V the only limits are the general kernels' grids: B <=
// 65535, ceil(V / 32) * ceil(Co / 32) <= 65535 (u) and 3 ceil(V / 32)^2
// <= 65535 (da1: V <= 4,704).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int K = 3;             // spatial subsets
constexpr int TT = 4;            // frames per tile of the bf16 da1 kernel

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

// ---------------------------------------------------------------- dW ----

// dW[i] = sum over the groups of the partials, in group order
template <typename T>
__global__ void __launch_bounds__(256)
gcn_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                     int n, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int gi = 0; gi < groups; ++gi) s += part[(size_t)gi * n + i];
  dw[i] = from_f<T>(s);
}

constexpr int U_THREADS = 256;
constexpr int U_FRAMES = 8;      // frames per block

// two consecutive values as one 2-vector, in fp32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// u[k, (b,t,v), o] = sum_w g[b,t,w,o] * a1[b,k,v,w], rounded to T (the
// identity in fp32). g_pairs: Co is even and g aligned to two elements,
// so an output-channel pair loads and stores as one 2-vector
// (__nv_bfloat162 or float2).
template <typename T, int V>
__global__ void __launch_bounds__(U_THREADS)
gcn_u_kernel(const T* __restrict__ a1, const T* __restrict__ g,
             T* __restrict__ u, int B, int Tn, int Co, bool g_pairs) {
  constexpr int VP = (V + 3) / 4 * 4;          // a1 row, float4-padded
  __shared__ __align__(16) float a_s[K * V * VP];  // a_s[k][v][w]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * U_FRAMES;
  const int tid = threadIdx.x;
  const T* a_b = a1 + (size_t)b * K * V * V;
  for (int i = tid; i < K * V * VP; i += U_THREADS) {
    const int w = i % VP;
    a_s[i] = w < V ? to_f(a_b[(i / VP) * V + w]) : 0.f;
  }
  __syncthreads();

  const int pairs = (Co + 1) / 2;
  const int frames = min(U_FRAMES, Tn - t0);
  const size_t slab = (size_t)B * Tn * V * Co;  // one subset's u
  for (int item = tid; item < frames * pairs; item += U_THREADS) {
    const int o = 2 * (item % pairs);
    const bool two = o + 1 < Co;
    const size_t base = ((size_t)b * Tn + t0 + item / pairs) * V * Co + o;
    float2 gv[VP];
#pragma unroll
    for (int w = 0; w < VP; ++w) {
      float2 f = make_float2(0.f, 0.f);
      if (w < V) {
        const T* src = g + base + (size_t)w * Co;
        if (g_pairs) {
          f = load_pair(src);
        } else {
          f.x = to_f(src[0]);
          if (two) f.y = to_f(src[1]);
        }
      }
      gv[w] = f;
    }
    for (int k = 0; k < K; ++k) {
      T* dst = u + k * slab + base;
#pragma unroll 1
      for (int v = 0; v < V; ++v) {
        const float4* arow =
            reinterpret_cast<const float4*>(a_s + (k * V + v) * VP);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int q = 0; q < VP / 4; ++q) {  // w = 4q .. 4q+3, in order
          const float4 a4 = arow[q];
          s0 += gv[4 * q + 0].x * a4.x;
          s1 += gv[4 * q + 0].y * a4.x;
          s0 += gv[4 * q + 1].x * a4.y;
          s1 += gv[4 * q + 1].y * a4.y;
          s0 += gv[4 * q + 2].x * a4.z;
          s1 += gv[4 * q + 2].y * a4.z;
          s0 += gv[4 * q + 3].x * a4.w;
          s1 += gv[4 * q + 3].y * a4.w;
        }
        T* d = dst + (size_t)v * Co;
        if (g_pairs) {
          store_pair(d, s0, s1);
        } else {
          d[0] = from_f<T>(s0);
          if (two) d[1] = from_f<T>(s1);
        }
      }
    }
  }
}

constexpr int UG_THREADS = 256;  // 8 warps
constexpr int UG_TT = 2;         // frames a block
constexpr int UG_VT = 32;        // rows v of u a block
constexpr int UG_WS = 32;        // joints w a slice (the sum's step)
constexpr int UG_OT = 32;        // output channels a block: one a lane
constexpr int UG_LDA = UG_VT + 4;  // row stride of aT_s

// gcn_u_kernel at any V >= 1 (V a run-time argument): the same u, the
// same fp32 sums in the order w = 0 .. V-1, rounded to T once. One block
// of 256 threads per (UG_TT frames, UG_VT rows v, UG_OT output channels,
// sample); w in slices of UG_WS joints: g of the slice (g_s[t][w][o])
// and a1 transposed (aT_s[k][w][v]) staged, zero past the edges. Lane o
// of warp q keeps frame q / 4, rows v 8 (q % 4) .. + 7, all three k: per
// w one load of g and six float4 of a1 for 24 FMAs. Shared memory is
// fixed (22,016 bytes), whatever V.
template <typename T>
__global__ void __launch_bounds__(UG_THREADS)
gcn_u_gen_kernel(const T* __restrict__ a1, const T* __restrict__ g,
                 T* __restrict__ u, int B, int Tn, int V, int Co) {
  __shared__ __align__(16) float g_s[UG_TT * UG_WS * UG_OT];
  __shared__ __align__(16) float aT_s[K * UG_WS * UG_LDA];
  const int nvt = (V + UG_VT - 1) / UG_VT;
  const int t0 = blockIdx.x * UG_TT;
  const int v0 = (blockIdx.y % nvt) * UG_VT;
  const int o0 = (blockIdx.y / nvt) * UG_OT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int o = tid % UG_OT;
  const int t = tid / UG_OT / 4;
  const int vg = (tid / UG_OT % 4) * 8;
  const T* a_b = a1 + (size_t)b * K * V * V;
  const size_t gb = (size_t)b * Tn * V;  // g and u as (B T V, Co)

  float s[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[k][j] = 0.f;
  }
  for (int w0 = 0; w0 < V; w0 += UG_WS) {
    __syncthreads();  // the previous slice is read
    for (int i = tid; i < UG_TT * UG_WS * UG_OT; i += UG_THREADS) {
      const int oo = i % UG_OT;
      const int w = i / UG_OT % UG_WS;
      const int tt = i / (UG_OT * UG_WS);
      const bool ok = t0 + tt < Tn && w0 + w < V && o0 + oo < Co;
      g_s[i] = ok ? to_f(g[(gb + (size_t)(t0 + tt) * V + w0 + w) * Co + o0 +
                           oo])
                  : 0.f;
    }
    for (int i = tid; i < K * UG_VT * UG_WS; i += UG_THREADS) {
      const int w = i % UG_WS;  // fastest: the reads of a1 coalesce
      const int v = i / UG_WS % UG_VT;
      const int k = i / (UG_WS * UG_VT);
      const bool ok = v0 + v < V && w0 + w < V;
      aT_s[(k * UG_WS + w) * UG_LDA + v] =
          ok ? to_f(a_b[((size_t)k * V + v0 + v) * V + w0 + w]) : 0.f;
    }
    __syncthreads();
    const int nw = V - w0 < UG_WS ? V - w0 : UG_WS;
    const float* gr = g_s + t * UG_WS * UG_OT + o;
    const float* ar = aT_s + vg;
#pragma unroll 2
    for (int w = 0; w < nw; ++w) {
      const float gv = gr[w * UG_OT];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 lo =
            *reinterpret_cast<const float4*>(ar + (k * UG_WS + w) * UG_LDA);
        const float4 hi = *reinterpret_cast<const float4*>(
            ar + (k * UG_WS + w) * UG_LDA + 4);
        s[k][0] = fmaf(gv, lo.x, s[k][0]);
        s[k][1] = fmaf(gv, lo.y, s[k][1]);
        s[k][2] = fmaf(gv, lo.z, s[k][2]);
        s[k][3] = fmaf(gv, lo.w, s[k][3]);
        s[k][4] = fmaf(gv, hi.x, s[k][4]);
        s[k][5] = fmaf(gv, hi.y, s[k][5]);
        s[k][6] = fmaf(gv, hi.z, s[k][6]);
        s[k][7] = fmaf(gv, hi.w, s[k][7]);
      }
    }
  }
  if (t0 + t >= Tn || o0 + o >= Co) return;
  const size_t slab = (size_t)B * Tn * V * Co;  // one subset's u
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = v0 + vg + j;
      if (v < V) {
        u[k * slab + (gb + (size_t)(t0 + t) * V + v) * Co + o0 + o] =
            from_f<T>(s[k][j]);
      }
    }
  }
}

// cp.async of 16 (or 4) bytes from src to shared memory at dst; with !ok
// nothing is read (source size 0: src may be any valid address) and dst
// is zero-filled. Wait for them with cp_async_wait_group / _all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int F_THREADS = 128;
constexpr int F_OT = 64;         // output channels per block
constexpr int F_RK = 32;         // (b, t, v) rows per chunk
constexpr int F_STAGES = 3;      // ring slots: two chunks in flight
constexpr int F_LDU = F_OT + 4;  // float row stride of a staged u chunk
constexpr int F_NARROW_C = 8;    // C up to this takes the CT = 8 tile

// The tiling of gcn_dw_fp32_kernel<CT, TM>, in floats: a thread owns TM
// input channels (TM / 4 quads, CT / (TM / 4) apart) x 8 output channels
// (two quads, 32 apart), 8 threads across the 64 output channels.
template <int CT, int TM>
struct Dw32Layout {
  static constexpr int CY = CT / TM;            // threads across the C tile
  static constexpr int SLICE = 8 * CY;          // threads of a row slice
  static constexpr int RS = F_THREADS / SLICE;  // row slices
  static constexpr int ROWS = F_RK / RS;        // rows of a chunk a slice
  static constexpr int CQ = TM / 4;             // c quads of a thread
  static constexpr int LDX = CT + 4;            // row stride of an x chunk
  static constexpr int X = F_RK * LDX;          // x_s[F_RK][LDX]
  static constexpr int STAGE = X + F_RK * F_LDU;  // then u_s[F_RK][F_LDU]
  static constexpr int RED = (RS - 1) * CT * F_LDU;  // slices 1.., at the end
  static constexpr int FLOATS =
      F_STAGES * STAGE > RED ? F_STAGES * STAGE : RED;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(TM % 4 == 0 && CT % TM == 0 && F_THREADS % SLICE == 0 &&
                    F_RK % RS == 0 && CT % 4 == 0,
                "dW fp32 tiling");
};

// Rows [r0, r0 + F_RK) of the row-major (rows, n) matrix m, columns
// [col0, col0 + W), into dst (row stride LD) by cp.async: zeros for rows
// at or past r_end and columns past n. `vec`: n % 4 == 0 and m 16-byte
// aligned (col0 is a multiple of 4), so four columns copy as 16 bytes.
template <int W, int LD>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ m,
                                           size_t r0, size_t r_end, int col0,
                                           int n, bool vec, int tid) {
  constexpr int NV = F_RK * W / 4;  // 16-byte copies of a chunk
  constexpr int NS = F_RK * W;      // or 4-byte ones
  if (vec) {
#pragma unroll
    for (int j = 0; j < (NV + F_THREADS - 1) / F_THREADS; ++j) {
      const int i = tid + j * F_THREADS;
      if (NV % F_THREADS != 0 && i >= NV) break;
      const int r = i / (W / 4);
      const int c = (i % (W / 4)) * 4;
      const bool ok = r0 + r < r_end && col0 + c < n;
      cp_async16(dst + r * LD + c, ok ? m + (r0 + r) * n + col0 + c : m, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < (NS + F_THREADS - 1) / F_THREADS; ++j) {
      const int i = tid + j * F_THREADS;
      if (NS % F_THREADS != 0 && i >= NS) break;
      const int r = i / W;
      const int c = i % W;
      const bool ok = r0 + r < r_end && col0 + c < n;
      cp_async4(dst + r * LD + c, ok ? m + (r0 + r) * n + col0 + c : m, ok);
    }
  }
}

// part[grp, k, c, o] = sum over the group's rows r of x[r, c] * u_k[r, o],
// exact fp32 FMAs. Four blocks an SM (52,224 bytes of shared memory each
// at CT = 64): the bound caps the registers at 128.
template <int CT, int TM>
__global__ void __launch_bounds__(F_THREADS, 4)
gcn_dw_fp32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                   float* __restrict__ part, int rows, int C, int Co,
                   int groups, bool x_vec, bool o_vec) {
  using L = Dw32Layout<CT, TM>;
  extern __shared__ __align__(16) float smem_dw[];

  const int o0 = blockIdx.x * F_OT;
  const int c0 = blockIdx.y * CT;
  const int k = blockIdx.z % K;
  const int grp = blockIdx.z / K;
  const int tid = threadIdx.x;
  const int slice = tid / L::SLICE;
  const int ty = (tid % L::SLICE) / 8;  // c quads at q * CT / CQ + 4 ty
  const int tx = tid % 8;               // o quads at h * 32 + 4 tx

  // the group's rows: whole chunks [chunks*grp/groups, chunks*(grp+1)/groups)
  const long long chunks = ((long long)rows + F_RK - 1) / F_RK;
  const size_t r_begin = (size_t)(chunks * grp / groups) * F_RK;
  const size_t r_last = (size_t)(chunks * (grp + 1) / groups) * F_RK;
  const size_t r_end = r_last < (size_t)rows ? r_last : (size_t)rows;
  const int n = (int)((r_end - r_begin + F_RK - 1) / F_RK);
  const float* u_k = u + (size_t)k * rows * Co;

  auto stage = [&](int i) {
    float* slot = smem_dw + (i % F_STAGES) * L::STAGE;
    const size_t r0 = r_begin + (size_t)i * F_RK;
    stage_rows<CT, L::LDX>(slot, x, r0, r_end, c0, C, x_vec, tid);
    stage_rows<F_OT, F_LDU>(slot + L::X, u_k, r0, r_end, o0, Co, o_vec, tid);
  };

  float acc[TM][8];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
  }

  stage(0);
  cp_async_commit();
  if (n > 1) stage(1);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    cp_async_wait_group<1>();  // this thread's copies of chunk i are in
    __syncthreads();           // everyone's; and chunk i - 1 is multiplied
    if (i + 2 < n) stage(i + 2);  // into chunk i - 1's slot
    cp_async_commit();            // (an empty group past the end)
    const float* slot = smem_dw + (i % F_STAGES) * L::STAGE;
    const float* xs = slot + slice * L::ROWS * L::LDX + 4 * ty;
    const float* us = slot + L::X + slice * L::ROWS * F_LDU + 4 * tx;
#pragma unroll
    for (int r = 0; r < L::ROWS; ++r) {  // the slice's rows, in order
      float xv[TM], uv[8];
#pragma unroll
      for (int q = 0; q < L::CQ; ++q) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            xs + r * L::LDX + q * (CT / L::CQ));
        xv[4 * q + 0] = a4.x;
        xv[4 * q + 1] = a4.y;
        xv[4 * q + 2] = a4.z;
        xv[4 * q + 3] = a4.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(us + r * F_LDU + 32 * h);
        uv[4 * h + 0] = b4.x;
        uv[4 * h + 1] = b4.y;
        uv[4 * h + 2] = b4.z;
        uv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int a = 0; a < TM; ++a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[a][j] = fmaf(xv[a], uv[j], acc[a][j]);
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every slice is done with the ring: red_s takes it
  float* red_s = smem_dw;  // [slice - 1][CT][F_LDU]
  // the tile row of acc[a]: c = q * CT / CQ + 4 ty + i for a = 4 q + i
  auto c_of = [&](int a) { return (a / 4) * (CT / L::CQ) + 4 * ty + a % 4; };
  if (slice > 0) {
    float* mine = red_s + (slice - 1) * CT * F_LDU;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(mine + c_of(a) * F_LDU + 32 * h + 4 * tx) =
            make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                        acc[a][4 * h + 3]);
      }
    }
  }
  __syncthreads();
  if (slice > 0) return;
  float* dst = part + ((size_t)grp * K + k) * C * Co;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int c = c0 + c_of(a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = acc[a][4 * h + j];
      for (int q = 1; q < L::RS; ++q) {  // the slices, in order
        const float4 p4 = *reinterpret_cast<const float4*>(
            red_s + ((q - 1) * CT + c_of(a)) * F_LDU + 32 * h + 4 * tx);
        s[0] += p4.x;
        s[1] += p4.y;
        s[2] += p4.z;
        s[3] += p4.w;
      }
      const int o = o0 + 32 * h + 4 * tx;
      if (c >= C || o >= Co) continue;
      float* d = dst + (size_t)c * Co + o;
      if (o_vec) {  // Co % 4 == 0: the whole quad lies inside
        *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (o + j < Co) d[j] = s[j];
        }
      }
    }
  }
}

// ------------------------------------------------- dW in bf16: MMA ----

namespace wmma = nvcuda::wmma;

constexpr int MM_THREADS = 128;    // 4 warps, each a 32 x 32 quarter
constexpr int MM_CT = 64;          // input channels (rows of dW) per block
constexpr int MM_OT = 64;          // output channels per block
constexpr int MM_RK = 32;          // (b, t, v) rows per chunk
constexpr int MM_LD = 64 + 8;      // bf16 row stride of a staged chunk
constexpr int MM_LDC = MM_OT + 4;  // fp32 row stride of the staged tile
constexpr int MM_CHUNK_BYTES = 2 * MM_RK * MM_LD * 2;  // x_s and u_s
constexpr int MM_TILE_BYTES = MM_CT * MM_LDC * 4;      // c_s
constexpr int MM_SMEM = MM_CHUNK_BYTES > MM_TILE_BYTES ? MM_CHUNK_BYTES
                                                       : MM_TILE_BYTES;
// each thread stages two 8-wide vectors of each 32 x 64 chunk
static_assert(MM_RK * MM_CT / 8 == 2 * MM_THREADS, "x staging");
static_assert(MM_RK * MM_OT / 8 == 2 * MM_THREADS, "u staging");

// 8 bf16 of row `row` of the row-major (rows, n) matrix m from column
// `col` on: zeros for a row past the group's end or columns past n.
// `vec`: n % 8 == 0 and m 16-byte aligned, so the 8 load as one uint4.
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

// part[grp, k, c, o] = sum over the group's rows r of x[r, c] * u_k[r, o]
__global__ void __launch_bounds__(MM_THREADS)
gcn_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ u,
                  float* __restrict__ part, int rows, int C, int Co,
                  int groups, bool x_vec) {
  __shared__ __align__(128) unsigned char smem[MM_SMEM];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [RK][LD]
  __nv_bfloat16* u_s = x_s + MM_RK * MM_LD;                     // [RK][LD]
  float* c_s = reinterpret_cast<float*>(smem);  // [CT][LDC], after the loop

  const int o0 = blockIdx.x * MM_OT;
  const int c0 = blockIdx.y * MM_CT;
  const int k = blockIdx.z % K;
  const int grp = blockIdx.z / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wc = (warp / 2) * 32;  // the warp's 32 input channels
  const int wo = (warp % 2) * 32;  // and 32 output channels
  // a warp wholly past C or Co has nothing to add (layer 1: C=3)
  const bool active = c0 + wc < C && o0 + wo < Co;

  // the group's rows: whole chunks [chunks*grp/groups, chunks*(grp+1)/groups)
  const long long chunks = ((long long)rows + MM_RK - 1) / MM_RK;
  const size_t r_begin = (size_t)(chunks * grp / groups) * MM_RK;
  const size_t r_last = (size_t)(chunks * (grp + 1) / groups) * MM_RK;
  const size_t r_end = r_last < (size_t)rows ? r_last : (size_t)rows;
  const __nv_bfloat16* u_k = u + (size_t)k * rows * Co;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  // this thread's vectors: row vi / 8, columns 8 * (vi % 8) .. +7
  uint4 x_r[2], u_r[2];
  auto fetch = [&](size_t r0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int vi = tid + j * MM_THREADS;
      const size_t r = r0 + vi / 8;
      const int col = (vi % 8) * 8;
      x_r[j] = load8(x, r, r < r_end, c0 + col, C, x_vec);
      u_r[j] = load8(u_k, r, r < r_end, o0 + col, Co, Co % 8 == 0);
    }
  };

  fetch(r_begin);
  for (size_t r0 = r_begin; r0 < r_end; r0 += MM_RK) {
    __syncthreads();  // the previous chunk's fragments are loaded
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int vi = tid + j * MM_THREADS;
      const int at = (vi / 8) * MM_LD + (vi % 8) * 8;
      *reinterpret_cast<uint4*>(x_s + at) = x_r[j];
      *reinterpret_cast<uint4*>(u_s + at) = u_r[j];
    }
    __syncthreads();
    if (r0 + MM_RK < r_end) fetch(r0 + MM_RK);  // in flight during the MMAs
    if (active) {
#pragma unroll
      for (int kk = 0; kk < MM_RK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A = x^T: element (c, r) at x_s[r * LD + c]
          wmma::load_matrix_sync(fa[i], x_s + kk * MM_LD + wc + 16 * i,
                                 MM_LD);
          wmma::load_matrix_sync(fb[i], u_s + kk * MM_LD + wo + 16 * i,
                                 MM_LD);
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

  __syncthreads();  // every warp is done with x_s, u_s: c_s takes them
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(c_s + (wc + 16 * i) * MM_LDC + wo + 16 * j,
                                acc[i][j], MM_LDC, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  float* dst = part + ((size_t)grp * K + k) * C * Co;
  for (int i = tid; i < MM_CT * MM_OT; i += MM_THREADS) {
    const int c = c0 + i / MM_OT;
    const int o = o0 + i % MM_OT;
    if (c < C && o < Co) {
      dst[(size_t)c * Co + o] = c_s[(i / MM_OT) * MM_LDC + i % MM_OT];
    }
  }
}

// ------------------------------------------------------- da1 in fp32 ----

constexpr int D32_THREADS = 256;
constexpr int D32_ROWS_P = 128;   // projection rows: 4 a thread, 32 apart
constexpr int D32_OT = 64;        // output channels per chunk
constexpr int D32_LD = D32_OT + 4;  // row stride of p_s and g_s
constexpr int D32_NARROW_C = 8;   // C up to this takes CC = 4

// The tiling of gcn_da1_fp32_kernel for V joints. A tile is TT whole
// frames, TT V of the 128 projection rows (5 frames, 125 rows at V = 25;
// 7 frames, 126 rows at V = 18; 8 frames, 120 rows at V = 15). p g^T: VT
// x VT register tiles of (v, w), NT x NT of them over the V x V output,
// each worked by SLICES threads, a slice being one frame x one of PARTS
// channel parts of the 64-channel chunk: at V = 25, 5 x 5 tiles x (5
// frames x 2 halves) = 250 threads; at V = 18, 6 x 6 tiles x (7 frames x
// 4 quarters) = 252 threads; at V = 15, 3 x 3 tiles of 5 x 5 x (8 frames
// x 2 halves) = 144 threads. Per o quad a thread loads VT float4 of p and
// VT of g for 4 VT^2 FMAs: 10 FMAs a load at V = 25 and 15, 12 at V = 18.
// V = 15 takes VT = 5 over VT = 3 (5 x 5 tiles of 3 x 3 x 8 frames x 1
// part = 200 threads, 6 FMAs a load): VT = 5 issues 40% fewer
// shared-memory loads for the same FMAs, with the 25 accumulators and
// register use of V = 25's tile (no new spill risk), at the cost of 112
// threads idle in this stage (they work in the projection).
template <int V>
struct Da32Tile {
  static constexpr int TT = D32_ROWS_P / V;
  static constexpr int ROWS = TT * V;
  static constexpr int VT = V == 18 ? 6 : 5;
  static constexpr int NT = V / VT;
  static constexpr int TILES = NT * NT;
  static constexpr int PARTS = V == 18 ? 4 : 2;
  static constexpr int PQ = D32_OT / 4 / PARTS;  // o quads of a part
  static constexpr int SLICES = TT * PARTS;
  static constexpr int WORKERS = TILES * SLICES;
  static_assert(V % VT == 0 && WORKERS <= D32_THREADS && ROWS <= D32_ROWS_P,
                "fp32 da1 tiling");
};

// Shared-memory layout in floats: x_s[2][D32_ROWS_P][LDX] and
// w_s[2][CC][D32_OT] (double-buffered), p_s[ROWS][D32_LD],
// g_s[ROWS][D32_LD]; at the end red_s[SLICES][V][V] takes p_s and g_s.
// LDX = CC + 4: the four rows that a warp reads at once (ty = 0 .. 3)
// land on distinct banks.
template <int V, int CC>
struct Da32Layout : Da32Tile<V> {
  using B = Da32Tile<V>;
  static constexpr int LDX = CC + 4;
  static constexpr int X = D32_ROWS_P * LDX;  // one x_s buffer
  static constexpr int W = CC * D32_OT;   // one w_s buffer
  static constexpr int W_OFF = 2 * X;
  static constexpr int P_OFF = W_OFF + 2 * W;
  static constexpr int G_OFF = P_OFF + B::ROWS * D32_LD;
  static constexpr int STAGE = G_OFF + B::ROWS * D32_LD;
  static constexpr int RED = B::SLICES * V * V;
  static constexpr int FLOATS =
      STAGE > P_OFF + RED ? STAGE : P_OFF + RED;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(CC % 4 == 0 && P_OFF % 4 == 0 && G_OFF % 4 == 0,
                "float4 rows, four channels a step");
};

// Rows [0, NR) x columns [0, W) of a tile, element (r, c) =
// m[(row0 + r) * n + col0 + c] where r < rows_ok and col0 + c < n, else
// zero, into dst (row stride LD) by cp.async. `vec`: n and col0 are
// multiples of 4 and m is 16-byte aligned, so each piece of 16 bytes is
// wholly inside or wholly outside. A thread keeps one column (piece) and
// steps down the rows, D32_THREADS / pieces-a-row apart. The loops stay
// rolled (gcn_fwd.cu's stage_tile: unrolled, their hoisted index math
// spilled).
template <int NR, int W, int LD>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ m,
                                           size_t row0, int rows_ok,
                                           int col0, int n, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int Q = W / 4;  // 16-byte pieces of a row
    constexpr int RS = D32_THREADS / Q;
    static_assert(D32_THREADS % Q == 0, "a thread keeps its column");
    const int c = tid % Q * 4;
    const bool c_ok = col0 + c < n;
    size_t at = (row0 + tid / Q) * n + col0 + c;
#pragma unroll 1
    for (int r = tid / Q; r < NR; r += RS, at += (size_t)RS * n) {
      const bool ok = c_ok && r < rows_ok;
      cp_async16(dst + r * LD + c, ok ? m + at : m, ok);
    }
    return;
  }
  constexpr int RS = D32_THREADS / W;
  static_assert(D32_THREADS % W == 0, "a thread keeps its column");
  const int c = tid % W;
  const bool c_ok = col0 + c < n;
  size_t at = (row0 + tid / W) * n + col0 + c;
#pragma unroll 1
  for (int r = tid / W; r < NR; r += RS, at += (size_t)RS * n) {
    const bool ok = c_ok && r < rows_ok;
    cp_async4(dst + r * LD + c, ok ? m + at : m, ok);
  }
}

// channel j of four rows, each a float4 over four channels
__device__ __forceinline__ float4 column(const float4 (&a)[4], int j) {
  return j == 0   ? make_float4(a[0].x, a[1].x, a[2].x, a[3].x)
         : j == 1 ? make_float4(a[0].y, a[1].y, a[2].y, a[3].y)
         : j == 2 ? make_float4(a[0].z, a[1].z, a[2].z, a[3].z)
                  : make_float4(a[0].w, a[1].w, a[2].w, a[3].w);
}

// acc[r][j] += a[r] w[j]: one c step of the projection, one row quad x
// two column quads, 32 FMAs (gcn_fwd.cu's fma_step<1>: each source
// builds alone)
__device__ __forceinline__ void fma_step(float (&acc)[4][8], const float4& a,
                                         const float4 (&w)[2]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float wv[4] = {w[h].x, w[h].y, w[h].z, w[h].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][4 * h + j] = fmaf(av[i], wv[j], acc[i][4 * h + j]);
      }
    }
  }
}

// part[b, k, grp, v, w] = sum over the group's frames t and all o of
// p_k[b,t,v,o] g[b,t,w,o], p_k = x W_k (rounded to x's type: the identity
// in fp32), in exact fp32 FMAs on the CUDA cores. Two blocks an SM
// (96,672 bytes of shared memory at V = 25, CC = 16): the bound caps the
// registers at 128.
template <int V, int CC>
__global__ void __launch_bounds__(D32_THREADS, 2)
gcn_da1_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ part,
                    int Tn, int C, int Co, int groups, bool x_vec,
                    bool w_vec, bool g_vec) {
  using L = Da32Layout<V, CC>;
  extern __shared__ __align__(16) float smem_d32[];
  float* p_s = smem_d32 + L::P_OFF;
  float* g_s = smem_d32 + L::G_OFF;

  const int grp = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // the projection: rows ty + 32 i (i < 4), columns 4 tx and 32 + 4 tx
  // of a quad
  const int tx = tid % 8;
  const int ty = tid / 8;
  // p g^T: the thread's (v, w) tile, and its slice (frame f, channels
  // from po of each chunk)
  const int tile = tid % L::TILES;
  const int slice = tid / L::TILES;
  const int f = slice / L::PARTS;
  const int po = (slice % L::PARTS) * L::PQ * 4;
  const int v0 = (tile / L::NT) * L::VT;
  const int w0 = (tile % L::NT) * L::VT;

  // the group's frames: whole tiles [tiles*grp/groups, tiles*(grp+1)/groups)
  const long long tiles = (Tn + L::TT - 1) / L::TT;
  const int tile_begin = (int)(tiles * grp / groups);
  const int tile_end = (int)(tiles * (grp + 1) / groups);
  const int nc = (C + CC - 1) / CC;
  const int no = (Co + D32_OT - 1) / D32_OT;
  const int steps = (tile_end - tile_begin) * no * nc;
  const size_t row_b = (size_t)b * Tn * V;  // x, g as (B*T*V, C or Co)
  const float* w_k = w + (size_t)k * C * Co;

  // the steps run c chunk fastest, then o chunk, then tile; step s
  // stages its x and W chunks into buffer s % 2. (nt, no_, nc_): the
  // tile, o chunk and c chunk of the next step to stage
  int nt = tile_begin, no_ = 0, nc_ = 0;
  auto stage_next = [&](int buf) {
    const int t0 = nt * L::TT;
    const int c0 = nc_ * CC;
    const int rows_ok = (Tn - t0 < L::TT ? Tn - t0 : L::TT) * V;
    stage_tile<D32_ROWS_P, CC, L::LDX>(smem_d32 + buf * L::X, x,
                                       row_b + (size_t)t0 * V, rows_ok, c0,
                                       C, x_vec, tid);
    stage_tile<CC, D32_OT, D32_OT>(smem_d32 + L::W_OFF + buf * L::W, w_k,
                                   c0, C - c0, no_ * D32_OT, Co, w_vec,
                                   tid);
    if (++nc_ == nc) {
      nc_ = 0;
      if (++no_ == no) {
        no_ = 0;
        ++nt;
      }
    }
  };

  float da[L::VT][L::VT];
#pragma unroll
  for (int i = 0; i < L::VT; ++i) {
#pragma unroll
    for (int j = 0; j < L::VT; ++j) da[i][j] = 0.f;
  }

  stage_next(0);  // a group holds one tile at least
  cp_async_commit();
  int s = 0;
  for (int tl = tile_begin; tl < tile_end; ++tl) {
    const int t0 = tl * L::TT;
    const int rows_ok = (Tn - t0 < L::TT ? Tn - t0 : L::TT) * V;
    // a thread whose frame lies past T adds nothing
    const bool adds = tid < L::WORKERS && t0 + f < Tn;
    for (int oc = 0; oc < no; ++oc) {
      const int o0 = oc * D32_OT;
      __syncthreads();  // the previous chunk's p g^T is done with p_s, g_s
      // g of the tile and chunk, in flight during the C loop
      stage_tile<L::ROWS, D32_OT, D32_LD>(g_s, g, row_b + (size_t)t0 * V,
                                          rows_ok, o0, Co, g_vec, tid);
      cp_async_commit();

      // p = x_tile W_k[:, chunk], c in order from 0
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
      for (int ci = 0; ci < nc; ++ci, ++s) {
        // this thread's copies of chunk s are in (at ci = 0, g's, the
        // newest group, may still be in flight)
        if (ci == 0) {
          cp_async_wait_group<1>();
        } else {
          cp_async_wait_group<0>();
        }
        __syncthreads();  // everyone's; and step s - 1 is done with the
                          // other buffer, which takes step s + 1's
                          // chunks, in flight during the FMAs
        if (s + 1 < steps) stage_next((s + 1) % 2);
        cp_async_commit();  // (an empty group past the end)
        const float* xr = smem_d32 + (s % 2) * L::X + ty * L::LDX;
        const float* wr = smem_d32 + L::W_OFF + (s % 2) * L::W + 4 * tx;
        // four channels a step: the thread's four rows as float4 over c,
        // then per c two float4 of W (unrolled fully)
#pragma unroll
        for (int c = 0; c < CC; c += 4) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = *reinterpret_cast<const float4*>(xr + 32 * i * L::LDX + c);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wv[2] = {
                *reinterpret_cast<const float4*>(wr + (c + j) * D32_OT),
                *reinterpret_cast<const float4*>(wr + (c + j) * D32_OT + 32)};
            fma_step(acc, column(a, j), wv);
          }
        }
      }
      // p rounded to x's type (from_f<float>: the identity) into p_s,
      // rows of the tile only
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 32 * i;
        if (r >= L::ROWS) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float4*>(p_s + r * D32_LD + 32 * h + 4 * tx) =
              make_float4(from_f<float>(acc[i][4 * h]),
                          from_f<float>(acc[i][4 * h + 1]),
                          from_f<float>(acc[i][4 * h + 2]),
                          from_f<float>(acc[i][4 * h + 3]));
        }
      }
      cp_async_wait_group<1>();  // g is in (the newest group is the next
      __syncthreads();           // step's chunk); p_s and g_s everyone's

      // da[v][w] += p[f][v][o] g[f][w] over the slice's o quads, in order
      if (adds) {
        const float* pr = p_s + (f * V + v0) * D32_LD + po;
        const float* gr = g_s + (f * V + w0) * D32_LD + po;
#pragma unroll 2
        for (int q = 0; q < L::PQ; ++q) {
          float4 gq[L::VT];
#pragma unroll
          for (int j = 0; j < L::VT; ++j) {
            gq[j] = *reinterpret_cast<const float4*>(gr + j * D32_LD + 4 * q);
          }
#pragma unroll
          for (int i = 0; i < L::VT; ++i) {
            const float4 pq =
                *reinterpret_cast<const float4*>(pr + i * D32_LD + 4 * q);
#pragma unroll
            for (int j = 0; j < L::VT; ++j) {
              da[i][j] = fmaf(pq.x, gq[j].x, da[i][j]);
              da[i][j] = fmaf(pq.y, gq[j].y, da[i][j]);
              da[i][j] = fmaf(pq.z, gq[j].z, da[i][j]);
              da[i][j] = fmaf(pq.w, gq[j].w, da[i][j]);
            }
          }
        }
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every slice is done with p_s, g_s: red_s takes them
  float* red_s = smem_d32 + L::P_OFF;  // [slice][v][w]
  if (tid < L::WORKERS) {
#pragma unroll
    for (int i = 0; i < L::VT; ++i) {
#pragma unroll
      for (int j = 0; j < L::VT; ++j) {
        red_s[(slice * V + v0 + i) * V + w0 + j] = da[i][j];
      }
    }
  }
  __syncthreads();
  float* dst = part + (((size_t)b * K + k) * groups + grp) * V * V;
  for (int i = tid; i < V * V; i += D32_THREADS) {
    float sum = 0.f;
    for (int sl = 0; sl < L::SLICES; ++sl) sum += red_s[sl * V * V + i];
    dst[i] = sum;
  }
}

// ------------------------------------------ da1 in bf16: p, then MMA ----

constexpr int DM_THREADS = 256;          // 8 warps: (frame, channel half)
constexpr int DM_WARPS = DM_THREADS / 32;
constexpr int DM_VP = 32;                // joints padded to two 16-row tiles
constexpr int DM_ROWS = TT * DM_VP;      // (t, v) rows of a tile: 128
constexpr int DM_OC = 64;                // output channels per chunk
constexpr int DM_LD = DM_OC + 8;         // bf16 row stride of w_s, p_s, g_s

// Shared-memory layout, in bytes, for an input-channel chunk of CC; the
// +8 bf16 on each row keeps the fragment loads off one bank.
template <int CC>
struct DaMmaLayout {
  static constexpr int LD = CC + 8;                    // x_s row stride
  static constexpr int W_OFF = DM_ROWS * LD * 2;       // x_s[ROWS][LD]
  static constexpr int P_OFF = W_OFF + CC * DM_LD * 2;     // w_s[CC][DM_LD]
  static constexpr int G_OFF = P_OFF + DM_ROWS * DM_LD * 2;  // p_s[ROWS][DM_LD]
  static constexpr int S_OFF = G_OFF + DM_ROWS * DM_LD * 2;  // g_s[ROWS][DM_LD]
  static constexpr int STAGE = S_OFF + DM_WARPS * 16 * 16 * 4;  // s_s[warps][16][16]
  static constexpr int RED = DM_WARPS * DM_VP * DM_VP * 4;  // r_s[warps][32][32], at the end
  static constexpr int BYTES = STAGE > RED ? STAGE : RED;
  static constexpr int XV = DM_ROWS * CC / 8;  // 8-bf16 vectors of an x chunk
  static constexpr int WV = CC * DM_OC / 8;    // and of a W chunk
  static_assert(W_OFF % 32 == 0 && P_OFF % 32 == 0 && G_OFF % 32 == 0 &&
                    S_OFF % 32 == 0,
                "wmma tiles must start on 256-bit boundaries");
  static_assert(CC % 16 == 0, "chunks are whole 16-deep MMA steps");
};

// two floats rounded to bf16 (RN), packed low then high
__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// 8 consecutive floats rounded to bf16 as one 16-byte vector (the same
// helper as in gcn_fwd.cu: each source builds alone)
__device__ __forceinline__ uint4 pack8(const float* __restrict__ src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

// load8's values of row `row` of m from column `col` on, into shared
// memory at dst (16-byte aligned). With `vec` the copy is asynchronous
// and takes no registers (cp.async; rows not `row_ok` and columns past n
// are zero-filled: source size 0); wait for it with cp_async_wait_all.
// Without, it goes through one register vector, one call at a time.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* __restrict__ m,
                                       size_t row, bool row_ok, int col,
                                       int n, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < n;
    const unsigned int s =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(ok ? m + row * n + col : m), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(dst) = load8(m, row, row_ok, col, n, false);
  }
}

// part[b, k, grp, v, w] = sum over the group's frames t and all o of
// bf16(x[b,t,v,:] . W_k[:,o]) * g[b,t,w,o]. Two blocks an SM (~71 KB of
// shared memory each at CC = 64): the bound caps the registers at 128.
// `g_rows` is V once more, as a run-time value: it bounds the rows of g
// that a warp loads, where the compile-time V = 15 let ptxas fold the
// bounds of the unrolled loads and spill 20 bytes at CC = 64 (V = 25 and
// 18 did not).
template <int V, int CC>
__global__ void __launch_bounds__(DM_THREADS, 2)
gcn_da1_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ g,
                   float* __restrict__ part, int Tn, int C, int Co,
                   int groups, bool x_vec, bool w_vec, bool g_vec,
                   int g_rows) {
  using L = DaMmaLayout<CC>;
  static_assert(V <= DM_VP, "joints fit one 32-row slot");
  extern __shared__ __align__(128) unsigned char smem_da[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_da);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_da + L::W_OFF);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem_da + L::P_OFF);
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem_da + L::G_OFF);
  float* r_s = reinterpret_cast<float*>(smem_da);  // after the last tile

  const int grp = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int f = warp % TT;            // the warp's frame of each tile
  const int wo = (warp / TT) * 32;    // and its 32 channels of each chunk
  const int pr = f * DM_VP;           // the frame's first row in p_s, g_s
  float* scratch = reinterpret_cast<float*>(smem_da + L::S_OFF) + warp * 256;

  // the group's frames: whole tiles [tiles*grp/groups, tiles*(grp+1)/groups)
  const long long tiles = (Tn + TT - 1) / TT;
  const int tile_begin = (int)(tiles * grp / groups);
  const int tile_end = (int)(tiles * (grp + 1) / groups);
  const int nc = (C + CC - 1) / CC;
  const int no = (Co + DM_OC - 1) / DM_OC;
  const size_t row_b = (size_t)b * Tn * V;  // x, g as (B*T*V, C or Co)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> da[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(da[i][j], 0.f);
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int t0 = tile * TT;
    const bool frame_ok = t0 + f < Tn;
    for (int oc = 0; oc < no; ++oc) {
      const int o0 = oc * DM_OC;
      // a warp whose frame lies past T or channels past Co adds nothing
      const bool active = frame_ok && o0 + wo < Co;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> p[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(p[i][j], 0.f);
      }
      for (int ci = 0; ci < nc; ++ci) {
        const int c0 = ci * CC;
        // with one C chunk x_s keeps the tile across the o chunks, and
        // with one o chunk too w_s keeps W_k across the tiles
        const bool new_x = nc > 1 || oc == 0;
        const bool new_w = nc > 1 || no > 1 || tile == tile_begin;
        __syncthreads();  // the previous step's MMAs have read x_s, w_s
        // x and W through cp.async (the registers are short here: both
        // accumulators are live), one vector a thread at a time
        if (new_x) {
#pragma unroll 1
          for (int vi = tid; vi < L::XV; vi += DM_THREADS) {
            const int r = vi / (CC / 8);  // row t * 32 + v
            const int t = t0 + r / DM_VP;
            const int v = r % DM_VP;
            stage8(x_s + r * L::LD + (vi % (CC / 8)) * 8, x,
                   row_b + (size_t)t * V + v, t < Tn && v < V,
                   c0 + (vi % (CC / 8)) * 8, C, x_vec);
          }
        }
        if (new_w) {
#pragma unroll 1
          for (int vi = tid; vi < L::WV; vi += DM_THREADS) {
            const int c = c0 + vi / (DM_OC / 8);
            stage8(w_s + (vi / (DM_OC / 8)) * DM_LD + (vi % (DM_OC / 8)) * 8,
                   w, (size_t)k * C + c, c < C, o0 + (vi % (DM_OC / 8)) * 8,
                   Co, w_vec);
          }
        }
        cp_async_wait_all();
        __syncthreads();
        if (active) {
          // p[rows of frame f][the warp's channels] += x_s . w_s
#pragma unroll
          for (int kk = 0; kk < CC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              wmma::load_matrix_sync(fa[i], x_s + (pr + 16 * i) * L::LD + kk,
                                     L::LD);
              wmma::load_matrix_sync(fb[i], w_s + kk * DM_LD + wo + 16 * i,
                                     DM_LD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                wmma::mma_sync(p[i][j], fa[i], fb[j], p[i][j]);
              }
            }
          }
        }
      }
      if (!active) continue;
      // the warp's own g: rows w of frame f, its 32 channels, 4 vectors a
      // lane, rows w >= V zero; loaded here, not with x and W, where the
      // registers are short, and in flight while p is rounded
      uint4 g_r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vi = lane + 32 * j;
        g_r[j] = load8(g, row_b + (size_t)(t0 + f) * V + vi / 4,
                       vi / 4 < g_rows, o0 + wo + (vi % 4) * 8, Co, g_vec);
      }
      // p rounded to bf16 (RN) once, through the warp's scratch tile;
      // lane: row lane / 2 of a tile, columns 8 * (lane % 2) .. +7
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(scratch, p[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          *reinterpret_cast<uint4*>(
              p_s + (pr + 16 * i + lane / 2) * DM_LD + wo + 16 * j +
              (lane % 2) * 8) =
              pack8(scratch + (lane / 2) * 16 + (lane % 2) * 8);
          __syncwarp();  // the scratch tile is free, p_s written
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vi = lane + 32 * j;
        *reinterpret_cast<uint4*>(g_s + (pr + vi / 4) * DM_LD + wo +
                                  (vi % 4) * 8) = g_r[j];
      }
      __syncwarp();  // g_s written
      // da1[v][w] += sum over the warp's channels of p[v][o] * g[w][o]
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(fa[i], p_s + (pr + 16 * i) * DM_LD + wo + kk,
                                 DM_LD);
          // B = g^T: element (o, w) at g_s[(pr + w) * DM_LD + o]
          wmma::load_matrix_sync(fb[i], g_s + (pr + 16 * i) * DM_LD + wo + kk,
                                 DM_LD);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::mma_sync(da[i][j], fa[i], fb[j], da[i][j]);
          }
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the staging: r_s takes it
  float* mine = r_s + warp * DM_VP * DM_VP;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(mine + 16 * i * DM_VP + 16 * j, da[i][j],
                              DM_VP, wmma::mem_row_major);
    }
  }
  __syncthreads();
  float* dst = part + (((size_t)b * K + k) * groups + grp) * V * V;
  for (int i = tid; i < V * V; i += DM_THREADS) {
    const int at = (i / V) * DM_VP + i % V;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < DM_WARPS; ++q) s += r_s[q * DM_VP * DM_VP + at];
    dst[i] = s;
  }
}

// ------------------------------------------------- da1 at any V ----

constexpr int DG_THREADS = 256;
constexpr int DG_TF = 4;     // frames a tile (the unit of the frame groups)
constexpr int DG_VT = 32;    // source joints v a block
constexpr int DG_WT = 32;    // destination joints w a block
constexpr int DG_OC = 32;    // output channels a chunk
constexpr int DG_CC = 16;    // input channels a chunk of the projection
constexpr int DG_ROWS = DG_TF * DG_VT;  // (t, v) rows of p: 128
constexpr int DG_LDX = DG_ROWS + 4;     // row stride of xT_s
constexpr int DG_LD = DG_OC + 4;        // row stride of p_s and g_s
// shared memory in floats: xT_s[DG_CC][DG_LDX], w_s[DG_CC][DG_OC],
// p_s[DG_ROWS][DG_LD], g_s[DG_TF * DG_WT][DG_LD]; at the end
// red_s[DG_TF][DG_VT][DG_WT] takes p_s
constexpr int DG_W_OFF = DG_CC * DG_LDX;
constexpr int DG_P_OFF = DG_W_OFF + DG_CC * DG_OC;
constexpr int DG_G_OFF = DG_P_OFF + DG_ROWS * DG_LD;
constexpr int DG_FLOATS = DG_G_OFF + DG_TF * DG_WT * DG_LD;
constexpr int DG_BYTES = DG_FLOATS * 4;
static_assert(DG_TF * DG_VT * DG_WT <= DG_ROWS * DG_LD, "red_s fits p_s");
static_assert(DG_BYTES <= 48 * 1024, "no opt-in shared memory needed");

// part[b, k, grp, v, w] for the block's 32 x 32 tile of (v, w): the sum
// over the group's frames t and all o of p_k[b,t,v,o] g[b,t,w,o], p_k = x
// W_k rounded to T (the identity in fp32), at any V >= 1, in exact fp32
// FMAs on the CUDA cores in both types. One block of 256 threads per
// (group of frames, (subset k, v tile, w tile), sample b); a group is a
// range of whole DG_TF-frame tiles. Per tile and DG_OC-channel o chunk:
//   1. p = x_tile . W_k[:, chunk] for the tile's 128 rows (t, v), C in
//      chunks of DG_CC (x staged transposed, xT_s[c][row], and W), each
//      thread a 4 (rows) x 4 (channels) register tile: one float4 of each
//      operand for 16 FMAs; rounded to T into p_s[row][o];
//   2. g of the tile's frames and w tile staged into g_s[(t, w)][o];
//   3. da[v][w] += sum over the chunk's o of p[t][v][o] g[t][w][o]: the
//      256 threads are 64 tiles of 4 x 4 (v, w) x 4 frames, each a float4
//      of p and of g per four rows for 64 FMAs.
// At the end the four frames' sums are added in frame order through
// shared memory. Rows past T or V and channels past C or Co are zero in
// shared memory; stores past V are skipped. Shared memory is fixed
// (47,360 bytes, dynamic), whatever V. p is formed once per w tile: at
// V > 32 again for each.
template <typename T>
__global__ void __launch_bounds__(DG_THREADS, 2)
gcn_da1_gen_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ g, float* __restrict__ part,
                   int Tn, int V, int C, int Co, int groups) {
  extern __shared__ __align__(16) float smem_dg[];
  float* xT_s = smem_dg;
  float* w_s = smem_dg + DG_W_OFF;
  float* p_s = smem_dg + DG_P_OFF;
  float* g_s = smem_dg + DG_G_OFF;

  const int nvt = (V + DG_VT - 1) / DG_VT;
  const int grp = blockIdx.x;
  const int k = blockIdx.y % K;
  const int v0 = (blockIdx.y / K / nvt) * DG_VT;
  const int w0 = (blockIdx.y / K % nvt) * DG_WT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // the projection: rows 4 ty .. 4 ty + 3, channels 4 tx .. 4 tx + 3
  const int tx = tid % 8;
  const int ty = tid / 8;
  // p g^T: the (v, w) quads 4 (tile / 8) and 4 (tile % 8) of frame f
  const int tile = tid % 64;
  const int f = tid / 64;
  const int vq = (tile / 8) * 4;
  const int wq = (tile % 8) * 4;

  // the group's frames: whole tiles [tiles*grp/groups, tiles*(grp+1)/groups)
  const long long tiles = (Tn + DG_TF - 1) / DG_TF;
  const int tile_begin = (int)(tiles * grp / groups);
  const int tile_end = (int)(tiles * (grp + 1) / groups);
  const size_t row_b = (size_t)b * Tn * V;  // x, g as (B*T*V, C or Co)
  const T* w_k = w + (size_t)k * C * Co;

  float da[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) da[i][j] = 0.f;
  }

  for (int tl = tile_begin; tl < tile_end; ++tl) {
    const int t0 = tl * DG_TF;
    for (int o0 = 0; o0 < Co; o0 += DG_OC) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int c0 = 0; c0 < C; c0 += DG_CC) {
        __syncthreads();  // the previous readers of xT_s, w_s, p_s, g_s
        for (int i = tid; i < DG_CC * DG_ROWS; i += DG_THREADS) {
          const int c = i % DG_CC;  // fastest: the reads of x coalesce
          const int r = i / DG_CC;
          const int t = t0 + r / DG_VT;
          const int v = v0 + r % DG_VT;
          const bool ok = t < Tn && v < V && c0 + c < C;
          xT_s[c * DG_LDX + r] =
              ok ? to_f(x[(row_b + (size_t)t * V + v) * C + c0 + c]) : 0.f;
        }
        for (int i = tid; i < DG_CC * DG_OC; i += DG_THREADS) {
          const int o = i % DG_OC;
          const int c = i / DG_OC;
          const bool ok = c0 + c < C && o0 + o < Co;
          w_s[i] = ok ? to_f(w_k[(size_t)(c0 + c) * Co + o0 + o]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < DG_CC; ++c) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(xT_s + c * DG_LDX + 4 * ty);
          const float4 w4 =
              *reinterpret_cast<const float4*>(w_s + c * DG_OC + 4 * tx);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          }
        }
      }
      // p rounded to x's type (from_f<float>: the identity) into p_s; the
      // C loop's barriers have kept the previous chunk's readers out
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(p_s + (4 * ty + i) * DG_LD + 4 * tx) =
            make_float4(to_f(from_f<T>(acc[i][0])),
                        to_f(from_f<T>(acc[i][1])),
                        to_f(from_f<T>(acc[i][2])),
                        to_f(from_f<T>(acc[i][3])));
      }
      for (int i = tid; i < DG_TF * DG_WT * DG_OC; i += DG_THREADS) {
        const int o = i % DG_OC;
        const int r = i / DG_OC;  // (frame, w)
        const int t = t0 + r / DG_WT;
        const int wd = w0 + r % DG_WT;
        const bool ok = t < Tn && wd < V && o0 + o < Co;
        g_s[r * DG_LD + o] =
            ok ? to_f(g[(row_b + (size_t)t * V + wd) * Co + o0 + o]) : 0.f;
      }
      __syncthreads();
      // da[v][w] += p[f][v][o] g[f][w][o] over the chunk's o, in order
      const float* pr = p_s + (f * DG_VT + vq) * DG_LD;
      const float* gr = g_s + (f * DG_WT + wq) * DG_LD;
#pragma unroll 2
      for (int q = 0; q < DG_OC; q += 4) {
        float4 pq[4], gq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pq[i] = *reinterpret_cast<const float4*>(pr + i * DG_LD + q);
          gq[i] = *reinterpret_cast<const float4*>(gr + i * DG_LD + q);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            da[i][j] = fmaf(pq[i].x, gq[j].x, da[i][j]);
            da[i][j] = fmaf(pq[i].y, gq[j].y, da[i][j]);
            da[i][j] = fmaf(pq[i].z, gq[j].z, da[i][j]);
            da[i][j] = fmaf(pq[i].w, gq[j].w, da[i][j]);
          }
        }
      }
    }
  }

  __syncthreads();  // every frame's sums are done with p_s: red_s takes it
  float* red_s = p_s;  // [f][v][w]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red_s[(f * DG_VT + vq + i) * DG_WT + wq + j] = da[i][j];
    }
  }
  __syncthreads();
  float* dst = part + (((size_t)b * K + k) * groups + grp) * V * V;
  for (int i = tid; i < DG_VT * DG_WT; i += DG_THREADS) {
    const int v = v0 + i / DG_WT;
    const int wd = w0 + i % DG_WT;
    if (v >= V || wd >= V) continue;
    float sum = 0.f;
#pragma unroll
    for (int ff = 0; ff < DG_TF; ++ff) sum += red_s[ff * DG_VT * DG_WT + i];
    dst[(size_t)v * V + wd] = sum;
  }
}

// da1[bk, i] = sum over the groups of part[bk, grp, i], in group order,
// rounded to T once
template <typename T>
__global__ void __launch_bounds__(256)
gcn_da1_reduce_kernel(const float* __restrict__ part, T* __restrict__ da1,
                      int n, int vv, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* src = part + (size_t)(i / vv) * groups * vv + i % vv;
  float s = 0.f;
  for (int gi = 0; gi < groups; ++gi) s += src[(size_t)gi * vv];
  da1[i] = from_f<T>(s);
}

// ------------------------------------------------------------ launch ----

template <typename T>
cudaError_t launch_reduce(const float* part, void* dw, int C, int Co,
                          int groups, cudaStream_t stream) {
  const int n = K * C * Co;
  gcn_dw_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dw), n, groups);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <int CT, int TM>
cudaError_t launch_dw_gemm_fp32(const float* x, const float* u, float* part,
                                int rows, int C, int Co, int groups,
                                cudaStream_t stream) {
  auto kern = gcn_dw_fp32_kernel<CT, TM>;
  const int bytes = Dw32Layout<CT, TM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Co + F_OT - 1) / F_OT, (C + CT - 1) / CT, K * groups);
  kern<<<grid, F_THREADS, bytes, stream>>>(
      x, u, part, rows, C, Co, groups, C % 4 == 0 && aligned(x, 16),
      Co % 4 == 0 && aligned(u, 16) && aligned(part, 16));
  return cudaGetLastError();
}

// dW_k = x^T u_k over the B*T*V rows, then the ordered reduce: V enters
// only through the row count, so the tuned and the general u share it
cudaError_t launch_dw_after_u_fp32(const void* x, void* dw, void* part,
                                   const void* u, int rows, int C, int Co,
                                   int groups, cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  float* pf = static_cast<float*>(part);
  // the C <= 8 entry layer takes an 8-channel C tile instead of 64
  cudaError_t err =
      C <= F_NARROW_C
          ? launch_dw_gemm_fp32<F_NARROW_C, 4>(xf, uf, pf, rows, C, Co,
                                               groups, stream)
          : launch_dw_gemm_fp32<64, 8>(xf, uf, pf, rows, C, Co, groups,
                                       stream);
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(pf, dw, C, Co, groups, stream);
}

cudaError_t launch_dw_after_u_bf16(const void* x, void* dw, void* part,
                                   const void* u, int rows, int C, int Co,
                                   int groups, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  dim3 grid((Co + MM_OT - 1) / MM_OT, (C + MM_CT - 1) / MM_CT, K * groups);
  gcn_dw_mma_kernel<<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u),
      static_cast<float*>(part), rows, C, Co, groups,
      C % 8 == 0 && aligned(x, 16));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<bf16>(static_cast<const float*>(part), dw, C, Co,
                             groups, stream);
}

template <int V>
cudaError_t launch_dw_fp32(const void* x, const void* a1, const void* g,
                           void* dw, void* part, void* u, int B, int Tn,
                           int C, int Co, int groups, cudaStream_t stream) {
  gcn_u_kernel<float, V><<<dim3((Tn + U_FRAMES - 1) / U_FRAMES, B),
                           U_THREADS, 0, stream>>>(
      static_cast<const float*>(a1), static_cast<const float*>(g),
      static_cast<float*>(u), B, Tn, Co, Co % 2 == 0 && aligned(g, 8));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_after_u_fp32(x, dw, part, u, B * Tn * V, C, Co, groups,
                                stream);
}

template <int V>
cudaError_t launch_dw_bf16(const void* x, const void* a1, const void* g,
                           void* dw, void* part, void* u, int B, int Tn,
                           int C, int Co, int groups, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  gcn_u_kernel<bf16, V><<<dim3((Tn + U_FRAMES - 1) / U_FRAMES, B),
                          U_THREADS, 0, stream>>>(
      static_cast<const bf16*>(a1), static_cast<const bf16*>(g),
      static_cast<bf16*>(u), B, Tn, Co, Co % 2 == 0 && aligned(g, 4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_after_u_bf16(x, dw, part, u, B * Tn * V, C, Co, groups,
                                stream);
}

// dW at any other V: gcn_u_gen_kernel, then the GEMM of the type
template <typename T>
cudaError_t launch_dw_gen(const void* x, const void* a1, const void* g,
                          void* dw, void* part, void* u, int B, int Tn,
                          int V, int C, int Co, int groups,
                          cudaStream_t stream) {
  const long long tiles =
      (long long)((V + UG_VT - 1) / UG_VT) * ((Co + UG_OT - 1) / UG_OT);
  if (B > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  gcn_u_gen_kernel<T><<<dim3((Tn + UG_TT - 1) / UG_TT, (unsigned)tiles, B),
                        UG_THREADS, 0, stream>>>(
      static_cast<const T*>(a1), static_cast<const T*>(g),
      static_cast<T*>(u), B, Tn, V, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sizeof(T) == 4
             ? launch_dw_after_u_fp32(x, dw, part, u, B * Tn * V, C, Co,
                                      groups, stream)
             : launch_dw_after_u_bf16(x, dw, part, u, B * Tn * V, C, Co,
                                      groups, stream);
}

template <typename T>
cudaError_t launch_da1_reduce(const void* part, void* da1, int B, int V,
                              int groups, cudaStream_t stream) {
  const int n = B * K * V * V;
  gcn_da1_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(da1), n, V * V,
      groups);
  return cudaGetLastError();
}

// What a da1 launch takes at its shapes: the frames of a tile (the unit
// of the caller's frame groups), the dynamic shared memory of a block,
// and the blocks of that size an SM of the current device holds.
struct Da1Tiling {
  int frames;
  int smem;
  int blocks_per_sm;
};

// Lets `kern` take `bytes` of dynamic shared memory; with `tiling` set,
// fills it in (the launcher then returns without launching).
template <typename Kern>
cudaError_t prepare_da1(Kern kern, int threads, int frames, int bytes,
                        Da1Tiling* tiling) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || tiling == nullptr) return err;
  tiling->frames = frames;
  tiling->smem = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &tiling->blocks_per_sm, kern, threads, bytes);
}

template <int V, int CC>
cudaError_t launch_da1_fp32_cc(const void* x, const void* w, const void* g,
                               void* da1, void* part, int B, int Tn, int C,
                               int Co, int groups, cudaStream_t stream,
                               Da1Tiling* tiling) {
  auto kern = gcn_da1_fp32_kernel<V, CC>;
  const int bytes = Da32Layout<V, CC>::BYTES;
  cudaError_t err =
      prepare_da1(kern, D32_THREADS, Da32Tile<V>::TT, bytes, tiling);
  if (err != cudaSuccess || tiling != nullptr) return err;
  kern<<<dim3(groups, K, B), D32_THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(part), Tn, C, Co,
      groups, C % 4 == 0 && aligned(x, 16), Co % 4 == 0 && aligned(w, 16),
      Co % 4 == 0 && aligned(g, 16));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_da1_reduce<float>(part, da1, B, V, groups, stream);
}

template <int V>
cudaError_t launch_da1_fp32(const void* x, const void* w, const void* g,
                            void* da1, void* part, int B, int Tn, int C,
                            int Co, int groups, cudaStream_t stream,
                            Da1Tiling* tiling) {
  // the C = 3 entry layer takes 4-channel chunks instead of 13 of zeros
  // out of 16
  if (C <= D32_NARROW_C) {
    return launch_da1_fp32_cc<V, 4>(x, w, g, da1, part, B, Tn, C, Co, groups,
                                    stream, tiling);
  }
  return launch_da1_fp32_cc<V, 16>(x, w, g, da1, part, B, Tn, C, Co, groups,
                                   stream, tiling);
}

template <int V, int CC>
cudaError_t launch_da1_mma(const void* x, const void* w, const void* g,
                           void* da1, void* part, int B, int Tn, int C,
                           int Co, int groups, cudaStream_t stream,
                           Da1Tiling* tiling) {
  using bf16 = __nv_bfloat16;
  auto kern = gcn_da1_mma_kernel<V, CC>;
  const int bytes = DaMmaLayout<CC>::BYTES;
  cudaError_t err = prepare_da1(kern, DM_THREADS, TT, bytes, tiling);
  if (err != cudaSuccess || tiling != nullptr) return err;
  kern<<<dim3(groups, K, B), DM_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(g), static_cast<float*>(part), Tn, C, Co,
      groups, C % 8 == 0 && aligned(x, 16), Co % 8 == 0 && aligned(w, 16),
      Co % 8 == 0 && aligned(g, 16), V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_da1_reduce<bf16>(part, da1, B, V, groups, stream);
}

template <int V>
cudaError_t launch_da1_bf16(const void* x, const void* w, const void* g,
                            void* da1, void* part, int B, int Tn, int C,
                            int Co, int groups, cudaStream_t stream,
                            Da1Tiling* tiling) {
  // the C=3 entry layer takes one 16-deep chunk instead of 64
  if (C <= 16) {
    return launch_da1_mma<V, 16>(x, w, g, da1, part, B, Tn, C, Co, groups,
                                 stream, tiling);
  }
  return launch_da1_mma<V, 64>(x, w, g, da1, part, B, Tn, C, Co, groups,
                               stream, tiling);
}

// da1 at any other V, both types: gcn_da1_gen_kernel, then the reduce
template <typename T>
cudaError_t launch_da1_gen(const void* x, const void* w, const void* g,
                           void* da1, void* part, int B, int Tn, int V, int C,
                           int Co, int groups, cudaStream_t stream,
                           Da1Tiling* tiling) {
  auto kern = gcn_da1_gen_kernel<T>;
  cudaError_t err = prepare_da1(kern, DG_THREADS, DG_TF, DG_BYTES, tiling);
  if (err != cudaSuccess || tiling != nullptr) return err;
  const int nvt = (V + DG_VT - 1) / DG_VT;
  if ((long long)K * nvt * nvt > 65535) return cudaErrorInvalidValue;
  kern<<<dim3(groups, K * nvt * nvt, B), DG_THREADS, DG_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<float*>(part), Tn, V, C, Co,
      groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_da1_reduce<T>(part, da1, B, V, groups, stream);
}

// da1 at V joints in fp32 or bf16, launched, or with `tiling` set only
// described
cudaError_t dispatch_da1(const void* x, const void* w, const void* g,
                         void* da1, void* part, int B, int Tn, int V, int C,
                         int Co, int groups, int bf16, cudaStream_t stream,
                         Da1Tiling* tiling) {
  switch (V) {  // the joint counts of the skeletons (NTU, Kinetics,
                // OpenPose 15)
    case 25:
      return bf16 ? launch_da1_bf16<25>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling)
                  : launch_da1_fp32<25>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling);
    case 18:
      return bf16 ? launch_da1_bf16<18>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling)
                  : launch_da1_fp32<18>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling);
    case 15:
      return bf16 ? launch_da1_bf16<15>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling)
                  : launch_da1_fp32<15>(x, w, g, da1, part, B, Tn, C, Co,
                                        groups, stream, tiling);
    default:  // any other V: the general kernel
      return bf16 ? launch_da1_gen<__nv_bfloat16>(x, w, g, da1, part, B, Tn,
                                                  V, C, Co, groups, stream,
                                                  tiling)
                  : launch_da1_gen<float>(x, w, g, da1, part, B, Tn, V, C,
                                          Co, groups, stream, tiling);
  }
}

}  // namespace

// the dW kernels: `groups` splits the 32-row chunks of the B*T*V rows (at
// most their count); `u` is the (K, B*T*V, Co) buffer of u in x's type
extern "C" int agcn_gcn_bwd_dw(const void* x, const void* a1, const void* g,
                               void* dw, void* part, void* u, int B, int Tn,
                               int V, int C, int Co, int groups, int bf16,
                               void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long most = ((long long)B * Tn * V + MM_RK - 1) / MM_RK;
  static_assert(MM_RK == F_RK, "both dW kernels take 32-row chunks");
  if (V < 1 || groups < 1 || groups > most ||
      (long long)K * groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  switch (V) {  // the joint counts of the skeletons (NTU, Kinetics,
                // OpenPose 15)
    case 25:
      return (int)(bf16 ? launch_dw_bf16<25>(x, a1, g, dw, part, u, B, Tn,
                                              C, Co, groups, s)
                        : launch_dw_fp32<25>(x, a1, g, dw, part, u, B, Tn,
                                             C, Co, groups, s));
    case 18:
      return (int)(bf16 ? launch_dw_bf16<18>(x, a1, g, dw, part, u, B, Tn,
                                              C, Co, groups, s)
                        : launch_dw_fp32<18>(x, a1, g, dw, part, u, B, Tn,
                                             C, Co, groups, s));
    case 15:
      return (int)(bf16 ? launch_dw_bf16<15>(x, a1, g, dw, part, u, B, Tn,
                                              C, Co, groups, s)
                        : launch_dw_fp32<15>(x, a1, g, dw, part, u, B, Tn,
                                             C, Co, groups, s));
    default:  // any other V: the general u, then the same GEMMs
      return (int)(bf16 ? launch_dw_gen<__nv_bfloat16>(x, a1, g, dw, part, u,
                                                       B, Tn, V, C, Co,
                                                       groups, s)
                        : launch_dw_gen<float>(x, a1, g, dw, part, u, B, Tn,
                                               V, C, Co, groups, s));
  }
}

extern "C" int agcn_gcn_bwd_da1(const void* x, const void* w, const void* g,
                                void* da1, void* part, int B, int Tn, int V,
                                int C, int Co, int groups, int bf16,
                                void* stream) {
  // `groups` splits each sample's frame tiles (agcn_gcn_bwd_da1_tiling's
  // frames; at most their count) and `part` is the (B, K, groups, V, V)
  // fp32 partials
  if (V < 1) return (int)cudaErrorInvalidValue;
  // a tile's frames: at the tuned V TT in bf16 and Da32Tile<V>::TT in
  // fp32, at any other V the general kernel's DG_TF
  const bool tuned = V == 25 || V == 18 || V == 15;
  const int tt = !tuned ? DG_TF : bf16 ? TT : D32_ROWS_P / V;
  if (groups < 1 || groups > (Tn + tt - 1) / tt ||
      (long long)K * groups > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch_da1(x, w, g, da1, part, B, Tn, V, C, Co, groups,
                           bf16, static_cast<cudaStream_t>(stream), nullptr);
}

// The tiling agcn_gcn_bwd_da1 takes at V joints and C input channels, on
// the current device: out[0] the frames of a tile, out[1] the dynamic
// shared memory of a block in bytes, out[2] the blocks an SM holds.
extern "C" int agcn_gcn_bwd_da1_tiling(int V, int C, int bf16, int* out) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  Da1Tiling tiling{};
  const cudaError_t err = dispatch_da1(nullptr, nullptr, nullptr, nullptr,
                                       nullptr, 0, 0, V, C, 0, 0, bf16,
                                       nullptr, &tiling);
  if (err != cudaSuccess) return (int)err;
  out[0] = tiling.frames;
  out[1] = tiling.smem;
  out[2] = tiling.blocks_per_sm;
  return 0;
}
