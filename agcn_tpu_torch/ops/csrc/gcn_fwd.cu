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
// Three kernels. At the tuned joint counts V = 15, 18 and 25 (the
// skeletons of graph/skeletons.py, each a template instance):
//   gcn_fwd_mma_kernel: bf16 x and a1, both round_agg modes, on the tensor
//     cores: round_agg = 1 (the served forward and the dx of training) as
//     SPLIT = false, round_agg = 0 (gcn_kernel's fused_gcn) as SPLIT = true;
//   gcn_fwd_fp32_kernel: every other combination (fp32, bf16 x with fp32
//     a1), all math in exact fp32 FMAs on the CUDA cores, so its ceiling
//     is the fp32 rate for both types.
// At every other V >= 1 (the JAX Pallas kernels take any V):
//   gcn_fwd_gen_kernel<T, A>: all three type combinations, both round_agg
//     modes, V a run-time argument, in exact fp32 FMAs on the CUDA cores;
//     fixed tiles of 32 destination x 32 source joints, so its shared
//     memory does not grow with V (below, before the tensor-core section).
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
// tile lies past T or Co skips its MMAs. Every V up to 32 takes the same
// 32-row slot a frame (25, 18 and 15 are built): at V = 15 more than
// half of each slot is padding, so a frame costs about what it costs at
// V = 25. Every sum runs in an order fixed
// by the shapes, with no atomics, so two calls are bitwise equal.
//
// gcn_fwd_fp32_kernel<T, V, OT, CC>: the aggregate never goes to device
// memory (as on the TPU, where it stayed in VMEM), and it is formed once
// per block for all OT output channels. One block of 256 threads owns
// (sample b, TT whole frames, OT output channels); its rows are (t, w)
// flattened without padding w. OT = 64 when Co <= 64 (256 rows: 10
// frames at V = 25, 14 at V = 18, 17 at V = 15), OT = 128 above (128
// rows: 5, 7 or 8 frames), OT = 8 when Co <= 8 (the dx of the C = 3
// entry layer, Co = 3; 1,024 rows: 40, 56 or 68 frames). At V = 15 a
// frame's a1 row is padded to 16 (four float4), as V = 25's is to 28 and
// V = 18's to 20. It stages a1[b] once, then walks C in
// chunks of CC (16; 4 when C <= 8 or Co <= 8), per chunk:
//   1. the aggregate aggT_k[c][t V + w] = sum_v x[t][v][c] a1_k[v][w],
//      transposed in shared memory, for every k and row of the tile:
//      each thread forms 4 (c) x 4 (w) tiles from a float4 of x and a
//      float4 of the staged a1 row per v (16 FMAs per 2 loads), rounded
//      to x's type with round_agg (the identity in fp32);
//   2. the projection acc += aggT_k[c][rows] (x) W_k[c][cols] over k and
//      c: each thread keeps an 8 x 8 fp32 register tile (4 x 8 at OT =
//      8), two row quads 4 RY rows apart and two column quads 4 CX
//      channels apart, so a warp's float4 loads of a staged row hit
//      distinct banks or broadcast; two float4 loads of each operand
//      feed 64 FMAs.
// x and W go to shared memory by cp.async (16-byte copies where the
// width is a multiple of 16 bytes and the base aligned, else 4-byte
// ones; bf16 staged raw and converted where it is read, its pieces of
// less than 16 bytes through registers; past the edges zero-filled):
// the W chunk is in flight during the aggregate, the next x chunk during
// the projection, two barriers a chunk. 128 registers at most
// (__launch_bounds__(256, 2)). y is written once, from registers.
//
// Ragged edges (T not a multiple of the block's frames, C not a multiple
// of the chunk, Co not a multiple of the output tile) are masked: staged
// values beyond the edge are zero and stores beyond it are skipped. No
// padding of T, C or Co is needed in device memory. Every sum runs in an
// order fixed by the shapes, with no atomics, so two calls are bitwise
// equal.
//
// C interface: agcn_gcn_fwd(...) launches on the given stream of the
// current device and returns cudaGetLastError() (0 on success). At an
// untuned V the only limits are the general kernel's grid: B <= 65535
// and ceil(V / 32) * ceil(Co / 64) <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int K = 3;             // spatial subsets
constexpr int TT = 4;            // frames per block (tensor cores)
constexpr int OT = 64;           // output channels per block (tensor cores)

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

// ---- any other V: the general kernel on the CUDA cores ----

constexpr int G_THREADS = 256;
constexpr int G_TT = 4;     // frames a block
constexpr int G_WT = 32;    // destination joints w a block
constexpr int G_VS = 32;    // source joints v a slice (the aggregate's step)
constexpr int G_OT = 64;    // output channels a block
constexpr int G_CC = 16;    // input channels a chunk
constexpr int G_ROWS = G_TT * G_WT;  // (t, w) rows of a block: 128
constexpr int G_LDA = G_ROWS + 4;    // row stride of agg_s
// shared memory in floats: agg_s[K][G_CC][G_LDA], then one staging
// region that holds x_s[G_TT][G_VS][G_CC] and a_s[K][G_VS][G_WT] during
// the aggregate and w_s[K][G_CC][G_OT] during the projection
constexpr int G_AGG = K * G_CC * G_LDA;
constexpr int G_XS = G_TT * G_VS * G_CC;
constexpr int G_AS = K * G_VS * G_WT;
constexpr int G_WS = K * G_CC * G_OT;
constexpr int G_STAGE = G_XS + G_AS > G_WS ? G_XS + G_AS : G_WS;
static_assert((G_AGG + G_STAGE) * 4 <= 48 * 1024, "static shared memory");

// y = sum_k round(x a1_k) W_k at any V >= 1, every sum in exact fp32 FMAs
// (the identity rounding in fp32). One block of 256 threads owns (sample
// b, G_TT frames, G_WT destination joints, G_OT output channels): 128
// rows (t, w) x 64 channels. Per chunk of G_CC input channels:
//   1. the aggregate agg_k[t][w][c] = sum_v x[t][v][c] a1_k[v][w] for the
//      block's rows, v in slices of G_VS source joints (x and a1 of a
//      slice staged, zero past the edges), v in order from 0; a thread
//      owns channel c = tid % 16 of eight rows (one frame, eight w) of
//      agg_s[k][c][row], summed one k at a time, one load of x and two
//      float4 of a1 for 8 FMAs, its running sums carried in agg_s from
//      slice to slice; after the last, rounded to T with round_agg.
//   2. the projection acc[row][o] += agg_s[k][c][row] W_k[c][o], (k, c)
//      in order: each thread an 8 (rows) x 4 (channels) register tile,
//      two float4 of agg_s and one of W for 32 FMAs.
// Shared memory is fixed (45,824 bytes), whatever V: no V is refused.
// Bound: the same work as the tuned kernels (header), which this
// simple kernel does not approach (PERF.md section 6).
template <typename T, typename A>
__global__ void __launch_bounds__(G_THREADS, 2)
gcn_fwd_gen_kernel(const T* __restrict__ x, const A* __restrict__ a1,
                   const T* __restrict__ w, T* __restrict__ y, int Tn, int V,
                   int C, int Co, int round_agg) {
  __shared__ __align__(16) float smem_gen[G_AGG + G_STAGE];
  float* agg_s = smem_gen;
  float* x_s = smem_gen + G_AGG;
  float* a_s = x_s + G_XS;
  float* w_s = smem_gen + G_AGG;  // the same region, after the aggregate

  const int nwt = (V + G_WT - 1) / G_WT;
  const int t0 = blockIdx.x * G_TT;
  const int w0 = (blockIdx.y % nwt) * G_WT;
  const int o0 = (blockIdx.y / nwt) * G_OT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // the aggregate: channel ac of the rows 8 arg .. 8 arg + 7 (frame
  // arg / 4, joints 8 (arg % 4) ..)
  const int ac = tid % G_CC;
  const int arg = tid / G_CC;
  const int at = arg / 4;
  const int aw = (arg % 4) * 8;
  // the projection: rows 8 ty .. 8 ty + 7, channels 4 tx .. 4 tx + 3
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t xb = (size_t)b * Tn * V;  // x and y as (B T V, .)
  const A* a_b = a1 + (size_t)b * K * V * V;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += G_CC) {
    for (int v0 = 0; v0 < V; v0 += G_VS) {
      __syncthreads();  // the previous readers of the staging region (and
                        // of agg_s: the previous chunk's projection)
      for (int i = tid; i < G_XS; i += G_THREADS) {
        const int c = i % G_CC;
        const int v = i / G_CC % G_VS;
        const int t = i / (G_CC * G_VS);
        const bool ok = t0 + t < Tn && v0 + v < V && c0 + c < C;
        x_s[i] = ok ? to_f(x[(xb + (size_t)(t0 + t) * V + v0 + v) * C + c0 +
                             c])
                    : 0.f;
      }
      for (int i = tid; i < G_AS; i += G_THREADS) {
        const int wd = i % G_WT;
        const int v = i / G_WT % G_VS;
        const int k = i / (G_WT * G_VS);
        const bool ok = v0 + v < V && w0 + wd < V;
        a_s[i] = ok ? to_f(a_b[((size_t)k * V + v0 + v) * V + w0 + wd]) : 0.f;
      }
      __syncthreads();
      const int nv = V - v0 < G_VS ? V - v0 : G_VS;
      const bool last = v0 + G_VS >= V;
      const float* xr = x_s + at * G_VS * G_CC + ac;
      // one k at a time, the thread's own eight sums carried from slice
      // to slice in agg_s (fp32, so the order stays v = 0 .. V-1): three
      // k's sums in registers beside the 32 accumulators spilled
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        float* dst = agg_s + (k * G_CC + ac) * G_LDA + arg * 8;
        float s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = v0 == 0 ? 0.f : dst[j];
        const float* ar = a_s + k * G_VS * G_WT + aw;
#pragma unroll 2
        for (int v = 0; v < nv; ++v) {
          const float xv = xr[v * G_CC];
          const float4 lo = *reinterpret_cast<const float4*>(ar + v * G_WT);
          const float4 hi =
              *reinterpret_cast<const float4*>(ar + v * G_WT + 4);
          s[0] = fmaf(xv, lo.x, s[0]);
          s[1] = fmaf(xv, lo.y, s[1]);
          s[2] = fmaf(xv, lo.z, s[2]);
          s[3] = fmaf(xv, lo.w, s[3]);
          s[4] = fmaf(xv, hi.x, s[4]);
          s[5] = fmaf(xv, hi.y, s[5]);
          s[6] = fmaf(xv, hi.z, s[6]);
          s[7] = fmaf(xv, hi.w, s[7]);
        }
        // gcn_fused semantics: after the last slice the aggregate is
        // rounded to x's type (the identity in fp32)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dst[j] = last && round_agg ? to_f(from_f<T>(s[j])) : s[j];
        }
      }
    }
    __syncthreads();  // every thread is done with x_s and a_s: W takes them
    for (int i = tid; i < G_WS; i += G_THREADS) {
      const int o = i % G_OT;
      const int c = i / G_OT % G_CC;
      const int k = i / (G_OT * G_CC);
      const bool ok = c0 + c < C && o0 + o < Co;
      w_s[i] = ok ? to_f(w[((size_t)k * C + c0 + c) * Co + o0 + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll 2
      for (int c = 0; c < G_CC; ++c) {
        const float* ar = agg_s + (k * G_CC + c) * G_LDA + 8 * ty;
        const float4 lo = *reinterpret_cast<const float4*>(ar);
        const float4 hi = *reinterpret_cast<const float4*>(ar + 4);
        const float4 wv =
            *reinterpret_cast<const float4*>(w_s + (k * G_CC + c) * G_OT +
                                             4 * tx);
        const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wq[j], acc[i][j]);
        }
      }
    }
  }

  // y rows (t, w) inside T and V, channels o < Co
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * ty + i;
    const int t = t0 + r / G_WT;
    const int wd = w0 + r % G_WT;
    if (t >= Tn || wd >= V) continue;
    T* dst = y + (xb + (size_t)t * V + wd) * Co + o0 + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (o0 + 4 * tx + j < Co) dst[j] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, typename A>
cudaError_t launch_gen(const void* x, const void* a1, const void* w, void* y,
                       int B, int Tn, int V, int C, int Co, int round_agg,
                       cudaStream_t stream) {
  const long long tiles =
      (long long)((V + G_WT - 1) / G_WT) * ((Co + G_OT - 1) / G_OT);
  if (V < 1 || B > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((Tn + G_TT - 1) / G_TT, (unsigned)tiles, B);
  gcn_fwd_gen_kernel<T, A><<<grid, G_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const A*>(a1),
      static_cast<const T*>(w), static_cast<T*>(y), Tn, V, C, Co, round_agg);
  return cudaGetLastError();
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
  switch (V) {  // the joint counts of the skeletons (NTU, Kinetics,
                // OpenPose 15), each padded to the 32-row tile
    case 25:
      return launch_mma_cc<25, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
    case 18:
      return launch_mma_cc<18, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
    case 15:
      return launch_mma_cc<15, SPLIT>(x, a1, w, y, B, Tn, C, Co, stream);
    default:  // any other V: the general kernel, on the CUDA cores
      return launch_gen<__nv_bfloat16, __nv_bfloat16>(
          x, a1, w, y, B, Tn, V, C, Co, SPLIT ? 0 : 1, stream);
  }
}

// ---- fp32, and bf16 x with fp32 a1, on the CUDA cores ----

// cp.async of 16 (or 4) bytes from src to shared memory at dst; with !ok
// nothing is read (source size 0: src may be any valid address) and dst
// is zero-filled. Wait for them with cp_async_wait_all. (The same
// helpers as in gcn_bwd.cu: each source builds alone.)
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four consecutive values of a staged row as floats (a 16-byte load of
// fp32, an 8-byte one of bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

constexpr int F_THREADS = 256;
constexpr int F_NARROW = 8;  // Co up to this takes the 8-channel tile
constexpr int F_NARROW_C = 4;  // C up to 8, or Co up to 8, takes CC = 4

// The tiling of gcn_fwd_fp32_kernel for V joints, OT output channels per
// block and input-channel chunks of CC. A thread owns RQ row quads (4 RY
// rows apart) x two column quads (4 CX channels apart) of the output
// tile: 8 x 8 at OT = 64 (rows 256, 10 frames at V = 25) and OT = 128
// (rows 128, 5 frames), 4 x 8 at OT = 8 (rows 1,024, 40 frames). Rows are
// (t, w) flattened without padding w; the ROWS_P - TT V rows past the
// last frame are never stored.
template <int V, int OT, int CC>
struct F32Tile {
  static constexpr int CX = OT / 8;                // threads across columns
  static constexpr int RY = F_THREADS / CX;        // threads across rows
  static constexpr int RQ = OT == F_NARROW ? 1 : 2;  // row quads a thread
  static constexpr int ROWS_P = 4 * RY * RQ;       // 1,024, 256 or 128
  static constexpr int TT = ROWS_P / V;            // frames a block
  static constexpr int ROWS = TT * V;
  static constexpr int VP = (V + 3) / 4 * 4;       // a1 row, float4-padded
  static constexpr int WQ = VP / 4;                // w quads of a frame
  static constexpr int CQ = CC / 4;                // c quads of a chunk
  static constexpr int ITEMS = K * TT * CQ * WQ;   // aggregate 4 x 4 tiles
  static constexpr int LDA = ROWS_P + 4;           // row stride of aggT_s
  static_assert(OT % 8 == 0 && F_THREADS % CX == 0 && CC % 4 == 0,
                "fp32 forward tiling");
};

// Shared-memory layout in bytes: a_s[K][V][VP] and aggT_s[K][CC][LDA] in
// fp32, then x_s[ROWS][CC] and w_s[K][CC][OT] in x's type (bf16 is
// staged raw and converted where it is read).
template <typename T, int V, int OT, int CC>
struct F32Layout : F32Tile<V, OT, CC> {
  using B = F32Tile<V, OT, CC>;
  static constexpr int AGG_OFF = K * V * B::VP * 4;
  static constexpr int X_OFF = AGG_OFF + K * CC * B::LDA * 4;
  static constexpr int W_OFF =
      X_OFF + (B::ROWS * CC * (int)sizeof(T) + 15) / 16 * 16;
  static constexpr int BYTES = W_OFF + K * CC * OT * (int)sizeof(T);
};

// Rows [0, NR) x columns [0, W) of a tile, element (r, c) =
// m[(row0 + r) * n + col0 + c] where r < rows_ok and col0 + c < n, else
// zero, into dst (row stride W) by cp.async. `vec`: n and col0 are
// multiples of 16 / sizeof(T) and m is 16-byte aligned, so each piece
// of 16 bytes is wholly inside or wholly outside. bf16 pieces of less
// than 16 bytes (cp.async copies 4 bytes at least) go through registers.
// The loops stay rolled: unrolled, their index math, which depends on
// the thread alone, was hoisted out of the caller's chunk loop and held
// in registers across it, and ptxas spilled.
template <typename T, int NR, int W>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ m,
                                           size_t row0, int rows_ok,
                                           int col0, int n, bool vec,
                                           int tid) {
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  if constexpr (W % E == 0) {
    if (vec) {
      constexpr int NV = NR * W / E;
#pragma unroll 1
      for (int i = tid; i < NV; i += F_THREADS) {
        const int r = i / (W / E);
        const int c = (i % (W / E)) * E;
        const bool ok = r < rows_ok && col0 + c < n;
        cp_async16(dst + r * W + c, ok ? m + (row0 + r) * n + col0 + c : m,
                   ok);
      }
      return;
    }
  }
#pragma unroll 1
  for (int i = tid; i < NR * W; i += F_THREADS) {
    const int r = i / W;
    const int c = i % W;
    const bool ok = r < rows_ok && col0 + c < n;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst + i, ok ? m + (row0 + r) * n + col0 + c : m, ok);
    } else {
      dst[i] = ok ? m[(row0 + r) * n + col0 + c] : from_f<T>(0.f);
    }
  }
}

// s[c][j] += x[c] a[j]: one step of an aggregate item, 16 FMAs
__device__ __forceinline__ void fma4x4(float (&s)[4][4], const float4& x,
                                       const float4& a) {
  const float xv[4] = {x.x, x.y, x.z, x.w};
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[c][j] = fmaf(xv[c], av[j], s[c][j]);
  }
}

// acc[r][j] += a[r] w[j]: one (k, c) step of the projection, RQ row quads
// x two column quads, 32 RQ FMAs
template <int RQ>
__device__ __forceinline__ void fma_step(float (&acc)[4 * RQ][8],
                                         const float4 (&a)[RQ],
                                         const float4 (&w)[2]) {
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const float av[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float wv[4] = {w[h].x, w[h].y, w[h].z, w[h].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[4 * q + i][4 * h + j] =
              fmaf(av[i], wv[j], acc[4 * q + i][4 * h + j]);
        }
      }
    }
  }
}

// y = sum_k round(x a1_k) W_k on the CUDA cores in exact fp32 FMAs (the
// tensor cores' fp32 is TF32, which would miss the fp32 bar). Two blocks
// an SM: the bound caps the registers at 128.
template <typename T, int V, int OT, int CC>
__global__ void __launch_bounds__(F_THREADS, 2)
gcn_fwd_fp32_kernel(const T* __restrict__ x, const float* __restrict__ a1,
                    const T* __restrict__ w, T* __restrict__ y, int Tn,
                    int C, int Co, int round_agg, bool x_vec, bool w_vec,
                    bool y_vec) {
  using L = F32Layout<T, V, OT, CC>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* a_s = reinterpret_cast<float*>(smem_f32);
  float* agg_s = reinterpret_cast<float*>(smem_f32 + L::AGG_OFF);
  T* x_s = reinterpret_cast<T*>(smem_f32 + L::X_OFF);
  T* w_s = reinterpret_cast<T*>(smem_f32 + L::W_OFF);

  const int t0 = blockIdx.x * L::TT;
  const int o0 = blockIdx.y * OT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % L::CX;  // column quads at 4 tx + 4 CX j
  const int ty = tid / L::CX;  // row quads at 4 ty + 4 RY i
  // frames of the tile inside T, and their (t, w) rows
  const int t_ok = Tn - t0 < L::TT ? Tn - t0 : L::TT;
  const int rows_ok = t_ok * V;
  const size_t row0 = ((size_t)b * Tn + t0) * V;  // x and y as (B T V, .)
  const int n = (C + CC - 1) / CC;

  auto stage_x = [&](int c0) {
    stage_tile<T, L::ROWS, CC>(x_s, x, row0, rows_ok, c0, C, x_vec, tid);
    cp_async_commit();
  };
  auto stage_w = [&](int c0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      stage_tile<T, CC, OT>(w_s + k * CC * OT, w + (size_t)k * C * Co, c0,
                            C - c0, o0, Co, w_vec, tid);
    }
    cp_async_commit();
  };

  stage_x(0);
  // a1[b] once per block, rows zero-padded to VP
  const float* a_b = a1 + (size_t)b * K * V * V;
  for (int i = tid; i < K * V * L::VP; i += F_THREADS) {
    const int col = i % L::VP;
    a_s[i] = col < V ? a_b[(i / L::VP) * V + col] : 0.f;
  }

  float acc[4 * L::RQ][8];
#pragma unroll
  for (int a = 0; a < 4 * L::RQ; ++a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int c0 = i * CC;
    cp_async_wait_all();  // this thread's copies of x chunk i are in
    __syncthreads();      // everyone's (and a_s); the projection of chunk
                          // i - 1 is done with w_s and agg_s
    stage_w(c0);          // in flight during the aggregate

    // aggregate: aggT_k[c][t V + w] = sum_v x[t][v][c] a1_k[v][w], a 4 (c)
    // x 4 (w) tile an item, v in order from 0
#pragma unroll 1
    for (int item = tid; item < L::ITEMS; item += F_THREADS) {
      const int wq = item % L::WQ;
      const int cq = item / L::WQ % L::CQ;
      const int t = item / (L::WQ * L::CQ) % L::TT;
      const int k = item / (L::WQ * L::CQ * L::TT);
      if (t >= t_ok) continue;  // rows past T are never stored
      const T* xr = x_s + t * V * CC + 4 * cq;
      const float* ar = a_s + k * V * L::VP + 4 * wq;
      float s[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[c][j] = 0.f;
      }
      // v in order from 0; the loads of step v + 1 are in flight during
      // the FMAs of step v, in a second register set (unrolled twice:
      // faster on the H100 than once or fully, PERF.md section 6)
      float4 xa = ld4(xr), aa = ld4(ar);
#pragma unroll 2
      for (int v = 0; v + 1 < V; v += 2) {
        const float4 xb = ld4(xr + (v + 1) * CC);
        const float4 ab = ld4(ar + (v + 1) * L::VP);
        fma4x4(s, xa, aa);
        const int nv = v + 2 < V ? v + 2 : v;  // past the end: reloaded
        xa = ld4(xr + nv * CC);
        aa = ld4(ar + nv * L::VP);
        fma4x4(s, xb, ab);
      }
      if constexpr (V % 2 == 1) fma4x4(s, xa, aa);
      float* dst = agg_s + (k * CC + 4 * cq) * L::LDA + t * V + 4 * wq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * wq + j >= V) continue;  // the pad columns of a1
          // gcn_fused semantics: the aggregate is rounded to x's type
          // (the identity in fp32)
          dst[c * L::LDA + j] =
              round_agg ? to_f(from_f<T>(s[c][j])) : s[c][j];
        }
      }
    }
    cp_async_wait_all();  // this thread's copies of W chunk i are in
    __syncthreads();      // everyone's, and every aggregate of the chunk
    if (i + 1 < n) stage_x(c0 + CC);  // in flight during the projection

    // project: acc[rows][cols] += aggT_k[c][rows] W_k[c][cols], (k, c) in
    // order, one staged row of each a step; the loads of step kc + 1 in
    // flight during the FMAs of step kc (two register sets, K CC even;
    // unrolled fully)
    {
      const float* ar = agg_s + 4 * ty;
      const T* wr = w_s + 4 * tx;
      float4 pa[L::RQ], pw[2], qa[L::RQ], qw[2];
      auto fetch = [&](float4 (&a)[L::RQ], float4 (&w)[2], int kc) {
#pragma unroll
        for (int q = 0; q < L::RQ; ++q) {
          a[q] = ld4(ar + kc * L::LDA + q * 4 * L::RY);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) w[h] = ld4(wr + kc * OT + h * 4 * L::CX);
      };
      fetch(pa, pw, 0);
#pragma unroll
      for (int kc = 0; kc < K * CC; kc += 2) {
        fetch(qa, qw, kc + 1);
        fma_step<L::RQ>(acc, pa, pw);
        fetch(pa, pw, kc + 2 < K * CC ? kc + 2 : kc);  // past the end: reloaded
        fma_step<L::RQ>(acc, qa, qw);
      }
    }
  }

  // y rows (t, w) inside T, channels o < Co
#pragma unroll
  for (int a = 0; a < 4 * L::RQ; ++a) {
    const int r = 4 * ty + (a / 4) * 4 * L::RY + a % 4;
    if (r >= rows_ok) continue;
    T* dst = y + (row0 + r) * Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + 4 * tx + h * 4 * L::CX;
      if (o >= Co) continue;
      if (y_vec) {  // Co % 4 == 0: the whole quad lies inside
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(dst + o) =
              make_float4(acc[a][4 * h], acc[a][4 * h + 1],
                          acc[a][4 * h + 2], acc[a][4 * h + 3]);
        } else {
          uint2 u;
          u.x = pack2(acc[a][4 * h], acc[a][4 * h + 1]);
          u.y = pack2(acc[a][4 * h + 2], acc[a][4 * h + 3]);
          *reinterpret_cast<uint2*>(dst + o) = u;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (o + j < Co) dst[o + j] = from_f<T>(acc[a][4 * h + j]);
        }
      }
    }
  }
}

template <typename T, int V, int OT, int CC>
cudaError_t launch_fp32(const void* x, const void* a1, const void* w,
                        void* y, int B, int Tn, int C, int Co,
                        int round_agg, cudaStream_t stream) {
  using L = F32Layout<T, V, OT, CC>;
  auto kern = gcn_fwd_fp32_kernel<T, V, OT, CC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  constexpr int E = 16 / (int)sizeof(T);
  auto aligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  dim3 grid((Tn + L::TT - 1) / L::TT, (Co + OT - 1) / OT, B);
  kern<<<grid, F_THREADS, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a1),
      static_cast<const T*>(w), static_cast<T*>(y), Tn, C, Co, round_agg,
      C % E == 0 && aligned(x, 16), Co % E == 0 && aligned(w, 16),
      Co % 4 == 0 && aligned(y, 4 * sizeof(T)));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_fp32_tile(const void* x, const void* a1, const void* w,
                             void* y, int B, int Tn, int C, int Co,
                             int round_agg, cudaStream_t stream) {
  // Co <= 8 (the dx of the C = 3 entry layer) takes the 8-channel tile
  // and 4-channel chunks; otherwise 64 or 128 output channels, and C <= 8
  // (the entry layer) 4-channel chunks instead of 13 of zeros out of 16
  if (Co <= F_NARROW) {
    return launch_fp32<T, V, F_NARROW, F_NARROW_C>(x, a1, w, y, B, Tn, C, Co,
                                                   round_agg, stream);
  }
  if (Co <= 64) {
    return C <= 8 ? launch_fp32<T, V, 64, F_NARROW_C>(x, a1, w, y, B, Tn, C,
                                                      Co, round_agg, stream)
                  : launch_fp32<T, V, 64, 16>(x, a1, w, y, B, Tn, C, Co,
                                              round_agg, stream);
  }
  return C <= 8 ? launch_fp32<T, V, 128, F_NARROW_C>(x, a1, w, y, B, Tn, C,
                                                     Co, round_agg, stream)
                : launch_fp32<T, V, 128, 16>(x, a1, w, y, B, Tn, C, Co,
                                             round_agg, stream);
}

template <typename T>
cudaError_t launch_fp32_v(const void* x, const void* a1, const void* w,
                          void* y, int B, int Tn, int V, int C, int Co,
                          int round_agg, cudaStream_t stream) {
  switch (V) {  // the joint counts of the skeletons (NTU, Kinetics,
                // OpenPose 15)
    case 25:
      return launch_fp32_tile<T, 25>(x, a1, w, y, B, Tn, C, Co, round_agg,
                                     stream);
    case 18:
      return launch_fp32_tile<T, 18>(x, a1, w, y, B, Tn, C, Co, round_agg,
                                     stream);
    case 15:
      return launch_fp32_tile<T, 15>(x, a1, w, y, B, Tn, C, Co, round_agg,
                                     stream);
    default:  // any other V: the general kernel
      return launch_gen<T, float>(x, a1, w, y, B, Tn, V, C, Co, round_agg,
                                  stream);
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
  if (!x_bf16 && !a_bf16) {  // CUDA cores
    err = launch_fp32_v<float>(x, a1, w, y, B, Tn, V, C, Co, round_agg, s);
  } else if (x_bf16 && a_bf16) {  // tensor cores
    err = round_agg ? launch_mma_v<false>(x, a1, w, y, B, Tn, V, C, Co, s)
                    : launch_mma_v<true>(x, a1, w, y, B, Tn, V, C, Co, s);
  } else if (x_bf16) {  // CUDA cores, bf16 staged raw
    err = launch_fp32_v<__nv_bfloat16>(x, a1, w, y, B, Tn, V, C, Co,
                                       round_agg, s);
  } else {
    err = cudaErrorInvalidValue;  // fp32 x with bf16 a1 is not taken
  }
  return (int)err;
}
