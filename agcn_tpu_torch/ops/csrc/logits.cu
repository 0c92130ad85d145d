// Embedding-attention logits for NVIDIA Hopper (sm_90a).
//
//   S[b,k,v,w] = sum_{t,c} th[b,t,v,k,c] * ph[b,t,w,k,c] / divisor
//
// th, ph (B,T,V,K,Ce) in float or bf16, read through their strides (in
// elements), so the theta and phi views of the fused (B,T,V,2*K*Ce)
// embedding are read where they lie; S (B,K,V,V) in float, the sums in
// fp32, the division one IEEE division of each sum.
//
// Replaces the TPU kernel agcn_tpu/ops/pallas/logits_kernel.py _kernel
// (reached through packed_logits and attention_logits_pallas). The TPU
// packs the K subsets' V rows at stride 32 into one 128 x 128 product per
// sample and keeps only its K diagonal V x V blocks. Here only the K
// diagonal blocks are computed, on the unpadded contraction x = (t, c).
//
// What bounds it on an H100: each call must read th and ph once
// (2 * B * T * V * K * Ce values) and write B * K * V * V floats, and do
// 2 * B * K * V^2 * T * Ce flops: V / 2 = 12.5 flops per byte in bf16 and
// 6.25 in fp32 at V = 25, far under the bf16 ridge of 295 (989 TFLOP/s on
// the tensor cores over 3.35 TB/s) and under the fp32 ridge of 20 (67
// TFLOP/s on the CUDA cores). Bytes bound it in both types: at the served
// AAGCN batch (B = 32, K = 3, ten layers of T * Ce = 4,800 or 9,600) a
// forward reads 553 MB in bf16 (0.166 ms) and 1.1 GB in fp32 (0.331 ms)
// for 6.9 GFLOP. So the design spends its effort on keeping the memory
// system busy and on issuing few instructions per byte:
//
// - Staging, both types. A block owns one (span of the contraction,
//   subset k, sample b) and walks its span in chunks of whole frames: a
//   chunk is F frames x `cols` channels (all Ce of them, or one part of
//   a frame when Ce is wider than 256), staged as s[v][x] with
//   x = f * cols + c, for th and ph alike, V rows each. For one (b, k) the
//   channels of a (t, v) row are contiguous in the embedding views, so
//   each row goes in whole 16-byte cp.async copies (32 to 256 bytes a
//   row at the served shapes), which take no registers and ask L2 for
//   the whole 128-byte line, which the other subsets' blocks read too; a
//   thread keeps its (tensor, joint, piece) and steps down the F frames,
//   its source address advancing by the frame stride (no division
//   anywhere in the copy loops). Rows or strides that are not 16-byte
//   aligned take 4-byte copies, and bf16 rows with 2-byte alignment or a
//   channel stride other than 1 go one element at a time through
//   registers: every shape stays on the kernel. Frames past T and
//   channels past Ce are zero-filled by the copies; rows v >= V and the
//   columns past F * cols are zeroed once per block, never written
//   again. Chunks go through a ring of three buffers: two chunks in
//   flight while the third is multiplied, one barrier a chunk.
// - bf16, logits_mma_kernel: the tensor cores, nvcuda::wmma 16x16x16 bf16
//   fragments with fp32 accumulators. S_k = Th_k Ph_k^T is a "TN"
//   product: A is th_s row-major [v][x], B is ph_s read col_major from the
//   same [w][x] layout, so neither is transposed. V is padded to 32; the
//   wasted MMAs cost nothing here. The 8 warps split each chunk's 16-wide
//   steps of x round-robin, each keeping its own 2 x 2 accumulator tiles
//   (32 x 32); at the end the warps' tiles are summed through shared
//   memory in warp order. Products of bf16 values are exact in fp32.
// - fp32, logits_fp32_kernel<V>: exact fp32 FMAs on the CUDA cores (TF32's
//   ten-bit mantissa would miss the 1e-5 bar). Each thread owns a VT x VT
//   register tile of (v, w) and one slice of every chunk's x quads
//   (slices cut the chunk's quads into nearly equal runs): 5 x 5 tiles
//   x 10 slices = 250 of 256 threads at V = 25, 6 x 6 x 28 = 252 at
//   V = 18, and a general 4 x 4 tile over V padded to 32 (4 slices) for
//   every other V <= 32. Per quad a thread reads VT float4 of th and VT
//   of ph for 4 VT^2 FMAs: 100 FMAs for 10 shared loads at V = 25. At the
//   end the slices are summed through shared memory in slice order.
// - Spans: the wrapper's launch_plan cuts each (b, k) contraction into
//   spans of whole chunks, their number fixed by the shapes alone: the
//   fewest waves of the card's block slots times a block's chunks (at
//   the served batch, 4 spans in bf16 and 5 in fp32; at the training
//   batch 1 and 2). Several spans write fp32 partials that
//   logits_reduce_kernel sums in span order. No atomics: two calls on
//   the same inputs give bitwise-equal results, and on integer inputs
//   whose sums stay below 2^24 the result is exact. (Summing the spans
//   inside a thread-block cluster instead, through distributed shared
//   memory, measured slower from 3 spans on: a cluster's blocks must be
//   placed together.)
//
// Shared memory (dynamic; 3 buffers x 2 tensors x rows x ld), and the
// blocks an SM holds of 256 threads (64K registers and 228 KB of shared
// memory an SM; the registers as ptxas reports them): bf16, 32 rows of
// ld = width + 8 bf16 (width = F * cols rounded up to 16; 128 at every
// served shape): 52,224 bytes, three blocks (bound by its 79 registers).
// fp32, rows of width + 4 floats (width 160 at Ce = 16 and 32, 128 at
// Ce = 64): V = 25, 98,400 / 79,200 bytes; V = 18, 70,848 / 57,024; both
// two blocks (128 registers); the general tile (32 rows) 125,952 /
// 101,376, one / two blocks. The wrapper's span rule assumes three bf16
// and two fp32 blocks an SM.
//
// C interface: agcn_logits(...) launches on the given stream of the
// current device and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;   // the ring: two chunks in flight
constexpr int VP = 32;      // joints, padded: the MMA's 32 x 32 tile
constexpr int MAX_SMEM = 232448;

struct Strides {
  long long b, t, v, k, c;
};

// What a launch stages per chunk (the wrapper's launch_plan).
struct Chunk {
  int frames;  // F whole frames a chunk
  int cols;    // channels of each frame a chunk: Ce, or a part of it
  int parts;   // chunks per frame group: ceil(Ce / cols)
  int width;   // staged columns: F * cols rounded up to 16
  int ld;      // row stride of a staged tile, in elements
  int copy;    // bytes a copy: 16, 4 (cp.async) or 2 (bf16, registers)
};

// cp.async of 16 or 4 bytes from src to shared memory at dst; with !ok
// nothing is read (source size 0: src may be any valid address) and dst
// is zero-filled. Each asks L2 for the whole 128-byte line (L2::128B):
// a (t, v) row of one subset is 32-128 bytes of a line that the other
// subsets' blocks and the other tensor read too. Wait for them with
// cp_async_wait_group / _all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;\n" ::"r"(s),
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

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// Where a thread's copies of a chunk start: pieces (tensor, v, q) of the
// 2 V rows (th's V, then ph's V) x q pieces a row, numbered r * pieces +
// q, thread tid taking tid, tid + THREADS, ...; (q, r) advance by (dq, dr)
// with one carry, so the copy loops divide nothing.
struct Walk {
  int q0, r0, dq, dr, pieces, pe;
};

__device__ __forceinline__ Walk make_walk(const Chunk& ch, int size) {
  Walk w;
  w.pe = ch.copy / size;  // elements a piece (1 through registers)
  w.pieces = ch.cols / w.pe;
  w.q0 = threadIdx.x % w.pieces;
  w.r0 = threadIdx.x / w.pieces;
  w.dq = THREADS % w.pieces;
  w.dr = THREADS / w.pieces;
  return w;
}

// One chunk of th and ph into th_s and ph_s (row v at v * ld, frame f's
// channels at f * cols): frames [t0, t0 + F) (past Tn: zeros), channels
// [c0, c0 + cols) of each (past Ce: zeros). th, ph: this block's (b, k).
template <typename T>
__device__ __forceinline__ void stage_chunk(T* th_s, T* ph_s,
                                            const T* __restrict__ th,
                                            const T* __restrict__ ph,
                                            const Strides& sth,
                                            const Strides& sph, int V,
                                            int Ce, int Tn, const Chunk& ch,
                                            const Walk& wk, int t0, int c0) {
  const int nf_all = Tn - t0 < ch.frames ? Tn - t0 : ch.frames;
  int q = wk.q0, r = wk.r0;
  while (r < 2 * V) {
    const bool second = r >= V;
    const int v = second ? r - V : r;
    // the strides by value: a reference chosen between the two structs
    // would put them in local memory
    const long long sv = second ? sph.v : sth.v;
    const long long st = second ? sph.t : sth.t;
    const long long sc = second ? sph.c : sth.c;
    const T* base = second ? ph : th;
    const int c = c0 + q * wk.pe;
    const T* src = base + v * sv + c * sc + t0 * st;
    T* dst = (second ? ph_s : th_s) + v * ch.ld + q * wk.pe;
    const int nf = c < Ce ? nf_all : 0;  // frames with data
    switch (ch.copy) {
      case 16:
#pragma unroll 1
        for (int f = 0; f < ch.frames; ++f, src += st, dst += ch.cols) {
          cp_async16(dst, f < nf ? src : base, f < nf);
        }
        break;
      case 4:  // one fp32 element (any channel stride) or two bf16
#pragma unroll 1
        for (int f = 0; f < ch.frames; ++f, src += st, dst += ch.cols) {
          cp_async4(dst, f < nf ? src : base, f < nf);
        }
        break;
      default:  // one element through a register
#pragma unroll 1
        for (int f = 0; f < ch.frames; ++f, src += st, dst += ch.cols) {
          *dst = f < nf ? *src : zero<T>();
        }
    }
    q += wk.dq;
    r += wk.dr;
    if (q >= wk.pieces) {
      q -= wk.pieces;
      ++r;
    }
  }
}

// Zero, in every buffer of the ring, what no copy writes and the product
// reads: rows [V, ROWS) and, of rows [0, V), columns [F * cols, width).
template <typename T, int ROWS>
__device__ __forceinline__ void zero_pads(T* ring, int V, const Chunk& ch) {
  const int filled = ch.frames * ch.cols;
  for (int r = threadIdx.x / 32; r < STAGES * 2 * ROWS; r += WARPS) {
    const int row = r % ROWS;
    for (int c = (row < V ? filled : 0) + threadIdx.x % 32; c < ch.width;
         c += 32) {
      ring[(size_t)r * ch.ld + c] = zero<T>();
    }
  }
}

// The chunks a block walks: its span (blockIdx.x of the (spans, K, B)
// grid) of the (b, k) contraction's ceil(T / F) * parts chunks.
struct Span {
  int first, count;
};
__device__ __forceinline__ Span block_span(int Tn, const Chunk& ch,
                                           int span_chunks) {
  const int total = (Tn + ch.frames - 1) / ch.frames * ch.parts;
  const int first = blockIdx.x * span_chunks;
  const int last = first + span_chunks < total ? first + span_chunks : total;
  return Span{first, last - first};
}

// Drives the ring over a block's span: stage(i, buf) starts chunk i's
// copies into buffer buf; product(buf) multiplies a landed chunk.
template <typename Stage, typename Product>
__device__ __forceinline__ void run_ring(int n, Stage stage,
                                         Product product) {
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) stage(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_group<STAGES - 2>();  // this thread's copies of chunk i
    __syncthreads();  // everyone's; and chunk i - 1's product is done
                      // with the buffer that chunk i + 2 takes
    if (i + STAGES - 1 < n) stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();  // (an empty group past the end)
    product(i % STAGES);
  }
  cp_async_wait_all();
  __syncthreads();  // every product is done: the ring may be reused
}

// The block's sums to their place; sum(e) is the block's sum for element
// e = v * rows + w. One span: the logits. Several: span s's fp32 partial,
// laid out (splits, B, K, V, V), which logits_reduce_kernel sums in span
// order.
template <typename Sum>
__device__ __forceinline__ void finish(float* out, int B, int K, int V,
                                       int rows, float divisor, Sum sum) {
  const bool whole = gridDim.x == 1;
  float* dst = out + (((size_t)blockIdx.x * B + blockIdx.z) * K +
                      blockIdx.y) * V * V;
  for (int e = threadIdx.x; e < rows * rows; e += THREADS) {
    const int v = e / rows, w = e % rows;
    if (v >= V || w >= V) continue;
    const float total = sum(e);
    dst[v * V + w] = whole ? total / divisor : total;
  }
}

// ------------------------------------------------------------- bf16 ----

__global__ void __launch_bounds__(THREADS, 3)
logits_mma_kernel(const bf16* __restrict__ th, Strides sth,
                  const bf16* __restrict__ ph, Strides sph,
                  float* __restrict__ out, int B, int K, int V, int Ce,
                  int Tn, Chunk ch, int span_chunks, float divisor) {
  extern __shared__ __align__(128) unsigned char smem_lg[];
  bf16* ring = reinterpret_cast<bf16*>(smem_lg);
  const int tile = VP * ch.ld;  // one tensor's staged tile
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  th += b * sth.b + k * sth.k;
  ph += b * sph.b + k * sph.k;
  const Span sp = block_span(Tn, ch, span_chunks);
  const Walk wk = make_walk(ch, 2);
  zero_pads<bf16, VP>(ring, V, ch);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  const int steps = ch.width / 16;
  run_ring(
      sp.count,
      [&](int i, int buf) {
        const int ci = sp.first + i;
        const int grp = ci / ch.parts;
        bf16* t_s = ring + (size_t)buf * 2 * tile;
        stage_chunk<bf16>(t_s, t_s + tile, th, ph, sth, sph, V, Ce, Tn, ch,
                          wk, grp * ch.frames,
                          (ci - grp * ch.parts) * ch.cols);
      },
      [&](int buf) {
        const bf16* a_s = ring + (size_t)buf * 2 * tile;
        const bf16* b_s = a_s + tile;
        for (int ks = warp; ks < steps; ks += WARPS) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(fa[i], a_s + 16 * i * ch.ld + 16 * ks,
                                   ch.ld);
            wmma::load_matrix_sync(fb[i], b_s + 16 * i * ch.ld + 16 * ks,
                                   ch.ld);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
            }
          }
        }
      });

  // the warps' 32 x 32 tiles, summed in warp order
  float* red = reinterpret_cast<float*>(smem_lg);  // [WARPS][32][32]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(red + warp * VP * VP + 16 * i * VP + 16 * j,
                              acc[i][j], VP, wmma::mem_row_major);
    }
  }
  __syncthreads();
  finish(out, B, K, V, VP, divisor, [&](int e) {
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) sum += red[wp * VP * VP + e];
    return sum;
  });
}

// ------------------------------------------------------------- fp32 ----

// The register tiling of logits_fp32_kernel for V joints (0: any other
// V <= 32): VT x VT tiles of (v, w), NT x NT of them over the staged
// ROWS x ROWS, each worked by SLICES threads.
template <int V_>
struct F32Tile {
  static constexpr int VT = V_ == 25 ? 5 : V_ == 18 ? 6 : 4;
  static constexpr int NT = V_ == 25 ? 5 : V_ == 18 ? 3 : 8;
  static constexpr int ROWS = VT * NT;  // 25, 18 or 32
  static constexpr int TILES = NT * NT;
  static constexpr int SLICES = THREADS / TILES;  // 10, 28 or 4
  static constexpr int WORKERS = TILES * SLICES;  // 250, 252 or 256
  static constexpr int RED_BYTES = SLICES * ROWS * ROWS * 4;
  static_assert(V_ == 0 || ROWS == V_, "the tile covers V exactly");
};

template <int V_>
__global__ void __launch_bounds__(THREADS, 2)
logits_fp32_kernel(const float* __restrict__ th, Strides sth,
                   const float* __restrict__ ph, Strides sph,
                   float* __restrict__ out, int B, int K, int V, int Ce,
                   int Tn, Chunk ch, int span_chunks, float divisor) {
  using L = F32Tile<V_>;
  extern __shared__ __align__(128) unsigned char smem_lg[];
  float* ring = reinterpret_cast<float*>(smem_lg);
  const int tile = L::ROWS * ch.ld;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  th += b * sth.b + k * sth.k;
  ph += b * sph.b + k * sph.k;
  const Span sp = block_span(Tn, ch, span_chunks);
  const Walk wk = make_walk(ch, 4);
  zero_pads<float, L::ROWS>(ring, V, ch);

  // the thread's (v, w) tile and its run [qa, qb) of each chunk's quads
  const int my_tile = tid % L::TILES;
  const int slice = tid / L::TILES;
  const int v0 = my_tile / L::NT * L::VT;
  const int w0 = my_tile % L::NT * L::VT;
  const int quads = ch.width / 4;
  const bool works = tid < L::WORKERS;
  const int qa = works ? slice * quads / L::SLICES : 0;
  const int qb = works ? (slice + 1) * quads / L::SLICES : 0;

  float acc[L::VT][L::VT];
#pragma unroll
  for (int i = 0; i < L::VT; ++i) {
#pragma unroll
    for (int j = 0; j < L::VT; ++j) acc[i][j] = 0.f;
  }
  run_ring(
      sp.count,
      [&](int i, int buf) {
        const int ci = sp.first + i;
        const int grp = ci / ch.parts;
        float* t_s = ring + (size_t)buf * 2 * tile;
        stage_chunk<float>(t_s, t_s + tile, th, ph, sth, sph, V, Ce, Tn, ch,
                           wk, grp * ch.frames,
                           (ci - grp * ch.parts) * ch.cols);
      },
      [&](int buf) {
        const float* a_s = ring + (size_t)buf * 2 * tile + v0 * ch.ld;
        const float* b_s = ring + (size_t)buf * 2 * tile + tile + w0 * ch.ld;
#pragma unroll 2
        for (int q = qa; q < qb; ++q) {
          float4 pq[L::VT];
#pragma unroll
          for (int j = 0; j < L::VT; ++j) {
            pq[j] = *reinterpret_cast<const float4*>(b_s + j * ch.ld + 4 * q);
          }
#pragma unroll
          for (int i = 0; i < L::VT; ++i) {
            const float4 tq =
                *reinterpret_cast<const float4*>(a_s + i * ch.ld + 4 * q);
#pragma unroll
            for (int j = 0; j < L::VT; ++j) {
              acc[i][j] = fmaf(tq.x, pq[j].x, acc[i][j]);
              acc[i][j] = fmaf(tq.y, pq[j].y, acc[i][j]);
              acc[i][j] = fmaf(tq.z, pq[j].z, acc[i][j]);
              acc[i][j] = fmaf(tq.w, pq[j].w, acc[i][j]);
            }
          }
        }
      });

  // the slices' tiles, summed in slice order
  float* red = ring;  // [SLICES][ROWS][ROWS]
  if (works) {
#pragma unroll
    for (int i = 0; i < L::VT; ++i) {
#pragma unroll
      for (int j = 0; j < L::VT; ++j) {
        red[(slice * L::ROWS + v0 + i) * L::ROWS + w0 + j] = acc[i][j];
      }
    }
  }
  __syncthreads();
  finish(out, B, K, V, L::ROWS, divisor, [&](int e) {
    float sum = 0.f;
    for (int s = 0; s < L::SLICES; ++s) sum += red[s * L::ROWS * L::ROWS + e];
    return sum;
  });
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

// ----------------------------------------------------------- launch ----

int ld_of(int width, bool is_bf16) { return width + (is_bf16 ? 8 : 4); }

int rows_of(int V, bool is_bf16) {
  if (is_bf16) return VP;
  return V == 25 ? 25 : V == 18 ? 18 : F32Tile<0>::ROWS;
}

int smem_bytes(int V, int width, bool is_bf16) {
  const int ring =
      STAGES * 2 * rows_of(V, is_bf16) * ld_of(width, is_bf16) *
      (is_bf16 ? 2 : 4);
  const int red = is_bf16               ? WARPS * VP * VP * 4
                  : V == 25             ? F32Tile<25>::RED_BYTES
                  : V == 18             ? F32Tile<18>::RED_BYTES
                                        : F32Tile<0>::RED_BYTES;
  return ring > red ? ring : red;
}

// What one launch takes, from the C entry.
struct Launch {
  const void* th;
  Strides sth;
  const void* ph;
  Strides sph;
  float* out;
  int B, K, V, Ce, Tn;
  Chunk ch;
  int span_chunks;
  float divisor;
};

// The kernel of a launch (type, V) on `grid`, its dynamic shared memory
// set first.
cudaError_t dispatch(const Launch& l, bool is_bf16, dim3 grid, int bytes,
                     cudaStream_t stream) {
  auto run = [&](auto kern, auto* type) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(type)>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(l.th), l.sth, static_cast<const T*>(l.ph),
        l.sph, l.out, l.B, l.K, l.V, l.Ce, l.Tn, l.ch, l.span_chunks,
        l.divisor);
    return cudaGetLastError();
  };
  if (is_bf16) return run(logits_mma_kernel, (bf16*)nullptr);
  if (l.V == 25) return run(logits_fp32_kernel<25>, (float*)nullptr);
  if (l.V == 18) return run(logits_fp32_kernel<18>, (float*)nullptr);
  return run(logits_fp32_kernel<0>, (float*)nullptr);
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Each piece of `copy` bytes lies inside one row and is aligned: copies
// wider than an element need unit channel stride and every row start
// (pointer and strides) on a multiple of the copy.
bool copies_fit(const void* p, const Strides& s, int size, int copy,
                int Ce, int cols) {
  if (copy == size) return true;
  if (s.c != 1 || (Ce * size) % copy || (cols * size) % copy) return false;
  const long long st[4] = {s.b, s.t, s.v, s.k};
  for (long long x : st) {
    if ((x * size) % copy) return false;
  }
  return aligned(p, copy);
}

}  // namespace

extern "C" int agcn_logits(const void* th, const void* ph, void* out,
                           void* partial, const long long* args,
                           float divisor, void* stream) {
  // launches on the caller's current device, which owns `stream`; with
  // several spans, `partial` (splits, B, K, V, V) takes their sums.
  // args (the wrapper's launch_args): th's strides (b, t, v, k, c), ph's,
  // B, Tn, V, K, Ce, frames, cols, copy, splits, span_chunks, is_bf16
  const Strides sth{args[0], args[1], args[2], args[3], args[4]};
  const Strides sph{args[5], args[6], args[7], args[8], args[9]};
  for (int i = 10; i < 21; ++i) {
    if (args[i] < 0 || args[i] > 0x7fffffff) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int B = (int)args[10], Tn = (int)args[11], V = (int)args[12],
            K = (int)args[13], Ce = (int)args[14], frames = (int)args[15],
            cols = (int)args[16], copy = (int)args[17],
            splits = (int)args[18], span_chunks = (int)args[19];
  const bool bf = args[20] != 0;
  const int size = bf ? 2 : 4;
  if (V < 1 || V > VP || K < 1 || K > 65535 || B < 1 || B > 65535 ||
      Ce < 1 || Tn < 1 || frames < 1 || cols < 1 || cols > Ce ||
      splits < 1 || span_chunks < 1 ||
      (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int parts = (Ce + cols - 1) / cols;
  const long long total = (long long)(Tn + frames - 1) / frames * parts;
  // copies of 16/4 bytes, or (bf16) one element through a register; a
  // part's channels start on a whole piece
  if (!(copy == 16 || copy == 4 || (bf && copy == 2)) ||
      !copies_fit(th, sth, size, copy, Ce, cols) ||
      !copies_fit(ph, sph, size, copy, Ce, cols) ||
      (long long)frames * cols > 4096 ||
      (long long)splits * span_chunks < total ||
      (long long)(splits - 1) * span_chunks >= total) {
    return (int)cudaErrorInvalidValue;
  }
  const int width = (frames * cols + 15) / 16 * 16;
  const int bytes = smem_bytes(V, width, bf);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const bool partials = splits > 1;
  const Launch l{th, sth, ph, sph, partials ? static_cast<float*>(partial) : o,
                 B, K, V, Ce, Tn,
                 Chunk{frames, cols, parts, width, ld_of(width, bf), copy},
                 span_chunks, divisor};
  const dim3 grid(splits, K, B);
  cudaError_t err = dispatch(l, bf, grid, bytes, s);
  if (err != cudaSuccess || !partials) return (int)err;
  const int n = B * K * V * V;
  logits_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(l.out, o, n, splits,
                                                       divisor);
  return (int)cudaGetLastError();
}
