// Shared device code of the low-rank linear applies for Hopper (sm_90a).
// Included by lowrank_linear_batched.cu (per-row adapters from (G, ., r)
// tables) and lowrank_linear.cu (one adapter, no ids: the lift-free
// training read). Each .cu builds into its own library, so the anonymous
// namespace gives each its own copy.
//
// For every flattened row i of x (rows, m), with g its adapter:
//   shrink:   s[i, :] = x[i] @ S_g           (S_g (m, r) fp32: rts right |
//                                             bases left), FP32 cores
//   GEMM:     acc     = x[i] @ W             (fp32 accumulation)
//   epilogue: y[i, c] = fmaf(scales[g], acc, s[i, :] @ E_g[:, c])
//                                            (E_g = bases^T right | rts
//                                             left), rounded once to y
//
// Three routes, chosen by the wrapper from the arguments alone
// (kernels/lowrank_linear.py::route) before anything launches:
//
// 1. tc_gemm (bf16 x and W, rows >= 64: prefill and training). Bound by
//    the base GEMM's operations at the bf16 tensor-core rate. A
//    warp-specialised GEMM: one producer thread keeps a ring of up to 8
//    shared-memory stages (as many as fit) filled by TMA (128-byte
//    swizzle, an mbarrier per stage and direction); BM/64 consumer
//    warpgroups run wgmma m64n128k16 bf16 -> fp32 on them. A is the x
//    tile (K-major), B the W tile read in place as N-major through the
//    wgmma transpose bit (no copy of W). Row tiles vary fastest in the
//    grid, so the blocks in flight share W's column slabs through L2. The
//    epilogue is fused: before the mainloop the consumers stage the
//    tile's s rows, each row's scale and the E_g columns of every
//    sequence the tile spans in shared memory and compute the rank-r
//    delta of their outputs into registers while the ring fills; after it
//    each output is one fmaf(scale, acc, delta), rounded to bf16 into a
//    shared tile and stored 16 bytes at a time. When the output tiles
//    cannot fill the card and the output is small, K is split across
//    blocks into fp32 partials and reduce_kernel finishes (a fixed
//    summation order: no atomics). The shrink is its own pass
//    (tc_shrink_kernel): blocks of 32 rows of one sequence, so one S_g
//    serves the block, x and S_g staged in 128-wide K chunks, 4 rows x 4
//    ranks a thread and the warps over K, in K pieces that tc_sum_kernel
//    adds in order.
// 2. tc_decode (bf16 x and W, rows < 64: decode). Bound by the bytes of W.
//    Swap-AB: W's columns are the wgmma M side (A read N-major through
//    the transpose bit), the rows, zero-filled by TMA to NR = 16 or 64,
//    the N side, so no tensor-core row pads a 64-row tile. Blocks of 128
//    W columns x one K chunk stream W through a 6-stage TMA ring, a stage
//    freed as soon as its (cheap) MMAs complete; K is split so that the
//    blocks fill the card's resident slots in one wave. Every block first
//    computes one K piece of the shrink for all rows (the shrink is
//    gridded over (row, K piece) with the GEMM), then writes fp32
//    partials; reduce_kernel sums partials and shrink pieces in a fixed
//    order and applies the epilogue.
// 3. fp32 (any fp32 operand, m or n not a multiple of 8, a base pointer of
//    x, W or y not 16-byte aligned, r > 64). Exact fp32 products on the
//    FP32 cores: a shrink block per row, 64 x 64 output tiles with 4 x 4
//    FMA blocks per thread, split-K into reduce_kernel when the tiles
//    cannot fill the card. No ported path sends such a call; it serves
//    the fp32 and odd-shaped checks.
//
// TMA descriptors (CUtensorMap) are encoded on the host at every launch
// from the tensors' pointers (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion, so nothing links libcuda) and passed
// as __grid_constant__ parameters, which CUDA-graph capture records.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using bf16 = __nv_bfloat16;

enum Route { ROUTE_FP32 = 0, ROUTE_TC_GEMM = 1, ROUTE_TC_DECODE = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// A row's adapter, clamped into the table only so that a bad id cannot read
// outside it: the serving entry points refuse ids outside [0, G). Without
// ids (the single-adapter apply, G = 1) every row reads table entry 0.
__device__ __forceinline__ int adapter_of(const int* ids, int row, int t,
                                          int G) {
  if (ids == nullptr) return 0;
  const int g = ids[row / t];
  return min(max(g, 0), G - 1);
}

struct Expand {
  const float* etab;    // E tables: bases (right) | rts (left)
  long long g_stride;   // elements between adapters
  int k_stride;         // elements between rank rows of E_g
  int col_stride;       // elements between output columns of E_g
};

__device__ __forceinline__ float expand_dot(const float* srow,
                                            const float* __restrict__ eg,
                                            int r, const Expand& e, int col) {
  float d = 0.f;
  const float* ec = eg + (size_t)col * e.col_stride;
#pragma unroll 8
  for (int k = 0; k < r; ++k)
    d = fmaf(srow[k], __ldg(ec + (size_t)k * e.k_stride), d);
  return d;
}

// Everything one launch needs; `s` holds `pieces` shrink partials
// (pieces, rows, r), `partial` ksplit GEMM partials (ksplit, rows, n).
struct Call {
  const void* x;
  const void* w;
  const float* stab;     // S tables: rts (right) | bases (left)
  const float* scales;   // (G,)
  const int* ids;        // (B,), or nullptr for one adapter
  Expand e;
  void* y;
  float* s;
  float* partial;
  int rows, t, m, n, r, G;
  int bm, ksplit, k_chunk, pieces, piece;
  cudaStream_t stream;
};

// ------------------------------------------------ reduce and epilogue --
constexpr int RED_THREADS = 256;

// grid (ceil(n / RED_THREADS), min(rows, 65535)). For each row: s = the
// sum of the `pieces` shrink partials (lanes of each rank column summed in
// a fixed order), then per column y = fmaf(scales[g], sum of the ksplit
// GEMM partials, s . E_g[:, col]). The loads that need no s (g, the scale,
// the partials, up to 16 ranks of E) are issued before the s sums.
template <typename TY>
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ partial,
              const float* __restrict__ s_part,
              const float* __restrict__ scales, const int* __restrict__ ids,
              Expand e, TY* __restrict__ y, int rows, int t, int n, int r,
              int G, int ksplit, int pieces) {
  extern __shared__ float red[];          // [lanes][r], then s row [r]
  constexpr int RREG = 16;
  const int lanes = max(1, RED_THREADS / r);
  float* srow = red + lanes * r;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * RED_THREADS + tid;
  const bool live = col < n;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int g = adapter_of(ids, row, t, G);
    const float* eg = e.etab + (size_t)g * e.g_stride;
    float acc = 0.f, sc = 0.f, ev[RREG];
    if (live) {
      sc = scales[g];
#pragma unroll 8
      for (int z = 0; z < ksplit; ++z)
        acc += partial[((size_t)z * rows + row) * n + col];
      const float* ec = eg + (size_t)col * e.col_stride;
      if (e.k_stride == 1 && (r & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(ec) & 15) == 0) {   // 16-byte loads
#pragma unroll
        for (int k = 0; k < RREG; k += 4) {
          const float4 q4 =
              k < r ? __ldg(reinterpret_cast<const float4*>(ec + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
          ev[k] = q4.x; ev[k + 1] = q4.y; ev[k + 2] = q4.z; ev[k + 3] = q4.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < RREG; ++k)
          ev[k] = k < r ? __ldg(ec + (size_t)k * e.k_stride) : 0.f;
      }
    }
    for (int o = tid; o < lanes * r; o += RED_THREADS) {
      const int lane = o / r, j = o - lane * r;
      float v = 0.f;
#pragma unroll 8
      for (int f = lane; f < pieces; f += lanes)
        v += s_part[((size_t)f * rows + row) * r + j];
      red[o] = v;
    }
    __syncthreads();
    for (int j = tid; j < r; j += RED_THREADS) {
      float v = 0.f;
      for (int l = 0; l < lanes; ++l) v += red[l * r + j];
      srow[j] = v;
    }
    __syncthreads();
    if (live) {
      float d;
      if (r <= RREG) {
        d = 0.f;
#pragma unroll
        for (int k = 0; k < RREG; ++k)
          if (k < r) d = fmaf(srow[k], ev[k], d);
      } else {
        d = expand_dot(srow, eg, r, e, col);
      }
      y[(size_t)row * n + col] = from_f32<TY>(fmaf(sc, acc, d));
    }
    __syncthreads();
  }
}

template <typename TY>
cudaError_t launch_reduce(const Call& c) {
  const int lanes = RED_THREADS / c.r > 1 ? RED_THREADS / c.r : 1;
  const size_t smem = (size_t)(lanes * c.r + c.r) * sizeof(float);
  dim3 grid((c.n + RED_THREADS - 1) / RED_THREADS,
            c.rows < 65535 ? c.rows : 65535);
  reduce_kernel<TY><<<grid, RED_THREADS, smem, c.stream>>>(
      c.partial, c.s, c.scales, c.ids, c.e, static_cast<TY*>(c.y), c.rows,
      c.t, c.n, c.r, c.G, c.ksplit, c.pieces);
  return cudaGetLastError();
}

// ========================================================= route: fp32 ==
constexpr int SHRINK_THREADS = 256;
constexpr int SHRINK_K = 16;   // rank columns per pass over the row

// One block per row: s[row, :] = x[row] @ S_g, a single shrink piece.
template <typename TX>
__global__ void __launch_bounds__(SHRINK_THREADS)
fp32_shrink_kernel(const TX* __restrict__ x, const float* __restrict__ stab,
                   const int* __restrict__ ids, float* __restrict__ s, int t,
                   int m, int r, int G) {
  const int row = blockIdx.x;
  const int g = adapter_of(ids, row, t, G);
  const TX* xr = x + (size_t)row * m;
  const float* sg = stab + (size_t)g * m * r;
  __shared__ float red[SHRINK_THREADS / 32][SHRINK_K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < r; k0 += SHRINK_K) {
    const int kn = min(SHRINK_K, r - k0);
    float acc[SHRINK_K];
#pragma unroll
    for (int kk = 0; kk < SHRINK_K; ++kk) acc[kk] = 0.f;
    for (int j = threadIdx.x; j < m; j += SHRINK_THREADS) {
      const float xv = to_f32(xr[j]);
      const float* srow = sg + (size_t)j * r + k0;
#pragma unroll
      for (int kk = 0; kk < SHRINK_K; ++kk)
        if (kk < kn) acc[kk] = fmaf(xv, __ldg(srow + kk), acc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < SHRINK_K; ++kk) {
      float v = acc[kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][kk] = v;
    }
    __syncthreads();
    if (threadIdx.x < kn) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < SHRINK_THREADS / 32; ++wi) v += red[wi][threadIdx.x];
      s[(size_t)row * r + k0 + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

// grid (ceil(n/BN), ceil(rows/BM), ksplit). With ksplit == 1 the epilogue
// is fused and y is written; otherwise block z writes its K-chunk's
// partial sums to partial[z] and reduce_kernel finishes.
template <typename TX, typename TW, typename TY>
__global__ void __launch_bounds__(GEMM_THREADS)
fp32_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 const float* __restrict__ scales, const int* __restrict__ ids,
                 const float* __restrict__ s, Expand e, TY* __restrict__ y,
                 float* __restrict__ partial, int rows, int t, int m, int n,
                 int r, int G, int k_chunk) {
  __shared__ float xs[BK][BM + 4];   // x tile, transposed: xs[k][row]
  __shared__ float ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(m, k_begin + k_chunk);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / GEMM_THREADS; ++q) {
      const int el = tid + q * GEMM_THREADS;
      const int rr = el / BK, kk = el % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      xs[kk][rr] = (gr < rows && gk < k_end)
                       ? to_f32(x[(size_t)gr * m + gk]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / GEMM_THREADS; ++q) {
      const int el = tid + q * GEMM_THREADS;
      const int kk = el / BN, cc = el % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      ws[kk][cc] = (gk < k_end && gc < n)
                       ? to_f32(w[(size_t)gk * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= rows) continue;
    if (partial != nullptr) {
      float* pr = partial + ((size_t)blockIdx.z * rows + gr) * n;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + tx * TN + j;
        if (gc < n) pr[gc] = acc[i][j];
      }
      continue;
    }
    const int g = adapter_of(ids, gr, t, G);
    const float sc = scales[g];
    const float* srow = s + (size_t)gr * r;
    const float* eg = e.etab + (size_t)g * e.g_stride;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n)
        y[(size_t)gr * n + gc] =
            from_f32<TY>(fmaf(sc, acc[i][j], expand_dot(srow, eg, r, e, gc)));
    }
  }
}

template <typename TX, typename TW, typename TY>
cudaError_t launch_fp32(const Call& c) {
  const TX* xp = static_cast<const TX*>(c.x);
  fp32_shrink_kernel<TX><<<c.rows, SHRINK_THREADS, 0, c.stream>>>(
      xp, c.stab, c.ids, c.s, c.t, c.m, c.r, c.G);
  dim3 grid((c.n + BN - 1) / BN, (c.rows + BM - 1) / BM, c.ksplit);
  fp32_gemm_kernel<TX, TW, TY><<<grid, GEMM_THREADS, 0, c.stream>>>(
      xp, static_cast<const TW*>(c.w), c.scales, c.ids, c.s, c.e,
      static_cast<TY*>(c.y), c.ksplit > 1 ? c.partial : nullptr, c.rows, c.t,
      c.m, c.n, c.r, c.G, c.k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c.ksplit == 1) return err;
  return launch_reduce<TY>(c);
}

constexpr int PANEL = 64 * 128;      // one TMA box: 64 rows of 64 bf16
constexpr int TC_BK = 64;            // K per stage: one 128-byte row
constexpr int BAR_BYTES = 128;       // the mbarriers after the stages

// ============================================== route: tc_gemm shrink ==
constexpr int TS_ROWS = 32;     // rows a block, all of one sequence
constexpr int TS_KC = 128;      // K values a chunk
constexpr int TS_RJ = 16;       // rank columns a pass
constexpr int TS_THREADS = 256;

// grid (B * ceil(t / 32), pieces). A block covers 32 rows of one sequence
// (so one S_g) and piece blockIdx.y of K, [y * piece, min(m, (y + 1) *
// piece)), in chunks of 128: the chunk's x rows (as fp32) and S_g rows are
// staged in shared memory, then lane l of every warp holds rows
// 4 (l / 4) .. + 3 by ranks 4 (l % 4) .. + 3 in registers while warp w
// takes the chunk's k = w mod 8. The 8 warps' sums meet in shared memory
// in a fixed order; writes s_part[y, row, :].
__global__ void __launch_bounds__(TS_THREADS)
tc_shrink_kernel(const bf16* __restrict__ x, const float* __restrict__ stab,
                 const int* __restrict__ ids, float* __restrict__ s_part,
                 int rows, int t, int m, int r, int G, int piece) {
  // x chunk [row][k] (odd row stride: the 8 rows a warp reads at one k
  // sit in 8 banks); the 8 warps' sums reuse its space
  __shared__ float xs_raw[TS_ROWS * (TS_KC + 1)];
  __shared__ __align__(16) float ss[TS_KC][TS_RJ];
  static_assert(TS_ROWS * (TS_KC + 1) >= TS_THREADS / 32 * TS_ROWS * TS_RJ,
                "the warps' sums fit the x chunk");
  float (*xs)[TS_KC + 1] = reinterpret_cast<float (*)[TS_KC + 1]>(xs_raw);
  float (*red)[TS_ROWS * TS_RJ] =
      reinterpret_cast<float (*)[TS_ROWS * TS_RJ]>(xs_raw);
  const int per_seq = (t + TS_ROWS - 1) / TS_ROWS;
  const int q = blockIdx.x / per_seq;
  const int r0 = q * t + (blockIdx.x - q * per_seq) * TS_ROWS;
  const int nrow = min(TS_ROWS, (q + 1) * t - r0);
  const float* sg = stab + (size_t)adapter_of(ids, q * t, t, G) * m * r;
  const int k0 = blockIdx.y * piece, k1 = min(m, k0 + piece);
  float* sp = s_part + (size_t)blockIdx.y * rows * r;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ri = 4 * (lane >> 2), jq = 4 * (lane & 3);
  for (int j0 = 0; j0 < r; j0 += TS_RJ) {
    const int jn = min(TS_RJ, r - j0);
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int kc = k0; kc < k1; kc += TS_KC) {
#pragma unroll
      for (int i = 0; i < TS_ROWS * TS_KC / 2 / TS_THREADS; ++i) {
        const int o = tid + i * TS_THREADS, row = o / (TS_KC / 2);
        const int kk = 2 * (o % (TS_KC / 2));
        float2 v = make_float2(0.f, 0.f);   // k1 - kc is even: pairs whole
        if (row < nrow && kc + kk < k1)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              x + (size_t)(r0 + row) * m + kc + kk));
        xs[row][kk] = v.x;
        xs[row][kk + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < TS_KC * TS_RJ / TS_THREADS; ++i) {
        const int o = tid + i * TS_THREADS, kk = o / TS_RJ, j = o % TS_RJ;
        ss[kk][j] = kc + kk < k1 && j < jn
                        ? __ldg(sg + (size_t)(kc + kk) * r + j0 + j) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = warp; kk < TS_KC; kk += TS_THREADS / 32) {
        const float4 sv = *reinterpret_cast<const float4*>(&ss[kk][jq]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = xs[ri + u][kk];
          acc[u][0] = fmaf(xv, sv.x, acc[u][0]);
          acc[u][1] = fmaf(xv, sv.y, acc[u][1]);
          acc[u][2] = fmaf(xv, sv.z, acc[u][2]);
          acc[u][3] = fmaf(xv, sv.w, acc[u][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[warp][(ri + u) * TS_RJ + jq + v] = acc[u][v];
    __syncthreads();
    for (int o = tid; o < TS_ROWS * TS_RJ; o += TS_THREADS) {
      const int i = o / TS_RJ, j = o % TS_RJ;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < TS_THREADS / 32; ++w) v += red[w][o];
      if (i < nrow && j < jn) sp[(size_t)(r0 + i) * r + j0 + j] = v;
    }
    __syncthreads();
  }
}

// s[row, :] = the sum of the `pieces` partials before it in the buffer
// (s_part[pieces] is s), in order; one thread per (row, rank column).
__global__ void __launch_bounds__(RED_THREADS)
tc_sum_kernel(float* __restrict__ s_part, int rows, int r, int pieces) {
  const size_t o = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  const size_t per = (size_t)rows * r;
  if (o >= per) return;
  float v = 0.f;
#pragma unroll 8
  for (int f = 0; f < pieces; ++f) v += s_part[f * per + o];
  s_part[pieces * per + o] = v;
}

// ===================================================== route: tc_gemm ==
constexpr int TC_BN = 128;           // output columns per block
constexpr int TC_MAX_STAGES = 8;     // ring depth: as many as fit, <= 8
constexpr int Y_STRIDE = TC_BN + 8;  // bf16 per staged output row: 272 B,
                                     // 16-byte rows, conflict-free pairs
constexpr int EPI_RREG = 16;         // ranks held in registers

template <int BM_>
struct TcGemm {
  static constexpr int A = BM_ * 128;        // x tile: BM rows x 64 K
  static constexpr int B = TC_BN * 128;      // W tile: 2 panels x 64 K
  static constexpr int STAGE = A + B;
  static constexpr int CONS = 2 * BM_;       // consumer threads
  static constexpr int THREADS = CONS + 32;  // + the producer warp
  // nst stages, barriers, s rows (BM x r), row scales and adapters, E tiles
  static size_t bytes(int r, int e_cap, int nst) {
    return 1024 + (size_t)nst * STAGE + BAR_BYTES + (size_t)BM_ * 8 +
           (size_t)BM_ * r * 4 + (size_t)e_cap * r * TC_BN * 4;
  }
};

// grid (ceil(rows / BM), ceil(n / 128), ksplit): output tile (BM rows,
// 128 columns), K chunk [z * k_chunk, min(m, (z + 1) * k_chunk)), through
// a ring of nst stages (the deeper, the more copies in flight: a stage is
// held while its MMAs and the next stage's are issued). Row
// tiles vary fastest, so the blocks in flight together share W's column
// slabs through L2 and W streams from memory about once. `s` holds the
// summed shrink rows (rows, r).
// Threads [0, 2 BM) are BM/64 consumer warpgroups (warpgroup wg owns rows
// 64 wg .. 64 wg + 63 of the tile); the warp after them is the producer.
// With ksplit > 1 (partial != nullptr) the block writes its fp32 partial
// sums and reduce_kernel finishes; else the epilogue is fused.
template <int BM_>
__global__ void __launch_bounds__(TcGemm<BM_>::THREADS)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ scales, const int* __restrict__ ids,
               const float* __restrict__ s, Expand e,
               bf16* __restrict__ y, float* __restrict__ partial, int rows,
               int t, int m, int n, int r, int G, int k_chunk, int e_cap,
               int nst) {
  using L = TcGemm<BM_>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int pipe = nst * L::STAGE;
  const uint32_t full0 = base + pipe, empty0 = full0 + 8 * TC_MAX_STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM_, col0 = blockIdx.y * TC_BN;
  const int kb = blockIdx.z * k_chunk;
  const int ktiles = (min(m, kb + k_chunk) - kb + TC_BK - 1) / TC_BK;
  if (tid == 0) {
    for (int st = 0; st < nst; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, L::CONS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= L::CONS) {   // producer: one thread keeps the ring full
    if (tid == L::CONS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t a = base + stage * L::STAGE, full = full0 + 8 * stage;
        const int k = kb + kt * TC_BK;
        mbar_expect_tx(full, L::STAGE);
        tma_load(a, &tm_x, full, k, row0);
        tma_load(a + L::A, &tm_w, full, col0, k);
        tma_load(a + L::A + PANEL, &tm_w, full, col0 + 64, k);
        if (++stage == nst) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers. The fused epilogue's operands are staged first (the tile's
  // s rows, each row's scale and adapter, the E_g columns of every
  // sequence the tile spans), so their loads overlap the ring's first
  // copies; the epilogue region lies past the stages.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float* s_sm = reinterpret_cast<float*>(smem + pipe + BAR_BYTES);
  float* sc_sm = s_sm + BM_ * r;
  int* g_sm = reinterpret_cast<int*>(sc_sm + BM_);
  float* e_sm = reinterpret_cast<float*>(g_sm + BM_);
  const int here = min(BM_, rows - row0);
  const int q0 = row0 / t, nq = (row0 + here - 1) / t - q0 + 1;
  const bool fused = partial == nullptr;
  const bool staged = fused && nq <= e_cap;
  if (fused) {
#pragma unroll 4
    for (int o = tid; o < BM_ * r; o += L::CONS)
      s_sm[o] = o < here * r ? s[(size_t)row0 * r + o] : 0.f;
    for (int i = tid; i < BM_; i += L::CONS) {
      const int g = adapter_of(ids, min(row0 + i, rows - 1), t, G);
      sc_sm[i] = scales[g];
      g_sm[i] = g;
    }
  }
  if (staged) {   // e_sm[qi][k][c] = E_g[k, col0 + c], g of sequence q0 + qi
    for (int qi = 0; qi < nq; ++qi) {
      const float* src =
          e.etab + (size_t)adapter_of(ids, (q0 + qi) * t, t, G) * e.g_stride;
      float* dst = e_sm + qi * r * TC_BN;
      if (e.k_stride == 1) {   // right: a column's r values are contiguous
#pragma unroll 4
        for (int o = tid; o < r * TC_BN; o += L::CONS) {
          const int c = o / r, k = o - c * r;
          dst[k * TC_BN + c] =
              col0 + c < n ? __ldg(src + (size_t)(col0 + c) * e.col_stride + k)
                           : 0.f;
        }
      } else {                 // left: a rank row's columns are contiguous
#pragma unroll 4
        for (int o = tid; o < r * TC_BN; o += L::CONS) {
          const int k = o / TC_BN, c = o % TC_BN;
          dst[o] = col0 + c < n
                       ? __ldg(src + (size_t)k * e.k_stride + col0 + c) : 0.f;
        }
      }
    }
  }

  // thread's rows rl0, rl0 + 8 of the tile; columns 8 j + cq, + 1
  const int rl0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  // The rank-r delta s . E_g of the thread's outputs, in the accumulator
  // layout, before the mainloop (while the ring fills): rank-outer, so the
  // 64 sums are independent and the E loads issue together. Every path
  // call takes this way (E staged, r <= 16).
  const bool fast = staged && r <= EPI_RREG;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  if (fused) named_sync(1, L::CONS);
  if (fast) {
    const float* e0 = e_sm + (min(row0 + rl0, rows - 1) / t - q0) * r * TC_BN;
    const float* e1 =
        e_sm + (min(row0 + rl0 + 8, rows - 1) / t - q0) * r * TC_BN;
    const bool same = e0 == e1;
    const float* s0 = s_sm + rl0 * r;
    const float* s1 = s0 + 8 * r;
#pragma unroll
    for (int k = 0; k < EPI_RREG; ++k) {
      if (k < r) {
        const float a0 = s0[k], a1 = s1[k];
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j) {
          const float2 u =
              *reinterpret_cast<const float2*>(e0 + k * TC_BN + 8 * j + cq);
          const float2 v = same ? u : *reinterpret_cast<const float2*>(
                                          e1 + k * TC_BN + 8 * j + cq);
          d[4 * j] = fmaf(a0, u.x, d[4 * j]);
          d[4 * j + 1] = fmaf(a0, u.y, d[4 * j + 1]);
          d[4 * j + 2] = fmaf(a1, v.x, d[4 * j + 2]);
          d[4 * j + 3] = fmaf(a1, v.y, d[4 * j + 3]);
        }
      }
    }
  }

  // wgmma over the ring, one group in flight
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t a = base + stage * L::STAGE + wg * PANEL;
    const uint32_t b = base + stage * L::STAGE + L::A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      wgmma_m64n128<0, 1>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                          sw128_desc(b + 2048 * kk, PANEL, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    if (++stage == nst) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if (!fused) {
    float* pz = partial + (size_t)blockIdx.z * rows * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rl0 + 8 * h;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
        const int col = col0 + 8 * j + cq;
        if (row < rows && col < n)
          *reinterpret_cast<float2*>(pz + (size_t)row * n + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  // fused epilogue: the stages are free once every consumer is here
  named_sync(1, L::CONS);
  bf16* y_sm = reinterpret_cast<bf16*>(smem);
  const float sc0 = sc_sm[rl0], sc1 = sc_sm[rl0 + 8];
  if (fast) {
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
      const int c = 8 * j + cq;
      *reinterpret_cast<__nv_bfloat162*>(y_sm + rl0 * Y_STRIDE + c) =
          __floats2bfloat162_rn(fmaf(sc0, acc[4 * j], d[4 * j]),
                                fmaf(sc0, acc[4 * j + 1], d[4 * j + 1]));
      *reinterpret_cast<__nv_bfloat162*>(y_sm + (rl0 + 8) * Y_STRIDE + c) =
          __floats2bfloat162_rn(fmaf(sc1, acc[4 * j + 2], d[4 * j + 2]),
                                fmaf(sc1, acc[4 * j + 3], d[4 * j + 3]));
    }
  } else {   // E from shared or global memory, any r
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = rl0 + 8 * h;
      const float* sr = s_sm + rl * r;
      const float sc = h ? sc1 : sc0;
      const float* eb;
      int eks, ecs;
      if (staged) {
        eb = e_sm + (min(row0 + rl, rows - 1) / t - q0) * r * TC_BN;
        eks = TC_BN;
        ecs = 1;
      } else {
        eb = e.etab + (size_t)g_sm[rl] * e.g_stride +
             (size_t)col0 * e.col_stride;
        eks = e.k_stride;
        ecs = e.col_stride;
      }
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
        const int c = 8 * j + cq;
        float d0 = 0.f, d1 = 0.f;
        if (col0 + c < n)
          for (int k = 0; k < r; ++k) {
            d0 = fmaf(sr[k], eb[k * eks + c * ecs], d0);
            d1 = fmaf(sr[k], eb[k * eks + (c + 1) * ecs], d1);
          }
        *reinterpret_cast<__nv_bfloat162*>(y_sm + rl * Y_STRIDE + c) =
            __floats2bfloat162_rn(fmaf(sc, acc[4 * j + 2 * h], d0),
                                  fmaf(sc, acc[4 * j + 2 * h + 1], d1));
      }
    }
  }
  named_sync(1, L::CONS);
  constexpr int CH = TC_BN / 8;   // 16-byte chunks per output row
  for (int o = tid; o < BM_ * CH; o += L::CONS) {
    const int rl = o / CH, c = (o - rl * CH) * 8;
    const int row = row0 + rl, col = col0 + c;
    if (row < rows && col < n)
      *reinterpret_cast<uint4*>(y + (size_t)row * n + col) =
          *reinterpret_cast<const uint4*>(y_sm + rl * Y_STRIDE + c);
  }
}

// =================================================== route: tc_decode ==
constexpr int TD_BM = 128;     // W columns per block: two m64 slices
constexpr int TD_STAGES = 6;
constexpr int TD_THREADS = 128 + 32;   // one consumer warpgroup + producer

template <int NR>
struct TcDecode {
  static constexpr int W = TD_BM * 128;   // 2 panels x 64 K
  static constexpr int X = NR * 128;      // NR rows x 64 K
  static constexpr int STAGE = W + X;
  static constexpr int PIPE = TD_STAGES * STAGE;
  static constexpr int BYTES = 1024 + PIPE + BAR_BYTES;
};

// grid (ceil(n / 128), ksplit): W columns [128 x, 128 x + 128), K chunk
// [y * k_chunk, min(m, (y + 1) * k_chunk)). D = W_tile^T x_tile^T, 128 x
// NR (NR >= rows, the rest zero-filled), accumulated over the chunk and
// written to partial[y] (rows x n, fp32). Every block first computes
// shrink piece y * gridDim.x + x: for all rows, the x-th of gridDim.x
// equal parts of its K chunk.
template <int NR>
__global__ void __launch_bounds__(TD_THREADS)
tc_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const bf16* __restrict__ x, const float* __restrict__ stab,
                 const int* __restrict__ ids, float* __restrict__ s_part,
                 float* __restrict__ partial, int rows, int t, int m, int n,
                 int r, int G, int k_chunk) {
  using L = TcDecode<NR>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::PIPE, empty0 = full0 + 8 * TD_STAGES;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * TD_BM, kz = blockIdx.y;
  const int kb = kz * k_chunk, ke = min(m, kb + k_chunk);
  const int ktiles = (ke - kb + TC_BK - 1) / TC_BK;
  if (tid == 0) {
    for (int st = 0; st < TD_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {   // producer
    if (tid == 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t a = base + stage * L::STAGE, full = full0 + 8 * stage;
        const int k = kb + kt * TC_BK;
        mbar_expect_tx(full, L::STAGE);
        tma_load(a, &tm_w, full, col0, k);
        tma_load(a + PANEL, &tm_w, full, col0 + 64, k);
        tma_load(a + L::W, &tm_x, full, k, 0);
        if (++stage == TD_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // the folded shrink piece, while the ring fills
  {
    const int sub = gridDim.x;
    const int len = (ke - kb + sub - 1) / sub;
    const int k0 = kb + blockIdx.x * len, k1 = min(ke, k0 + len);
    float* sp = s_part + (size_t)(kz * sub + blockIdx.x) * rows * r;
    for (int o = tid; o < rows * r; o += 128) {
      const int i = o / r, j = o - i * r;
      const float* sg = stab + (size_t)adapter_of(ids, i, t, G) * m * r + j;
      const bf16* xr = x + (size_t)i * m;
      float v = 0.f;
#pragma unroll 8
      for (int k = k0; k < k1; ++k)
        v = fmaf(__bfloat162float(xr[k]), __ldg(sg + (size_t)k * r), v);
      sp[o] = v;
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  float acc[2][NR / 2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[s][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t a = base + stage * L::STAGE;
    const uint32_t b = a + L::W;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint64_t da = sw128_desc(a + s * PANEL + 2048 * kk, PANEL, 1024);
        if constexpr (NR == 16) wgmma_m64n16<1, 0>(acc[s], da, db);
        else wgmma_m64n64<1, 0>(acc[s], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();     // the MMAs are cheap here: free the stage at once
    mbar_arrive(empty0 + 8 * stage);
    if (++stage == TD_STAGES) { stage = 0; phase ^= 1; }
  }
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  float* pz = partial + (size_t)kz * rows * n;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const int xrow = (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      const int col =
          col0 + s * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      if (xrow < rows && col < n) pz[(size_t)xrow * n + col] = acc[s][i];
    }
}


// ====================================================== host: tc routes ==
// A row-major bf16 matrix (outer, inner) as 2-D TMA boxes of (box_outer,
// 64) with the 128-byte swizzle; reads outside it fill zeros.
int bf16_map(CUtensorMap* map, const void* ptr, int inner, int outer,
             int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return bf16_tensor_map(map, ptr, 2, dims, strides, box);
}

template <int BM_>
cudaError_t launch_tc_gemm(const Call& c, const CUtensorMap& mx,
                           const CUtensorMap& mw) {
  using L = TcGemm<BM_>;
  // As many stages as fit beside the epilogue's E tiles for two sequences
  // (up to 8), then E tiles for every sequence a tile can span, as far as
  // they fit; a tile over more sequences reads E from global memory.
  const int span = c.ids ? (BM_ - 1) / c.t + 2 : 1;
  const size_t per = (size_t)c.r * TC_BN * 4;
  const size_t keep = L::bytes(c.r, span < 2 ? span : 2, 0);
  int nst = keep < (size_t)SMEM_LIMIT
                ? (int)(((size_t)SMEM_LIMIT - keep) / L::STAGE) : 0;
  nst = nst < TC_MAX_STAGES ? nst : TC_MAX_STAGES;
  if (nst < 2) return cudaErrorInvalidValue;
  const size_t fixed = L::bytes(c.r, 0, nst);
  const int fit = fixed < (size_t)SMEM_LIMIT
                      ? (int)(((size_t)SMEM_LIMIT - fixed) / per) : 0;
  const int e_cap = span < fit ? span : fit;
  const size_t smem = L::bytes(c.r, e_cap, nst);
  static const cudaError_t opt_in = cudaFuncSetAttribute(   // once
      tc_gemm_kernel<BM_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((c.rows + BM_ - 1) / BM_, (c.n + TC_BN - 1) / TC_BN, c.ksplit);
  tc_gemm_kernel<BM_><<<grid, L::THREADS, smem, c.stream>>>(
      mx, mw, c.scales, c.ids, c.s + (size_t)c.pieces * c.rows * c.r, c.e,
      static_cast<bf16*>(c.y), c.ksplit > 1 ? c.partial : nullptr, c.rows,
      c.t, c.m, c.n, c.r, c.G, c.k_chunk, e_cap, nst);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch_tc_decode(const Call& c, const CUtensorMap& mx,
                             const CUtensorMap& mw) {
  using L = TcDecode<NR>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(   // once
      tc_decode_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((c.n + TD_BM - 1) / TD_BM, c.ksplit);
  tc_decode_kernel<NR><<<grid, TD_THREADS, L::BYTES, c.stream>>>(
      mx, mw, static_cast<const bf16*>(c.x), c.stab, c.ids, c.s, c.partial,
      c.rows, c.t, c.m, c.n, c.r, c.G, c.k_chunk);
  return cudaGetLastError();
}

// tc_gemm: shrink, GEMM (+ reduce when K is split); tc_decode: the
// streaming GEMM with the shrink folded in, then reduce. bf16 x, W and y.
int launch_tc(const Call& c, int route) {
  CUtensorMap mx, mw;
  int bad = bf16_map(&mx, c.x, c.m, c.rows, c.bm);
  if (bad == 0) bad = bf16_map(&mw, c.w, c.n, c.m, 64);
  if (bad != 0) return bad;
  cudaError_t err;
  if (route == ROUTE_TC_GEMM) {
    const int per_seq = (c.t + TS_ROWS - 1) / TS_ROWS;
    dim3 grid((c.rows / c.t) * per_seq, c.pieces);
    tc_shrink_kernel<<<grid, TS_THREADS, 0, c.stream>>>(
        static_cast<const bf16*>(c.x), c.stab, c.ids, c.s, c.rows, c.t, c.m,
        c.r, c.G, c.piece);
    const size_t per = (size_t)c.rows * c.r;
    tc_sum_kernel<<<(unsigned)((per + RED_THREADS - 1) / RED_THREADS),
                    RED_THREADS, 0, c.stream>>>(c.s, c.rows, c.r, c.pieces);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = c.bm == 128 ? launch_tc_gemm<128>(c, mx, mw)
                        : launch_tc_gemm<64>(c, mx, mw);
    if (err == cudaSuccess && c.ksplit > 1) {
      Call summed = c;   // the reduce reads s as one piece
      summed.s = c.s + (size_t)c.pieces * per;
      summed.pieces = 1;
      err = launch_reduce<bf16>(summed);
    }
  } else {
    err = c.bm == 16 ? launch_tc_decode<16>(c, mx, mw)
                     : launch_tc_decode<64>(c, mx, mw);
    if (err == cudaSuccess) err = launch_reduce<bf16>(c);
  }
  return (int)err;
}

// Launch one call on its route. The tc routes take bf16 x and W only.
int dispatch(const Call& c, int route, int x_bf16, int w_bf16) {
  if (route == ROUTE_TC_GEMM || route == ROUTE_TC_DECODE) {
    if (!(x_bf16 && w_bf16)) return (int)cudaErrorInvalidValue;
    return launch_tc(c, route);
  }
  if (route != ROUTE_FP32) return (int)cudaErrorInvalidValue;
  if (x_bf16 && w_bf16) return (int)launch_fp32<bf16, bf16, bf16>(c);
  if (x_bf16) return (int)launch_fp32<bf16, float, float>(c);
  if (w_bf16) return (int)launch_fp32<float, bf16, float>(c);
  return (int)launch_fp32<float, float, float>(c);
}

}  // namespace
