// Shared device code of the low-rank linear applies for Hopper (sm_90a):
// the rank-r shrink, the tiled base GEMM with its fused rank-r epilogue,
// and the split-K reduce. Included by lowrank_linear_batched.cu (per-row
// adapters from (G, ., r) tables) and lowrank_linear.cu (one adapter, no
// ids: the lift-free training read). Each .cu builds into its own library,
// so the anonymous namespace gives each its own copy.
//
// For every flattened row i of x (rows, m), with g its adapter:
//   1. shrink:  s[i, :] = x[i] @ S_g  (S_g (m, r): rts right | bases left)
//   2. GEMM:    acc = x[i] @ W over (64 x 64) output tiles, fp32 FMA, with
//               K split across blocks into an fp32 partial buffer when the
//               output tiles alone cannot fill the card;
//   3. epilogue (fused into 2 unless K is split):
//               y[i, c] = scales[g] * acc + s[i, :] @ E_g[:, c]
//               (E_g = bases^T right, a strided read | rts left).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
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

// ----------------------------------------------------------- 1. shrink --
constexpr int SHRINK_THREADS = 256;
constexpr int SHRINK_K = 16;   // rank columns per pass over the row

template <typename TX>
__global__ void __launch_bounds__(SHRINK_THREADS)
shrink_kernel(const TX* __restrict__ x, const float* __restrict__ stab,
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

// ---------------------------------------------------------- 3. epilogue --
struct Expand {
  const float* etab;    // E tables: bases (right) | rts (left)
  long long g_stride;   // elements between adapters
  int k_stride;         // elements between rank rows of E_g
  int col_stride;       // elements between output columns of E_g
};

__device__ __forceinline__ float expand_dot(const float* __restrict__ srow,
                                            const float* __restrict__ eg,
                                            int r, const Expand& e, int col) {
  float d = 0.f;
  const float* ec = eg + (size_t)col * e.col_stride;
  for (int k = 0; k < r; ++k)
    d = fmaf(srow[k], __ldg(ec + (size_t)k * e.k_stride), d);
  return d;
}

// ------------------------------------------------------- 2. base GEMM --
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

// grid (ceil(n/BN), ceil(rows/BM), ksplit). With ksplit == 1 the epilogue
// is fused and y is written; otherwise block z writes its K-chunk's
// partial sums to partial[z] and reduce_epilogue_kernel finishes.
template <typename TX, typename TW, typename TY>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
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

constexpr int REDUCE_THREADS = 256;

template <typename TY>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_epilogue_kernel(const float* __restrict__ partial,
                       const float* __restrict__ scales,
                       const int* __restrict__ ids,
                       const float* __restrict__ s, Expand e,
                       TY* __restrict__ y, int rows, int t, int n, int r,
                       int G, int ksplit) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= (size_t)rows * n) return;
  const int gr = (int)(idx / n), gc = (int)(idx % n);
  float acc = 0.f;
  for (int z = 0; z < ksplit; ++z) acc += partial[(size_t)z * rows * n + idx];
  const int g = adapter_of(ids, gr, t, G);
  const float* eg = e.etab + (size_t)g * e.g_stride;
  y[idx] = from_f32<TY>(
      fmaf(scales[g], acc, expand_dot(s + (size_t)gr * r, eg, r, e, gc)));
}

template <typename TX, typename TW, typename TY>
cudaError_t launch(const void* x, const void* w, const float* stab,
                   const float* scales, const int* ids, const Expand& e,
                   void* y, float* s, float* partial, int rows, int t, int m,
                   int n, int r, int G, int ksplit, int k_chunk,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  shrink_kernel<TX><<<rows, SHRINK_THREADS, 0, stream>>>(xp, stab, ids, s, t,
                                                         m, r, G);
  dim3 grid((n + BN - 1) / BN, (rows + BM - 1) / BM, ksplit);
  gemm_kernel<TX, TW, TY><<<grid, GEMM_THREADS, 0, stream>>>(
      xp, static_cast<const TW*>(w), scales, ids, s, e, static_cast<TY*>(y),
      ksplit > 1 ? partial : nullptr, rows, t, m, n, r, G, k_chunk);
  if (ksplit > 1) {
    const size_t total = (size_t)rows * n;
    const unsigned blocks =
        (unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
    reduce_epilogue_kernel<TY><<<blocks, REDUCE_THREADS, 0, stream>>>(
        partial, scales, ids, s, e, static_cast<TY*>(y), rows, t, n, r, G,
        ksplit);
  }
  return cudaGetLastError();
}

}  // namespace
