// The RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (pallas_call at rwkv6_scan.py:69). Per (b, h), with S a D x D fp32 state
// carried over the whole sequence:
//
//   y_t = r_t . (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
//
// r, k, v, w (B, L, H, D) read in place (no transpose); r, k, v bf16 or fp32
// (one type), w fp32 or bf16; u (H, D) fp32; s0 (B, H, D, D) fp32 or null
// (zeros). Writes y (B, L, H, D) in r's type and s_out (B, H, D, D) fp32.
// Any L (decode is L = 1), 1 <= D <= 64.
//
// Design (the upstream RWKV6 CUDA forward, not the Pallas grid). One block
// per (b, h) with D threads; thread j owns column j of S (S[i][j], i < D) in
// registers for the whole sequence, so the state never leaves the SM between
// steps. `chunk` time steps of r, k, v and w are staged in shared memory
// (as fp32) per load: each thread loads element j of every staged step,
// neighbouring threads on neighbouring addresses. Then, per step, thread j
// forms y_j = sum_i r_i (S_ij + u_i k_i v_j) from broadcast reads of the
// staged r, k, w and of u, and updates its column S_ij <- w_i S_ij + k_i v_j.
// Thread j reads only its own v_j. y is written once per step, S_final once
// at the end.
//
// Arithmetic order, shared with the plain version (ref.rwkv6_scan_ref) so
// that the two agree bit for bit: kv = k_i v_j; p_i = r_i (S_ij + u_i kv);
// S_ij <- w_i S_ij + kv, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into fused multiply-adds); y_j is
// the pairwise tree of adjacent pairs ((p_0 + p_1) + (p_2 + p_3)) + ...
// over the D products, zero-padded to 64.
//
// What bounds it on this card. Bytes: r, k, v, w in, y out, s0 in and S out
// per (b, h); operations: ~4 D^2 fp32 per step per (b, h). At the serving
// shapes both bounds are around a microsecond, while the recurrence is a
// chain of L dependent steps per block and the grid is B*H blocks of D
// threads (32 blocks for one prompt of rwkv6-1.6b, on 132 SMs): latency
// bounds it. The tree keeps the dependent chain of y at log2(64) adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DMAX = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(DMAX)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int L, int H, int D,
            int chunk) {
  extern __shared__ float stage[];          // 4 x chunk x DMAX floats
  __shared__ float su[DMAX];
  float* sr = stage;
  float* sk = sr + (size_t)chunk * DMAX;
  float* sv = sk + (size_t)chunk * DMAX;
  float* sw = sv + (size_t)chunk * DMAX;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;                // blockDim.x == D
  const size_t sbase = (size_t)bh * D * D;

  float S[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    S[i] = (i < D && s0 != nullptr) ? s0[sbase + (size_t)i * D + j] : 0.f;
  su[j] = u[(size_t)h * D + j];

  const size_t step = (size_t)H * D;        // between time steps
  const size_t base = ((size_t)b * L * H + h) * D + j;
  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int n = min(chunk, L - t0);
    __syncthreads();                        // the last chunk is consumed
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const size_t off = base + (size_t)(t0 + c) * step;
      sr[c * DMAX + j] = to_f(r[off]);
      sk[c * DMAX + j] = to_f(k[off]);
      sv[c * DMAX + j] = to_f(v[off]);
      sw[c * DMAX + j] = to_f(w[off]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float* rc = sr + c * DMAX;
      const float* kc = sk + c * DMAX;
      const float* wc = sw + c * DMAX;
      const float vj = sv[c * DMAX + j];
      float p[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        p[i] = 0.f;
        if (i < D) {
          const float kv = __fmul_rn(kc[i], vj);
          p[i] = __fmul_rn(rc[i], __fadd_rn(S[i], __fmul_rn(su[i], kv)));
          S[i] = __fadd_rn(__fmul_rn(wc[i], S[i]), kv);
        }
      }
#pragma unroll
      for (int width = 1; width < DMAX; width *= 2) {
#pragma unroll
        for (int i = 0; i < DMAX; i += 2 * width)
          p[i] = __fadd_rn(p[i], p[i + width]);
      }
      y[base + (size_t)(t0 + c) * step] = from_f<T>(p[0]);
    }
  }
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < D) s_out[sbase + (size_t)i * D + j] = S[i];
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int L, int H, int D, int chunk, cudaStream_t stream) {
  const int staged = L < chunk ? (L > 0 ? L : 1) : chunk;
  const size_t smem = (size_t)4 * staged * DMAX * sizeof(float);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem + DMAX * sizeof(float) > (size_t)limit)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = wkv6_kernel<T, TW>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<B * H, D, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w), u, s0,
      static_cast<T*>(y), s_out, L, H, D, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. rkv_bf16: 1 when r, k, v (and y)
// are bf16, 0 for fp32; w_bf16 likewise for w. s0 may be null. Returns
// cudaErrorInvalidConfiguration when `chunk` steps do not fit in the
// device's shared memory per block, else cudaGetLastError().
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const float* u,
                                 const float* s0, void* y, float* s_out,
                                 int B, int L, int H, int D, int chunk,
                                 int rkv_bf16, int w_bf16, void* stream) {
  if (D < 1 || D > DMAX || chunk < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rkv_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, y, s_out,
                                                B, L, H, D, chunk, st);
  if (rkv_bf16)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, y, s_out, B, L, H,
                                        D, chunk, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, L, H,
                                        D, chunk, st);
  return launch<float, float>(r, k, v, w, u, s0, y, s_out, B, L, H, D, chunk,
                              st);
}
