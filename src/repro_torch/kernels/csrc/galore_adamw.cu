// Fused GaLore preconditioner / GaLoreAdamW step for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/galore_adamw.py::
// galore_precond_step (pallas_call at galore_adamw.py:222) and
// galore_adamw_step (pallas_call at galore_adamw.py:172). For one block of a
// stack of `batch` blocks (the stacked leading dims flatten into the grid):
//
//   right side (basis B (N, r), moments (M, r)):   g~ = g @ B
//   left side  (basis B (M, r), moments (r, N)):   g~ = B^T @ g
//   m' = b1*m + (1-b1)*g~,  v' = b2*v + (1-b2)*g~^2
//   u~ = (m'/c1) / (sqrt(v'/c2) + eps)       (c1, c2: bias corrections)
//   precond, project_back = 0:  out = u~ (moment shape)
//   precond, project_back = 1:  out = u~ @ B^T (right) | B @ u~ (left)
//   adamw:                      w' = w - lr*u - lr*wd*w,  u the lifted u~
//
// g is fp32; w fp32 or bf16 (updated in place); moments fp32 (m, v read
// from one buffer and written to another, which may be the same one).
//
// Design. The Pallas kernel tiles the long axis with B resident in VMEM.
// Here B sits in shared memory for the whole block:
//   right: one warp per row of g; lanes stride along the row (coalesced),
//          accumulate the r projections, reduce them with shuffles, run
//          Adam on the row's r moments (lane k owns column k), and lift the
//          row back by streaming B again from shared memory. B is stored
//          transposed there (r x N) so that the lanes read consecutive words.
//   left:  one thread per column of g, 128 columns per block; each thread
//          walks down its column (neighbouring threads read neighbouring
//          words), with B's row a broadcast read from shared memory, keeps
//          the r projections in registers, and lifts the column back.
// The basis is the shorter dimension (proj_type=std), 1024 x r at most on
// the qwen1.5-0.5b path: 32 KB at r = 8. The C entry point checks the
// shared memory it needs against the device's opt-in limit and refuses
// (returns -1) a basis that does not fit.
//
// What bounds it on this card. Each g element is read once and, with
// project_back or adamw, one element written; the work per element is 2r
// (4r lifted) FMAs, under 32 FLOP/byte at r = 8: bytes bound it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct AdamArgs {
  float b1, omb1, b2, omb2, eps, c1, c2, lr, wd;
};

__device__ __forceinline__ float load_w(const float* w, size_t i) {
  return w[i];
}
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ void store_w(float* w, size_t i, float v) {
  w[i] = v;
}
__device__ __forceinline__ void store_w(__nv_bfloat16* w, size_t i, float v) {
  w[i] = __float2bfloat16(v);
}

// Adam on one projected coordinate; returns u~ and writes m', v'.
__device__ __forceinline__ float adam(float gt, size_t mi, const float* m_in,
                                      const float* v_in, float* m_out,
                                      float* v_out, const AdamArgs& a) {
  const float m = a.b1 * m_in[mi] + a.omb1 * gt;
  const float v = a.b2 * v_in[mi] + a.omb2 * gt * gt;
  m_out[mi] = m;
  v_out[mi] = v;
  return (m / a.c1) / (sqrtf(v / a.c2) + a.eps);
}

constexpr int RIGHT_WARPS = 8;   // rows of g per block

// mode: 0 precond -> u~, 1 precond -> lifted u, 2 adamw -> w updated.
template <int RMAX, typename TW>
__global__ void __launch_bounds__(RIGHT_WARPS * 32)
right_kernel(const float* __restrict__ g, const float* __restrict__ basis,
             const float* m_in, const float* v_in, float* m_out, float* v_out,
             float* __restrict__ u_out, TW* w, int M, int N, int r, int mode,
             AdamArgs a) {
  extern __shared__ float smem[];
  float* bt = smem;                         // B^T, (r, N)
  float* ut = smem + (size_t)r * N;         // (RIGHT_WARPS, RMAX)
  const size_t blk = blockIdx.y;
  const float* gb = g + blk * M * N;
  const float* bb = basis + blk * (size_t)N * r;
  for (int idx = threadIdx.x; idx < N * r; idx += blockDim.x) {
    const int j = idx / r, k = idx % r;
    bt[(size_t)k * N + j] = bb[idx];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * RIGHT_WARPS + warp;
  if (row >= M) return;
  const float* grow = gb + (size_t)row * N;
  float acc[RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc[k] = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float gv = grow[j];
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) acc[k] = fmaf(gv, bt[(size_t)k * N + j], acc[k]);
  }
  float* myut = ut + warp * RMAX;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && k < r) myut[k] = v;
  }
  __syncwarp();
  const size_t mbase = (blk * M + row) * (size_t)r;
  for (int k = lane; k < r; k += 32) {
    const float u = adam(myut[k], mbase + k, m_in, v_in, m_out, v_out, a);
    if (mode == 0) u_out[mbase + k] = u;
    else myut[k] = u;
  }
  __syncwarp();
  if (mode == 0) return;
  const size_t wrow = (blk * M + row) * (size_t)N;
  for (int j = lane; j < N; j += 32) {
    float u = 0.f;
    for (int k = 0; k < r; ++k) u = fmaf(myut[k], bt[(size_t)k * N + j], u);
    if (mode == 1) {
      u_out[wrow + j] = u;
    } else {
      const float wv = load_w(w, wrow + j);
      store_w(w, wrow + j, wv - a.lr * u - a.lr * a.wd * wv);
    }
  }
}

constexpr int LEFT_THREADS = 128;   // columns of g per block

template <int RMAX, typename TW>
__global__ void __launch_bounds__(LEFT_THREADS)
left_kernel(const float* __restrict__ g, const float* __restrict__ basis,
            const float* m_in, const float* v_in, float* m_out, float* v_out,
            float* __restrict__ u_out, TW* w, int M, int N, int r, int mode,
            AdamArgs a) {
  extern __shared__ float smem[];
  float* bs = smem;                         // B, (M, r)
  const size_t blk = blockIdx.y;
  const float* bb = basis + blk * (size_t)M * r;
  for (int idx = threadIdx.x; idx < M * r; idx += blockDim.x) bs[idx] = bb[idx];
  __syncthreads();
  const int col = blockIdx.x * LEFT_THREADS + threadIdx.x;
  if (col >= N) return;
  const float* gb = g + blk * (size_t)M * N;
  float acc[RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc[k] = 0.f;
  for (int i = 0; i < M; ++i) {
    const float gv = gb[(size_t)i * N + col];
    const float* brow = bs + (size_t)i * r;
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) acc[k] = fmaf(brow[k], gv, acc[k]);
  }
  const size_t mblk = blk * (size_t)r * N;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    if (k < r) {
      const size_t mi = mblk + (size_t)k * N + col;
      acc[k] = adam(acc[k], mi, m_in, v_in, m_out, v_out, a);
      if (mode == 0) u_out[mi] = acc[k];
    }
  }
  if (mode == 0) return;
  const size_t wblk = blk * (size_t)M * N;
  for (int i = 0; i < M; ++i) {
    const float* brow = bs + (size_t)i * r;
    float u = 0.f;
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) u = fmaf(brow[k], acc[k], u);
    const size_t wi = wblk + (size_t)i * N + col;
    if (mode == 1) {
      u_out[wi] = u;
    } else {
      const float wv = load_w(w, wi);
      store_w(w, wi, wv - a.lr * u - a.lr * a.wd * wv);
    }
  }
}

template <int RMAX, typename TW>
cudaError_t launch(const float* g, const float* basis, const float* m_in,
                   const float* v_in, float* m_out, float* v_out, float* u_out,
                   TW* w, int batch, int M, int N, int r, int side, int mode,
                   const AdamArgs& a, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (side == 0) {
    const size_t smem = ((size_t)r * N + RIGHT_WARPS * RMAX) * sizeof(float);
    if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
    auto kern = right_kernel<RMAX, TW>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid((M + RIGHT_WARPS - 1) / RIGHT_WARPS, batch);
    kern<<<grid, RIGHT_WARPS * 32, smem, stream>>>(
        g, basis, m_in, v_in, m_out, v_out, u_out, w, M, N, r, mode, a);
  } else {
    const size_t smem = (size_t)M * r * sizeof(float);
    if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
    auto kern = left_kernel<RMAX, TW>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid((N + LEFT_THREADS - 1) / LEFT_THREADS, batch);
    kern<<<grid, LEFT_THREADS, smem, stream>>>(
        g, basis, m_in, v_in, m_out, v_out, u_out, w, M, N, r, mode, a);
  }
  return cudaGetLastError();
}

template <typename TW>
int dispatch(const float* g, const float* basis, const float* m_in,
             const float* v_in, float* m_out, float* v_out, float* u_out,
             TW* w, int batch, int M, int N, int r, int side, int mode,
             const AdamArgs& a, cudaStream_t st) {
  if (r <= 8)
    return (int)launch<8>(g, basis, m_in, v_in, m_out, v_out, u_out, w, batch,
                          M, N, r, side, mode, a, st);
  if (r <= 16)
    return (int)launch<16>(g, basis, m_in, v_in, m_out, v_out, u_out, w,
                           batch, M, N, r, side, mode, a, st);
  if (r <= 32)
    return (int)launch<32>(g, basis, m_in, v_in, m_out, v_out, u_out, w,
                           batch, M, N, r, side, mode, a, st);
  return (int)launch<64>(g, basis, m_in, v_in, m_out, v_out, u_out, w, batch,
                         M, N, r, side, mode, a, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. g (batch, M, N) fp32; basis
// (batch, N|M, r); moments (batch, M, r) right | (batch, r, N) left. side: 0
// right, 1 left. mode: 0 precond -> u_out in the moment shape, 1 precond ->
// u_out (batch, M, N), 2 adamw -> w (batch, M, N) updated in place (w_bf16:
// 1 for bf16, 0 for fp32). r <= 64. Returns cudaErrorInvalidConfiguration
// when the basis does not fit in shared memory, else cudaGetLastError().
extern "C" int galore_adamw_launch(
    const float* g, const float* basis, const float* m_in, const float* v_in,
    float* m_out, float* v_out, float* u_out, void* w, int w_bf16, int batch,
    int M, int N, int r, int side, int mode, float b1, float omb1, float b2,
    float omb2, float eps, float c1, float c2, float lr, float wd,
    void* stream) {
  if (r < 1 || r > 64) return (int)cudaErrorInvalidValue;
  const AdamArgs a{b1, omb1, b2, omb2, eps, c1, c2, lr, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return dispatch(g, basis, m_in, v_in, m_out, v_out, u_out,
                    static_cast<__nv_bfloat16*>(w), batch, M, N, r, side,
                    mode, a, st);
  return dispatch(g, basis, m_in, v_in, m_out, v_out, u_out,
                  static_cast<float*>(w), batch, M, N, r, side, mode, a, st);
}
