// The backward of the RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces no pallas_call: the Pallas kernel repro/kernels/rwkv6_scan.py is
// forward only, and the JAX package trains RWKV6 through XLA's derivative
// of the lax.scan in repro/models/rwkv.py:126-136 (jax.vjp of
// repro/kernels/ref.py:102's scan is the same function). The port needs a
// kernel of its own for the gradient that scan gives.
//
// Per (b, h), with S_{t-1} the state before step t and G = dL/dS (D x D
// fp32) walked back from ds_final over t = L-1 ... 0:
//
//   A = r_t (x) dy_t;  dkv = G + diag(u) A
//   dr_t = sum_j S_{t-1} dy_t + (u . k_t)(v_t . dy_t)
//   dk_t = sum_j dkv v_t;  dv_t = sum_i k_t dkv;  dw_t = sum_j G . S_{t-1}
//   du += (r_t . k_t)(v_t . dy_t);  G <- diag(w_t) G + A
//
// and ds0 = G. r, k, v, dy (B, L, H, D) bf16 or fp32 (one type), w fp32 or
// bf16, u (H, D) fp32, ckpt (B, H, ceil(L / K), D, D) fp32: the states the
// forward's checkpoint mode (csrc/rwkv6_scan.cu) wrote every K = 8 steps;
// ds_final (B, H, D, D) fp32 or null (zeros). Writes dr, dk, dv in r's
// type, dw in w's, du (B, H, D) fp32 (the wrapper sums over b) and ds0
// (B, H, D, D) fp32. Any L, 1 <= D <= 64.
//
// Arithmetic order, shared bit for bit with the plain version
// (ref.rwkv6_scan_bwd_ref): every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no fused multiply-adds), and each sum over j, over
// i and v . dy the pairwise tree of adjacent pairs over 64 leaves (D
// zero-padded), as ref._pairwise_sum. The states S_{t-1} are recomputed
// from the checkpoints with the forward's own S <- w S + k v, so they are
// the forward's bit for bit; they are never recovered by dividing by w_t,
// which underflows to 0 in fp32.
//
// What bounds it on this card: operations and bytes nearly alike. About
// 16 D^2 fp32 operations a step per (b, h) (the recomputed step, then A,
// dkv, the four products that are summed and the G update): at rwkv6-1.6b's
// training layer, (4, 128, 32, 64), 1.07 GFLOP, 16.0 us at 67 TFLOP/s;
// against r, k, v, dy, w in, dr, dk, dv, dw out and the checkpoints read,
// 58.7 MB, 17.5 us at 3.35 TB/s (25 MB without the checkpoints). Like the
// forward it is a chain of L dependent steps per (b, h), so the design
// keeps the chain in registers and every step's reductions inside one warp
// where it can.
//
// Design (one simple kernel; its speed is later work):
// - One block of 256 threads per (b, h): B H blocks, 128 (one wave on 132
//   SMs) at the training shape. Thread (i, q) = (tid / 4, tid % 4) holds
//   row i and columns 16 q .. 16 q + 15 of G in registers, so a warp holds
//   8 rows. The sums over j (dr, dk, dw, v . dy) are 16 in-thread adjacent
//   pairs and two __shfl_xor_sync levels across the row's 4 lanes; the sum
//   over i (dv) a reduce-scatter over the warp's 8 rows (three levels, each
//   keeping half the columns) into shared memory, then the 8 warps' partial
//   sums added as a pairwise tree: both are the plain version's tree.
// - Chunks of K = 8 steps, last chunk first. The block stages the chunk's
//   r, k, w (per row) and v, dy (per column) as fp32 in shared memory, each
//   thread loads its 16 entries of the chunk's checkpoint and recomputes
//   S_{t0} .. S_{t0+7} into its own slots of shared memory (128 KB, float4
//   a thread a slot: conflict-free, no other thread reads them), then walks
//   the chunk backwards.
// - Three __syncthreads a chunk; none inside a step.
// - Rows and columns at or past D are staged and loaded as zeros, so they
//   add exact zeros to every tree.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TREE = 64;       // rows and columns of a state, zero-padded
constexpr int K = 8;           // steps between checkpoints, and a chunk
constexpr int THREADS = 256;   // 64 rows x 4 lanes
constexpr int QC = 16;         // columns a thread holds
constexpr int CS = 20;         // floats between a staged step's quarters
constexpr int WARPS = THREADS / 32;
// Shared memory, in floats: the states, r k w staged per row, v dy per
// column, the warps' dv partials.
constexpr int ST_F = K * THREADS * QC;
constexpr int ROW_F = K * TREE;
constexpr int COL_F = K * 4 * CS;
constexpr int RED_F = K * WARPS * TREE;
constexpr size_t SMEM = (size_t)(ST_F + 3 * ROW_F + 2 * COL_F + RED_F) * 4;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
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

// Row i, columns c0 .. c0 + 15 of a D x D fp32 matrix (null: zeros), zero
// past D; `vec` (D = 64, 16-byte aligned) loads float4s.
__device__ __forceinline__ void load_row(const float* m, int i, int c0,
                                         int D, bool vec, float (&o)[QC]) {
  if (m != nullptr && vec) {
#pragma unroll
    for (int a = 0; a < QC; a += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(m + (size_t)i * TREE + c0 + a);
      o[a] = x.x; o[a + 1] = x.y; o[a + 2] = x.z; o[a + 3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int a = 0; a < QC; ++a)
    o[a] = (m != nullptr && i < D && c0 + a < D)
               ? m[(size_t)i * D + c0 + a] : 0.f;
}

__device__ __forceinline__ void store_row(float* m, int i, int c0, int D,
                                          bool vec, const float (&x)[QC]) {
  if (vec) {
#pragma unroll
    for (int a = 0; a < QC; a += 4)
      *reinterpret_cast<float4*>(m + (size_t)i * TREE + c0 + a) =
          make_float4(x[a], x[a + 1], x[a + 2], x[a + 3]);
    return;
  }
#pragma unroll
  for (int a = 0; a < QC; ++a)
    if (i < D && c0 + a < D) m[(size_t)i * D + c0 + a] = x[a];
}

// The pairwise tree of adjacent pairs over a thread's 16 columns, then
// across the row's 4 lanes (lane bits 0 and 1): the row's sum over j.
__device__ __forceinline__ float row_sum(float (&p)[QC]) {
#pragma unroll
  for (int width = 1; width < QC; width *= 2) {
#pragma unroll
    for (int a = 0; a < QC; a += 2 * width) p[a] = add(p[a], p[a + width]);
  }
  float x = p[0];
  x = add(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return add(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The sum over the warp's 8 rows (lane bits 2, 3, 4) of a thread's 16
// column partials, as a reduce-scatter: at each level the thread keeps half
// of its columns (the upper half when that bit of its row is set), sends
// the other half to its partner row and adds what comes back. Partners hold
// the same columns, so each sum is the tree of adjacent rows. Leaves p[0],
// p[1] = columns sigma, sigma + 1 of this thread's 16; returns sigma.
__device__ __forceinline__ int rows_reduce_scatter(float (&p)[QC], int i) {
  int sigma = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int half = (QC >> l) / 2;
    const bool hi = (i >> l) & 1;
#pragma unroll
    for (int c = 0; c < half; ++c) {
      const float send = hi ? p[c] : p[c + half];
      const float keep = hi ? p[c + half] : p[c];
      p[c] = add(keep, __shfl_xor_sync(0xffffffffu, send, 4 << l));
    }
    sigma += hi ? half : 0;
  }
  return sigma;
}

template <typename T, typename TW>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const TW* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const T* __restrict__ dy,
                const float* __restrict__ ds_final, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv,
                TW* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ ds0, int L, int H, int D, int vec) {
  extern __shared__ __align__(16) float smem[];
  float4* st = reinterpret_cast<float4*>(smem);
  float* rin = smem + ST_F;            // r, k, w: [K][TREE] each
  float* kin = rin + ROW_F;
  float* win = kin + ROW_F;
  float* vin = win + ROW_F;            // v, dy: [K][4][CS] each
  float* dyin = vin + COL_F;
  float* red = dyin + COL_F;           // [K][WARPS][TREE]

  const int tid = threadIdx.x, i = tid >> 2, q = tid & 3, warp = tid >> 5;
  const int c0 = QC * q;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;   // (b, 0, h, 0)
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (L + K - 1) / K;
  const bool row_ok = i < D;

  float G[QC];
  load_row(ds_final == nullptr ? nullptr : ds_final + sbase, i, c0, D, vec,
           G);
  const float ui = row_ok ? u[(size_t)h * D + i] : 0.f;
  float dui = 0.f;

  for (int n = nck - 1; n >= 0; --n) {
    const int t0 = n * K, cnt = min(K, L - t0);
    __syncthreads();          // the last chunk's staging and red are read
    // All ten loads of a thread in flight at once: op is known per pass.
#pragma unroll
    for (int m = 0; m < 5 * K * TREE / THREADS; ++m) {
      const int idx = tid + m * THREADS;
      const int op = idx / (K * TREE), rem = idx - op * K * TREE;
      const int s = rem / TREE, e = rem - s * TREE;
      const size_t off = base + (size_t)(t0 + s) * step + e;
      const bool ok = s < cnt && e < D;
      float x = 0.f;
      if (ok) {
        switch (op) {
          case 0: x = to_f(r[off]); break;
          case 1: x = to_f(k[off]); break;
          case 2: x = to_f(w[off]); break;
          case 3: x = to_f(v[off]); break;
          default: x = to_f(dy[off]); break;
        }
      }
      if (op < 3)
        rin[op * ROW_F + s * TREE + e] = x;
      else
        vin[(op - 3) * COL_F + s * 4 * CS + (e >> 4) * CS + (e & 15)] = x;
    }
    float S[QC];
    load_row(ckpt + (sbase * nck + (size_t)n * D * D), i, c0, D, vec, S);
    __syncthreads();

    // S_{t0 + s} into this thread's slot s.
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < cnt) {
#pragma unroll
        for (int a = 0; a < QC; a += 4)
          st[(s * 4 + a / 4) * THREADS + tid] =
              make_float4(S[a], S[a + 1], S[a + 2], S[a + 3]);
        if (s + 1 < cnt) {
          const float wi = win[s * TREE + i], ki = kin[s * TREE + i];
          const float* vs = vin + s * 4 * CS + q * CS;
#pragma unroll
          for (int a = 0; a < QC; ++a)
            S[a] = add(mul(wi, S[a]), mul(ki, vs[a]));
        }
      }
    }

#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      if (s >= cnt) continue;
      float Ss[QC], vv[QC], dd[QC];
#pragma unroll
      for (int a = 0; a < QC; a += 4) {
        const float4 x = st[(s * 4 + a / 4) * THREADS + tid];
        Ss[a] = x.x; Ss[a + 1] = x.y; Ss[a + 2] = x.z; Ss[a + 3] = x.w;
        const float4 y4 = *reinterpret_cast<const float4*>(
            vin + s * 4 * CS + q * CS + a);
        vv[a] = y4.x; vv[a + 1] = y4.y; vv[a + 2] = y4.z; vv[a + 3] = y4.w;
        const float4 d4 = *reinterpret_cast<const float4*>(
            dyin + s * 4 * CS + q * CS + a);
        dd[a] = d4.x; dd[a + 1] = d4.y; dd[a + 2] = d4.z; dd[a + 3] = d4.w;
      }
      const float ri = rin[s * TREE + i], ki = kin[s * TREE + i],
                  wi = win[s * TREE + i];
      float pk[QC], pv[QC], pr[QC], pw[QC], pd[QC];
#pragma unroll
      for (int a = 0; a < QC; ++a) {
        const float ad = mul(ri, dd[a]);
        const float dkv = add(G[a], mul(ui, ad));
        pk[a] = mul(dkv, vv[a]);
        pv[a] = mul(ki, dkv);
        pr[a] = mul(Ss[a], dd[a]);
        pw[a] = mul(G[a], Ss[a]);
        pd[a] = mul(vv[a], dd[a]);
        G[a] = add(mul(wi, G[a]), ad);
      }
      const float vdy = row_sum(pd);
      const float dkt = row_sum(pk);
      const float drt = add(row_sum(pr), mul(mul(ui, ki), vdy));
      const float dwt = row_sum(pw);
      dui = add(dui, mul(mul(ri, ki), vdy));
      if (row_ok) {
        const size_t off = base + (size_t)(t0 + s) * step + i;
        if (q == 0) dr[off] = from_f<T>(drt);
        else if (q == 1) dk[off] = from_f<T>(dkt);
        else if (q == 2) dw[off] = from_f<TW>(dwt);
      }
      const int sigma = rows_reduce_scatter(pv, i);
      float* rp = red + (s * WARPS + warp) * TREE + c0 + sigma;
      rp[0] = pv[0];
      rp[1] = pv[1];
    }
    __syncthreads();
    // dv: the warps' partial sums, a pairwise tree over the 8 warps.
    for (int idx = tid; idx < K * TREE; idx += THREADS) {
      const int s = idx / TREE, j = idx - s * TREE;
      if (s < cnt && j < D) {
        float p[WARPS];
#pragma unroll
        for (int x = 0; x < WARPS; ++x) p[x] = red[(s * WARPS + x) * TREE + j];
#pragma unroll
        for (int width = 1; width < WARPS; width *= 2) {
#pragma unroll
          for (int a = 0; a < WARPS; a += 2 * width)
            p[a] = add(p[a], p[a + width]);
        }
        dv[base + (size_t)(t0 + s) * step + j] = from_f<T>(p[0]);
      }
    }
  }
  store_row(ds0 + sbase, i, c0, D, vec, G);
  if (q == 0 && row_ok) du[(size_t)bh * D + i] = dui;
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* ckpt, const void* dy,
           const float* ds_final, void* dr, void* dk, void* dv, void* dw,
           float* du, float* ds0, int B, int L, int H, int D,
           cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (SMEM > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  auto ok16 = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D == TREE && ok16(ckpt) && ok16(ds_final) && ok16(ds0);
  auto kern = wkv6_bwd_kernel<T, TW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM);
  kern<<<B * H, THREADS, SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w), u, ckpt,
      static_cast<const T*>(dy), ds_final, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<TW*>(dw), du,
      ds0, L, H, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. every must be K (the stride the
// forward's checkpoint mode was asked for); rkv_bf16: 1 when r, k, v, dy
// (and dr, dk, dv) are bf16, 0 for fp32; w_bf16 likewise for w and dw.
// ds_final may be null. Returns cudaGetLastError() after the launch.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* ckpt, const void* dy, const float* ds_final,
    void* dr, void* dk, void* dv, void* dw, float* du, float* ds0, int B,
    int L, int H, int D, int every, int rkv_bf16, int w_bf16, void* stream) {
  if (D < 1 || D > TREE || every != K || L < 0)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV6_BWD(T, TW)                                                    \
  return launch<T, TW>(r, k, v, w, u, ckpt, dy, ds_final, dr, dk, dv, dw, \
                       du, ds0, B, L, H, D, st)
  if (rkv_bf16 && w_bf16) WKV6_BWD(__nv_bfloat16, __nv_bfloat16);
  if (rkv_bf16) WKV6_BWD(__nv_bfloat16, float);
  if (w_bf16) WKV6_BWD(float, __nv_bfloat16);
  WKV6_BWD(float, float);
#undef WKV6_BWD
}
