// Causal GQA flash attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:95, body _flash_kernel). It computes
// what _flash_kernel computes:
//
//   o[b,i,h] = sum_j softmax_j(scale * q[b,i,h] . k[b,j,h/G]) v[b,j,h/G]
//
// with G = H / Hkv (q head h reads kv head h / G), a suffix-aligned causal
// mask (query i sits at position Lk - Lq + i and sees keys j <= that
// position) and, with window > 0, only keys less than `window` positions
// back. Masked scores are the finite -1e30 of the JAX package, so a query
// that sees no key (Lq > Lk) averages V uniformly over the keys, as both
// JAX versions do; the result divides by max(l, 1e-30).
//
// q (B, Lq, H, D), k and v (B, Lk, Hkv, D), read in place through their
// batch, sequence and head strides (unit stride along D): no transposed
// copies. bf16 or fp32, one type for all three; o (B, Lq, H, D) contiguous
// in that type. Any Lq and Lk (ragged tails are masked: keys past Lk take
// no part, query rows past Lq are not written); D = 64 or 128.
//
// Design. One block of 256 threads per (query tile of 64 rows, q head,
// batch row). The block keeps its query tile in shared memory as fp32 and
// streams the 64-key tiles of its kv head through shared memory, staged
// in the input type (bf16: 2 x 64 x 130 x 2 B = 33 KB at D = 128; fp32
// 66 KB), above 48 KB through the opt-in attribute, checked against the
// device's limit. Thread (ty, tx) of a 16 x 16 grid owns query rows
// 4 ty .. 4 ty + 3: it forms the 4 x 4 scores of those rows with keys
// tx + 16 j, and holds the rows' running max m, sum l and the 4 x D/16
// accumulator (columns tx + 16 j) in fp32 registers. Per key tile, with
// the online-softmax recurrence of the Pallas kernel:
//
//   m' = max(m, rowmax s);  p = exp(s - m');  l = e^{m-m'} l + rowsum p;
//   acc = e^{m-m'} acc + p v
//
// row max and sum are reduced across the 16 threads of a row group with
// warp shuffles, and p goes through shared memory to the PV product.
// Key tiles that lie wholly in the future of the query tile, or wholly
// outside its window, are skipped (as blockwise_attend skips them; the
// Pallas kernel masks them but visits them), unless a row of the tile
// sees no key at all, which needs every key. The K row stride is padded
// to an odd number of 32-bit words so that the 16 keys a half-warp reads
// sit in 16 banks.
//
// What bounds it on this card. At the prompts of serving (128 tokens)
// the bytes: q, k, v read once and o written once, about a microsecond.
// At a long prefill the operations: 4 D multiply-adds per attended
// (query, key) pair and head, 0.47 ms per starcoder2-7b layer at 8192
// tokens with a 4096 window on bf16 tensor cores. This first version
// computes on the FP32 cores with scalar fused multiply-adds from shared
// memory; mma.sync / wgmma and TMA are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;      // 16 x 16; 4 rows x 4 keys of scores each
constexpr int PSTRIDE = BK + 4;   // p row stride (floats): 16-byte rows,
                                  // the two row groups of a warp in
                                  // different banks
constexpr float NEG = -1e30f;     // masked score (finite, as in JAX)

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
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// K and V row stride in shared memory, in elements: an odd number of
// 32-bit words.
template <typename T, int D>
__host__ __device__ constexpr int kv_stride() {
  return sizeof(T) == 2 ? D + 2 : D + 1;
}

// Elements d and d + 1 (d even) of a staged K row, as floats.
__device__ __forceinline__ float2 pair(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + d));
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)BQ * D * sizeof(float) + (size_t)BQ * PSTRIDE * sizeof(float)
         + 2 * (size_t)BK * kv_stride<T, D>() * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, long long qsb,
             long long qsl, long long qsh, long long ksb, long long ksl,
             long long ksh, long long vsb, long long vsl, long long vsh,
             int Lq, int Lk, int H, int groups, float scale, int causal,
             int window) {
  constexpr int KS = kv_stride<T, D>();
  constexpr int NJ = D / 16;                 // accumulator columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // BQ x D
  float* p_s = q_s + BQ * D;                            // BQ x PSTRIDE
  T* k_s = reinterpret_cast<T*>(p_s + BQ * PSTRIDE);    // BK x KS
  T* v_s = k_s + BK * KS;                               // BK x KS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / groups;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Lk - Lq;                   // query i sits at off + i
  const float NO_KEY = __int_as_float((int)0xff800000u);   // -inf
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    q_s[idx] = q0 + r < Lq ? to_f(qb[(long long)(q0 + r) * qsl + c]) : 0.f;
  }

  float acc[4][NJ], m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // Key tiles to visit. Skipping needs every row of the tile to see a key
  // (query position >= 0); a row that sees none averages over all keys.
  const int q_lo = off + q0;
  const int q_hi = off + min(q0 + BQ, Lq) - 1;
  int kt_begin = 0, kt_end = (Lk + BK - 1) / BK;
  if (causal && q_lo >= 0) {
    kt_end = min(kt_end, q_hi / BK + 1);     // not wholly in the future
    const int lo = q_lo - window + 1;        // first key any row may see
    if (window > 0 && lo > 0) kt_begin = lo / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                         // last tile consumed, q staged
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < Lk;
      k_s[r * KS + c] = in ? kb[(long long)(k0 + r) * ksl + c] : zero<T>();
      v_s[r * KS + c] = in ? vb[(long long)(k0 + r) * vsl + c] : zero<T>();
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float2*>(q_s + (ty * 4 + i) * D + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = pair(k_s + (tx + 16 * j) * KS, d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = off + q0 + ty * 4 + i;
      float mx = NO_KEY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Lk)
          x = NO_KEY;                        // no such key: p = 0
        else if (causal && (kj > qpos || (window > 0 && qpos - kj >= window)))
          x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m_i[i], mx);   // finite: m_i starts at NEG
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o_);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty * 4 + i) * PSTRIDE + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            p_s + (ty * 4 + i) * PSTRIDE + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T* vrow = v_s + (kk + u) * KS + tx;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float vv = to_f(vrow[16 * jj]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z : pv[i].w;
            acc[i][jj] = fmaf(p, vv, acc[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((long long)b * Lq + qi) * H + h) * D + tx;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[16 * jj] = from_f<T>(acc[i][jj] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Lq, int Lk, int H, int Hkv,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], Lq, Lk, H, H / Hkv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. strides: 9 element strides, the
// batch, sequence and head strides of q, then k, then v (unit stride along
// D). is_bf16: 1 when q, k, v and o are bf16, 0 for fp32. Returns
// cudaErrorInvalidValue for a shape the kernel does not take,
// cudaErrorInvalidConfiguration when its shared memory exceeds the
// device's limit per block, else cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int Lq, int Lk, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int is_bf16, void* stream) {
  if (Hkv < 1 || H % Hkv || B > 65535 || H > 65535 || window < 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Lq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return D == 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, strides, B, Lq, Lk,
                                                H, Hkv, scale, causal, window,
                                                st)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, strides, B, Lq,
                                                 Lk, H, Hkv, scale, causal,
                                                 window, st);
  return D == 64 ? launch<float, 64>(q, k, v, o, strides, B, Lq, Lk, H, Hkv,
                                     scale, causal, window, st)
                 : launch<float, 128>(q, k, v, o, strides, B, Lq, Lk, H, Hkv,
                                      scale, causal, window, st);
}
