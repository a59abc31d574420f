// Causal GQA flash attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:73
// (flash_attention; pallas_call at :95, body _flash_kernel). It computes
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
// copies. o (B, Lq, H, D) contiguous in the input type. Any Lq and Lk
// (keys past Lk take no part, query rows past Lq are not written); D = 64
// or 128.
//
// What bounds it on this card. At a long prefill the operations: 4 D
// multiply-adds per attended (query, key) pair and head, 0.47 ms per
// starcoder2-7b layer at 8192 tokens with a 4096 window at the bf16
// tensor-core rate. At the prompts of serving (100-128 tokens) latency
// and bytes: q, k, v read once and o written once is about a microsecond,
// so the chain of one block's copies, products and store, and how many
// blocks the card runs at once, set the time.
//
// Two routes, chosen by the wrapper from the arguments alone
// (kernels/flash_attention.py::route) before anything launches:
//
// 1. tc (bf16 q, k, v that a tensor map describes: base pointers and strides
//    16-byte aligned, strides nested as in (B, L, H, D); every call of the
//    ported paths). A warp-specialised tensor-core kernel. A block owns BQ = 64
//    or 128 query rows of one (q head, batch row): BQ / 64 consumer warpgroups
//    of 64 rows each, and a producer. The producer issues TMA loads of the Q
//    tile once and keeps the K and V tiles (128 keys) of the block's kv head
//    flowing through a ring of 2 to 4 shared-memory stages (as many as the
//    block's budget fits), with an mbarrier per stage for K, for V and for the
//    stage's release. Q, K and V are read in place through 4-D tensor maps over
//    (D, H, L, B) with the 128-byte swizzle; D = 128 loads as two 64-column
//    boxes, and ragged tails arrive zero-filled. Each consumer warpgroup runs
//    S = Q K^T on wgmma m64n128k16 (bf16 -> fp32, Q and K both K-major in
//    shared memory), the online softmax on S in fp32 registers (exp2 with
//    scale * log2(e) folded in; row max and sum across the 4 lanes that share a
//    row, the sum reduced only at the end), rounds P to bf16 in registers (l
//    sums the rounded weights) and feeds it as the register A operand of wgmma
//    m64nDk16 for O += P V, V read N-major through the transpose bit. O stays
//    in fp32 registers to the end, is divided by l, rounded once and stored
//    through shared memory (the warpgroup's own Q rows) in 16-byte pieces.
//    Masks cost only the tiles that need them: key tiles wholly in the future
//    or wholly outside the window are never loaded, and of the visited ones
//    only those that cross the diagonal, the window's edge or Lk apply a mask
//    (keys >= Lk get -inf, p = 0; causal and window masks the finite -1e30);
//    the interior tiles run unmasked. With two consumer warpgroups the producer
//    is a warpgroup whose registers setmaxnreg hands to the consumers (24 / 240
//    a thread). The grid runs the q heads of one kv head side by side (K and V
//    shared through L2) and the heaviest query tiles first; BQ = 64 where
//    128-row tiles would leave SMs idle (at D = 64 two such blocks then share
//    an SM).
// 2. simt (fp32 inputs, which TF32 wgmma cannot hold to 1e-5 of scale, and
//    layouts the tensor maps do not describe: a base pointer or stride off 16
//    bytes, strides not nested; also Lk = 0). The first version of this port:
//    one 256-thread block per (64-row query tile, q head, batch row) on the
//    FP32 cores. It keeps the query tile in shared memory as fp32 and streams
//    64-key tiles of its kv head through shared memory in the input type (above
//    48 KB through the opt-in attribute); thread (ty, tx) of a 16 x 16 grid
//    owns rows 4 ty .. + 3, forms their 4 x 4 scores with keys tx + 16 j and
//    holds the rows' m, l and the 4 x D/16 accumulator in fp32 registers; p
//    goes through shared memory to the PV product; tiles wholly in the future
//    or outside the window are skipped unless a row of the tile sees no key.
//    The K row stride is padded to an odd number of 32-bit words (conflict-
//    free).
//
// Both routes skip tiles alike: a block whose rows all see a key visits
// [first key any row's window reaches, the last row's position]; a block
// with a row that sees none (Lq > Lk) visits every key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_ptx.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

// ================================================================ simt ==
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
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_simt(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Lq, int Lk, int H, int Hkv,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  auto kern = simt_kernel<T, D>;
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

// ================================================================== tc ==
constexpr int TC_BK = 128;            // keys per tile
constexpr int TC_MAX_STAGES = 4;
constexpr int TC_BARS = 128;          // mbarrier bytes after the stages
// setmaxnreg with two consumer warpgroups: the producer warpgroup gives
// back all but 24 registers a thread, the consumers take 240. ptxas gives
// the kernel 168 at entry, so the block's pool (384 x 168) covers exactly
// 128 x 24 + 256 x 240; launch_tc refuses a kernel whose pool would not,
// since an unmet request waits forever. With one consumer warpgroup the
// producer is a lone warp and nothing moves.
constexpr int PROD_REGS = 24;
constexpr int CONS_REGS = 240;
// A block's shared-memory budget: one block of two consumer warpgroups
// per SM (the opt-in limit); two blocks of one per SM (the SM's 228 KB
// less 1 KB reserved per block, halved) where a ring of two stages fits
// that (D = 64), else one block with a ring of two (D = 128).
constexpr int TC_BUDGET_1 = (233472 - 2 * 1024) / 2;

template <int NWG, int D>
struct Tc {
  static constexpr int BQ = 64 * NWG;            // query rows a block
  static constexpr int PANELS = D / 64;          // 64-column TMA boxes
  static constexpr int Q_PANEL = BQ * 128;       // bytes: BQ rows x 64 bf16
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_PANEL = TC_BK * 128;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int STAGE = 2 * KV_BYTES;     // K, then V
  static constexpr int CONS = 128 * NWG;         // consumer threads
  static constexpr int PROD = NWG == 2 ? 128 : 32;   // producer threads
  static constexpr int THREADS = CONS + PROD;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int BUDGET = NWG == 1 ? TC_BUDGET_1 : SMEM_LIMIT;
  static constexpr size_t bytes(int nst) {
    return 1024 + (size_t)Q_BYTES + (size_t)nst * STAGE + TC_BARS;
  }
  static int stages() {
    const int n = (int)((BUDGET - (long long)bytes(0)) / STAGE);
    return n < 2 ? 2 : n < TC_MAX_STAGES ? n : TC_MAX_STAGES;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The sum of the two bf16 values of a packed pair, in fp32.
__device__ __forceinline__ float pair_sum(uint32_t u) {
  return __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
}

// grid (ceil(Lq / BQ) * B * H): block x runs, from the fastest-varying
// index out, q head g of kv head hk, batch row b and query tile
// n_qt - 1 - t (the heaviest, latest tiles first). Threads [0, 128 NWG)
// are the consumer warpgroups (warpgroup wg owns rows 64 wg .. + 63 of the
// tile); the producer warp (warpgroup, with two consumers) follows.
template <int NWG, int D>
__global__ void __launch_bounds__(Tc<NWG, D>::THREADS, Tc<NWG, D>::MIN_BLOCKS)
tc_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          __nv_bfloat16* __restrict__ o, int B, int Lq, int Lk, int H,
          int Hkv, int n_qt, float scale_log2, int causal, int window,
          int nst) {
  using L = Tc<NWG, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t ring = base + L::Q_BYTES;
  const uint32_t bars = ring + nst * L::STAGE;
  const uint32_t q_bar = bars;                   // then full K, full V,
  const uint32_t fullk0 = bars + 8;              // empty: nst each
  const uint32_t fullv0 = fullk0 + 8 * TC_MAX_STAGES;
  const uint32_t empty0 = fullv0 + 8 * TC_MAX_STAGES;
  const int tid = threadIdx.x;

  const int groups = H / Hkv;
  int idx = blockIdx.x;
  const int g = idx % groups;
  idx /= groups;
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  const int qt = n_qt - 1 - idx / B;
  const int h = hk * groups + g;
  const int q0 = qt * L::BQ;

  // key tiles [kt_begin, kt_end), as the simt route chooses them
  const int off = Lk - Lq;                       // query i sits at off + i
  const int q_lo = off + q0, q_hi = off + min(q0 + L::BQ, Lq) - 1;
  int kt_begin = 0, kt_end = (Lk + TC_BK - 1) / TC_BK;
  if (causal && q_lo >= 0) {
    kt_end = min(kt_end, q_hi / TC_BK + 1);
    const int lo = q_lo - window + 1;
    if (window > 0 && lo > 0) kt_begin = lo / TC_BK;
  }

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < nst; ++st) {
      mbar_init(fullk0 + 8 * st, 1);
      mbar_init(fullv0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, L::CONS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= L::CONS) {   // producer: one thread issues every copy
    if constexpr (NWG == 2) reg_dealloc<PROD_REGS>();
    if (tid == L::CONS) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_load_4d(base + p * L::Q_PANEL, &tm_q, q_bar, 64 * p, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t ks = ring + stage * L::STAGE, vs = ks + L::KV_BYTES;
        const uint32_t fk = fullk0 + 8 * stage, fv = fullv0 + 8 * stage;
        mbar_expect_tx(fk, L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load_4d(ks + p * L::KV_PANEL, &tm_k, fk, 64 * p, hk,
                      kt * TC_BK, b);
        mbar_expect_tx(fv, L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load_4d(vs + p * L::KV_PANEL, &tm_v, fv, 64 * p, hk,
                      kt * TC_BK, b);
        if (++stage == nst) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers
  if constexpr (NWG == 2) reg_alloc<CONS_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rl = warp * 16 + (lane >> 2);      // rows rl, rl + 8 of the
  const int cq = 2 * (lane & 3);               // warpgroup; columns 8 j + cq
  const int qp0 = off + q0 + 64 * wg + rl;     // the two rows' positions
  const int qp1 = qp0 + 8;
  // the warpgroup's first and last real query positions: a tile needs a
  // mask where a key crosses the diagonal or the window's edge for them
  const int wq_lo = off + q0 + 64 * wg;
  const int wq_hi = off + min(q0 + 64 * wg + 63, Lq - 1);
  const float NO_KEY = __int_as_float((int)0xff800000u);   // -inf
  const uint32_t q_s = base + wg * 64 * 128;   // the warpgroup's Q rows

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TC_BK;
    const uint32_t ks = ring + stage * L::STAGE, vs = ks + L::KV_BYTES;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    mbar_wait(fullk0 + 8 * stage, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pq = (kk >> 2) * L::Q_PANEL + 32 * (kk & 3);
      const uint32_t pk = (kk >> 2) * L::KV_PANEL + 32 * (kk & 3);
      wgmma_m64n128<0, 0>(s, sw128_desc(q_s + pq, 16, 1024),
                          sw128_desc(ks + pk, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // s[4 j + e]: row rl + 8 (e >> 1), key k0 + 8 j + cq + (e & 1)
    const bool masked =
        k0 + TC_BK > Lk ||
        (causal && (k0 + TC_BK - 1 > wq_lo ||
                    (window > 0 && wq_hi - k0 >= window)));
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + cq + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          float x = s[4 * j + e] * scale_log2;
          if (kp >= Lk)
            x = NO_KEY;                        // no such key: p = 0
          else if (causal && (kp > qp || (window > 0 && qp - kp >= window)))
            x = NEG;
          s[4 * j + e] = x;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
    }
    float mx0 = NO_KEY, mx1 = NO_KEY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);   // finite
    const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[TC_BK / 16][4];                // P as wgmma A fragments
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2f(s[4 * j] - n0), p1 = exp2f(s[4 * j + 1] - n0);
      const float p2 = exp2f(s[4 * j + 2] - n1);
      const float p3 = exp2f(s[4 * j + 3] - n1);
      const uint32_t r0 = pack_bf16(p0, p1), r1 = pack_bf16(p2, p3);
      pa[j >> 1][2 * (j & 1)] = r0;
      pa[j >> 1][2 * (j & 1) + 1] = r1;
      rs0 += pair_sum(r0);
      rs1 += pair_sum(r1);
    }
    // l sums the rounded weights that PV applies, so O / l weighs V by
    // weights that sum to one: the rounding of P moves O by its weights'
    // shifts times (v - o), not times v
    l0 = alpha0 * l0 + rs0;                    // this thread's columns
    l1 = alpha1 * l1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    mbar_wait(fullv0 + 8 * stage, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + 2048 * kk, L::KV_PANEL, 1024);
      if constexpr (D == 128) wgmma_rs_m64n128<1>(acc, pa[kk], dv);
      else wgmma_rs_m64n64<1>(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * stage);
    if (++stage == nst) { stage = 0; phase ^= 1; }
  }

  // the 4 lanes of a row hold its sum in pieces
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);

  // O through the warpgroup's own Q rows (its products are done), 16-byte
  // chunk c of row r at chunk c ^ (r % 8) of its 128-byte row: the 8 rows
  // a warp writes at once fall in 8 different bank groups.
  uint8_t* o_s = smem + wg * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int p = j >> 3, c = (j & 7) ^ (rl & 7);
    uint8_t* at = o_s + p * L::Q_PANEL + rl * 128 + c * 16 + cq * 2;
    *reinterpret_cast<uint32_t*>(at) =
        pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(at + 8 * 128) =
        pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  named_sync(1 + wg, 128);
  constexpr int CH = D / 8;                    // 16-byte chunks a row
  const int t = tid & 127;
#pragma unroll
  for (int i = 0; i < 64 * CH / 128; ++i) {
    const int u = t + 128 * i, r = u / CH, c = u % CH;
    const int qi = q0 + 64 * wg + r;
    if (qi < Lq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Lq + qi) * H + h) * D +
                                8 * c) =
          *reinterpret_cast<const uint4*>(
              o_s + (c >> 3) * L::Q_PANEL + r * 128 +
              (((c & 7) ^ (r & 7)) << 4));
  }
}

// q, k, v as 4-D tensor maps over (D, H, L, B); st: the 9 element
// strides (batch, sequence, head of q, then k, then v).
template <int NWG, int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const long long* st, int B, int Lq, int Lk, int H, int Hkv,
              float scale, int causal, int window, cudaStream_t stream) {
  using L = Tc<NWG, D>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)D,
                                (cuuint64_t)(i ? Hkv : H),
                                (cuuint64_t)(i ? Lk : Lq), (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st[3 * i + 2] * 2,
                                   (cuuint64_t)st[3 * i + 1] * 2,
                                   (cuuint64_t)st[3 * i] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)(i ? TC_BK : L::BQ), 1};
    const int bad = bf16_tensor_map(&maps[i], ptrs[i], 4, dims, strides, box);
    if (bad != 0) return bad;
  }
  const int nst = L::stages();
  if (L::bytes(nst) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidConfiguration;
  static const cudaError_t opt_in = cudaFuncSetAttribute(   // once
      tc_kernel<NWG, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (opt_in != cudaSuccess) return (int)opt_in;
  static const int pool_regs = [] {   // the block's registers at entry
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, tc_kernel<NWG, D>) == cudaSuccess
               ? a.numRegs * L::THREADS : 0;
  }();
  if (NWG == 2 && pool_regs < L::PROD * PROD_REGS + L::CONS * CONS_REGS)
    return (int)cudaErrorInvalidConfiguration;
  const int n_qt = (Lq + L::BQ - 1) / L::BQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  tc_kernel<NWG, D><<<(unsigned)blocks, L::THREADS, L::bytes(nst), stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), B, Lq, Lk,
      H, Hkv, n_qt, scale * 1.4426950408889634f, causal, window, nst);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. strides: 9 element strides, the
// batch, sequence and head strides of q, then k, then v (unit stride along
// D; the tc route needs each a multiple of 8 elements). is_bf16: 1 when q,
// k, v and o are bf16, 0 for fp32. route: 0 simt, 1 tc (bf16 only, Lk >=
// 1); bq: the tc route's query rows a block, 64 or 128. Returns
// cudaErrorInvalidValue for a shape or route the kernel does not take,
// cudaErrorInvalidConfiguration when its shared memory exceeds the
// device's limit per block, 10000 + a CUresult when a tensor map cannot
// be encoded, else cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int Lq, int Lk, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int is_bf16, int route, int bq,
                                      void* stream) {
  if (Hkv < 1 || H % Hkv || B > 65535 || H > 65535 || window < 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Lq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!is_bf16 || Lk < 1 || (bq != 64 && bq != 128))
      return (int)cudaErrorInvalidValue;
    if (bq == 128)
      return D == 64 ? launch_tc<2, 64>(q, k, v, o, strides, B, Lq, Lk, H,
                                        Hkv, scale, causal, window, st)
                     : launch_tc<2, 128>(q, k, v, o, strides, B, Lq, Lk, H,
                                         Hkv, scale, causal, window, st);
    return D == 64 ? launch_tc<1, 64>(q, k, v, o, strides, B, Lq, Lk, H, Hkv,
                                      scale, causal, window, st)
                   : launch_tc<1, 128>(q, k, v, o, strides, B, Lq, Lk, H,
                                       Hkv, scale, causal, window, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return D == 64 ? launch_simt<__nv_bfloat16, 64>(
                         q, k, v, o, strides, B, Lq, Lk, H, Hkv, scale,
                         causal, window, st)
                   : launch_simt<__nv_bfloat16, 128>(
                         q, k, v, o, strides, B, Lq, Lk, H, Hkv, scale,
                         causal, window, st);
  return D == 64 ? launch_simt<float, 64>(q, k, v, o, strides, B, Lq, Lk, H,
                                          Hkv, scale, causal, window, st)
                 : launch_simt<float, 128>(q, k, v, o, strides, B, Lq, Lk, H,
                                           Hkv, scale, causal, window, st);
}
