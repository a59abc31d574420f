// The RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (the
// public function at rwkv6_scan.py:54, pallas_call at rwkv6_scan.py:69).
// Per (b, h), with S a D x D fp32 state carried over the whole sequence:
//
//   y_t = r_t . (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
//
// r, k, v, w (B, L, H, D) read in place (no transpose); r, k, v bf16 or fp32
// (one type), w fp32 or bf16; u (H, D) fp32; s0 (B, H, D, D) fp32 or null
// (zeros). Writes y (B, L, H, D) in r's type and s_out (B, H, D, D) fp32.
// Any L (decode is L = 1, L = 0 copies s0), 1 <= D <= 64.
//
// Checkpoint mode (ckpt not null; training, for csrc/rwkv6_scan_bwd.cu):
// the state before steps 0, every, 2 every, ... is also written, fp32
// row-major, into ckpt (B, H, ceil(L / every), D, D). `every` is a
// multiple of the steps a group reduces and divides the staged chunk, so
// each checkpoint falls on a group's first step. The arithmetic is the
// same in both modes; the mode adds B H ceil(L / every) D^2 4 bytes of
// writes (32 MiB for rwkv6-1.6b's training layer, (4, 128, 32, 64), at
// every = 8).
//
// Arithmetic order, shared bit for bit with the plain version
// (ref.rwkv6_scan_ref): kv = k_i v_j; p_i = r_i (S_ij + u_i kv);
// S_ij <- w_i S_ij + kv, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into fused multiply-adds); y_j is
// ref._pairwise_sum's tree of adjacent pairs over the D products. The
// kernel's tree always has TREE = 64 leaves, the products of rows past D
// set to zero: where D is not a power of two the plain version pads to a
// smaller power, and the extra zeros change at most the sign of a zero sum.
//
// What bounds it on this card. Bytes: r, k, v, w in, y out, s0 in and S out
// (1.25 us for one 128-token rwkv6-1.6b prompt, (1, 128, 32, 64); 2.57 us for
// a decode step of 8 rows, almost all of it S). Operations: 6 D^2 unfused
// fp32 operations a step per (b, h), 3x the fused count the bound takes.
// The recurrence is a chain of L dependent steps: a design with one block
// of D threads per (b, h), each thread walking all 64 rows a step, runs 32
// blocks for one prompt and is latency-bound at ~1.9 us a step.
//
// Design (kernels/rwkv6_scan.py::plan picks the numbers):
// - Columns of S are independent: y_j and column j need only column j and
//   the broadcast r, k, w, u. A column's 64 rows are spread over LANES =
//   64 / RHO lanes of one warp, RHO contiguous rows a lane in registers
//   (with u for them); a block holds `cols` columns of 256 threads at most
//   and a (b, h) takes `col_blocks` blocks. RHO = 4 (one prompt: 128
//   blocks of 16 columns); 16 when that grid would need more than a wave
//   (8 prompts, 8 decode rows: 256 blocks of 64 columns, fewer and fatter
//   lanes, more work a thread between shuffles).
// - A step costs a lane one vector shared-memory load each of r, k, w for
//   its rows, one of v_j, and 6 RHO rounded operations. Only
//   S <- w S + kv chains from step to step.
// - The y tree: the lane sums its rows as adjacent pairs, then the column's
//   lanes join by __shfl_xor_sync at offsets 1, 2, 4, ...; a + b and b + a
//   round alike, so the sum is the plain version's tree. GROUP = 8 steps
//   are reduced together, off the chain, as a reduce-scatter: each level
//   halves the steps a lane carries, so a group costs 2 (GROUP - 1)
//   shuffles and adds a lane rather than 2 GROUP log2(LANES), and the lane
//   left holding a step writes its y. Decode (L < 8) reduces one step at a
//   time, a kernel with fewer registers. When D < 64 every lane of the grid
//   takes the masked copy of the step code (a grid-uniform choice), which
//   zeroes each product of a row at or past D; the rows' staged inputs are
//   never read into y or S_out.
// - `staged` steps of r, k, v, w are copied into shared memory in their own
//   types with cp.async, 16 bytes a thread (rows whose bytes are not a
//   multiple of 16, or an operand off 16 bytes, are copied element by
//   element), one commit group and one __syncthreads a chunk. When
//   L > staged a second slot takes the next chunk while this one is
//   computed; plan shortens `staged` where two slots would not fit (fp32
//   operands). (Finer commit groups, each behind its own barrier or
//   mbarrier, measured slower on the card: each group boundary cost more
//   than the first copy's latency it hid.)
// - Two blocks of 256 threads an SM (__launch_bounds__): ptxas keeps the
//   16-row kernel at 128 registers, with a small spill.
// - S enters and leaves through a shared-memory tile of the block's
//   columns, so s0 and s_out are read and written row-major, coalesced,
//   each thread's loads all in flight before its first store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TREE = 64;      // rows of a column: D <= 64, zero-padded
constexpr int MAX_THREADS = 256;

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

// N consecutive values from shared memory as floats, in 16- or 8-byte
// vector loads (the row offsets keep them aligned).
template <int N, typename T>
__device__ __forceinline__ void load_rows(const T* p, float (&o)[N]);
__device__ __forceinline__ void unpack_bf16x2(uint32_t x, float& lo,
                                              float& hi) {
  lo = __uint_as_float(x << 16);        // a bf16 is the top half of a float
  hi = __uint_as_float(x & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load_rows<4, float>(const float* p,
                                                    float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
template <>
__device__ __forceinline__ void load_rows<16, float>(const float* p,
                                                     float (&o)[16]) {
#pragma unroll
  for (int a = 0; a < 16; a += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + a);
    o[a] = x.x; o[a + 1] = x.y; o[a + 2] = x.z; o[a + 3] = x.w;
  }
}
template <>
__device__ __forceinline__ void load_rows<4, __nv_bfloat16>(
    const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  unpack_bf16x2(x.x, o[0], o[1]);
  unpack_bf16x2(x.y, o[2], o[3]);
}
template <>
__device__ __forceinline__ void load_rows<16, __nv_bfloat16>(
    const __nv_bfloat16* p, float (&o)[16]) {
#pragma unroll
  for (int a = 0; a < 16; a += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + a);
    unpack_bf16x2(x.x, o[a], o[a + 1]);
    unpack_bf16x2(x.y, o[a + 2], o[a + 3]);
    unpack_bf16x2(x.z, o[a + 4], o[a + 5]);
    unpack_bf16x2(x.w, o[a + 6], o[a + 7]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's commit groups are in flight.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's share of copying an operand's rows into shared memory: a
// row is `pieces` 16-byte pieces (vec) or D elements, and `per_pass` rows
// are copied a pass; this thread copies piece `pc` of rows first, first +
// per_pass, ...
struct Share {
  int pieces, per_pass, first, pc;
  __device__ Share(int D, int elem, bool vec) {
    pieces = vec ? D * elem / 16 : D;
    per_pass = blockDim.x / pieces;
    first = threadIdx.x / pieces;
    pc = threadIdx.x - first * pieces;
    if (first >= per_pass) first = 1 << 30;    // a thread left over
  }
};

// Copy steps [t, t + n) of one operand (rows of D elements, `step` apart)
// into shared rows 0 .. n of RS elements.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int t, int n,
                                      int RS, size_t step, bool vec,
                                      const Share& sh) {
  if (vec) {                   // D * sizeof(T) % 16 == 0, operand aligned
    constexpr int EPP = 16 / sizeof(T);
    for (int s = sh.first; s < n; s += sh.per_pass)
      cp_async16(dst + (size_t)s * RS + sh.pc * EPP,
                 src + (size_t)(t + s) * step + sh.pc * EPP);
  } else {
    for (int s = sh.first; s < n; s += sh.per_pass)
      dst[(size_t)s * RS + sh.pc] = src[(size_t)(t + s) * step + sh.pc];
  }
}

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

// GROUP steps (or the first `cnt`, when not FULL) from shared rows row0 ..:
// S advances, and each step's y_j is stored by one lane of the column.
// MASK: D < TREE, the same for every lane; the products of rows at or past
// D are the tree's zeros.
template <int RHO, int LANES, int GROUP, bool FULL, bool MASK,
          typename T, typename TW>
__device__ __forceinline__ void steps(const T* sr, const T* sk, const T* sv,
                                      const TW* sw, int row0, int cnt,
                                      float (&S)[RHO],
                                      const float (&uu)[RHO], int q, int jv,
                                      int D, T* yp, size_t step, bool store) {
  float part[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    part[g] = 0.f;
    if (FULL || g < cnt) {
      const int row = (row0 + g) * TREE;
      float rr[RHO], kk[RHO], ww[RHO], p[RHO];
      load_rows<RHO>(sr + row + RHO * q, rr);
      load_rows<RHO>(sk + row + RHO * q, kk);
      load_rows<RHO>(sw + row + RHO * q, ww);
      const float vj = to_f(sv[row + jv]);
#pragma unroll
      for (int a = 0; a < RHO; ++a) {
        const float kv = __fmul_rn(kk[a], vj);
        p[a] = __fmul_rn(rr[a], __fadd_rn(S[a], __fmul_rn(uu[a], kv)));
        S[a] = __fadd_rn(__fmul_rn(ww[a], S[a]), kv);
      }
      if (MASK) {
#pragma unroll
        for (int a = 0; a < RHO; ++a)
          if (RHO * q + a >= D) p[a] = 0.f;
      }
#pragma unroll
      for (int width = 1; width < RHO; width *= 2) {
#pragma unroll
        for (int a = 0; a < RHO; a += 2 * width)
          p[a] = __fadd_rn(p[a], p[a + width]);
      }
      part[g] = p[0];
    }
  }
  // Reduce-scatter over the column's lanes: at offset 2^l a lane keeps
  // half of its steps (the upper half when bit l of q is set), sends the
  // other half to lane q ^ 2^l and adds what comes back. Both partners hold
  // the same tree nodes, so each sum is the plain version's. After
  // min(log2 LANES, log2 GROUP) halvings lane q holds NV steps from
  // sigma(q) on; lanes q and q ^ GROUP (when LANES > GROUP) end equal.
  constexpr int LEV = LANES < GROUP ? ilog2(LANES) : ilog2(GROUP);
  constexpr int NV = GROUP >> LEV;
  int sigma = 0;
#pragma unroll
  for (int l = 0; l < LEV; ++l) {
    const int half = (GROUP >> l) / 2;
    const bool hi = (q >> l) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? part[i] : part[i + half];
      const float keep = hi ? part[i + half] : part[i];
      part[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 1 << l));
    }
    sigma += hi ? half : 0;
  }
#pragma unroll
  for (int off = GROUP; off < LANES; off *= 2)
    part[0] = __fadd_rn(part[0], __shfl_xor_sync(0xffffffffu, part[0], off));
  if (store && q < GROUP) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (FULL || sigma + i < cnt)
        yp[(size_t)(sigma + i) * step] = from_f<T>(part[i]);
  }
}

// This lane's rows of column j of the state, into a checkpoint (D x D,
// row-major); rows and columns at or past D are padding.
template <int RHO>
__device__ __forceinline__ void write_state(float* ck, const float (&S)[RHO],
                                            int q, int j, int D) {
  if (j >= D) return;
#pragma unroll
  for (int a = 0; a < RHO; ++a)
    if (RHO * q + a < D) ck[(size_t)(RHO * q + a) * D + j] = S[a];
}

// Block x = (b h, column block); thread = (column c, lane q), q fastest:
// lane q of column j0 + c holds rows [RHO q, RHO q + RHO).
template <int RHO, int GROUP, typename T, typename TW>
__global__ void __launch_bounds__(MAX_THREADS, 2)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out,
            float* __restrict__ ckpt, int every, int L, int H,
            int D, int cols, int col_blocks, int staged, int vec) {
  constexpr int LANES = TREE / RHO;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int q = tid % LANES, c = tid / LANES;
  const int bh = blockIdx.x / col_blocks;
  const int j0 = (blockIdx.x - bh * col_blocks) * cols;
  const int b = bh / H, h = bh - b * H;
  const int j = j0 + c;
  const int jv = j < D ? j : 0;
  const bool mask = D < TREE;

  // Shared memory: the slots (r, k, v, w of `staged` steps each), then
  // the S tile.
  const int slots = L > staged ? 2 : 1;
  const size_t per = (size_t)staged * TREE;     // elements of one operand
  const size_t slot_bytes = per * (3 * sizeof(T) + sizeof(TW));
  float* tile = reinterpret_cast<float*>(smem + slots * slot_bytes);
  const int ts = cols + 1;                    // tile row stride
  auto operand = [&](int slot, int which) {
    return smem + slot * slot_bytes + which * per * sizeof(T);
  };

  const size_t step = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;   // (b, 0, h, 0)
  const int nchunks = (L + staged - 1) / staged;
  const Share sh_t(D, sizeof(T), vec), sh_w(D, sizeof(TW), vec);
  // Copy chunk ch into slot ch & 1, one commit group.
  auto copy_chunk = [&](int ch) {
    const int slot = ch & 1, t = ch * staged, n = min(staged, L - t);
    T* dr = reinterpret_cast<T*>(operand(slot, 0));
    T* dk = reinterpret_cast<T*>(operand(slot, 1));
    T* dv = reinterpret_cast<T*>(operand(slot, 2));
    TW* dw = reinterpret_cast<TW*>(operand(slot, 3));
    stage(dr, r + base, t, n, TREE, step, vec, sh_t);
    stage(dk, k + base, t, n, TREE, step, vec, sh_t);
    stage(dv, v + base, t, n, TREE, step, vec, sh_t);
    stage(dw, w + base, t, n, TREE, step, vec, sh_w);
    cp_commit();
  };
  if (nchunks > 0) copy_chunk(0);
  if (nchunks > 1) copy_chunk(1);

  float S[RHO], uu[RHO];
#pragma unroll
  for (int a = 0; a < RHO; ++a)
    uu[a] = RHO * q + a < D ? u[(size_t)h * D + RHO * q + a] : 0.f;

  // S in: the block's columns of s0 through the tile, row-major. The
  // block's threads cover LANES rows a pass, so a thread moves RHO
  // elements, all its loads in flight before its first store.
  const size_t sbase = (size_t)bh * D * D;
  const size_t nck = ckpt != nullptr ? (L + every - 1) / every : 0;
  const int ti = tid / cols, tc = tid - ti * cols;
  const bool tj = j0 + tc < D;
  {
    float in[RHO];
#pragma unroll
    for (int a = 0; a < RHO; ++a) {
      const int i = ti + a * LANES;
      in[a] = (s0 != nullptr && i < D && tj)
                  ? s0[sbase + (size_t)i * D + j0 + tc] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RHO; ++a) tile[(ti + a * LANES) * ts + tc] = in[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RHO; ++a) S[a] = tile[(RHO * q + a) * ts + c];

  for (int ch = 0; ch < nchunks; ++ch) {
    const int slot = ch & 1, t = ch * staged, n = min(staged, L - t);
    const T* sr = reinterpret_cast<const T*>(operand(slot, 0));
    const T* sk = reinterpret_cast<const T*>(operand(slot, 1));
    const T* sv = reinterpret_cast<const T*>(operand(slot, 2));
    const TW* sw = reinterpret_cast<const TW*>(operand(slot, 3));
    if (ch + 1 < nchunks)              // this chunk's copies have landed
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();                   // ... every thread's
    for (int s = 0; s < n; s += GROUP) {
      if (ckpt != nullptr && (t + s) % every == 0)
        write_state<RHO>(ckpt + (sbase * nck + (size_t)((t + s) / every) *
                                                   D * D),
                         S, q, j, D);
      T* yp = y + base + (size_t)(t + s) * step + jv;
      const int cnt = n - s;
#define WKV6_STEPS(FULL, MASK)                                            \
  steps<RHO, LANES, GROUP, FULL, MASK>(sr, sk, sv, sw, s, cnt, S, uu, \
                                           q, jv, D, yp, step, j < D)
      if (cnt >= GROUP) {
        if (mask) WKV6_STEPS(true, true); else WKV6_STEPS(true, false);
      } else {
        if (mask) WKV6_STEPS(false, true); else WKV6_STEPS(false, false);
      }
#undef WKV6_STEPS
    }
    if (ch + 2 < nchunks) {
      __syncthreads();                 // this slot is read; refill it
      copy_chunk(ch + 2);
    }
  }

  // S out through the tile.
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RHO; ++a) tile[(RHO * q + a) * ts + c] = S[a];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RHO; ++a) {
    const int i = ti + a * LANES;
    if (i < D && tj)
      s_out[sbase + (size_t)i * D + j0 + tc] = tile[i * ts + tc];
  }
}

template <int RHO, int GROUP, typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* s_out,
           float* ckpt, int every, int B, int L, int H, int D, int cols,
           int col_blocks, int staged, cudaStream_t stream) {
  constexpr int LANES = TREE / RHO;
  const int threads = cols * LANES;
  if (threads > MAX_THREADS || threads % 32 != 0 || cols * col_blocks < D)
    return (int)cudaErrorInvalidValue;
  const int slots = L > staged ? 2 : 1;
  const size_t smem =
      (size_t)slots * staged * TREE * (3 * sizeof(T) + sizeof(TW)) +
      (size_t)TREE * (cols + 1) * sizeof(float);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  auto ok16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D * sizeof(T) % 16 == 0 && D * sizeof(TW) % 16 == 0 &&
                  ok16(r) && ok16(k) && ok16(v) && ok16(w);
  auto kern = wkv6_kernel<RHO, GROUP, T, TW>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<B * H * col_blocks, threads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w), u, s0,
      static_cast<T*>(y), s_out, ckpt, every, L, H, D, cols, col_blocks,
      staged, vec);
  return (int)cudaGetLastError();
}

// The (RHO, GROUP) kernels kernels/rwkv6_scan.py::plan chooses.
template <typename T, typename TW>
int by_plan(int rho, int group, const void* r, const void* k, const void* v,
            const void* w, const float* u, const float* s0, void* y,
            float* s_out, float* ckpt, int every, int B, int L, int H, int D,
            int cols, int col_blocks, int staged, cudaStream_t st) {
#define WKV6_PLAN(R, G)                                                    \
  if (rho == R && group == G)                                              \
    return launch<R, G, T, TW>(r, k, v, w, u, s0, y, s_out, ckpt, every,   \
                               B, L, H, D, cols, col_blocks, staged, st);
  WKV6_PLAN(4, 8) WKV6_PLAN(4, 1) WKV6_PLAN(16, 8) WKV6_PLAN(16, 1)
#undef WKV6_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. rho, group, cols, col_blocks and
// staged are kernels/rwkv6_scan.py::plan's: rho rows a lane, group steps
// reduced together, cols columns a block, col_blocks blocks per (b, h),
// staged steps a shared-memory slot. rkv_bf16: 1 when r, k, v (and y) are
// bf16, 0 for fp32; w_bf16 likewise for w. s0 may be null. ckpt null runs
// the serving mode; else the checkpoint mode writes a state every `every`
// steps (a multiple of group that divides staged when L > staged).
// Returns cudaErrorInvalidConfiguration when the staged steps do not fit
// in the device's shared memory per block, else cudaGetLastError().
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const float* u,
                                 const float* s0, void* y, float* s_out,
                                 float* ckpt, int every, int B, int L, int H,
                                 int D, int rho, int group, int cols,
                                 int col_blocks, int staged, int rkv_bf16,
                                 int w_bf16, void* stream) {
  if (D < 1 || D > TREE || staged < 1)
    return (int)cudaErrorInvalidValue;
  if (ckpt != nullptr && (every < 1 || every % group != 0 ||
                          (L > staged && staged % every != 0)))
    return (int)cudaErrorInvalidValue;
  if (B * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV6_TYPES(T, TW)                                                  \
  return by_plan<T, TW>(rho, group, r, k, v, w, u, s0, y, s_out, ckpt,      \
                        every, B, L, H, D, cols, col_blocks, staged, st)
  if (rkv_bf16 && w_bf16) WKV6_TYPES(__nv_bfloat16, __nv_bfloat16);
  if (rkv_bf16) WKV6_TYPES(__nv_bfloat16, float);
  if (w_bf16) WKV6_TYPES(float, __nv_bfloat16);
  WKV6_TYPES(float, float);
#undef WKV6_TYPES
}
