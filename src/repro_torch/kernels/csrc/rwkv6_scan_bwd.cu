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
// zero-padded), as ref._pairwise_sum. Any aligned power-of-two group of
// leaves is a subtree of it, and IEEE addition commutes exactly, so a sum
// may be cut into such groups and their partial sums added in any lane
// order. The states S_{t-1} are recomputed from the checkpoints with the
// forward's own S <- w S + k v, so they are the forward's bit for bit;
// they are never recovered by dividing by w_t, which underflows to 0 in
// fp32.
//
// What bounds it on this card: operations. 16 D^2 fp32 operations a step
// per (b, h), a multiply-add counted as two (the recomputed step, then A,
// dkv, the four products that are summed and the G update): at
// rwkv6-1.6b's training layer, (4, 128, 32, 64), 1.07 GFLOP, 16.0 us at
// 67 TFLOP/s, against 25 MB of r, k, v, dy, w in and dr, dk, dv, dw out
// (7.5 us at 3.35 TB/s; the design's checkpoints add 33.6 MB, 10.0 us).
// The order above forbids fused multiply-adds, so every multiply and add
// issues on its own: the ceiling of this arithmetic is half the table's
// rate, 32.1 us. Like the forward it is a chain of L dependent steps per
// (b, h), so the design keeps the chain in registers and every step's
// reductions inside one warp.
//
// Design (one block per (b, h): B H blocks, 128 at the training shape on
// 132 SMs; plan: rwkv6_scan.py's bwd_plan, whose cols / threads / smem the
// entry point checks against the constants below):
// - 512 threads: thread (i, q) = (tid / 8, tid % 8) holds row i, columns
//   8 q .. 8 q + 7 of G in registers; a warp holds 4 rows, 16 warps the 64
//   rows. Four warps a scheduler hide the latency of a step's shuffles
//   and shared-memory reads behind one another; the 128 registers a
//   thread may have at 512 threads hold it without a spill (16 columns a
//   thread, at 256 threads, was slower).
// - Chunks of K = 8 steps, one a checkpoint, walked last chunk first, in
//   a three-stage pipeline: while chunk n is walked, chunk n - 1's states
//   are recomputed from its checkpoint and chunk n - 2's r, k, w, v, dy and
//   checkpoint are loaded into registers. So no step waits on device
//   memory, except in the prologue, which loads the last two chunks and
//   recomputes the last.
// - The states sit in 128 KB of shared memory, K slots of the thread's own
//   QC floats (float4 a thread a slot: conflict-free, no other thread reads
//   them, so no barrier guards them). The walk frees slots K-1 ... 0, and
//   the recompute of the chunk before writes its states 0 ... K-1 into
//   them in that order: the ring runs mirrored every other chunk
//   (template FLIP), so one chunk of states fits where two would not.
// - A step's three row sums (dr, dk, dw) are trees of adjacent pairs over
//   the thread's 8 columns, then one reduce-scatter across the row's
//   lanes (lane bits 0 and 1: two shuffles, then one), after which lane
//   q % 4 = 0, 2, 1 holds the row's dr, dk, dw; one more shuffle (lane
//   bit 2) adds the row's two halves.
//   v . dy, the same for every row, is summed once a step where the chunk
//   is staged (a 32-lane butterfly over each half of the 64 leaves) and
//   its two halves added where it is read.
// - dv, a sum over i, is a reduce-scatter over the warp's 4 rows (each
//   level keeps half the columns and adds the partner row's other half),
//   left in shared memory; after the chunk's walk the 16 warps' partial
//   sums are added in a pairwise tree and written as rows of 64, with the
//   chunk's dr, dk, dw, which the walk also left in shared memory.
// - Two __syncthreads a chunk (after the walk; after the chunk's rows are
//   written and chunk n - 2 is staged), none inside a step.
// - Rows and columns at or past D are staged and loaded as zeros, so they
//   add exact zeros to every tree.
// Measured with scripts/rwkv_bwd_profile.py, the walk is issue-bound: most
// of its instructions are the arithmetic's own multiplies and adds, the
// rest the reduce-scatters' shuffles and selects and the shared-memory
// reads a step needs (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TREE = 64;             // rows and columns of a state, padded
constexpr int K = 8;                 // steps between checkpoints, a chunk
constexpr int QC = 8;                // columns a thread holds
constexpr int LPR = TREE / QC;       // lanes a row (lane bits 0-2)
constexpr int THREADS = TREE * LPR;
constexpr int WARPS = THREADS / 32;
constexpr int RW = 32 / LPR;         // rows a warp
static_assert(THREADS == K * TREE, "a thread stages one step's leaf");
constexpr int CS = QC + 4;           // floats between a step's column groups
// Shared memory, in floats: the states; two staging buffers (r k w 0 as a
// float4 per row, v and dy per column group, the halves of v . dy); the
// warps' dv partial sums; the chunk's dr, dk, dw rows.
constexpr int ST_F = K * TREE * TREE;
constexpr int RKW_F = K * TREE * 4;
constexpr int COL_F = K * LPR * CS;
constexpr int BUF_F = RKW_F + 2 * COL_F + 2 * K;
constexpr int RED_F = K * WARPS * TREE;
constexpr int OUT_S = K * TREE + 8;  // dr, dk, dw apart: 3 banks per row
constexpr int OUT_F = 3 * OUT_S;
constexpr size_t SMEM = (size_t)(ST_F + 2 * BUF_F + RED_F + OUT_F) * 4;
static_assert(BUF_F % 4 == 0 && OUT_F % 4 == 0, "float4 alignment");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float shfl(float x, int mask) {
  return __shfl_xor_sync(0xffffffffu, x, mask);
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

// One staging buffer: r k w 0 [K][TREE] as float4, v and dy [K][LPR][CS],
// vh [K] the sums of v . dy over leaves 0..31 and 32..63.
struct Buf {
  float4* rkw;
  float* v;
  float* dy;
  float2* vh;
};

// Staging buffer `parity` (chunk n stages into buffer n % 2).
__device__ __forceinline__ Buf buf_at(float* smem, int parity) {
  float* p = smem + ST_F + parity * BUF_F;
  return Buf{reinterpret_cast<float4*>(p), p + RKW_F, p + RKW_F + COL_F,
             reinterpret_cast<float2*>(p + RKW_F + 2 * COL_F)};
}

// Row i, columns c0 .. c0 + QC - 1 of a D x D fp32 matrix (null: zeros),
// zero past D; `vec` (D = 64, 16-byte aligned) loads float4s.
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

// A chunk's inputs as loaded, in their own types: thread tid's entry
// (step tid / TREE, leaf tid % TREE) of each of r, k, w, v, dy; zero past
// the sequence and past D.
template <typename T, typename TW>
struct Staged {
  T r, k, v, dy;
  TW w;
};

template <typename T, typename TW>
__device__ __forceinline__ void fetch(Staged<T, TW>& in, const T* r,
                                      const T* k, const T* v, const TW* w,
                                      const T* dy, size_t base, size_t step,
                                      int t0, int cnt, int D, int tid) {
  const int s = tid / TREE, e = tid % TREE;
  const bool ok = s < cnt && e < D;
  const size_t off = base + (size_t)(t0 + s) * step + e;
  in.r = ok ? r[off] : from_f<T>(0.f);
  in.k = ok ? k[off] : from_f<T>(0.f);
  in.v = ok ? v[off] : from_f<T>(0.f);
  in.dy = ok ? dy[off] : from_f<T>(0.f);
  in.w = ok ? w[off] : from_f<TW>(0.f);
}

// Staged entries into a buffer as fp32, and v . dy of each step: the
// warp holds 32 adjacent leaves of one step, so an xor butterfly over its
// lanes is that half's subtree.
template <typename T, typename TW>
__device__ __forceinline__ void stage(const Staged<T, TW>& in, const Buf& b,
                                      int tid) {
  const int s = tid / TREE, e = tid % TREE;
  const float vv = to_f(in.v), dd = to_f(in.dy);
  b.rkw[tid] = make_float4(to_f(in.r), to_f(in.k), to_f(in.w), 0.f);
  const int col = (s * LPR + e / QC) * CS + e % QC;
  b.v[col] = vv;
  b.dy[col] = dd;
  float x = mul(vv, dd);
#pragma unroll
  for (int m = 1; m < 32; m *= 2) x = add(x, shfl(x, m));
  if ((tid & 31) == 0) reinterpret_cast<float*>(b.vh)[2 * s + e / 32] = x;
}

// The pairwise tree of adjacent pairs over a thread's QC columns.
__device__ __forceinline__ float tree(float (&p)[QC]) {
#pragma unroll
  for (int width = 1; width < QC; width *= 2) {
#pragma unroll
    for (int a = 0; a < QC; a += 2 * width) p[a] = add(p[a], p[a + width]);
  }
  return p[0];
}

// The row's three sums over its 8 lanes as one reduce-scatter: at lane
// bit 0 the even lane keeps (dr, dk) and the odd one (dw, -), at bit 1
// each keeps one of its two, and bit 2 adds the row's two halves. Lane
// q % 4 = 0, 2, 1 returns the row's dr, dk, dw sum (3: nothing).
__device__ __forceinline__ float lanes_reduce_scatter(float xr, float xk,
                                                      float xw, int q) {
  const bool b0 = q & 1, b1 = q & 2;
  const float r0 = shfl(b0 ? xr : xw, 1);
  const float r1 = shfl(b0 ? xk : 0.f, 1);
  const float y0 = add(b0 ? xw : xr, r0);
  const float y1 = add(b0 ? 0.f : xk, r1);
  const float z = add(b1 ? y1 : y0, shfl(b1 ? y0 : y1, 2));
  return add(z, shfl(z, 4));
}

// The sum over the warp's RW rows of a thread's QC column partials, as a
// reduce-scatter: at each level the thread keeps half of its columns (the
// upper half when that bit of its row is set), sends the other half to its
// partner row and adds what comes back. Partners hold the same columns, so
// each sum is the tree of adjacent rows. Leaves p[0], p[1] = columns
// sigma, sigma + 1 of this thread's QC; returns sigma.
__device__ __forceinline__ int rows_reduce_scatter(float (&p)[QC], int i) {
  int sigma = 0;
#pragma unroll
  for (int l = 0; (1 << l) < RW; ++l) {
    const int half = (QC >> l) / 2;
    const bool hi = (i >> l) & 1;
#pragma unroll
    for (int c = 0; c < half; ++c) {
      const float send = hi ? p[c] : p[c + half];
      const float keep = hi ? p[c + half] : p[c];
      p[c] = add(keep, shfl(send, LPR << l));
    }
    sigma += hi ? half : 0;
  }
  return sigma;
}

__device__ __forceinline__ void put_state(float4* st, int slot, int tid,
                                          const float (&x)[QC]) {
#pragma unroll
  for (int a = 0; a < QC; a += 4)
    st[(slot * (QC / 4) + a / 4) * THREADS + tid] =
        make_float4(x[a], x[a + 1], x[a + 2], x[a + 3]);
}

// The forward's step S <- w_s S + k_s v_s on this thread's entries.
__device__ __forceinline__ void advance(float (&S)[QC], const Buf& b, int s,
                                        int i, int q) {
  const float4 rkw = b.rkw[s * TREE + i];
  const float* vs = b.v + (s * LPR + q) * CS;
#pragma unroll
  for (int a = 0; a < QC; a += 4) {
    const float4 x = *reinterpret_cast<const float4*>(vs + a);
    S[a] = add(mul(rkw.z, S[a]), mul(rkw.y, x.x));
    S[a + 1] = add(mul(rkw.z, S[a + 1]), mul(rkw.y, x.y));
    S[a + 2] = add(mul(rkw.z, S[a + 2]), mul(rkw.y, x.z));
    S[a + 3] = add(mul(rkw.z, S[a + 3]), mul(rkw.y, x.w));
  }
}

// Step s of the walked chunk, its state in slot `slot`: G moves back one
// step; dr, dk, dw go to `out`, dv's warp partials to `red`.
__device__ __forceinline__ void walk_step(int s, int slot, float (&G)[QC],
                                          float& dui, const float4* st,
                                          const Buf& b, float* red,
                                          float* out, int tid, int i, int q,
                                          int warp, float ui) {
  float Ss[QC], vv[QC], dd[QC];
  const float* vs = b.v + (s * LPR + q) * CS;
  const float* ds = b.dy + (s * LPR + q) * CS;
#pragma unroll
  for (int a = 0; a < QC; a += 4) {
    const float4 x = st[(slot * (QC / 4) + a / 4) * THREADS + tid];
    Ss[a] = x.x; Ss[a + 1] = x.y; Ss[a + 2] = x.z; Ss[a + 3] = x.w;
    const float4 y = *reinterpret_cast<const float4*>(vs + a);
    vv[a] = y.x; vv[a + 1] = y.y; vv[a + 2] = y.z; vv[a + 3] = y.w;
    const float4 d = *reinterpret_cast<const float4*>(ds + a);
    dd[a] = d.x; dd[a + 1] = d.y; dd[a + 2] = d.z; dd[a + 3] = d.w;
  }
  const float4 rkw = b.rkw[s * TREE + i];
  const float2 h = b.vh[s];
  const float vdy = add(h.x, h.y);
  const float ri = rkw.x, ki = rkw.y, wi = rkw.z;
  float pk[QC], pv[QC], pr[QC], pw[QC];
#pragma unroll
  for (int a = 0; a < QC; ++a) {
    const float ad = mul(ri, dd[a]);
    const float dkv = add(G[a], mul(ui, ad));
    pk[a] = mul(dkv, vv[a]);
    pv[a] = mul(ki, dkv);
    pr[a] = mul(Ss[a], dd[a]);
    pw[a] = mul(G[a], Ss[a]);
    G[a] = add(mul(wi, G[a]), ad);
  }
  const float xr = tree(pr), xk = tree(pk), xw = tree(pw);
  const float z = lanes_reduce_scatter(xr, xk, xw, q);
  // dr's lane adds the bonus term; lanes 0, 2, 1 store (a predicated
  // store, no branch).
  const float bonus = add(z, mul(mul(ui, ki), vdy));
  const int role = q & 3;
  float* dst = out + (role == 0 ? 0 : role == 2 ? OUT_S : 2 * OUT_S) +
               s * TREE + i;
  if (q < 4 && role != 3) *dst = role == 0 ? bonus : z;
  dui = add(dui, mul(mul(ri, ki), vdy));
  const int sigma = rows_reduce_scatter(pv, i);
  *reinterpret_cast<float2*>(red + (s * WARPS + warp) * TREE + QC * q +
                             sigma) = make_float2(pv[0], pv[1]);
}

// Walk one chunk backwards from its states, and recompute the chunk
// before it (from R, its checkpoint) into the slots the walk frees: after
// walk step s, that chunk's state K - 1 - s goes into slot s's place. The
// walk reads slot s (FLIP: K - 1 - s); PARTIAL skips steps s >= cnt.
// Chunk 0 too recomputes a chunk before it, which nothing reads: skipping
// that, by a template flag or a uniform guard, measured 3-4 % slower at
// the training shape (scripts/rwkv_bwd_profile.py; PERF.md), so it stays.
template <bool FLIP, bool PARTIAL>
__device__ __forceinline__ void walk_chunk(float (&G)[QC], float (&R)[QC],
                                           float& dui, float4* st,
                                           const Buf& bw, const Buf& br,
                                           float* red, float* out, int tid,
                                           int i, int q, int warp, float ui,
                                           int cnt) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const int slot = FLIP ? K - 1 - s : s;
    if (!PARTIAL || s < cnt)
      walk_step(s, slot, G, dui, st, bw, red, out, tid, i, q, warp, ui);
    put_state(st, slot, tid, R);
    if (s > 0) advance(R, br, K - 1 - s, i, q);
  }
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
  float* red = smem + ST_F + 2 * BUF_F;     // [K][WARPS][TREE]
  float* out = red + RED_F;                 // dr, dk, dw: [K][TREE] each

  const int tid = threadIdx.x, i = tid / LPR, q = tid % LPR;
  const int warp = tid / 32, c0 = QC * q;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;   // (b, 0, h, 0)
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (L + K - 1) / K;
  const float* ck = ckpt + sbase * nck;     // this (b, h)'s checkpoints
  const bool row_ok = i < D;

  float G[QC];
  load_row(ds_final == nullptr ? nullptr : ds_final + sbase, i, c0, D, vec,
           G);
  const float ui = row_ok ? u[(size_t)h * D + i] : 0.f;
  float dui = 0.f;

  if (nck > 0) {
    // Prologue: stage the last two chunks, recompute the last one's states
    // into slots 0 .. cnt - 1; R is the chunk before's checkpoint.
    const int last = nck - 1, cnt = L - last * K;
    float R[QC], CK[QC];
    {
      Staged<T, TW> in;
      fetch(in, r, k, v, w, dy, base, step, last * K, cnt, D, tid);
      stage(in, buf_at(smem, last & 1), tid);
      if (last > 0) {
        fetch(in, r, k, v, w, dy, base, step, (last - 1) * K, K, D, tid);
        stage(in, buf_at(smem, (last - 1) & 1), tid);
      }
    }
    load_row(ck + (size_t)last * D * D, i, c0, D, vec, R);
    load_row(last > 0 ? ck + (size_t)(last - 1) * D * D : nullptr, i, c0, D,
             vec, CK);
    __syncthreads();
    for (int s = 0; s < cnt; ++s) {
      put_state(st, s, tid, R);
      if (s + 1 < cnt) advance(R, buf_at(smem, last & 1), s, i, q);
    }

    for (int n = last; n >= 0; --n) {
      const int t0 = n * K, c = min(K, L - t0);
#pragma unroll
      for (int a = 0; a < QC; ++a) R[a] = CK[a];
      // Chunk n - 2's inputs and checkpoint, landing under the walk.
      Staged<T, TW> in;
      if (n >= 2) {
        fetch(in, r, k, v, w, dy, base, step, (n - 2) * K, K, D, tid);
        load_row(ck + (size_t)(n - 2) * D * D, i, c0, D, vec, CK);
      }
      const Buf bw = buf_at(smem, n & 1);
      const Buf br = buf_at(smem, (n + 1) & 1);   // chunk n - 1's
      if (c < K)
        walk_chunk<false, true>(G, R, dui, st, bw, br, red, out, tid, i, q,
                                warp, ui, c);
      else if ((last - n) & 1)
        walk_chunk<true, false>(G, R, dui, st, bw, br, red, out, tid, i, q,
                                warp, ui, c);
      else
        walk_chunk<false, false>(G, R, dui, st, bw, br, red, out, tid, i, q,
                                 warp, ui, c);
      __syncthreads();
      // The chunk's rows, thread tid at step tid / TREE, column tid % TREE:
      // dv as the warps' partial sums added in a pairwise tree over the
      // warps, and dr, dk, dw as the walk left them.
      {
        const int s = tid / TREE, j = tid % TREE;
        float p[WARPS];
#pragma unroll
        for (int x = 0; x < WARPS; ++x) p[x] = red[(s * WARPS + x) * TREE + j];
#pragma unroll
        for (int width = 1; width < WARPS; width *= 2) {
#pragma unroll
          for (int a = 0; a < WARPS; a += 2 * width)
            p[a] = add(p[a], p[a + width]);
        }
        if (s < c && j < D) {
          const size_t off = base + (size_t)(t0 + s) * step + j;
          dv[off] = from_f<T>(p[0]);
          dr[off] = from_f<T>(out[tid]);
          dk[off] = from_f<T>(out[OUT_S + tid]);
          dw[off] = from_f<TW>(out[2 * OUT_S + tid]);
        }
      }
      if (n >= 2) stage(in, bw, tid);
      __syncthreads();
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
// forward's checkpoint mode was asked for); cols, threads and smem are the
// plan's (rwkv6_scan.py's bwd_plan) and must be QC, THREADS and SMEM;
// rkv_bf16: 1 when r, k, v, dy (and dr, dk, dv) are bf16, 0 for
// fp32; w_bf16 likewise for w and dw. ds_final may be null. Returns
// cudaGetLastError() after the launch.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* ckpt, const void* dy, const float* ds_final,
    void* dr, void* dk, void* dv, void* dw, float* du, float* ds0, int B,
    int L, int H, int D, int every, int cols, int threads, int smem,
    int rkv_bf16, int w_bf16, void* stream) {
  if (D < 1 || D > TREE || every != K || L < 0 || cols != QC ||
      threads != THREADS || (size_t)smem != SMEM)
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
