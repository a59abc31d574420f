// Batched small symmetric eigensolver (parallel-order Jacobi) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/batched_eigh.py::jacobi_eigh
// (pallas_call at batched_eigh.py:154). Input a (batch, n, n) fp32
// symmetric, n <= 64; output lam (batch, n) ascending and vec (batch, n, n)
// with a ~= vec diag(lam) vec^T, the jnp.linalg.eigh convention.
//
// Algorithm, as the reference's: cyclic Jacobi in the round-robin (circle)
// order, so each step applies n/2 disjoint rotations at once and a sweep is
// m - 1 steps (m = n rounded up to even; odd n plays against a phantom
// seat). A fixed `sweeps` sweeps, no early exit. Per step, for every pair
// (p, q), theta = atan2(2 a_pq, a_qq - a_pp) / 2, pinned to 0 where
// a_pq == 0 (converged and phantom pairs are then exact no-ops), and
// A <- J^T A J, V <- V J. Then the eigenvalues are sorted ascending
// (stable, NaN last as torch.sort) with their columns.
//
// What bounds it. The data is tiny (n^2 floats in and out per matrix) and
// the batches of the main path (384, 96 and 192 matrices of 8 x 8) fit one
// wave many times over: the time is the chain of sweeps * (m - 1)
// dependent steps (84 at n = 8), each a rotation computed from the last
// step's pivots and applied to the whole matrix, and the instructions one
// warp issues for it. The design shortens each link of that chain:
// - (c, s) without trigonometry: with x = a_qq - a_pp, y = 2 a_pq, scaled
//   by a power of two to dodge under- and overflow, rho = |(x, y)| from one
//   refined rsqrt, g = (1 + |x| / rho) / 2, and two square roots of g from a
//   second one. For x >= 0, c = sqrt(g) and s = sign(y) |y| / (2 rho c);
//   for x < 0 the two swap (c >= 0, s with y's sign): the reference's
//   branch of atan2 in exact arithmetic, with none of its cancellations.
// - Route `warp` (m <= WARP_MAX_M): A and V in registers, 4 warps a block,
//   one per scheduler; what a lane needs from another arrives by
//   __shfl_sync, so the sweep has no shared memory and no barrier. The
//   round-robin pairs are compile-time constants (m is a template
//   parameter, a sweep is unrolled), so every register index is static.
//   Two layouts:
//   - pairs (m = 8, the main path): one warp a matrix, a lane for each
//     (column j, pair slot g) holding entries (p_g, j), (q_g, j) of A and
//     two rows of V. Every lane computes its row pair's and its column's
//     rotation, updates its two entries from the partner column's two,
//     shuffles in the next step's six pivots straight from the lanes
//     that just computed them (so the next rotation need not wait for the
//     rows to move) and takes the next step's rows from those lanes.
//   - columns (the rest of m <= 16, and m = 8 for batches past
//     batched_eigh.PAIR_MAX_BATCH = 528, one warp a scheduler, where its
//     4 matrices a warp win): a lane owns a column of A
//     and of V, several matrices a warp below 32 lanes; a step picks the
//     lane's pivots by selects on its index, shuffles in its partner's
//     diagonal, computes its pair's rotation, takes every pair's rotation
//     from the pairs' p lanes and the partner column of A and V.
// - A stays exactly symmetric by construction instead of being re-pinned:
//   A'_ij = RN(RN(P1 X + P4 W) + RN(RN(P2 Y) + RN(P3 Z))) with the products
//   P of the row's and the column's (alpha, beta) and X, Y, Z, W the
//   entries at (i, j), (i, j'), (i', j), (i', j'). The lane computing A'_ji
//   meets the same four products and values with Y and Z (and P2, P3)
//   swapped, and the sum of two rounded terms commutes, so the two lanes
//   write the same bits.
// - Route `block` (larger n, up to 64): one block of several warps owns a
//   matrix in shared memory, A double-buffered. One thread per 2 x 2 block
//   {p_k, q_k} x {p_l, q_l} (k <= l) rotates it in place of the reference's
//   column and row passes and writes it and its mirror; threads own V's
//   rows of a pair; the pair threads recompute the next step's three pivot
//   entries the same way and its rotation. One barrier a step; the seat
//   arithmetic needs no runtime division.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int MAXN = 64;
constexpr int WARP_MAX_M = 16;     // the largest m the warp route is built for
constexpr int PAIR_M = 8;          // the warp route's pair layout: m = 8
constexpr int WARPS = 4;           // warp route: warps a block
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------- schedule --
// The circle method on m (even) seats: seat 0 keeps player 0; after each
// step the player in seat s >= 1 moves to seat s + 1, and the one in seat
// m - 1 to seat 1. Step t pairs seat k with seat m - 1 - k. The same
// arithmetic as ref.round_robin_pairs, with a conditional subtract where a
// modulo would be (no division).

__host__ __device__ constexpr int rr_player(int seat, int t, int m) {
  return seat == 0 ? 0
                   : 1 + (seat - 1 - t < 0 ? seat - 1 - t + m - 1
                                           : seat - 1 - t);
}

__host__ __device__ constexpr int rr_seat(int j, int t, int m) {
  return j == 0 ? 0 : 1 + (j - 1 + t >= m - 1 ? j - 1 + t - (m - 1)
                                               : j - 1 + t);
}

__host__ __device__ constexpr int rr_partner(int j, int t, int m) {
  return rr_player(m - 1 - rr_seat(j, t, m), t, m);
}

__host__ __device__ constexpr int rr_p(int k, int t, int m) {
  return rr_player(k, t, m) < rr_player(m - 1 - k, t, m)
             ? rr_player(k, t, m) : rr_player(m - 1 - k, t, m);
}

__host__ __device__ constexpr int rr_q(int k, int t, int m) {
  return rr_player(k, t, m) < rr_player(m - 1 - k, t, m)
             ? rr_player(m - 1 - k, t, m) : rr_player(k, t, m);
}

// ------------------------------------------------------------- rotation --

// 1 / sqrt(v) for the normal v of `rotation` (x^2 + y^2 in [1, 8) once
// scaled, g in [1/2, 1]): the hardware estimate, then one Newton step.
__device__ __forceinline__ float rsqrt_nr(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return fmaf(r, fmaf(-0.5f * v * r, r, 0.5f), r);
}

// (c, s) of theta = atan2(2 apq, aqq - app) / 2; (1, 0) where apq == 0.
__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float& c, float& s) {
  const float x = aqq - app, y = 2.f * apq;
  const float big_xy = fmaxf(fabsf(x), fabsf(y));
  const int e = min((__float_as_int(big_xy) >> 23) & 0xff, 253);
  const float f = __int_as_float((254 - e) << 23);       // 2^-exponent
  const float xs = x * f, ys = y * f;
  const float ir = rsqrt_nr(fmaf(xs, xs, ys * ys));      // 1 / rho
  const float g = fmaf(0.5f, fabsf(xs * ir), 0.5f);
  const float rg = rsqrt_nr(g);
  const float big = g * rg, small = 0.5f * fabsf(ys * ir) * rg;
  const bool inner = x >= 0.f;
  c = inner ? big : small;
  s = copysignf(inner ? small : big, y);
  if (apq == 0.f) {
    c = 1.f;
    s = 0.f;
  }
}

// One entry of J^T A J from the products P of its row's and column's
// coefficients, summed so that (i, j) and (j, i) round alike.
__device__ __forceinline__ float sym(float p1, float p2, float p3, float p4,
                                     float x, float y, float z, float w) {
  return __fadd_rn(fmaf(p1, x, __fmul_rn(p4, w)),
                   __fadd_rn(__fmul_rn(p2, y), __fmul_rn(p3, z)));
}

// NaN-last stable order: does (x, i) sort before (y, j)?
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool nx = x != x, ny = y != y;
  if (nx || ny) return (!nx && ny) || (nx && ny && i < j);
  return x < y || (x == y && i < j);
}

// --------------------------------------------- warp route, column layout --

// a[idx] by a tree of selects on idx's bits (static register indices).
template <int M>
__device__ __forceinline__ float pick(const float (&a)[M], int idx) {
  float t[M];
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = a[i];
#pragma unroll
  for (int w = 1; w < M; w <<= 1) {
    const bool hi = idx & w;
#pragma unroll
    for (int i = 0; i + w < M; i += 2 * w) t[i] = hi ? t[i + w] : t[i];
  }
  return t[0];
}

// Rows p_K and q_K of column j: the pair's rotation (ck, sk) on the rows,
// the lane's own (ac, bc) = (J[j][j], J[j'][j]) on the columns.
template <int M, int T, int K>
__device__ __forceinline__ void update_pair(float (&a)[M],
                                            const float (&ap)[M], float ck,
                                            float sk, float ac, float bc) {
  constexpr int p = rr_p(K, T, M), q = rr_q(K, T, M);
  const float m1 = ck * ac, m2 = ck * bc, m3 = sk * ac, m4 = sk * bc;
  const float xp = a[p], xq = a[q];
  // row p: (alpha, beta) = (c, -s); row q: (c, s)
  a[p] = sym(m1, m2, -m3, -m4, xp, ap[p], xq, ap[q]);
  a[q] = sym(m1, m2, m3, m4, xq, ap[q], xp, ap[p]);
}

template <int M, int T, int... K>
__device__ __forceinline__ void update_pairs(
    float (&a)[M], const float (&ap)[M], const float (&ck)[M / 2],
    const float (&sk)[M / 2], float ac, float bc,
    std::integer_sequence<int, K...>) {
  (update_pair<M, T, K>(a, ap, ck[K], sk[K], ac, bc), ...);
}

template <int M, int T>
__device__ __forceinline__ void warp_step(float (&a)[M], float (&v)[M],
                                          int j, int base) {
  const int jp = j < M ? rr_partner(j, T, M) : j;   // spare lanes: no pair
  const bool lo = j < jp;
  const float d = pick<M>(a, j), o = pick<M>(a, jp);
  const float dq = __shfl_sync(FULL, d, base + jp);
  float c, s;
  rotation(lo ? d : dq, lo ? dq : d, o, c, s);
  if (j == jp) {
    c = 1.f;
    s = 0.f;
  }
  // every pair's rotation from its p lane, this lane's own from the same
  float ck[M / 2], sk[M / 2];
#pragma unroll
  for (int k = 0; k < M / 2; ++k) {
    ck[k] = __shfl_sync(FULL, c, base + rr_p(k, T, M));
    sk[k] = __shfl_sync(FULL, s, base + rr_p(k, T, M));
  }
  const int own = lo ? j : jp;
  const float ac = __shfl_sync(FULL, c, base + own);
  const float as = __shfl_sync(FULL, s, base + own);
  const float bc = lo ? -as : as;
  float ap[M], vp[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    ap[i] = __shfl_sync(FULL, a[i], base + jp);
    vp[i] = __shfl_sync(FULL, v[i], base + jp);
  }
  update_pairs<M, T>(a, ap, ck, sk, ac, bc,
                     std::make_integer_sequence<int, M / 2>{});
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = fmaf(ac, v[i], bc * vp[i]);
}

template <int M, int... T>
__device__ __forceinline__ void warp_sweep(float (&a)[M], float (&v)[M],
                                           int j, int base,
                                           std::integer_sequence<int, T...>) {
  (warp_step<M, T>(a, v, j, base), ...);
}

// Lanes of a matrix: 1 << lg (>= M); matrices a warp: 32 >> lg.
template <int M>
__global__ void __launch_bounds__(WARPS * 32)
jacobi_warp_kernel(const float* __restrict__ a_in, float* __restrict__ lam,
                   float* __restrict__ vec, int batch, int n, int sweeps,
                   int lg) {
  const int lane = threadIdx.x & 31;
  const int j = lane & ((1 << lg) - 1);
  const int base = lane - j;
  const long long b =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          (32 >> lg) +
      (lane >> lg);
  const bool col = b < batch && j < n;
  const float* in = a_in + b * n * n;
  float a[M], v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    a[i] = (col && i < n) ? 0.5f * (in[i * n + j] + in[j * n + i]) : 0.f;
    v[i] = i == j ? 1.f : 0.f;
  }
  for (int sw = 0; sw < sweeps; ++sw)
    warp_sweep<M>(a, v, j, base, std::make_integer_sequence<int, M - 1>{});
  const float d = pick<M>(a, j);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float di = __shfl_sync(FULL, d, base + i);
    rank += (i < n && before(di, i, d, j)) ? 1 : 0;
  }
  if (!col) return;
  lam[b * n + rank] = d;
  float* out = vec + b * n * n + rank;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < n) out[i * n] = v[i];
}

// --------------------------------------- warp route, pair layout, m = 8 --
// One warp a matrix, one lane for each (column j, pair slot g): lane
// g * m + j. At every step the lane holds rows p_g and q_g of column j of A
// (x0, x1) and rows g and g + m / 2 of column j of V: 4 floats. It computes
// the rotation of its row pair g and of its column's pair (three pivots
// each), updates its two entries from the partner column's two (two
// shuffles), shuffles in the next step's pivots from the lanes that
// updated them, and fetches the two rows its slot pairs at the next step.
// Every source lane of a step is packed into one 64-bit register per step
// when the kernel starts.

constexpr int SRC_BITS = 5;

// Pair index (seat k < m / 2) of player i at step t.
__host__ __device__ constexpr int pair_of(int i, int t, int m) {
  return rr_seat(i, t, m) < m - 1 - rr_seat(i, t, m) ? rr_seat(i, t, m)
                                                     : m - 1 - rr_seat(i, t, m);
}

// What lane (j, g) needs at step t, tn = t + 1 (mod m - 1), as lanes of
// the warp: [0], [1], [2] where step tn's row-pair pivots lie once step t
// has updated: a_pp, a_qq with the lanes holding p's and q's diagonal,
// a_qp with the lane of column p holding row q; [3], [4], [5] the same
// for the pair of column j at tn; [6] the partner column's lane at slot
// g; [7], [8] the lanes that computed rows p_g and q_g of step tn. Bit
// 45: j is its pair's p at t; 46, 47: the next rows come from the q slot
// of their lanes; 48: this lane's q slot holds its column's diagonal;
// 49: its q slot holds the row that pairs with column j at tn.
__device__ __forceinline__ unsigned long long pair_sources(int j, int g,
                                                           int t, int m) {
  const int tn = t + 1 == m - 1 ? 0 : t + 1;
  const int q = rr_q(g, t, m);
  const int k = pair_of(j, t, m), pk = rr_p(k, t, m), qk = rr_q(k, t, m);
  const int jp = j == pk ? qk : pk;
  const int pn = rr_p(g, tn, m), qn = rr_q(g, tn, m);
  const int kn = pair_of(j, tn, m);
  const int pkn = rr_p(kn, tn, m), qkn = rr_q(kn, tn, m);
  const int f[9] = {pair_of(pn, t, m) * m + pn, pair_of(qn, t, m) * m + qn,
                    pair_of(qn, t, m) * m + pn,
                    pair_of(pkn, t, m) * m + pkn,
                    pair_of(qkn, t, m) * m + qkn,
                    pair_of(qkn, t, m) * m + pkn, g * m + jp,
                    pair_of(pn, t, m) * m + j, pair_of(qn, t, m) * m + j};
  unsigned long long w = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) w |= (unsigned long long)f[i] << (SRC_BITS * i);
  w |= (unsigned long long)(j == pk) << 45;
  w |= (unsigned long long)(pn != rr_p(pair_of(pn, t, m), t, m)) << 46;
  w |= (unsigned long long)(qn != rr_p(pair_of(qn, t, m), t, m)) << 47;
  w |= (unsigned long long)(j == q) << 48;
  w |= (unsigned long long)(rr_partner(j, tn, m) == q) << 49;
  return w;
}

__device__ __forceinline__ int field(unsigned long long w, int i) {
  return int(w >> (SRC_BITS * i)) & ((1 << SRC_BITS) - 1);
}

__device__ __forceinline__ bool bit(unsigned long long w, int i) {
  return (w >> i) & 1;
}

// The three pivots (a_pp, a_qq, a_qp) of a rotation.
struct Pivots {
  float pp, qq, qp;
};

template <int M, int T>
__device__ __forceinline__ void pair_step(float& x0, float& x1, float& v0,
                                          float& v1, Pivots& row,
                                          Pivots& colp,
                                          unsigned long long w) {
  float cr, sr, cc, sc;
  rotation(row.pp, row.qq, row.qp, cr, sr);
  rotation(colp.pp, colp.qq, colp.qp, cc, sc);
  const float ac = cc, bc = bit(w, 45) ? -sc : sc;       // J[j][j], J[j'][j]
  const int lj = field(w, 6);
  const float y0 = __shfl_sync(FULL, x0, lj), y1 = __shfl_sync(FULL, x1, lj);
  const float m1 = cr * ac, m2 = cr * bc, m3 = sr * ac, m4 = sr * bc;
  // row p: (alpha, beta) = (c, -s); row q: (c, s)
  const float n0 = sym(m1, m2, -m3, -m4, x0, y0, x1, y1);
  const float n1 = sym(m1, m2, m3, m4, x1, y1, x0, y0);
  // the next step's pivots, straight from the lanes that computed them
  const float diag = bit(w, 48) ? n1 : n0, pair = bit(w, 49) ? n1 : n0;
  row = {__shfl_sync(FULL, diag, field(w, 0)),
         __shfl_sync(FULL, diag, field(w, 1)),
         __shfl_sync(FULL, pair, field(w, 2))};
  colp = {__shfl_sync(FULL, diag, field(w, 3)),
          __shfl_sync(FULL, diag, field(w, 4)),
          __shfl_sync(FULL, pair, field(w, 5))};
  const float w0 = __shfl_sync(FULL, v0, lj), w1 = __shfl_sync(FULL, v1, lj);
  v0 = fmaf(ac, v0, bc * w0);
  v1 = fmaf(ac, v1, bc * w1);
  const int l0 = field(w, 7), l1 = field(w, 8);
  const float a0 = __shfl_sync(FULL, n0, l0), b0 = __shfl_sync(FULL, n1, l0);
  const float a1 = __shfl_sync(FULL, n0, l1), b1 = __shfl_sync(FULL, n1, l1);
  x0 = bit(w, 46) ? b0 : a0;
  x1 = bit(w, 47) ? b1 : a1;
}

template <int M, int... T>
__device__ __forceinline__ void pair_sweep(
    float& x0, float& x1, float& v0, float& v1, Pivots& row, Pivots& colp,
    const unsigned long long (&w)[M - 1], std::integer_sequence<int, T...>) {
  (pair_step<M, T>(x0, x1, v0, v1, row, colp, w[T]), ...);
}

template <int M>
__global__ void __launch_bounds__(WARPS * 32)
jacobi_pair_kernel(const float* __restrict__ a_in, float* __restrict__ lam,
                   float* __restrict__ vec, int batch, int n, int sweeps) {
  constexpr int H = M / 2;
  static_assert(M * H == 32, "one matrix a warp");
  const int lane = threadIdx.x & 31;
  const int g = lane / M, j = lane - g * M;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  const bool live = b < batch;
  const float* in = a_in + b * n * n;
  const int r0 = g, r1 = M - 1 - g;          // rows p_g, q_g of step 0
  auto entry = [&](int r) {
    return (live && r < n && j < n) ? 0.5f * (in[r * n + j] + in[j * n + r])
                                    : 0.f;
  };
  float x0 = entry(r0), x1 = entry(r1);      // in flight while w is packed
  unsigned long long w[M - 1];
#pragma unroll
  for (int t = 0; t < M - 1; ++t) w[t] = pair_sources(j, g, t, M);
  float v0 = g == j ? 1.f : 0.f, v1 = g + H == j ? 1.f : 0.f;
  // step 0's pivots: pair k = (k, m - 1 - k) in slot k's lanes
  const int k = j < H ? j : M - 1 - j;
  Pivots row = {__shfl_sync(FULL, x0, g * M + g),
                __shfl_sync(FULL, x1, g * M + r1),
                __shfl_sync(FULL, x1, g * M + g)};
  Pivots colp = {__shfl_sync(FULL, x0, k * M + k),
                 __shfl_sync(FULL, x1, k * M + M - 1 - k),
                 __shfl_sync(FULL, x1, k * M + k)};
  for (int sw = 0; sw < sweeps; ++sw)
    pair_sweep<M>(x0, x1, v0, v1, row, colp, w,
                  std::make_integer_sequence<int, M - 1>{});
  // back in step 0's slots: A[i][i] is slot 0 of lane (i, i) for i < m / 2,
  // slot 1 of lane (i, m - 1 - i) above
  float d[M];
#pragma unroll
  for (int i = 0; i < M; ++i)
    d[i] = i < H ? __shfl_sync(FULL, x0, i * M + i)
                 : __shfl_sync(FULL, x1, (M - 1 - i) * M + i);
  const float dj = pick<M>(d, j);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
    rank += (i < n && before(d[i], i, dj, j)) ? 1 : 0;
  if (!live || j >= n) return;
  if (g == 0) lam[b * n + rank] = dj;
  float* out = vec + b * n * n + rank;
  if (g < n) out[g * n] = v0;
  if (g + H < n) out[(g + H) * n] = v1;
}

// ----------------------------------------------------------- block route --

// The 2 x 2 block rows {p, q} (rotation ck, sk) x columns {pl, ql} (cl, sl)
// of J^T A J: columns first, then rows, as the reference; a diagonal block
// (same pair) has its off-diagonal pair averaged, the reference's re-pin.
__device__ __forceinline__ void rotate_block(const float* A, int ld, int p,
                                             int q, float ck, float sk,
                                             int pl, int ql, float cl,
                                             float sl, bool diag,
                                             float (&o)[4]) {
  const float b00 = A[p * ld + pl], b01 = A[p * ld + ql];
  const float b10 = A[q * ld + pl], b11 = A[q * ld + ql];
  const float t00 = __fadd_rn(__fmul_rn(b00, cl), -__fmul_rn(b01, sl));
  const float t01 = __fadd_rn(__fmul_rn(b00, sl), __fmul_rn(b01, cl));
  const float t10 = __fadd_rn(__fmul_rn(b10, cl), -__fmul_rn(b11, sl));
  const float t11 = __fadd_rn(__fmul_rn(b10, sl), __fmul_rn(b11, cl));
  o[0] = __fadd_rn(__fmul_rn(ck, t00), -__fmul_rn(sk, t10));
  o[1] = __fadd_rn(__fmul_rn(ck, t01), -__fmul_rn(sk, t11));
  o[2] = __fadd_rn(__fmul_rn(sk, t00), __fmul_rn(ck, t10));
  o[3] = __fadd_rn(__fmul_rn(sk, t01), __fmul_rn(ck, t11));
  if (diag) o[1] = o[2] = __fmul_rn(0.5f, __fadd_rn(o[1], o[2]));
}

// Entry (i, j) of the next A, exactly as the thread of its block writes it.
__device__ __forceinline__ float next_entry(const float* A, int ld, int i,
                                            int j, int t, int m,
                                            const float* C, const float* S) {
  int ki = pair_of(i, t, m), kj = pair_of(j, t, m);
  if (ki > kj) {
    const int x = i; i = j; j = x;
    const int y = ki; ki = kj; kj = y;
  }
  const int p = rr_p(ki, t, m), q = rr_q(ki, t, m);
  const int pl = rr_p(kj, t, m), ql = rr_q(kj, t, m);
  float o[4];
  rotate_block(A, ld, p, q, C[ki], S[ki], pl, ql, C[kj], S[kj], ki == kj, o);
  return i == p ? (j == pl ? o[0] : o[1]) : (j == pl ? o[2] : o[3]);
}

// blockDim (32, warps): x over columns or rows, y over pairs.
__global__ void __launch_bounds__(256)
jacobi_block_kernel(const float* __restrict__ a_in, float* __restrict__ lam,
                    float* __restrict__ vec, int n, int sweeps) {
  extern __shared__ float sm[];
  const int m = n + (n & 1), half = m >> 1, ld = m + 1;
  float* A0 = sm;
  float* A1 = A0 + m * ld;
  float* V = A1 + m * ld;
  float* C = V + m * ld;            // [2][MAXN / 2]
  float* S = C + MAXN;              // [2][MAXN / 2]
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int tid = ty * 32 + tx, nthreads = 32 * ny;
  const size_t b = blockIdx.x;
  const float* in = a_in + b * n * n;
  for (int i = ty; i < m; i += ny)
    for (int k = tx; k < m; k += 32) {
      A0[i * ld + k] = (i < n && k < n)
                           ? 0.5f * (in[i * n + k] + in[k * n + i]) : 0.f;
      V[i * ld + k] = i == k ? 1.f : 0.f;
    }
  __syncthreads();
  for (int k = tid; k < half; k += nthreads) {
    const int p = rr_p(k, 0, m), q = rr_q(k, 0, m);
    rotation(A0[p * ld + p], A0[q * ld + q], A0[p * ld + q], C[k], S[k]);
  }
  __syncthreads();
  const int total = sweeps * (m - 1);
  int t = 0;
  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    const float* Ac = cur ? A1 : A0;
    float* An = cur ? A0 : A1;
    const float* Cc = C + cur * (MAXN / 2);
    const float* Sc = S + cur * (MAXN / 2);
    for (int k = ty; k < half; k += ny) {
      const int p = rr_p(k, t, m), q = rr_q(k, t, m);
      for (int l = k + tx; l < half; l += 32) {
        const int pl = rr_p(l, t, m), ql = rr_q(l, t, m);
        float o[4];
        rotate_block(Ac, ld, p, q, Cc[k], Sc[k], pl, ql, Cc[l], Sc[l],
                     k == l, o);
        An[p * ld + pl] = o[0];
        An[p * ld + ql] = o[1];
        An[q * ld + pl] = o[2];
        An[q * ld + ql] = o[3];
        An[pl * ld + p] = o[0];
        An[ql * ld + p] = o[1];
        An[pl * ld + q] = o[2];
        An[ql * ld + q] = o[3];
      }
      const float c = Cc[k], s = Sc[k];
      for (int r = tx; r < m; r += 32) {
        const float vp = V[r * ld + p], vq = V[r * ld + q];
        V[r * ld + p] = __fadd_rn(__fmul_rn(vp, c), -__fmul_rn(vq, s));
        V[r * ld + q] = __fadd_rn(__fmul_rn(vp, s), __fmul_rn(vq, c));
      }
    }
    const int tn = t + 1 == m - 1 ? 0 : t + 1;
    if (it + 1 < total) {
      float* Cn = C + (cur ^ 1) * (MAXN / 2);
      float* Sn = S + (cur ^ 1) * (MAXN / 2);
      for (int k = tid; k < half; k += nthreads) {
        const int p = rr_p(k, tn, m), q = rr_q(k, tn, m);
        rotation(next_entry(Ac, ld, p, p, t, m, Cc, Sc),
                 next_entry(Ac, ld, q, q, t, m, Cc, Sc),
                 next_entry(Ac, ld, p, q, t, m, Cc, Sc), Cn[k], Sn[k]);
      }
    }
    __syncthreads();
    t = tn;
  }
  const float* Af = (total & 1) ? A1 : A0;
  for (int i = tid; i < n; i += nthreads) {
    const float di = Af[i * ld + i];
    int rank = 0;
    for (int k = 0; k < n; ++k)
      rank += before(Af[k * ld + k], k, di, i) ? 1 : 0;
    lam[b * n + rank] = di;
    float* out = vec + b * n * n + rank;
    for (int r = 0; r < n; ++r) out[r * n] = V[r * ld + i];
  }
}

template <int M>
cudaError_t launch_columns(const float* a, float* lam, float* vec, int batch,
                           int n, int sweeps, int lanes, int warps,
                           cudaStream_t stream) {
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  if ((1 << lg) != lanes || lanes < M || lanes > 32)
    return cudaErrorInvalidValue;
  const int per_block = warps * (32 >> lg);
  jacobi_warp_kernel<M>
      <<<(batch + per_block - 1) / per_block, warps * 32, 0, stream>>>(
          a, lam, vec, batch, n, sweeps, lg);
  return cudaGetLastError();
}

template <int... H>
cudaError_t dispatch_columns(std::integer_sequence<int, H...>, const float* a,
                             float* lam, float* vec, int batch, int n,
                             int sweeps, int lanes, int warps,
                             cudaStream_t stream) {
  const int m = n + (n & 1);
  cudaError_t err = cudaErrorInvalidValue;
  ((m == 2 * (H + 1)
        ? (err = launch_columns<2 * (H + 1)>(a, lam, vec, batch, n, sweeps,
                                             lanes, warps, stream), 0)
        : 0), ...);
  return err;
}

}  // namespace

// Plain C entry point, loaded with ctypes: a (batch, n, n) fp32, lam
// (batch, n), vec (batch, n, n); 1 <= n <= 64; `warps` a block. route 0:
// `warp` in the column layout (n rounded up to even m <= WARP_MAX_M,
// `lanes` a matrix, a power of two >= m and <= 32, warps <= WARPS); route
// 2: `warp` in the pair layout (m == PAIR_M, 32 lanes a matrix, warps <=
// WARPS); route 1: `block` (warps <= 8). Returns cudaGetLastError().
extern "C" int jacobi_eigh_launch(const float* a, float* lam, float* vec,
                                  int batch, int n, int sweeps, int route,
                                  int lanes, int warps, void* stream) {
  if (n < 1 || n > MAXN || sweeps < 0 || warps < 1 || warps > 8)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n + (n & 1);
  if (route == 0) {
    if (m > WARP_MAX_M || warps > WARPS) return (int)cudaErrorInvalidValue;
    return (int)dispatch_columns(
        std::make_integer_sequence<int, WARP_MAX_M / 2>{}, a, lam, vec, batch,
        n, sweeps, lanes, warps, st);
  }
  if (route == 2) {
    constexpr int S = PAIR_M * PAIR_M / 2;
    if (m != PAIR_M || lanes != S || warps > WARPS)
      return (int)cudaErrorInvalidValue;
    jacobi_pair_kernel<PAIR_M>
        <<<(batch + warps - 1) / warps, warps * 32, 0, st>>>(a, lam, vec,
                                                             batch, n, sweeps);
    return (int)cudaGetLastError();
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  const int smem = (3 * m * (m + 1) + 2 * MAXN) * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (3 * MAXN * (MAXN + 1) + 2 * MAXN) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  jacobi_block_kernel<<<batch, dim3(32, warps), smem, st>>>(a, lam, vec, n,
                                                           sweeps);
  return (int)cudaGetLastError();
}
