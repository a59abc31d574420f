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
//   mode 0 (precond, project_back = 0): out = u~ (moment shape)
//   mode 1 (precond, project_back = 1): out = u~ @ B^T (right) | B @ u~ (left)
//   mode 2 (adamw):                     w' = w - lr*u - lr*wd*w, u lifted
//
// g is fp32 or bf16, read once in its own type and converted in registers
// (exactly); w fp32 or bf16 (updated in place); basis and moments fp32 (m, v
// read from one buffer and written to another, which may be the same one).
//
// What bounds it on this card. Each g element is read once and, in modes 1
// and 2, one element written; the work is r FMAs an element (2r lifted), 4
// FLOP/byte for fp32 g at r = 8: bytes bound it (PERF.md). The design keeps
// g streaming at the memory's rate and reads everything else once:
//
//   right: a warp owns R = 64 / RMAX whole rows at a time; lane l holds
//          the 8 columns 8q..8q+7 of each of them for q = l, l + 32, ...,
//          as one (bf16) or two (fp32) 16-byte pieces a row. B sits in
//          shared memory for the whole block, staged once per (block,
//          batch item) with conflict-free 16-byte stores, as [rank group
//          of 4][column in chunk][chunk] float4s, so that a lane's read of
//          B(8q + c, 4kg..4kg+3) is one conflict-free LDS.128 reused over
//          its R rows: r / R shared words a g element (1 at r = 8). The
//          lane's R x RMAX = 64 partial sums are combined by a warp
//          reduce-scatter (halving, 62 shuffles, each lane ending with two
//          (row, k) sums), Adam runs on those, and the lift reads B again
//          with u~ broadcast from the warp's shared slot. The grid is
//          persistent per batch item (plan() sizes it to the card's
//          resident slots), so B is staged once per block, not per 8 rows.
//   left:  a block takes 32 * C columns (C = 64 / RMAX a lane, as 16-byte
//          pieces) and splits M into contiguous row ranges among its 8
//          warps; B's row i is a broadcast read from shared memory ([rank
//          group][row] float4s, staged once per block). Each lane keeps its
//          C x RMAX sums in registers, the warps' partials are summed in
//          shared memory in warp order, Adam runs on (k, column), and the
//          lift walks the warp's rows again.
//
// Bytes in flight. Rows that start on 16-byte boundaries move as 16-byte
// pieces. An fp32 g loads straight into registers, R rows' pieces (right)
// or 4 rows' (left) in flight a lane. A bf16 g streams through a per-lane
// cp.async ring in shared memory instead: loaded into registers it ran at a
// third of its bound, its 8 values a piece held as floats beside the 64
// sums; through the ring the next piece is in flight while one is summed,
// with no registers held for it (an fp32 g ran slower through the ring:
// PERF.md, scripts/galore_profile.py). Other rows load one value at a time.
//
// The arithmetic order depends on (side, M, N, r) alone: a lane holds the
// same columns and rows, and sums them in the same order, whatever g's
// type or the load form, so a bf16 g and its fp32 copy give equal results,
// bit for bit. Ranks r <= RMAX run the RMAX instantiation with B
// zero-padded to whole groups of 4.
//
// A basis too large for a block's shared memory (plan(): at r = 8 past
// about 7,200 rows on the right, 5,200 on the left, as a width-8192
// model's projections) is read from global memory instead (the GB
// instantiations): the same 16-byte quads at the
// same points of the loops, served by L1 and L2, so the sums and their
// order are those of the staged form. The C entry point refuses (returns
// cudaErrorInvalidConfiguration) shared memory past the device's opt-in
// limit per block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct AdamArgs {
  float b1, omb1, b2, omb2, eps, c1, c2, lr, wd;
};

constexpr int NV = 64;        // sums a lane holds: R rows (right) or C
                              // columns (left) times RMAX
constexpr int CHUNK = 8;      // right side: columns a lane holds a row
constexpr int LEFT_WARPS = 8;
constexpr int RIGHT_THREADS = 128;
constexpr int LEFT_THREADS = LEFT_WARPS * 32;

// ---------------------------------------------------------------- I/O --

// A piece of P consecutive T, moved as one load or store of its width.
template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(const float* in, float) {
  return __float_as_uint(in[0]);
}
__device__ __forceinline__ uint32_t pack(const float* in, __nv_bfloat16) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(in[0])) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(in[1])) << 16);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Values of T a piece of C columns moves at once: 16 bytes, or all C.
template <typename T, int C>
__host__ __device__ constexpr int piece() {
  return C * (int)sizeof(T) < 16 ? C : 16 / (int)sizeof(T);
}

__device__ __forceinline__ void unpack_words(uint4 x, float* out, float t) {
  unpack(x.x, out, t);
  unpack(x.y, out + 1, t);
  unpack(x.z, out + 2, t);
  unpack(x.w, out + 3, t);
}
__device__ __forceinline__ void unpack_words(uint4 x, float* out,
                                             __nv_bfloat16 t) {
  unpack(x.x, out, t);
  unpack(x.y, out + 2, t);
  unpack(x.z, out + 4, t);
  unpack(x.w, out + 6, t);
}
__device__ __forceinline__ void unpack_words(uint2 x, float* out, float t) {
  unpack(x.x, out, t);
  unpack(x.y, out + 1, t);
}
__device__ __forceinline__ void unpack_words(uint2 x, float* out,
                                             __nv_bfloat16 t) {
  unpack(x.x, out, t);
  unpack(x.y, out + 2, t);
}
__device__ __forceinline__ void unpack_words(uint32_t x, float* out, float t) {
  unpack(x, out, t);
}
__device__ __forceinline__ void unpack_words(uint32_t x, float* out,
                                             __nv_bfloat16 t) {
  unpack(x, out, t);
}

template <typename T, int P>
__device__ __forceinline__ void load_piece(const T* p, float* out) {
  constexpr int BYTES = P * (int)sizeof(T);
  if constexpr (BYTES >= 4) {
    unpack_words(*reinterpret_cast<const typename Word<BYTES>::type*>(p),
                 out, T());
  } else {
    out[0] = to_f(p[0]);
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_piece(T* p, const float* in) {
  constexpr int BYTES = P * (int)sizeof(T);
  constexpr int E = 4 / (int)sizeof(T);     // values a 32-bit word
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(in, T()), pack(in + E, T()), pack(in + 2 * E, T()),
                   pack(in + 3 * E, T()));
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(in, T()),
                                              pack(in + E, T()));
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(p) = pack(in, T());
  } else {
    from_f(p, in[0]);
  }
}

// C consecutive values of a row from column `col` into fp32 registers;
// values past N, or of an absent row (ok false), read 0. With `vec` each
// piece of P values lies wholly inside or outside the row (N % P == 0 and
// the row 16-byte aligned, which plan() checks).
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* row, int col, int N,
                                          bool ok, bool vec, float* out) {
  constexpr int P = piece<T, C>();
  if (vec) {
#pragma unroll
    for (int p = 0; p < C / P; ++p) {
      if (ok && col + p * P < N) {
        load_piece<T, P>(row + col + p * P, out + p * P);
      } else {
#pragma unroll
        for (int e = 0; e < P; ++e) out[p * P + e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e)
      out[e] = (ok && col + e < N) ? to_f(row[col + e]) : 0.f;
  }
}

template <typename T, int C>
__device__ __forceinline__ void store_cols(T* row, int col, int N, bool vec,
                                           const float* in) {
  constexpr int P = piece<T, C>();
  if (vec) {
#pragma unroll
    for (int p = 0; p < C / P; ++p)
      if (col + p * P < N) store_piece<T, P>(row + col + p * P, in + p * P);
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e)
      if (col + e < N) from_f(row + col + e, in[e]);
  }
}

// The lifted u of C columns of one row: written (mode 1) or applied to w
// (mode 2, w fp32 or bf16 by w_bf16).
template <int C>
__device__ __forceinline__ void emit_row(float* u_out, void* w, int w_bf16,
                                         size_t off, int col, int N,
                                         bool vec, int mode, float* u,
                                         const AdamArgs& a) {
  if (mode == 1) {
    store_cols<float, C>(u_out + off, col, N, vec, u);
    return;
  }
  float wv[C];
  if (w_bf16) {
    __nv_bfloat16* wr = static_cast<__nv_bfloat16*>(w) + off;
    load_cols<__nv_bfloat16, C>(wr, col, N, true, vec, wv);
#pragma unroll
    for (int e = 0; e < C; ++e) wv[e] = wv[e] - a.lr * u[e] - a.lr * a.wd * wv[e];
    store_cols<__nv_bfloat16, C>(wr, col, N, vec, wv);
  } else {
    float* wr = static_cast<float*>(w) + off;
    load_cols<float, C>(wr, col, N, true, vec, wv);
#pragma unroll
    for (int e = 0; e < C; ++e) wv[e] = wv[e] - a.lr * u[e] - a.lr * a.wd * wv[e];
    store_cols<float, C>(wr, col, N, vec, wv);
  }
}

// Adam on one projected coordinate from its moments m0, v0; returns u~
// and writes m', v' at mi.
__device__ __forceinline__ float adam(float gt, float m0, float v0,
                                      size_t mi, float* m_out, float* v_out,
                                      const AdamArgs& a) {
  const float m = a.b1 * m0 + a.omb1 * gt;
  const float v = a.b2 * v0 + a.omb2 * gt * gt;
  m_out[mi] = m;
  v_out[mi] = v;
  return (m / a.c1) / (sqrtf(v / a.c2) + a.eps);
}

// B(j, 4kg..4kg+3) of a basis (rows, r), zero past its rows or rank: one
// 16-byte load where r % 4 == 0 (and the basis 16-byte aligned, as the
// wrapper's fresh or stacked buffers are), else four.
__device__ __forceinline__ float4 basis_quad(const float* __restrict__ bb,
                                             int j, int rows, int r, int kg) {
  if (j >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = bb + (size_t)j * r + 4 * kg;
  if ((r & 3) == 0 && (reinterpret_cast<uintptr_t>(bb) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  const int n = r - 4 * kg;
  return make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                     n > 3 ? p[3] : 0.f);
}

// acc[0..3] += x * b
__device__ __forceinline__ void fma4(float x, float4 b, float* acc) {
  acc[0] = fmaf(x, b.x, acc[0]);
  acc[1] = fmaf(x, b.y, acc[1]);
  acc[2] = fmaf(x, b.z, acc[2]);
  acc[3] = fmaf(x, b.w, acc[3]);
}

// Which g types stream through a cp.async ring in shared memory where
// rows start on 16-byte boundaries (the others load into registers): bf16
// by default, as measured fastest on either side (PERF.md); the switches
// let scripts/galore_profile.py time the other forms.
#ifndef GALORE_RING_BF16
#define GALORE_RING_BF16 1
#endif
#ifndef GALORE_RING_FP32
#define GALORE_RING_FP32 0
#endif
template <typename T>
__host__ __device__ constexpr bool ring_type() {
  return sizeof(T) == 2 ? GALORE_RING_BF16 : GALORE_RING_FP32;
}
constexpr int RING = 2;         // ring stages: one in flight while one
                                // is summed
constexpr int LEFT_ROWS = 4;    // rows a left ring stage (or load) holds

// 16 bytes global -> shared without registers; src_size 0 zero-fills.
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int src_size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- right side --

// Reduce-scatter of 2 * HALF values over a warp by halving: at each level
// a lane keeps one half (the upper where its lane bit HALF / 2 is set),
// adds its partner's copy of that half and passes on the other. Value x
// ends, summed over the 32 lanes, in v[x % 2] of lane x / 2.
template <int HALF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  const bool upper = lane & (HALF / 2);
#pragma unroll
  for (int x = 0; x < HALF; ++x) {
    const float send = upper ? v[x] : v[x + HALF];
    const float keep = upper ? v[x + HALF] : v[x];
    v[x] = keep + __shfl_xor_sync(0xffffffffu, send, HALF / 2);
  }
  if constexpr (HALF > 2) reduce_scatter<HALF / 2>(v, lane);
}

// Grid (blocks per batch item, batch); RIGHT_THREADS threads. Shared
// memory: B as KG * CHUNK * NQ float4s (none with GB: B read from global
// memory), then NV floats a warp for u~. With GB, two blocks a
// multiprocessor (the global reads' addresses need registers past the 168
// of three).
template <int RMAX, typename T, bool GB>
__global__ void __launch_bounds__(RIGHT_THREADS, GB ? 2 : 3)
right_kernel(const T* __restrict__ g, const float* __restrict__ basis,
             const float* m_in, const float* v_in, float* m_out,
             float* v_out, float* u_out, void* w, int w_bf16, int M, int N,
             int r, int mode, int vec, AdamArgs a) {
  constexpr int R = NV / RMAX;
  constexpr int KGMAX = RMAX / 4;
  constexpr int H = piece<T, CHUNK>();
  extern __shared__ float4 smem4[];
  const int KG = (r + 3) >> 2;
  const int NQ = (N + CHUNK - 1) / CHUNK;
  float4* bs = smem4;
  float* uts = reinterpret_cast<float*>(
      smem4 + (GB ? 0 : (size_t)KG * CHUNK * NQ));
  const size_t blk = blockIdx.y;
  const float* bb = basis + blk * (size_t)N * r;
  // B(q * CHUNK + c, 4kg..4kg+3): staged, or from global memory
  auto bq = [&](int q, int c, int kg) -> float4 {
    if constexpr (GB) return basis_quad(bb, q * CHUNK + c, N, r, kg);
    else return bs[(kg * CHUNK + c) * NQ + q];
  };
  if constexpr (!GB) {
    for (int q = threadIdx.x; q < NQ; q += blockDim.x) {
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
#pragma unroll
        for (int kg = 0; kg < KGMAX; ++kg)
          if (kg < KG)
            bs[(kg * CHUNK + c) * NQ + q] =
                basis_quad(bb, q * CHUNK + c, N, r, kg);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* gb = g + blk * (size_t)M * N;
  const size_t mn0 = blk * (size_t)M;
  float* my = uts + warp * NV;
  // This warp's groups of R rows: grp0, grp0 + gstride, ...
  const int groups = (M + R - 1) / R;
  const int grp0 = blockIdx.x * warps + warp, gstride = gridDim.x * warps;
  const int ngrp = grp0 < groups ? (groups - 1 - grp0) / gstride + 1 : 0;
  // The ring (bf16 g by default, rows 16-byte aligned): g streams through
  // a per-lane ring of RING stages in shared memory, a stage holding one
  // 16-byte piece of each of the R rows (cp.async, zero-filled past the
  // row's end). The lane's pieces run on from one group into the next, so
  // the next is in flight while a piece is summed and while a group's
  // sums are reduced. A lane reads back only its own slots: no barrier.
  constexpr int PIECES = CHUNK / H;       // 16-byte pieces a row's chunk
  const bool ring_on = ring_type<T>() && vec;
  const int ppg = (NQ > lane ? (NQ - lane + 31) / 32 : 0) * PIECES;
  uint4* ring = reinterpret_cast<uint4*>(uts + warps * NV) +
                (size_t)warp * RING * R * 32;
  auto fetch = [&](int u) {               // the lane's u-th piece
    int qq = NQ, col = 0, r0 = 0;
    if (u < ngrp * ppg) {
      const int gi = u / ppg, t = u - gi * ppg;
      r0 = (grp0 + gi * gstride) * R;
      qq = lane + 32 * (t / PIECES);
      col = qq * CHUNK + (t % PIECES) * H;
    }
    uint4* dst = ring + (size_t)(u % RING) * R * 32 + lane;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool ok = qq < NQ && r0 + i < M && col < N;
      cp_async16z(dst + i * 32, ok ? gb + (size_t)(r0 + i) * N + col : gb,
                  ok ? 16 : 0);
    }
    cp_async_commit();
  };
  if (ring_on)
#pragma unroll
    for (int u = 0; u < RING - 1; ++u) fetch(u);
  for (int grp = grp0, u0 = 0; grp < groups; grp += gstride, u0 += ppg) {
    const int row0 = grp * R;
    // lane l ends the reduction with (row0 + 2l / RMAX, 2l % RMAX + s),
    // s = 0, 1; with the ring their moments are read now, ahead of the
    // sums (the register form has no registers to spare for them)
    float mo[2], vo[2];
    auto read_moments = [&]() {
      const int row = row0 + (2 * lane) / RMAX, k0 = (2 * lane) % RMAX;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool ok = row < M && k0 + s < r;
        const size_t mi = (mn0 + row) * r + k0 + s;
        mo[s] = ok ? m_in[mi] : 0.f;
        vo[s] = ok ? v_in[mi] : 0.f;
      }
    };
    if (ring_on) read_moments();
    float v[NV];                 // v[i * RMAX + k]: row i, rank k
#pragma unroll
    for (int x = 0; x < NV; ++x) v[x] = 0.f;
    if (ring_on) {
      for (int t = 0; t < ppg; ++t) {
        const int u = u0 + t;
        fetch(u + RING - 1);
        cp_async_wait<RING - 1>();
        const int q = lane + 32 * (t / PIECES), h = t % PIECES;
        const uint4* src = ring + (size_t)(u % RING) * R * 32 + lane;
        float gv[R][H];
#pragma unroll
        for (int i = 0; i < R; ++i) unpack_words(src[i * 32], gv[i], T());
#pragma unroll
        for (int c = 0; c < H; ++c) {
#pragma unroll
          for (int kg = 0; kg < KGMAX; ++kg) {
            if (kg < KG) {
              const float4 b = bq(q, h * H + c, kg);
#pragma unroll
              for (int i = 0; i < R; ++i)
                fma4(gv[i][c], b, v + i * RMAX + 4 * kg);
            }
          }
        }
      }
    } else {
      for (int q = lane; q < NQ; q += 32) {
        // the chunk in steps of one 16-byte piece a row (all 8 columns
        // for bf16, 4 for fp32): the ring's order of sums
#pragma unroll
        for (int h = 0; h < PIECES; ++h) {
          float gv[R][H];
#pragma unroll
          for (int i = 0; i < R; ++i)
            load_cols<T, H>(gb + (size_t)(row0 + i) * N, q * CHUNK + h * H,
                            N, row0 + i < M, vec, gv[i]);
#pragma unroll
          for (int c = 0; c < H; ++c) {
#pragma unroll
            for (int kg = 0; kg < KGMAX; ++kg) {
              if (kg < KG) {
                const float4 b = bq(q, h * H + c, kg);
#pragma unroll
                for (int i = 0; i < R; ++i)
                  fma4(gv[i][c], b, v + i * RMAX + 4 * kg);
              }
            }
          }
        }
      }
    }
    reduce_scatter<NV / 2>(v, lane);
    if (!ring_on) read_moments();
    const int row = row0 + (2 * lane) / RMAX, k0 = (2 * lane) % RMAX;
    float ut[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      ut[s] = 0.f;
      if (row < M && k0 + s < r) {
        const size_t mi = (mn0 + row) * r + k0 + s;
        ut[s] = adam(v[s], mo[s], vo[s], mi, m_out, v_out, a);
        if (mode == 0) u_out[mi] = ut[s];
      }
    }
    if (mode == 0) continue;
    my[2 * lane] = ut[0];
    my[2 * lane + 1] = ut[1];
    __syncwarp();
    float4 ug[R][KGMAX];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int kg = 0; kg < KGMAX; ++kg)
        ug[i][kg] = reinterpret_cast<const float4*>(my)[i * KGMAX + kg];
    __syncwarp();
    for (int q = lane; q < NQ; q += 32) {
      float u[R][CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
#pragma unroll
        for (int i = 0; i < R; ++i) u[i][c] = 0.f;
#pragma unroll
        for (int kg = 0; kg < KGMAX; ++kg) {
          if (kg < KG) {
            const float4 b = bq(q, c, kg);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              u[i][c] = fmaf(ug[i][kg].x, b.x, u[i][c]);
              u[i][c] = fmaf(ug[i][kg].y, b.y, u[i][c]);
              u[i][c] = fmaf(ug[i][kg].z, b.z, u[i][c]);
              u[i][c] = fmaf(ug[i][kg].w, b.w, u[i][c]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (row0 + i < M)
          emit_row<CHUNK>(u_out, w, w_bf16, (mn0 + row0 + i) * N, q * CHUNK,
                          N, vec, mode, u[i], a);
    }
  }
  if (ring_on) cp_async_wait<0>();
}

// ----------------------------------------------------------- left side --

// Grid (column tiles of 32 * C, batch); LEFT_THREADS threads. Shared
// memory: B as KG * M float4s (none with GB: B read from global memory),
// then LEFT_WARPS * NV * 32 floats of partial sums (reused for u~).
template <int RMAX, typename T, bool GB>
__global__ void __launch_bounds__(LEFT_THREADS, 2)
left_kernel(const T* __restrict__ g, const float* __restrict__ basis,
            const float* m_in, const float* v_in, float* m_out, float* v_out,
            float* u_out, void* w, int w_bf16, int M, int N, int r,
            int mode, int vec, AdamArgs a) {
  constexpr int C = NV / RMAX;
  constexpr int KGMAX = RMAX / 4;
  constexpr int PPR = C * (int)sizeof(T) / 16;   // 16-byte pieces a row
  constexpr bool use_ring = ring_type<T>() && C * (int)sizeof(T) % 16 == 0;
  extern __shared__ float4 smem4[];
  const int KG = (r + 3) >> 2;
  float4* bs = smem4;
  float* red = reinterpret_cast<float*>(smem4 + (GB ? 0 : (size_t)KG * M));
  const size_t blk = blockIdx.y;
  const float* bb = basis + blk * (size_t)M * r;
  // B(i, 4kg..4kg+3): staged, or from global memory
  auto bq = [&](int i, int kg) -> float4 {
    if constexpr (GB) return basis_quad(bb, i, M, r, kg);
    else return bs[kg * M + i];
  };
  if constexpr (!GB) {
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
#pragma unroll
      for (int kg = 0; kg < KGMAX; ++kg)
        if (kg < KG) bs[kg * M + i] = basis_quad(bb, i, M, r, kg);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * 32 + lane) * C;
  const int per = (M + LEFT_WARPS - 1) / LEFT_WARPS;
  const int i0 = min(M, warp * per), i1 = min(M, i0 + per);
  const T* gb = g + blk * (size_t)M * N;
  float v[NV];                   // v[c * RMAX + k]: column c, rank k
#pragma unroll
  for (int x = 0; x < NV; ++x) v[x] = 0.f;
  if (use_ring && vec) {
    // g streams through a ring in the partial sums' shared memory (idle
    // until the sums land): stage t holds rows i0 + LEFT_ROWS * t, ... of
    // the warp's range, PPR 16-byte pieces a lane a row, as
    // [stage][row][piece][warp][lane]; stage t + 1 is in flight while
    // stage t is summed. A lane reads back only its own slots.
    constexpr int P = 16 / (int)sizeof(T);         // values a piece
    uint4* ring = reinterpret_cast<uint4*>(red);
    auto slot = [&](int t, int s, int p) {
      return ring + ((((t % RING) * LEFT_ROWS + s) * PPR + p) * LEFT_WARPS +
                     warp) * 32 + lane;
    };
    auto fetch = [&](int t) {
#pragma unroll
      for (int s = 0; s < LEFT_ROWS; ++s) {
        const int i = i0 + t * LEFT_ROWS + s;
#pragma unroll
        for (int p = 0; p < PPR; ++p) {
          const bool ok = i < i1 && col0 + p * P < N;
          cp_async16z(slot(t, s, p),
                      ok ? gb + (size_t)i * N + col0 + p * P : gb,
                      ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    const int stages = (i1 - i0 + LEFT_ROWS - 1) / LEFT_ROWS;
#pragma unroll
    for (int t = 0; t < RING - 1; ++t) fetch(t);
    for (int t = 0; t < stages; ++t) {
      fetch(t + RING - 1);
      cp_async_wait<RING - 1>();
#pragma unroll
      for (int s = 0; s < LEFT_ROWS; ++s) {
        const int i = i0 + t * LEFT_ROWS + s;
        if (i < i1) {
          float gv[C];
#pragma unroll
          for (int p = 0; p < PPR; ++p) unpack_words(*slot(t, s, p),
                                                     gv + p * P, T());
#pragma unroll
          for (int kg = 0; kg < KGMAX; ++kg) {
            if (kg < KG) {
              const float4 b = bq(i, kg);
#pragma unroll
              for (int c = 0; c < C; ++c)
                fma4(gv[c], b, v + c * RMAX + 4 * kg);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();              // every warp is done with the ring
  } else {
    for (int i = i0; i < i1; i += LEFT_ROWS) {
      float gv[LEFT_ROWS][C];
#pragma unroll
      for (int s = 0; s < LEFT_ROWS; ++s)
        load_cols<T, C>(gb + (size_t)(i + s) * N, col0, N, i + s < i1, vec,
                        gv[s]);
#pragma unroll
      for (int s = 0; s < LEFT_ROWS; ++s) {
        if (i + s < i1) {
#pragma unroll
          for (int kg = 0; kg < KGMAX; ++kg) {
            if (kg < KG) {
              const float4 b = bq(i + s, kg);
#pragma unroll
              for (int c = 0; c < C; ++c)
                fma4(gv[s][c], b, v + c * RMAX + 4 * kg);
            }
          }
        }
      }
    }
  }
  // Partials to shared memory as [warp][x][lane], x = c * RMAX + k.
#pragma unroll
  for (int x = 0; x < NV; ++x) red[(warp * NV + x) * 32 + lane] = v[x];
  __syncthreads();
  // Thread (warp, lane) finishes x = warp + LEFT_WARPS * j of its lane's
  // columns, summing the warps in order; u~ goes to warp 0's slot, which
  // no other thread reads before the barrier below.
  const size_t mk0 = blk * (size_t)r;
#pragma unroll
  for (int j = 0; j < NV / LEFT_WARPS; ++j) {
    const int x = warp + LEFT_WARPS * j;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < LEFT_WARPS; ++ww) s += red[(ww * NV + x) * 32 + lane];
    const int k = x % RMAX, col = col0 + x / RMAX;
    float ut = 0.f;
    if (k < r && col < N) {
      const size_t mi = (mk0 + k) * N + col;
      ut = adam(s, m_in[mi], v_in[mi], mi, m_out, v_out, a);
      if (mode == 0) u_out[mi] = ut;
    }
    red[x * 32 + lane] = ut;
  }
  if (mode == 0) return;
  __syncthreads();
  float4 ug[C][KGMAX];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kg = 0; kg < KGMAX; ++kg)
      ug[c][kg] = make_float4(red[(c * RMAX + 4 * kg) * 32 + lane],
                              red[(c * RMAX + 4 * kg + 1) * 32 + lane],
                              red[(c * RMAX + 4 * kg + 2) * 32 + lane],
                              red[(c * RMAX + 4 * kg + 3) * 32 + lane]);
  for (int i = i0; i < i1; ++i) {
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = 0.f;
#pragma unroll
    for (int kg = 0; kg < KGMAX; ++kg) {
      if (kg < KG) {
        const float4 b = bq(i, kg);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          u[c] = fmaf(b.x, ug[c][kg].x, u[c]);
          u[c] = fmaf(b.y, ug[c][kg].y, u[c]);
          u[c] = fmaf(b.z, ug[c][kg].z, u[c]);
          u[c] = fmaf(b.w, ug[c][kg].w, u[c]);
        }
      }
    }
    emit_row<C>(u_out, w, w_bf16, (blk * (size_t)M + i) * N, col0, N, vec,
                mode, u, a);
  }
}

// ------------------------------------------------------------- launch --

template <int RMAX, typename T>
cudaError_t launch(const T* g, const float* basis, const float* m_in,
                   const float* v_in, float* m_out, float* v_out,
                   float* u_out, void* w, int w_bf16, int batch, int M,
                   int N, int r, int side, int mode, int vec, int threads,
                   int blocks_x, int smem, int gbasis, const AdamArgs& a,
                   cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > limit) return cudaErrorInvalidConfiguration;
  auto kern = side == 0
      ? (gbasis ? right_kernel<RMAX, T, true> : right_kernel<RMAX, T, false>)
      : (gbasis ? left_kernel<RMAX, T, true> : left_kernel<RMAX, T, false>);
  if (threads != (side == 0 ? RIGHT_THREADS : LEFT_THREADS))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  kern<<<dim3(blocks_x, batch), threads, smem, stream>>>(
      g, basis, m_in, v_in, m_out, v_out, u_out, w, w_bf16, M, N, r, mode,
      vec, a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* g, const float* basis, const float* m_in,
             const float* v_in, float* m_out, float* v_out, float* u_out,
             void* w, int w_bf16, int batch, int M, int N, int r, int side,
             int mode, int vec, int threads, int blocks_x, int smem,
             int gbasis, const AdamArgs& a, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
#define GALORE_LAUNCH(RM)                                                   \
  return (int)launch<RM, T>(gt, basis, m_in, v_in, m_out, v_out, u_out, w, \
                            w_bf16, batch, M, N, r, side, mode, vec,        \
                            threads, blocks_x, smem, gbasis, a, st)
  if (r <= 8) GALORE_LAUNCH(8);
  if (r <= 16) GALORE_LAUNCH(16);
  if (r <= 32) GALORE_LAUNCH(32);
  GALORE_LAUNCH(64);
#undef GALORE_LAUNCH
}

}  // namespace

// Plain C entry point, loaded with ctypes. g (batch, M, N), fp32 or bf16
// (g_bf16); basis (batch, N|M, r) fp32; moments (batch, M, r) right |
// (batch, r, N) left. side: 0 right, 1 left. mode: 0 precond -> u_out in
// the moment shape, 1 precond -> u_out (batch, M, N), 2 adamw -> w (batch,
// M, N) updated in place (w_bf16: 1 for bf16, 0 for fp32). vec, threads,
// blocks_x, smem and gbasis (1: B read from global memory, not staged)
// come from kernels/galore_adamw.py::plan. 1 <= r <= 64.
// Returns cudaErrorInvalidConfiguration when the shared memory exceeds the
// device's opt-in limit per block, cudaErrorInvalidValue for an argument
// outside these, else cudaGetLastError() after the launch.
extern "C" int galore_adamw_launch(
    const void* g, const float* basis, const float* m_in, const float* v_in,
    float* m_out, float* v_out, float* u_out, void* w, int w_bf16,
    int g_bf16, int batch, int M, int N, int r, int side, int mode, int vec,
    int threads, int blocks_x, int smem, int gbasis, float b1, float omb1,
    float b2, float omb2, float eps, float c1, float c2, float lr, float wd,
    void* stream) {
  if (r < 1 || r > 64 || M < 1 || N < 1 || batch < 1 || blocks_x < 1 ||
      side < 0 || side > 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{b1, omb1, b2, omb2, eps, c1, c2, lr, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return dispatch<__nv_bfloat16>(g, basis, m_in, v_in, m_out, v_out, u_out,
                                   w, w_bf16, batch, M, N, r, side, mode, vec,
                                   threads, blocks_x, smem, gbasis, a, st);
  return dispatch<float>(g, basis, m_in, v_in, m_out, v_out, u_out, w,
                         w_bf16, batch, M, N, r, side, mode, vec, threads,
                         blocks_x, smem, gbasis, a, st);
}
