// Batched heterogeneous-adapter low-rank linear apply for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lowrank_linear.py::
// lowrank_linear_batched (pallas_call at lowrank_linear.py:175). For every
// flattened row of x (B*t rows, row i belongs to sequence i / t):
//
//   g = ids[i / t]
//   right side (m >= n): y[i] = scales[g]*(x[i] @ W) + (x[i] @ rts[g]) @ bases[g]^T
//   left side  (m <  n): y[i] = scales[g]*(x[i] @ W) + (x[i] @ bases[g]) @ rts[g]
//
// x (rows, m) and W (m, n) are fp32 or bf16; the tables (G, ., r), scales
// (G,) are fp32; ids (B,) int32. Accumulation is fp32 throughout; y is bf16
// when x and W are both bf16, else fp32 (torch.result_type). Ragged ranks
// arrive zero-padded, duplicate ids are allowed, t needs no divisibility.
//
// Design. The Pallas kernel keeps all of W resident in VMEM for each (row,
// tile) program; an SM has 227 KB, so here the work is three passes:
//   1. shrink:  s[i, :] = x[i] @ S_g, S_g = rts[g] (right) | bases[g] (left),
//      both (m, r): one block per row, an fp32 scratch of (rows, r).
//   2. base GEMM over (row tile, column tile) of the flattened rows, so the
//      rows of different sequences share each W tile: x and W tiles staged
//      in shared memory as fp32, FMA into registers (64x64 tile, 4x4 per
//      thread). When there are too few output tiles to fill the card
//      (decode), K is split across blocks into an fp32 partial buffer.
//   3. epilogue, fused into 2 when K is not split, else its own pass that
//      sums the K partials: each row reads its own g and writes
//      scales[g]*acc + s[i, :] @ E_g[:, col], E_g = bases[g]^T (right, a
//      strided read) | rts[g] (left).
//
// What bounds it on this card. Decode (t = 1, 8 rows) moves W (2-6 MB in
// bf16) plus the gathered tables and does ~2*8*m*n FLOPs: bytes bound it,
// and the K split is what keeps enough blocks in flight to stream W at
// rate. Prefill (1024 rows) does 2*rows*m*n FLOPs against the same bytes:
// the base GEMM's FLOPs bound it, at the bf16 tensor-core rate. This first
// version multiplies on the FP32 cores (no mma/wgmma, no TMA), so prefill
// runs far from that bound; tensor-core tiles are later work.
//
// The passes live in lowrank_tiles.cuh, shared with lowrank_linear.cu.
#include "lowrank_tiles.cuh"

// Plain C entry point, loaded with ctypes. side: 0 right, 1 left. x_bf16 /
// w_bf16: 1 for bf16, 0 for fp32; y is bf16 iff both are. `partial` holds
// ksplit*rows*n floats when ksplit > 1 (else unused); k_chunk is a multiple
// of the K tile. Returns cudaGetLastError() after the launches.
extern "C" int lowrank_linear_batched_launch(
    const void* x, const void* w, const float* bases, const float* rts,
    const float* scales, const int* ids, void* y, float* s, float* partial,
    int rows, int t, int m, int n, int r, int G, int side, int x_bf16,
    int w_bf16, int ksplit, int k_chunk, void* stream) {
  Expand e;
  const float* stab;
  if (side == 0) {   // right: S = rts (G, m, r), E = bases (G, n, r)^T
    stab = rts;
    e = Expand{bases, (long long)n * r, 1, r};
  } else {           // left: S = bases (G, m, r), E = rts (G, r, n)
    stab = bases;
    e = Expand{rts, (long long)r * n, n, 1};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return (int)launch<bf16, bf16, bf16>(x, w, stab, scales, ids, e, y, s,
                                         partial, rows, t, m, n, r, G, ksplit,
                                         k_chunk, st);
  if (x_bf16)
    return (int)launch<bf16, float, float>(x, w, stab, scales, ids, e, y, s,
                                           partial, rows, t, m, n, r, G,
                                           ksplit, k_chunk, st);
  if (w_bf16)
    return (int)launch<float, bf16, float>(x, w, stab, scales, ids, e, y, s,
                                           partial, rows, t, m, n, r, G,
                                           ksplit, k_chunk, st);
  return (int)launch<float, float, float>(x, w, stab, scales, ids, e, y, s,
                                          partial, rows, t, m, n, r, G,
                                          ksplit, k_chunk, st);
}
