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
// tile) program; an SM has 227 KB of shared memory, so here the work is
// passes chosen per call (lowrank_tiles.cuh has them in full):
//   tc_decode (bf16, rows < 64: decode, t = 1, 8 rows). W (2-170 MB) moves
//     for ~2*8*m*n FLOPs, so bytes bound it. W's columns are the wgmma M
//     side and the 8 rows the N side (swap-AB, zero-filled to 16 by TMA);
//     W streams through a 6-stage TMA ring in blocks of 128 columns x a K
//     chunk, K split so that the blocks fill the card's resident slots in
//     one wave; each block also computes one K piece of the shrink for
//     all rows; a reduce pass sums the fp32 partials in a fixed order and
//     applies the epilogue.
//   tc_gemm (bf16, rows >= 64: prefill, 100-1024 rows). 2*rows*m*n FLOPs
//     bound it at the bf16 tensor-core rate: a warp-specialised TMA +
//     wgmma GEMM over the flattened rows (the rows of different sequences
//     share each W tile), the shrink in its own pass (32-row blocks inside
//     one sequence, so one S_g a block), and a fused epilogue in which each
//     row reads its own g (a tile may span two sequences at t = 100).
//   fp32 (any fp32 operand, m or n not a multiple of 8, a base pointer not
//     16-byte aligned, r > 64): FP32-core tiles, exact fp32 products.
//
// The passes live in lowrank_tiles.cuh, shared with lowrank_linear.cu.
#include "lowrank_tiles.cuh"

// Plain C entry point, loaded with ctypes. side: 0 right, 1 left. x_bf16 /
// w_bf16: 1 for bf16, 0 for fp32; y is bf16 iff both are. route: 0 fp32,
// 1 tc_gemm, 2 tc_decode, with the plan of kernels/lowrank_linear.py::plan
// (bm, ksplit, k_chunk, pieces, piece). `s` holds Plan.s_slots*rows*r
// floats, `partial` ksplit*rows*n floats when the route needs them. Returns
// cudaGetLastError() after the launches, or 10000 + the CUresult of
// cuTensorMapEncodeTiled if a TMA descriptor could not be encoded.
extern "C" int lowrank_linear_batched_launch(
    const void* x, const void* w, const float* bases, const float* rts,
    const float* scales, const int* ids, void* y, float* s, float* partial,
    int rows, int t, int m, int n, int r, int G, int side, int x_bf16,
    int w_bf16, int route, int bm, int ksplit, int k_chunk, int pieces,
    int piece, void* stream) {
  Call c{};
  if (side == 0) {   // right: S = rts (G, m, r), E = bases (G, n, r)^T
    c.stab = rts;
    c.e = Expand{bases, (long long)n * r, 1, r};
  } else {           // left: S = bases (G, m, r), E = rts (G, r, n)
    c.stab = bases;
    c.e = Expand{rts, (long long)r * n, n, 1};
  }
  c.x = x; c.w = w; c.scales = scales; c.ids = ids; c.y = y; c.s = s;
  c.partial = partial; c.rows = rows; c.t = t; c.m = m; c.n = n; c.r = r;
  c.G = G; c.bm = bm; c.ksplit = ksplit; c.k_chunk = k_chunk;
  c.pieces = pieces; c.piece = piece;
  c.stream = static_cast<cudaStream_t>(stream);
  return dispatch(c, route, x_bf16, w_bf16);
}
