// Lift-free low-rank linear apply for Hopper (sm_90a): the factored client's
// weight read in the FedGaLore local step.
//
// Replaces the TPU kernel repro/kernels/lowrank_linear.py::lowrank_linear
// (pallas_call at lowrank_linear.py:101). For x (rows, m), rows = batch*seq:
//
//   right side (m >= n; basis (n, r), rt (m, r)):
//       y = scale*(x @ W) + (x @ rt) @ basis^T
//   left side  (m <  n; basis (m, r), rt (r, n)):
//       y = scale*(x @ W) + (x @ basis) @ rt
//
// x and W are fp32 or bf16, basis and rt fp32, scale one fp32 value read on
// the device (no host sync); fp32 accumulation; y is bf16 when x and W both
// are, else fp32. The rank-r shrink lands in an fp32 scratch and the tiled
// base GEMM applies scale and the rank-r expand in its epilogue, so the
// lifted m x n weight scale*W + lift(rt) never exists.
//
// The routes and passes are those of the batched serving apply
// (lowrank_tiles.cuh) with one adapter and no ids: G = 1, every row reads
// entry 0, and the rows form one sequence (t = rows).
//
// What bounds it on this card. A training forward has rows = 4 x 128 = 512
// and m, n of 1024 and 2816: 2*rows*m*n FLOPs against ~2*(m*n + rows*(m+n))
// bytes, far above the ~295 FLOP/byte ridge, so the base GEMM's FLOPs bound
// it at the bf16 tensor-core rate. bf16 x and W take the tc_gemm route of
// lowrank_tiles.cuh: TMA stages, wgmma m64n128k16 with fp32 accumulation,
// the shrink in its own pass and the epilogue fused. At 512 rows the
// output tiles alone leave half the SMs idle (8 x 8 tiles of 64 x 128 at
// n = 1024), and the K of 1024-2816 is too short to pay for a split, so
// each tile's fixed cost (the first copies, the epilogue's staging and
// store) sets much of its time; the epilogue's rank-r delta is computed
// while the ring fills to keep that cost down. fp32 or odd-shaped
// operands take the fp32 route (FP32-core tiles, exact products).
#include "lowrank_tiles.cuh"

// Plain C entry point, loaded with ctypes. side: 0 right, 1 left. x_bf16 /
// w_bf16: 1 for bf16, 0 for fp32. `scale` points at one fp32 value on the
// device. route: 0 fp32, 1 tc_gemm, 2 tc_decode, with the plan of
// kernels/lowrank_linear.py::plan (bm, ksplit, k_chunk, pieces, piece).
// `s` holds Plan.s_slots*rows*r floats, `partial` ksplit*rows*n floats
// when the route needs them. Returns cudaGetLastError() after the
// launches, or 10000 + the CUresult of cuTensorMapEncodeTiled if a TMA
// descriptor could not be encoded.
extern "C" int lowrank_linear_launch(
    const void* x, const void* w, const float* basis, const float* rt,
    const float* scale, void* y, float* s, float* partial, int rows, int m,
    int n, int r, int side, int x_bf16, int w_bf16, int route, int bm,
    int ksplit, int k_chunk, int pieces, int piece, void* stream) {
  Call c{};
  if (side == 0) {   // right: S = rt (m, r), E = basis (n, r)^T
    c.stab = rt;
    c.e = Expand{basis, 0, 1, r};
  } else {           // left: S = basis (m, r), E = rt (r, n)
    c.stab = basis;
    c.e = Expand{rt, 0, n, 1};
  }
  c.x = x; c.w = w; c.scales = scale; c.ids = nullptr; c.y = y; c.s = s;
  c.partial = partial; c.rows = rows; c.t = rows; c.m = m; c.n = n; c.r = r;
  c.G = 1; c.bm = bm; c.ksplit = ksplit; c.k_chunk = k_chunk;
  c.pieces = pieces; c.piece = piece;
  c.stream = static_cast<cudaStream_t>(stream);
  return dispatch(c, route, x_bf16, w_bf16);
}
