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
// are, else fp32. The rank-r shrink lands in an fp32 (rows, r) scratch and
// the tiled base GEMM applies scale and the rank-r expand in its epilogue,
// so the lifted m x n weight scale*W + lift(rt) never exists.
//
// The passes are those of the batched serving apply (lowrank_tiles.cuh) with
// one adapter and no ids: G = 1, every row reads entry 0.
//
// What bounds it on this card. A training forward has rows = 4 x 128 = 512
// and m, n of 1024 and 2816: 2*rows*m*n FLOPs against ~2*(m*n + rows*(m+n))
// bytes, far above the ~295 FLOP/byte ridge, so the base GEMM's FLOPs bound
// it at the bf16 tensor-core rate. This first version multiplies on the FP32
// cores (no mma/wgmma, no TMA) and runs far from that bound; tensor-core
// tiles are later work.
#include "lowrank_tiles.cuh"

// Plain C entry point, loaded with ctypes. side: 0 right, 1 left. x_bf16 /
// w_bf16: 1 for bf16, 0 for fp32. `scale` points at one fp32 value on the
// device. `partial` holds ksplit*rows*n floats when ksplit > 1 (else
// unused). Returns cudaGetLastError() after the launches.
extern "C" int lowrank_linear_launch(
    const void* x, const void* w, const float* basis, const float* rt,
    const float* scale, void* y, float* s, float* partial, int rows, int m,
    int n, int r, int side, int x_bf16, int w_bf16, int ksplit, int k_chunk,
    void* stream) {
  Expand e;
  const float* stab;
  if (side == 0) {   // right: S = rt (m, r), E = basis (n, r)^T
    stab = rt;
    e = Expand{basis, 0, 1, r};
  } else {           // left: S = basis (m, r), E = rt (r, n)
    stab = basis;
    e = Expand{rt, 0, n, 1};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int* no_ids = nullptr;
  if (x_bf16 && w_bf16)
    return (int)launch<bf16, bf16, bf16>(x, w, stab, scale, no_ids, e, y, s,
                                         partial, rows, 1, m, n, r, 1, ksplit,
                                         k_chunk, st);
  if (x_bf16)
    return (int)launch<bf16, float, float>(x, w, stab, scale, no_ids, e, y, s,
                                           partial, rows, 1, m, n, r, 1,
                                           ksplit, k_chunk, st);
  if (w_bf16)
    return (int)launch<float, bf16, float>(x, w, stab, scale, no_ids, e, y, s,
                                           partial, rows, 1, m, n, r, 1,
                                           ksplit, k_chunk, st);
  return (int)launch<float, float, float>(x, w, stab, scale, no_ids, e, y, s,
                                          partial, rows, 1, m, n, r, 1,
                                          ksplit, k_chunk, st);
}
