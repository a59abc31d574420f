// Batched small symmetric eigensolver (parallel-order Jacobi) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/batched_eigh.py::jacobi_eigh
// (pallas_call at batched_eigh.py:154). Input a (batch, n, n) fp32
// symmetric, n <= 64; output lam (batch, n) ascending and vec (batch, n, n)
// with a ~= vec diag(lam) vec^T, the jnp.linalg.eigh convention.
//
// Algorithm, as the reference: cyclic Jacobi in the round-robin (circle)
// order, so each step applies up to n/2 disjoint rotations at once and a
// sweep is n-1 steps (odd n plays against a phantom seat, whose pairs are
// dropped); a fixed 12 sweeps. Per step, for every pair (p, q):
//   theta = atan2(2 a_pq, a_qq - a_pp) / 2, pinned to 0 where a_pq == 0
//   (converged and phantom pairs are then exact no-ops, not pi/2 swaps);
//   J = I except J_pp = J_qq = 1 + (c - 1), J_pq = s, J_qp = -s;
//   A <- J^T (A J), V <- V J, then A <- (A + A^T) / 2.
// Then the eigenvalues are sorted ascending (stable) with their columns.
//
// Design. The Pallas kernel sweeps a tile of 8 matrices in lock-step with
// one-hot GEMMs. Here one block owns one matrix: A and V live in shared
// memory (2 x 64 x 65 floats, 33 KB, padded against bank conflicts), one
// thread per pair computes the step's (c, s), then all threads rotate the
// columns of A and V, barrier, rotate the rows of A, barrier, re-pin
// symmetry, barrier. The schedule is computed in the kernel from the step
// index (seat i of step t is 1 + (i - 1 - t) mod (m - 1), m = n rounded up
// to even).
//
// What bounds it on this card. The data is tiny (n^2 floats in and out per
// matrix) and each step is a few hundred flops behind three barriers: the
// chain of 12 (n - 1) dependent steps bounds it (latency), far above both
// the byte and the FLOP bound of the batch.
#include <cuda_runtime.h>

namespace {

constexpr int MAXN = 64;
constexpr int LD = MAXN + 1;
constexpr int THREADS = 256;

__device__ __forceinline__ int seat(int i, int step, int m) {
  if (i == 0) return 0;
  const int k = ((i - 1 - step) % (m - 1) + (m - 1)) % (m - 1);
  return 1 + k;
}

__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const float* __restrict__ a_in, float* __restrict__ lam_out,
              float* __restrict__ vec_out, int n, int sweeps) {
  __shared__ float A[MAXN * LD];
  __shared__ float V[MAXN * LD];
  __shared__ int pp[MAXN / 2], qq[MAXN / 2];
  __shared__ float cc[MAXN / 2], ss[MAXN / 2];
  __shared__ float lam[MAXN];
  const size_t b = blockIdx.x;
  const float* a = a_in + b * n * n;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < n * n; idx += THREADS) {
    const int i = idx / n, j = idx % n;
    A[i * LD + j] = a[idx];
    V[i * LD + j] = (i == j) ? 1.f : 0.f;
  }
  const int m = n + (n & 1);
  const int half = m / 2;
  __syncthreads();
  for (int it = 0; it < sweeps * (m - 1); ++it) {
    const int step = it % (m - 1);
    if (tid < half) {
      const int sa = seat(tid, step, m), sb = seat(m - 1 - tid, step, m);
      if (sa < n && sb < n) {
        const int p = min(sa, sb), q = max(sa, sb);
        const float app = A[p * LD + p], aqq = A[q * LD + q];
        const float apq = A[p * LD + q];
        float theta = 0.5f * atan2f(2.f * apq, aqq - app);
        if (apq == 0.f) theta = 0.f;
        pp[tid] = p;
        qq[tid] = q;
        cc[tid] = 1.f + (cosf(theta) - 1.f);
        ss[tid] = sinf(theta);
      } else {
        pp[tid] = -1;
      }
    }
    __syncthreads();
    // columns: A <- A J and V <- V J
    for (int idx = tid; idx < half * n; idx += THREADS) {
      const int k = idx / n, i = idx % n;
      const int p = pp[k];
      if (p < 0) continue;
      const int q = qq[k];
      const float c = cc[k], s = ss[k];
      const float ap = A[i * LD + p], aq = A[i * LD + q];
      A[i * LD + p] = ap * c - aq * s;
      A[i * LD + q] = ap * s + aq * c;
      const float vp = V[i * LD + p], vq = V[i * LD + q];
      V[i * LD + p] = vp * c - vq * s;
      V[i * LD + q] = vp * s + vq * c;
    }
    __syncthreads();
    // rows: A <- J^T A
    for (int idx = tid; idx < half * n; idx += THREADS) {
      const int k = idx / n, l = idx % n;
      const int p = pp[k];
      if (p < 0) continue;
      const int q = qq[k];
      const float c = cc[k], s = ss[k];
      const float xp = A[p * LD + l], xq = A[q * LD + l];
      A[p * LD + l] = c * xp - s * xq;
      A[q * LD + l] = s * xp + c * xq;
    }
    __syncthreads();
    // re-pin symmetry
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      if (i < j) {
        const float v = 0.5f * (A[i * LD + j] + A[j * LD + i]);
        A[i * LD + j] = v;
        A[j * LD + i] = v;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += THREADS) lam[i] = A[i * LD + i];
  __syncthreads();
  // stable ascending sort: eigenpair i goes to its rank
  for (int i = tid; i < n; i += THREADS) {
    const float li = lam[i];
    int rank = 0;
    for (int j = 0; j < n; ++j)
      rank += (lam[j] < li) || (lam[j] == li && j < i);
    lam_out[b * n + rank] = li;
    float* vo = vec_out + b * n * n;
    for (int row = 0; row < n; ++row) vo[row * n + rank] = V[row * LD + i];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: a (batch, n, n) fp32, lam
// (batch, n), vec (batch, n, n); 1 <= n <= 64. Returns cudaGetLastError().
extern "C" int jacobi_eigh_launch(const float* a, float* lam, float* vec,
                                  int batch, int n, int sweeps,
                                  void* stream) {
  if (n < 1 || n > MAXN) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  jacobi_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, lam, vec, n, sweeps);
  return (int)cudaGetLastError();
}
