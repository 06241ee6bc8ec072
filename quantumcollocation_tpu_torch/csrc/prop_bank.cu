// Propagator-derivative bank of the Padé defect, batched over (instance,
// knot) pairs.
//
// Replaces: quantumcollocation_tpu/ops/pallas_prop_bank.py::_bank_kernel,
// Padé branch (the exponential branch, a Gauss-Jordan inverse and
// squarings, is not ported).
//
// For every pair m < M, with G = G_drift + sum_j a[m, j] G_drives[j] and
// X = G dt[m], the Horner recursion of the [order/2] Padé numerator
// q(sX) = sum_c coeffs[c] (sX)^c for s = +1 (N) and s = -1 (D), with its
// first and second derivatives in theta = (a_1..a_na[, dt]):
//   N, D     (M, n, n)
//   dN, dD   (M, K, n, n)     K = na (+1 with free dt)
//   d2N, d2D (M, Kp, n, n)    Kp = K(K+1)/2, pairs (k, l), k <= l, in order
// dX_k = G_k dt for a drive, G for dt; d2X is nonzero only for the pairs
// (a_k, dt), where it is G_k.  The recursion is that of
// dynamics/expm.py::pade_poly_frechet: per step, second derivatives first
// (they read the previous first derivatives and acc), then first, then acc.
//
// What bounds it: at the two-qubit sizes (n=8, K=5, fixed dt, 4,992
// pairs) it writes 10,752 bytes per pair (53.7 MB) and needs ~8.7*10^4
// flops per pair (two signs; the first Horner step only scales c I, the
// second takes 41 products of 8x8), so bytes bound it at the card's
// rates.  Design: one
// thread per matrix entry (i, j) of a pair, n*n threads per pair and
// several pairs per block; the whole state of a pair (acc, the K first and
// Kp second derivatives) sits in shared memory twice, the previous step
// and the next, so a thread reads row i of the directions and column j of
// the state and writes only its own entry.  The bank per pair (~10.7 KB at
// n=8, K=5) cannot live in one thread's registers, which is why this is
// not the one-thread-per-pair design of dyn_assembly.cu.  Each thread
// writes its entry of every output matrix: n*n neighbouring threads write
// neighbouring addresses of the batch-first outputs.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void bank_kernel(const float* __restrict__ a, const float* __restrict__ dt,
                            const float* __restrict__ Gd, const float* __restrict__ Gs,
                            const float* __restrict__ coeffs, int ncoef, int M, int na, int K,
                            int Kp, int free_dt, float* __restrict__ Nm, float* __restrict__ dN,
                            float* __restrict__ d2N, float* __restrict__ Dm,
                            float* __restrict__ dD, float* __restrict__ d2D) {
  extern __shared__ float smem[];
  constexpr int NN = N * N;
  const int Q = 1 + K + Kp;  // acc, first derivatives, second derivatives
  const int P = blockDim.x / NN;
  const int pl = threadIdx.x / NN, e = threadIdx.x % NN, i = e / N, j = e % N;
  float* Gs_s = smem;                                  // na x NN, the block's copy
  float* G = Gs_s + na * NN + pl * (NN + 2 * Q * NN);  // NN
  float* bufs[2] = {G + NN, G + NN + Q * NN};          // Q x NN each

  long m = (long)blockIdx.x * P + pl;
  const bool live = m < M;
  if (!live) m = M - 1;  // idle threads compute a copy and write nothing

  for (int idx = threadIdx.x; idx < na * NN; idx += blockDim.x) Gs_s[idx] = Gs[idx];
  __syncthreads();
  float g = Gd[e];
  for (int k = 0; k < na; ++k) g += a[m * na + k] * Gs_s[k * NN + e];
  G[e] = g;
  const float h = dt[m];

  for (int sg = 0; sg < 2; ++sg) {
    const float sgn = sg == 0 ? 1.f : -1.f;
    const float sx = sgn * h;  // X = sx G, dX_k = sx G_k (drive), sgn G (dt)
    int cur = 0;
    for (int q = 0; q < Q; ++q) bufs[0][q * NN + e] = (q == 0 && i == j) ? coeffs[ncoef - 1] : 0.f;
    __syncthreads();
    for (int ci = ncoef - 2; ci >= 0; --ci) {
      const float* old = bufs[cur];
      float* nw = bufs[cur ^ 1];
      {
        float xr[N];
#pragma unroll
        for (int k2 = 0; k2 < N; ++k2) xr[k2] = G[i * N + k2];
        const float* acc = old;
        const float* dacc = old + NN;
        const float* d2acc = old + (1 + K) * NN;
        int p = 0;
        for (int k = 0; k < K && Kp > 0; ++k) {  // second derivatives, if asked for
          const float* Rk = k < na ? Gs_s + k * NN : G;
          const float sk = k < na ? sx : sgn;
          for (int l = k; l < K; ++l, ++p) {
            const float* Rl = l < na ? Gs_s + l * NN : G;
            const float sl = l < na ? sx : sgn;
            float x2 = 0.f, ck = 0.f, cl = 0.f, ex = 0.f;
#pragma unroll
            for (int r = 0; r < N; ++r) {
              x2 += xr[r] * d2acc[p * NN + r * N + j];
              ck += Rk[i * N + r] * dacc[l * NN + r * N + j];
              cl += Rl[i * N + r] * dacc[k * NN + r * N + j];
            }
            if (free_dt && k < na && l == na) {
#pragma unroll
              for (int r = 0; r < N; ++r) ex += Rk[i * N + r] * acc[r * N + j];
            }
            nw[(1 + K + p) * NN + e] = sx * x2 + sk * ck + sl * cl + sgn * ex;
          }
        }
        for (int k = 0; k < K; ++k) {
          const float* Rk = k < na ? Gs_s + k * NN : G;
          const float sk = k < na ? sx : sgn;
          float c1 = 0.f, c2 = 0.f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            c1 += Rk[i * N + r] * acc[r * N + j];
            c2 += xr[r] * dacc[k * NN + r * N + j];
          }
          nw[(1 + k) * NN + e] = sk * c1 + sx * c2;
        }
        float c0 = 0.f;
#pragma unroll
        for (int r = 0; r < N; ++r) c0 += xr[r] * acc[r * N + j];
        nw[e] = sx * c0 + (i == j ? coeffs[ci] : 0.f);
      }
      __syncthreads();
      cur ^= 1;
    }
    if (live) {
      const float* fin = bufs[cur];
      float* o0 = sg == 0 ? Nm : Dm;
      float* o1 = sg == 0 ? dN : dD;
      float* o2 = sg == 0 ? d2N : d2D;
      o0[m * NN + e] = fin[e];
      for (int k = 0; k < K; ++k) o1[(m * K + k) * NN + e] = fin[(1 + k) * NN + e];
      for (int p = 0; p < Kp; ++p) o2[(m * Kp + p) * NN + e] = fin[(1 + K + p) * NN + e];
    }
    __syncthreads();  // the next sign reinitializes the buffers just read
  }
}

template <int N>
int launch(const float* a, const float* dt, const float* Gd, const float* Gs, const float* coeffs,
           int ncoef, int M, int na, int K, int Kp, int free_dt, float* Nm, float* dN, float* d2N,
           float* Dm, float* dD, float* d2D, cudaStream_t stream) {
  constexpr int NN = N * N;
  const int Q = 1 + K + Kp;
  // the opt-in shared memory per block, and the largest dynamic shared
  // memory set for this instantiation so far, per device (read and set
  // once, not on every launch)
  static int caps[16] = {0}, opted[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = caps[dev & 15];
  if (cap == 0) cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int fixed = na * NN * (int)sizeof(float);
  const int per_pair = (NN + 2 * Q * NN) * (int)sizeof(float);
  int P = 256 / NN > 0 ? 256 / NN : 1;  // pairs per block: >= 128 threads for n >= 4
  while (P > 1 && fixed + P * per_pair > cap) --P;
  const int smem = fixed + P * per_pair;
  if (smem > cap) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024 && smem > opted[dev & 15]) {
    cudaError_t err = cudaFuncSetAttribute(bank_kernel<N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev & 15] = smem;
  }
  const int blocks = (M + P - 1) / P;
  bank_kernel<N><<<blocks, P * NN, smem, stream>>>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp,
                                                   free_dt, Nm, dN, d2N, Dm, dD, d2D);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, na), dt (M,), Gd (n, n), Gs (na, n, n), coeffs (ncoef) on the
// device; outputs batch-first as above (d2N, d2D unused when Kp = 0).
extern "C" int qct_prop_bank(const float* a, const float* dt, const float* Gd, const float* Gs,
                             const float* coeffs, int ncoef, int M, int n, int na, int K, int Kp,
                             int free_dt, float* Nm, float* dN, float* d2N, float* Dm, float* dD,
                             float* d2D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0) return 0;
#define QCT_CASE(NN)                                                                          \
  if (n == NN)                                                                                \
    return launch<NN>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, Nm, dN, d2N, Dm, \
                      dD, d2D, st);
  QCT_CASE(2) QCT_CASE(4) QCT_CASE(6) QCT_CASE(8)
#undef QCT_CASE
  return (int)cudaErrorInvalidValue;
}
