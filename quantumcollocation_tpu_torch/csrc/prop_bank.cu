// Propagator-derivative bank, batched over (instance, knot) pairs.
//
// Replaces: quantumcollocation_tpu/ops/pallas_prop_bank.py::_bank_kernel,
// Padé branch (bank_kernel) and exponential branch (exp_bank_kernel).
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
//
// Exponential branch: P = exp(X) with its first and second derivatives by
// scaling and squaring, as dynamics/expm.py::expm_frechet_bank.  The
// generators are scaled by 2^-nsq in shared memory (exact), both Horner
// signs of q run as above and are kept (N and D families), then D is
// inverted by Gauss-Jordan without pivoting (the scaled denominator is
// diagonally dominant): each thread holds its entry of the working matrix
// and of the inverse in registers and publishes both to shared memory once
// per column, one barrier after publishing and one after the update.  Then
// P = D^-1 N, dP_k = D^-1 (dN_k - dD_k P), d2P likewise (each numerator in
// place of the N family, a barrier, then the product with D^-1 into a third
// buffer), and nsq squarings double-buffered between that buffer and the
// freed N buffer.  Only the P family is written: 1 + K + Kp matrices per
// pair.  At n=8, K=5 a pair holds three (1 + K + Kp) x n x n buffers plus
// four n x n matrices, 17,152 bytes, so four pairs per block need the
// opt-in to more than 48 KB of dynamic shared memory.  What bounds it: at
// n=8, K=5 with two squarings it needs ~5.5*10^5 flops per pair (six
// times the Padé branch: the solves and squarings) and writes 5,376 bytes
// (half the Padé bytes), so operations bound it at the card's rates.

#include <cuda_runtime.h>

namespace {

// One sign of the Horner recursion of q(sgn X), X = h G, with first and
// second theta-derivatives, in a pair's two Q x NN buffers b0 and b1 (Q = 1
// + K + Kp: acc, first, second derivatives); returns the buffer with the
// result.  Every thread of the block calls it (it holds barriers).
template <int N>
__device__ __forceinline__ float* horner(float* b0, float* b1, const float* G,
                                         const float* Gs_s, const float* coeffs, int ncoef,
                                         float sgn, float h, int na, int K, int Kp, int free_dt,
                                         int i, int j, int e) {
  constexpr int NN = N * N;
  const int Q = 1 + K + Kp;
  float* bufs[2] = {b0, b1};
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
  return bufs[cur];
}

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
    const float* fin = horner<N>(bufs[0], bufs[1], G, Gs_s, coeffs, ncoef, sg == 0 ? 1.f : -1.f,
                                 h, na, K, Kp, free_dt, i, j, e);
    if (live) {
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
__global__ void exp_bank_kernel(const float* __restrict__ a, const float* __restrict__ dt,
                                const float* __restrict__ Gd, const float* __restrict__ Gs,
                                const float* __restrict__ coeffs, int ncoef, int M, int na, int K,
                                int Kp, int free_dt, int nsq, float* __restrict__ Pm,
                                float* __restrict__ dP, float* __restrict__ d2P) {
  extern __shared__ float smem[];
  constexpr int NN = N * N;
  const int Q = 1 + K + Kp;
  const int P = blockDim.x / NN;
  const int pl = threadIdx.x / NN, e = threadIdx.x % NN, i = e / N, j = e % N;
  float* Gs_s = smem;                                  // na x NN, scaled by 2^-nsq
  float* G = Gs_s + na * NN + pl * (4 * NN + 3 * Q * NN);
  float* Di = G + NN;                                  // D^-1
  float* Mp = Di + NN;                                 // Gauss-Jordan: published entries
  float* Rp = Mp + NN;
  float* b0 = Rp + NN;                                 // three Q x NN buffers
  float* b1 = b0 + Q * NN;
  float* b2 = b1 + Q * NN;

  long m = (long)blockIdx.x * P + pl;
  const bool live = m < M;
  if (!live) m = M - 1;  // idle threads compute a copy and write nothing

  const float scale = ldexpf(1.f, -nsq);
  for (int idx = threadIdx.x; idx < na * NN; idx += blockDim.x) Gs_s[idx] = Gs[idx] * scale;
  __syncthreads();
  float g = Gd[e] * scale;
  for (int k = 0; k < na; ++k) g += a[m * na + k] * Gs_s[k * NN + e];
  G[e] = g;
  const float h = dt[m];

  float* Nb = horner<N>(b0, b1, G, Gs_s, coeffs, ncoef, 1.f, h, na, K, Kp, free_dt, i, j, e);
  float* other = Nb == b0 ? b1 : b0;
  const float* Db = horner<N>(other, b2, G, Gs_s, coeffs, ncoef, -1.f, h, na, K, Kp, free_dt, i,
                              j, e);
  float* W = Db == other ? b2 : other;  // the free buffer: the P family goes here

  // D^-1: thread (i, j) holds its entries of the working matrix and of the
  // inverse; per column c: publish, barrier, normalise row c / eliminate,
  // barrier
  float mw = Db[e], rw = (i == j) ? 1.f : 0.f;
  for (int c = 0; c < N; ++c) {
    Mp[e] = mw;
    Rp[e] = rw;
    __syncthreads();
    const float inv = 1.f / Mp[c * N + c];
    const float mc = Mp[c * N + j] * inv, rc = Rp[c * N + j] * inv;
    if (i == c) {
      mw = mc;
      rw = rc;
    } else {
      const float f = Mp[i * N + c];
      mw -= f * mc;
      rw -= f * rc;
    }
    __syncthreads();
  }
  Di[e] = rw;
  __syncthreads();

  const float* dD = Db + NN;
  const float* d2D = Db + (1 + K) * NN;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) acc += Di[i * N + r] * Nb[r * N + j];
  W[e] = acc;  // P = D^-1 N
  __syncthreads();
  for (int k = 0; k < K; ++k) {  // numerators dN_k - dD_k P, in place of dN_k
    float t = Nb[(1 + k) * NN + e];
#pragma unroll
    for (int r = 0; r < N; ++r) t -= dD[k * NN + i * N + r] * W[r * N + j];
    Nb[(1 + k) * NN + e] = t;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {  // dP_k = D^-1 (dN_k - dD_k P)
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r) t += Di[i * N + r] * Nb[(1 + k) * NN + r * N + j];
    W[(1 + k) * NN + e] = t;
  }
  __syncthreads();
  if (Kp > 0) {
    int p = 0;
    for (int k = 0; k < K; ++k)
      for (int l = k; l < K; ++l, ++p) {  // d2N_p - d2D_p P - dD_k dP_l - dD_l dP_k
        float t = Nb[(1 + K + p) * NN + e];
#pragma unroll
        for (int r = 0; r < N; ++r)
          t -= d2D[p * NN + i * N + r] * W[r * N + j] +
               dD[k * NN + i * N + r] * W[(1 + l) * NN + r * N + j] +
               dD[l * NN + i * N + r] * W[(1 + k) * NN + r * N + j];
        Nb[(1 + K + p) * NN + e] = t;
      }
    __syncthreads();
    for (int q = 0; q < Kp; ++q) {  // d2P_p = D^-1 (...)
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r) t += Di[i * N + r] * Nb[(1 + K + q) * NN + r * N + j];
      W[(1 + K + q) * NN + e] = t;
    }
    __syncthreads();
  }

  // squarings: every new entry reads the old P family only
  float* cur = W;
  float* nxt = Nb;
  for (int sq = 0; sq < nsq; ++sq) {
    const float* Po = cur;
    const float* dPo = cur + NN;
    const float* d2Po = cur + (1 + K) * NN;
    if (Kp > 0) {
      int p = 0;
      for (int k = 0; k < K; ++k)
        for (int l = k; l < K; ++l, ++p) {
          float t = 0.f;
#pragma unroll
          for (int r = 0; r < N; ++r)
            t += d2Po[p * NN + i * N + r] * Po[r * N + j] + Po[i * N + r] * d2Po[p * NN + r * N + j] +
                 dPo[k * NN + i * N + r] * dPo[l * NN + r * N + j] +
                 dPo[l * NN + i * N + r] * dPo[k * NN + r * N + j];
          nxt[(1 + K + p) * NN + e] = t;
        }
    }
    for (int k = 0; k < K; ++k) {
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r)
        t += dPo[k * NN + i * N + r] * Po[r * N + j] + Po[i * N + r] * dPo[k * NN + r * N + j];
      nxt[(1 + k) * NN + e] = t;
    }
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r) t += Po[i * N + r] * Po[r * N + j];
    nxt[e] = t;
    __syncthreads();
    float* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  if (live) {
    Pm[m * NN + e] = cur[e];
    for (int k = 0; k < K; ++k) dP[(m * K + k) * NN + e] = cur[(1 + k) * NN + e];
    for (int p = 0; p < Kp; ++p) d2P[(m * Kp + p) * NN + e] = cur[(1 + K + p) * NN + e];
  }
}

// Pairs per block from the opt-in shared memory, the opt-in itself where
// the block needs more than 48 KB, and the launch.  Padé outputs: N, dN,
// d2N, D, dD, d2D; exponential: P, dP, d2P in the first three.
template <int N, bool EXP>
int launch(const float* a, const float* dt, const float* Gd, const float* Gs, const float* coeffs,
           int ncoef, int M, int na, int K, int Kp, int free_dt, int nsq, float* o0, float* o1,
           float* o2, float* o3, float* o4, float* o5, cudaStream_t stream) {
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
  const int per_pair = (EXP ? 4 * NN + 3 * Q * NN : NN + 2 * Q * NN) * (int)sizeof(float);
  int P = 256 / NN > 0 ? 256 / NN : 1;  // pairs per block: >= 128 threads for n >= 4
  while (P > 1 && fixed + P * per_pair > cap) --P;
  const int smem = fixed + P * per_pair;
  if (smem > cap) return (int)cudaErrorInvalidConfiguration;
  const void* kernel = EXP ? (const void*)exp_bank_kernel<N> : (const void*)bank_kernel<N>;
  if (smem > 48 * 1024 && smem > opted[dev & 15]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev & 15] = smem;
  }
  const int blocks = (M + P - 1) / P;
  if constexpr (EXP)
    exp_bank_kernel<N><<<blocks, P * NN, smem, stream>>>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K,
                                                         Kp, free_dt, nsq, o0, o1, o2);
  else
    bank_kernel<N><<<blocks, P * NN, smem, stream>>>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp,
                                                     free_dt, o0, o1, o2, o3, o4, o5);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, na), dt (M,), Gd (n, n), Gs (na, n, n), coeffs (ncoef) on the
// device; outputs batch-first as above (the second-order ones unused when
// Kp = 0; o3..o5 unused for exp_kind = 1, whose nsq squarings follow the
// Padé step).
extern "C" int qct_prop_bank(const float* a, const float* dt, const float* Gd, const float* Gs,
                             const float* coeffs, int ncoef, int M, int n, int na, int K, int Kp,
                             int free_dt, int exp_kind, int nsq, float* o0, float* o1, float* o2,
                             float* o3, float* o4, float* o5, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0) return 0;
#define QCT_CASE(NN)                                                                             \
  if (n == NN)                                                                                   \
    return exp_kind ? launch<NN, true>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, nsq, \
                                       o0, o1, o2, o3, o4, o5, st)                               \
                    : launch<NN, false>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, 0,  \
                                        o0, o1, o2, o3, o4, o5, st);
  QCT_CASE(2) QCT_CASE(4) QCT_CASE(6) QCT_CASE(8)
#undef QCT_CASE
  return (int)cudaErrorInvalidValue;
}
