// Fused dynamics assembly for the batched interior-point solver.
//
// Replaces: quantumcollocation_tpu/ops/pallas_dyn_assembly.py::_assembly_kernel
// (with its bank helper _group_bank), Padé and exponential branches.
//
// Computes, for every (instance b, knot t < T-1) pair of a SCALED decision
// tensor Z (B, T, d) and multipliers lam (B, T-1, s):
//   F  (B, T-1, s)      defects
//   A  (B, T-1, s, d)   dF/dz_t
//   Bm (B, T-1, s, d)   dF/dz_{t+1}
//   Hc (B, T, d, d)     curvature of -lam.F in z_t (last knot zero)
//   Cc (B, T-1, d, d)   curvature coupling (z_t, z_{t+1})
// from the Padé bank N = q(X), D = q(-X), X = G(a) dt, with first and second
// derivatives in theta = (a, dt), plus derivative rows x' - x - dx dt and
// dt-equality rows.  Variable and defect scales are folded into the writes.
// Padé groups (EXP = false) give the implicit defect D u' - N u.  Exponential
// groups (EXP = true) give u' - P u with P = exp(X) by scaling and squaring:
// the table carries the generators already scaled by 2^-nsq, so the same
// Horner code gives the scaled N and D; then P = D^-1 N (Gauss-Jordan
// without pivoting, the scaled denominator being diagonally dominant), its
// derivatives dP_k = D^-1 (dN_k - dD_k P) and d2P, and nsq squarings, all
// in place of the N family.  That branch has B = I and no Cc term; its
// bank takes about three times the Padé flops (~3*10^4 a pair at n=4, K=3,
// one squaring), still below the writes at the card's rates, so bytes
// bound it too.  Both branches spill to local memory at n=4, K=3.
//
// What bounds it: bytes.  Per pair it reads 2d + s floats and writes
// s + 2sd + 2d^2 floats (853 at d=15, s=13); the bank is ~10^4 flops on
// 4x4 matrices held in registers.  Design: one thread per pair, so
// B*(T-1) threads fill the card; the bank lives in registers/local memory
// and is computed once; each thread writes its own contiguous output rows
// in the batch-first layout the solver consumes (no transpose pass after).
// The n x n size and the number K of theta directions are template
// parameters; the problem structure comes in as an argument table, so a new
// problem needs no rebuild.
//
// Argument table (int ispec, float fspec), walked in order:
//   ispec: ng, nderiv, ndteq,
//          per group: n, na, a0, dt_col (-1 = static), nsq (0 for Padé),
//                     nmembers, nmembers x (u0, u1, r0, r1, ncols)
//          per derivative row: x0, x1, dx0, dx1, r0, r1, dt_col
//          per dt-equality row: c0, c1, r0, r1
//   fspec: var_scale (d), defect_scale (s),
//          per group: dt_static, ncoef, coeffs (ncoef), G_drift (n*n),
//                     G_drives (na*n*n) (both times 2^-nsq)
//          per derivative row: dt_static

#include <cuda_runtime.h>

namespace {

template <int N>
__device__ inline void mm_acc(float sgn, const float (&X)[N][N], const float (&Y)[N][N],
                              float (&out)[N][N]) {
  // out += sgn * X @ Y
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) acc += X[i][k] * Y[k][j];
      out[i][j] += sgn * acc;
    }
}

// Horner recursion for q(sign*X) with first and second theta-derivatives.
// d2X is nonzero only for pairs (k, na) with k < na (free dt): Gs[k].
template <int N, int K>
__device__ void horner(float sgn, const float* coeffs, int ncoef, const float (&X)[N][N],
                       const float (&dX)[K][N][N], const float* Gs, int na, bool free_dt,
                       float (&acc)[N][N], float (&dacc)[K][N][N],
                       float (&d2acc)[K * (K + 1) / 2][N][N]) {
  constexpr int KP = K * (K + 1) / 2;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      acc[i][j] = (i == j) ? coeffs[ncoef - 1] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dacc[k][i][j] = 0.f;
#pragma unroll
      for (int p = 0; p < KP; ++p) d2acc[p][i][j] = 0.f;
    }
  for (int ci = ncoef - 2; ci >= 0; --ci) {
    // second derivatives first: they read the previous dacc and acc
    {
      int p = 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int l = k; l < K; ++l, ++p) {
          float nw[N][N];
#pragma unroll
          for (int i = 0; i < N; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) nw[i][j] = 0.f;
          mm_acc<N>(sgn, X, d2acc[p], nw);
          mm_acc<N>(sgn, dX[k], dacc[l], nw);
          mm_acc<N>(sgn, dX[l], dacc[k], nw);
          if (free_dt && k < na && l == na) {
            float g[N][N];
#pragma unroll
            for (int i = 0; i < N; ++i)
#pragma unroll
              for (int j = 0; j < N; ++j) g[i][j] = Gs[(k * N + i) * N + j];
            mm_acc<N>(sgn, g, acc, nw);
          }
#pragma unroll
          for (int i = 0; i < N; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) d2acc[p][i][j] = nw[i][j];
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float nw[N][N];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) nw[i][j] = 0.f;
      mm_acc<N>(sgn, dX[k], acc, nw);
      mm_acc<N>(sgn, X, dacc[k], nw);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) dacc[k][i][j] = nw[i][j];
    }
    float nw[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) nw[i][j] = (i == j) ? coeffs[ci] : 0.f;
    mm_acc<N>(sgn, X, acc, nw);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = nw[i][j];
  }
}

// In place of the N family (acc, dacc, d2acc of q(X) on the scaled X):
// P = D^-1 N with first and second derivatives, then nsq squarings.  The
// order is that of pallas_dyn_assembly.py::_group_bank: dP before d2P (which
// reads it); in each squaring d2P first (it reads the old dP and P), then
// dP (the old P), then P.
template <int N, int K>
__device__ void to_exponential(int nsq, float (&Pm)[N][N], float (&dP)[K][N][N],
                               float (&d2P)[K * (K + 1) / 2][N][N], const float (&Dm)[N][N],
                               const float (&dD)[K][N][N],
                               const float (&d2D)[K * (K + 1) / 2][N][N]) {
  float Mw[N][N], R[N][N];  // Gauss-Jordan: Mw -> I, R -> D^-1
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Mw[i][j] = Dm[i][j];
      R[i][j] = (i == j) ? 1.f : 0.f;
    }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float inv = 1.f / Mw[c][c];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Mw[c][j] *= inv;
      R[c][j] *= inv;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == c) continue;
      const float f = Mw[r][c];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Mw[r][j] -= f * Mw[c][j];
        R[r][j] -= f * R[c][j];
      }
    }
  }
  float tw[N][N], nw[N][N];
  auto zero = [](float (&x)[N][N]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) x[i][j] = 0.f;
  };
  auto copy = [](const float (&x)[N][N], float (&y)[N][N]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) y[i][j] = x[i][j];
  };
  zero(nw);
  mm_acc<N>(1.f, R, Pm, nw);  // P = D^-1 N
  copy(nw, Pm);
#pragma unroll
  for (int k = 0; k < K; ++k) {  // dP_k = D^-1 (dN_k - dD_k P)
    copy(dP[k], tw);
    mm_acc<N>(-1.f, dD[k], Pm, tw);
    zero(nw);
    mm_acc<N>(1.f, R, tw, nw);
    copy(nw, dP[k]);
  }
  {
    int p = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int l = k; l < K; ++l, ++p) {  // d2P = D^-1 (d2N - d2D P - dD_k dP_l - dD_l dP_k)
        copy(d2P[p], tw);
        mm_acc<N>(-1.f, d2D[p], Pm, tw);
        mm_acc<N>(-1.f, dD[k], dP[l], tw);
        mm_acc<N>(-1.f, dD[l], dP[k], tw);
        zero(nw);
        mm_acc<N>(1.f, R, tw, nw);
        copy(nw, d2P[p]);
      }
  }
  for (int sq = 0; sq < nsq; ++sq) {
    int p = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int l = k; l < K; ++l, ++p) {
        zero(nw);
        mm_acc<N>(1.f, d2P[p], Pm, nw);
        mm_acc<N>(1.f, Pm, d2P[p], nw);
        mm_acc<N>(1.f, dP[k], dP[l], nw);
        mm_acc<N>(1.f, dP[l], dP[k], nw);
        copy(nw, d2P[p]);
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zero(nw);
      mm_acc<N>(1.f, dP[k], Pm, nw);
      mm_acc<N>(1.f, Pm, dP[k], nw);
      copy(nw, dP[k]);
    }
    zero(nw);
    mm_acc<N>(1.f, Pm, Pm, nw);
    copy(nw, Pm);
  }
}

template <int N, int K, bool EXP>
__global__ void assembly_kernel(const float* __restrict__ Z, const float* __restrict__ lam,
                                int Bt, int T, int d, int s, const int* __restrict__ ispec,
                                const float* __restrict__ fspec, float* __restrict__ F,
                                float* __restrict__ A, float* __restrict__ Bm,
                                float* __restrict__ Hc, float* __restrict__ Cc) {
  constexpr int KP = K * (K + 1) / 2;
  const int Tm1 = T - 1;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long)Bt * Tm1) return;
  const long b = m / Tm1;
  const int t = (int)(m % Tm1);

  const float* zt = Z + (b * T + t) * d;
  const float* ztp1 = zt + d;
  const float* lm = lam + m * s;
  float* Fm = F + m * s;
  float* Am = A + m * s * d;
  float* Bmm = Bm + m * s * d;
  float* Hm = Hc + (b * T + t) * d * d;
  float* Cm = Cc + m * d * d;

  for (int i = 0; i < s; ++i) Fm[i] = 0.f;
  for (int i = 0; i < s * d; ++i) { Am[i] = 0.f; Bmm[i] = 0.f; }
  for (int i = 0; i < d * d; ++i) { Hm[i] = 0.f; Cm[i] = 0.f; }
  if (t == Tm1 - 1) {
    float* Hlast = Hc + (b * T + Tm1) * d * d;
    for (int i = 0; i < d * d; ++i) Hlast[i] = 0.f;
  }

  const float* vs = fspec;
  const float* ds = fspec + d;
  const float* fp = fspec + d + s;
  const int* ip = ispec + 3;
  const int ng = ispec[0], nderiv = ispec[1], ndteq = ispec[2];

  for (int gi = 0; gi < ng; ++gi) {
    const int na = ip[1], a0 = ip[2], dt_col = ip[3], nsq = ip[4], nmem = ip[5];
    const int* mem = ip + 6;
    ip += 6 + 5 * nmem;
    const float dt_static = fp[0];
    const int ncoef = (int)fp[1];
    const float* coeffs = fp + 2;
    const float* Gd = coeffs + ncoef;
    const float* Gs = Gd + N * N;
    fp = Gs + na * N * N;
    const bool free_dt = dt_col >= 0;
    const float dt = free_dt ? zt[dt_col] * vs[dt_col] : dt_static;

    float G[N][N], X[N][N], dX[K][N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float g = Gd[i * N + j];
        for (int k = 0; k < na; ++k) g += zt[a0 + k] * vs[a0 + k] * Gs[(k * N + i) * N + j];
        G[i][j] = g;
        X[i][j] = g * dt;
#pragma unroll
        for (int k = 0; k < K; ++k)
          dX[k][i][j] = (k < na) ? Gs[(k * N + i) * N + j] * dt : G[i][j];
      }
    float Nm[N][N], dN[K][N][N], d2N[KP][N][N];
    float Dm[N][N], dD[K][N][N], d2D[KP][N][N];
    horner<N, K>(1.f, coeffs, ncoef, X, dX, Gs, na, free_dt, Nm, dN, d2N);
    horner<N, K>(-1.f, coeffs, ncoef, X, dX, Gs, na, free_dt, Dm, dD, d2D);
    if constexpr (EXP) to_exponential<N, K>(nsq, Nm, dN, d2N, Dm, dD, d2D);  // N family := P

    int theta[K];
#pragma unroll
    for (int k = 0; k < K; ++k) theta[k] = (k < na) ? a0 + k : dt_col;

    for (int mi = 0; mi < nmem; ++mi) {
      const int u0 = mem[5 * mi], r0 = mem[5 * mi + 2], ncols = mem[5 * mi + 4];
      float U0[N][N], U1[N][N], Lam[N][N];
      for (int c = 0; c < ncols; ++c)
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const int zi = u0 + c * N + r;
          U0[r][c] = zt[zi] * vs[zi];
          U1[r][c] = ztp1[zi] * vs[zi];
          Lam[r][c] = lm[r0 + c * N + r] * ds[r0 + c * N + r];
        }
      for (int c = 0; c < ncols; ++c)
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const int row = r0 + c * N + r;
          float res = 0.f;
          if constexpr (EXP) {  // u' - P u
            float pu = 0.f;
#pragma unroll
            for (int j = 0; j < N; ++j) pu += Nm[r][j] * U0[j][c];
            res = U1[r][c] - pu;
          } else {
#pragma unroll
            for (int j = 0; j < N; ++j) res += Dm[r][j] * U1[j][c] - Nm[r][j] * U0[j][c];
          }
          Fm[row] = res * ds[row];
#pragma unroll
          for (int rp = 0; rp < N; ++rp) {
            const int col = u0 + c * N + rp;
            Am[row * d + col] = -Nm[r][rp] * (ds[row] * vs[col]);
            if constexpr (EXP)
              Bmm[row * d + col] = (rp == r) ? ds[row] * vs[col] : 0.f;
            else
              Bmm[row * d + col] = Dm[r][rp] * (ds[row] * vs[col]);
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float dc = 0.f;
            if constexpr (EXP) {
#pragma unroll
              for (int j = 0; j < N; ++j) dc -= dN[k][r][j] * U0[j][c];
            } else {
#pragma unroll
              for (int j = 0; j < N; ++j) dc += dD[k][r][j] * U1[j][c] - dN[k][r][j] * U0[j][c];
            }
            Am[row * d + theta[k]] = dc * (ds[row] * vs[theta[k]]);
          }
        }
      // curvature of -lam.F: W = Lam U^T
      float W0[N][N], W1[N][N];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float w0 = 0.f, w1 = 0.f;
          for (int c = 0; c < ncols; ++c) {
            w0 += Lam[i][c] * U0[j][c];
            w1 += Lam[i][c] * U1[j][c];
          }
          W0[i][j] = w0;
          W1[i][j] = w1;
        }
      {
        int p = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int l = k; l < K; ++l, ++p) {
            float h = 0.f;
#pragma unroll
            for (int i = 0; i < N; ++i)
#pragma unroll
              for (int j = 0; j < N; ++j) {
                if constexpr (EXP)
                  h += d2N[p][i][j] * W0[i][j];
                else
                  h += d2N[p][i][j] * W0[i][j] - d2D[p][i][j] * W1[i][j];
              }
            const int ck = theta[k], cl = theta[l];
            const float hv = h * (vs[ck] * vs[cl]);
            Hm[ck * d + cl] += hv;
            if (ck != cl) Hm[cl * d + ck] += hv;
          }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int ck = theta[k];
        for (int c = 0; c < ncols; ++c)
#pragma unroll
          for (int r = 0; r < N; ++r) {
            float mt = 0.f, mp = 0.f;
#pragma unroll
            for (int i = 0; i < N; ++i) {
              mt += dN[k][i][r] * Lam[i][c];
              if constexpr (!EXP) mp += dD[k][i][r] * Lam[i][c];
            }
            const int ui = u0 + c * N + r;
            const float sc = vs[ui] * vs[ck];
            Hm[ui * d + ck] += mt * sc;
            Hm[ck * d + ui] += mt * sc;
            if constexpr (!EXP) Cm[ck * d + ui] += -mp * sc;  // D' u' has no exp counterpart
          }
      }
    }
  }

  for (int ri = 0; ri < nderiv; ++ri, ip += 7, fp += 1) {
    const int x0 = ip[0], x1 = ip[1], dx0 = ip[2], r0 = ip[4], dt_col = ip[6];
    const float dt = dt_col >= 0 ? zt[dt_col] * vs[dt_col] : fp[0];
    for (int i = 0; i < x1 - x0; ++i) {
      const int row = r0 + i, xi = x0 + i, dxi = dx0 + i;
      const float dxv = zt[dxi] * vs[dxi];
      Fm[row] = (ztp1[xi] * vs[xi] - zt[xi] * vs[xi] - dxv * dt) * ds[row];
      Am[row * d + xi] = -ds[row] * vs[xi];
      Am[row * d + dxi] = -dt * (ds[row] * vs[dxi]);
      Bmm[row * d + xi] = ds[row] * vs[xi];
      if (dt_col >= 0) {
        Am[row * d + dt_col] = -dxv * (ds[row] * vs[dt_col]);
        const float lv = lm[row] * ds[row] * (vs[dxi] * vs[dt_col]);
        Hm[dxi * d + dt_col] += lv;
        Hm[dt_col * d + dxi] += lv;
      }
    }
  }

  for (int ri = 0; ri < ndteq; ++ri, ip += 4) {
    const int c0 = ip[0], c1 = ip[1], r0 = ip[2];
    for (int i = 0; i < c1 - c0; ++i) {
      const int row = r0 + i, ci = c0 + i;
      Fm[row] = (ztp1[ci] * vs[ci] - zt[ci] * vs[ci]) * ds[row];
      Am[row * d + ci] = -ds[row] * vs[ci];
      Bmm[row * d + ci] = ds[row] * vs[ci];
    }
  }
}

template <int N, int K, bool EXP>
int launch(const float* Z, const float* lam, int Bt, int T, int d, int s, const int* ispec,
           const float* fspec, float* F, float* A, float* Bm, float* Hc, float* Cc,
           cudaStream_t stream) {
  const long M = (long)Bt * (T - 1);
  const int threads = 128;
  const int blocks = (int)((M + threads - 1) / threads);
  assembly_kernel<N, K, EXP><<<blocks, threads, 0, stream>>>(Z, lam, Bt, T, d, s, ispec, fspec,
                                                             F, A, Bm, Hc, Cc);
  return (int)cudaGetLastError();
}

}  // namespace

// exp_kind = 0: every group is Padé; 1: every group is exponential.
extern "C" int qct_dyn_assembly(const float* Z, const float* lam, int Bt, int T, int d, int s,
                                const int* ispec, const float* fspec, float* F, float* A,
                                float* Bm, float* Hc, float* Cc, int n, int K, int exp_kind,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define QCT_CASE(NN, KK)                                                                     \
  if (n == NN && K == KK)                                                                   \
    return exp_kind ? launch<NN, KK, true>(Z, lam, Bt, T, d, s, ispec, fspec, F, A, Bm, Hc, Cc, st) \
                    : launch<NN, KK, false>(Z, lam, Bt, T, d, s, ispec, fspec, F, A, Bm, Hc, Cc, st);
  QCT_CASE(2, 1) QCT_CASE(2, 2) QCT_CASE(2, 3)
  QCT_CASE(4, 1) QCT_CASE(4, 2) QCT_CASE(4, 3)
#undef QCT_CASE
  return (int)cudaErrorInvalidValue;
}
