// Riccati sweeps of the batched block-tridiagonal KKT solve.
//
// Replaces: quantumcollocation_tpu/solver/kkt_lanes.py::_fwd_sweep_kernel
// (kernel 2, with the jnp terminal block that follows it, which is folded
// into the end of kkt_fwd_sweep here), ::_bwd_sweep_kernel (kernel 3) and
// ::_rhs_fwd_sweep_kernel (kernel 4, with the terminal solve of
// _resolve_kkt_lanes_impl folded in), and the lanes_scan backend's
// ::_fwd_step_kernel (kernel 6) and ::_bwd_step_kernel (kernel 7).
// Kernels 2 and 3 take r right-hand-side columns (the L-BFGS [rz | U]
// system has 13); kernels 4, 6 and 7 take one, as their JAX callers do.
//
// Forward sweep, per instance, carrying Delta_t and qd_t (Delta_0 = 0):
//   P = H_t + Delta;  L_P = chol(P);  [X_A | X_C | x] = P^-1 [A^T | C | q];
//   q = rz_t + qd;    [S | G | r] = A [X_A | X_C | x] + [delta_c I | -B | -rnu_t];
//   L_S = chol(S);    [S^-1 G | y] = S^-1 [G | r];
//   Delta' = sym(G^T S^-1 G - C^T X_C);  qd' = G^T y - C^T x
// then the terminal block: P_f = sym(H_{T-1} + Delta), dz_{T-1} = P_f^-1
// (rz_{T-1} + qd).  With kept factors it also writes G_t = A X_C - B and
// L_Pf = chol(P_f).  The rhs-only forward sweep re-runs the q recursion
// against kept factors, no Cholesky: q = rz_t + qd; x = L_P^-T L_P^-1 q;
// y = L_S^-T L_S^-1 (A x - rnu_t); qd' = G^T y - C^T x; then
// dz_{T-1} = L_Pf^-T L_Pf^-1 (rz_{T-1} + qd).  Backward sweep, t = T-2 .. 0:
//   u = q_t - C dz_{t+1};  v = rnu_t - B dz_{t+1};  x = P^-1 u;
//   y = S^-1 (A x - v);    dz_t = x - X_A y;       nu_t = y.
// A Cholesky pivot is never clamped: sqrtf of a negative pivot gives NaN,
// which reaches dz and nu and marks the instance failed (the solver's
// delta_w retry loop reads that).  Build without fast math.
//
// What bounds it: by bytes, the forward sweep reads H, C, A, B, rz, rnu
// (868 floats per knot at d=15, s=13) and writes L_P, L_S, X_A, q (604);
// the backward sweep reads ~1232 and writes 28.  Its arithmetic, ~3*10^4
// flops per knot, is a chain of small dependent factorizations, so with
// few instances the latency of that chain bounds it.  Design: one warp per
// instance walks the knots in order (the loop replaces the TPU's
// sequential grid axis).  The knot's blocks and the carry live in shared
// memory; the lanes own the right-hand-side columns of the triangular
// solves (the three solves against L_P run as one, 29 columns at d=15,
// s=13) and the rows of the Cholesky column updates and the products.
// Buffers are batch-first, so a warp reads and writes its instance's
// contiguous blocks, and the solver's layout needs no transpose.  With r
// columns, x, q, qd and the terminal rhs widen to d x r, r and rnu_t to
// s x r; the single-column instantiation (template R = 1) compiles as the
// one-column code did.  The per-knot bodies (fwd_knot, bwd_knot) are shared
// by the sweeps, which loop over the knots with the carry in shared memory,
// and the lanes_scan steps, one launch per knot, which read and write the
// full carry P, q in global memory: P_{t+1} = sym(H_{t+1}) + Delta',
// q_{t+1} = rz_{t+1} + qd' (the JAX scan leaves the terminal Cholesky to
// plain array code, and so does the port).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;  // instances per block, at most

__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }  // bank-conflict-free stride

// In-place lower Cholesky of the n x n matrix at M (row stride ld); the
// upper triangle is zeroed.  Lanes own the rows of each column update.
__device__ void warp_chol(float* M, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    for (int i = j + lane; i < n; i += 32) {
      float v = M[i * ld + j];
      for (int k = 0; k < j; ++k) v -= M[i * ld + k] * M[j * ld + k];
      M[i * ld + j] = v;
    }
    __syncwarp();
    const float piv = sqrtf(M[j * ld + j]);
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) M[i * ld + j] = (i == j) ? piv : M[i * ld + j] / piv;
    __syncwarp();
  }
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    if (j > i) M[i * ld + j] = 0.f;
  }
  __syncwarp();
}

// In place Y <- (L L^T)^-1 Y for an n x ncols block Y (row stride ldy);
// lanes own the columns.
__device__ void warp_chol_solve(const float* L, int ldl, float* Y, int n, int ncols, int ldy,
                                int lane) {
  for (int c = lane; c < ncols; c += 32) {
    for (int i = 0; i < n; ++i) {
      float v = Y[i * ldy + c];
      for (int k = 0; k < i; ++k) v -= L[i * ldl + k] * Y[k * ldy + c];
      Y[i * ldy + c] = v / L[i * ldl + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float v = Y[i * ldy + c];
      for (int k = i + 1; k < n; ++k) v -= L[k * ldl + i] * Y[k * ldy + c];
      Y[i * ldy + c] = v / L[i * ldl + i];
    }
  }
  __syncwarp();
}

// In place y <- (L L^T)^-1 y for one column y of length n; lanes own the
// rows of each column update, so the chain is n steps, not n^2.
__device__ void warp_chol_solve_vec(const float* L, int ldl, float* y, int n, int lane) {
  for (int i = 0; i < n; ++i) {
    const float xi = y[i] / L[i * ldl + i];
    __syncwarp();
    if (lane == (i & 31)) y[i] = xi;
    for (int r = i + 1 + lane; r < n; r += 32) y[r] -= L[r * ldl + i] * xi;
    __syncwarp();
  }
  for (int i = n - 1; i >= 0; --i) {
    const float xi = y[i] / L[i * ldl + i];
    __syncwarp();
    if (lane == (i & 31)) y[i] = xi;
    for (int r = lane; r < i; r += 32) y[r] -= L[i * ldl + r] * xi;
    __syncwarp();
  }
}

// Shared-memory layout of one warp's forward elimination, r rhs columns.
struct FwdBufs {
  float* Lm;  // P, then L_P          d x ldd
  float* Dl;  // Delta (carry / out)  d x ldd
  float* W;   // [X_A | X_C | x]      d x nc
  float* Am;  // A_t                  s x d
  float* Cm;  // C_t                  d x d
  float* Mm;  // [S -> L_S | G | r]   s x nc
  float* SG;  // [S^-1 G | y]         s x (d+r)
  float* qd;  // qd (carry / out)     d x r
  float* qv;  // terminal rhs         d x r
};

__host__ __device__ inline int fwd_warp_floats(int d, int s, int r) {
  const int ldd = odd(d), nc = s + d + r;
  return 2 * d * ldd + d * nc + s * d + d * d + s * nc + s * (d + r) + 2 * d * r;
}

__device__ FwdBufs fwd_bufs(float* base, int d, int s, int r) {
  const int ldd = odd(d), nc = s + d + r;
  FwdBufs m;
  m.Lm = base;
  m.Dl = m.Lm + d * ldd;
  m.W = m.Dl + d * ldd;
  m.Am = m.W + d * nc;
  m.Cm = m.Am + s * d;
  m.Mm = m.Cm + d * d;
  m.SG = m.Mm + s * nc;
  m.qd = m.SG + s * (d + r);
  m.qv = m.qd + d * r;
  return m;
}

// Forward elimination of one knot, shared by the fused sweep (kernel 2) and
// the per-knot step (kernel 6).  On entry m.Lm holds P and the last r
// columns of m.W hold q; At, Ct, Bt, rnut point at the knot's blocks.  It
// writes L_P, L_S, X_A, q (and G = A X_C - B where Go is not null) to
// global memory, and leaves Delta' = sym(G^T S^-1 G - C^T X_C) in m.Dl and
// qd' = G^T y - C^T x in m.qd.  R > 0 fixes the column count at compile
// time (R = 1: the single-column instantiation); R = 0 reads it from r.
template <int R>
__device__ void fwd_knot(const FwdBufs& m, const float* __restrict__ At,
                         const float* __restrict__ Ct, const float* __restrict__ Bt,
                         const float* __restrict__ rnut, int d, int s, int r_arg, float delta_c,
                         int lane, float* __restrict__ LPo, float* __restrict__ LSo,
                         float* __restrict__ XAo, float* __restrict__ Go,
                         float* __restrict__ qo) {
  const int r = R > 0 ? R : r_arg;
  const int ldd = odd(d), nc = s + d + r, sd = s + d;
  for (int idx = lane; idx < d * d; idx += 32) m.Cm[idx] = Ct[idx];
  for (int idx = lane; idx < s * d; idx += 32) m.Am[idx] = At[idx];
  for (int idx = lane; idx < d * sd; idx += 32) {
    const int i = idx / sd, c = idx % sd;
    m.W[i * nc + c] = c < s ? At[c * d + i] : Ct[i * d + (c - s)];
  }
  for (int idx = lane; idx < d * r; idx += 32) qo[idx] = m.W[(idx / r) * nc + sd + idx % r];
  __syncwarp();
  warp_chol(m.Lm, d, ldd, lane);
  warp_chol_solve(m.Lm, ldd, m.W, d, nc, nc, lane);
  for (int c = lane; c < nc; c += 32) {
    for (int i = 0; i < s; ++i) {
      float v = 0.f;
      for (int k = 0; k < d; ++k) v += m.Am[i * d + k] * m.W[k * nc + c];
      if (c < s) {
        if (c == i) v += delta_c;
      } else if (c < sd) {
        v -= Bt[i * d + (c - s)];
      } else {
        v -= rnut[i * r + (c - sd)];
      }
      m.Mm[i * nc + c] = v;
      if (c >= s) m.SG[i * (d + r) + (c - s)] = v;
    }
  }
  __syncwarp();
  warp_chol(m.Mm, s, nc, lane);
  warp_chol_solve(m.Mm, nc, m.SG, s, d + r, d + r, lane);
  // Delta' (unsymmetrized, into Dl) and qd' (columns j >= d)
  for (int j = lane; j < d + r; j += 32) {
    for (int i = 0; i < d; ++i) {
      float a = 0.f, c = 0.f;
      for (int k = 0; k < s; ++k) a += m.Mm[k * nc + s + i] * m.SG[k * (d + r) + j];
      for (int k = 0; k < d; ++k) c += m.Cm[k * d + i] * m.W[k * nc + s + j];
      if (j < d) {
        m.Dl[i * ldd + j] = a - c;
      } else {
        m.qd[i * r + (j - d)] = a - c;
      }
    }
  }
  __syncwarp();
  for (int idx = lane; idx < d * d; idx += 32) {
    const int i = idx / d, j = idx % d;
    if (j >= i) {
      const float v = 0.5f * (m.Dl[i * ldd + j] + m.Dl[j * ldd + i]);
      m.Dl[i * ldd + j] = v;
      m.Dl[j * ldd + i] = v;
    }
  }
  for (int idx = lane; idx < d * d; idx += 32) LPo[idx] = m.Lm[(idx / d) * ldd + idx % d];
  for (int idx = lane; idx < s * s; idx += 32) LSo[idx] = m.Mm[(idx / s) * nc + idx % s];
  for (int idx = lane; idx < d * s; idx += 32) XAo[idx] = m.W[(idx / s) * nc + idx % s];
  if (Go)  // G = A X_C - B, still in Mm's columns s..s+d-1
    for (int idx = lane; idx < s * d; idx += 32) Go[idx] = m.Mm[(idx / d) * nc + s + idx % d];
  __syncwarp();
}

template <int R>
__global__ void fwd_sweep(const float* __restrict__ H, const float* __restrict__ C,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ rz, const float* __restrict__ rnu, int Bn,
                          int T, int d, int s, int r_arg, float delta_c,
                          float* __restrict__ LP, float* __restrict__ LS,
                          float* __restrict__ XA, float* __restrict__ q,
                          float* __restrict__ dz, float* __restrict__ Gk,
                          float* __restrict__ LPf) {
  extern __shared__ float smem[];
  const int r = R > 0 ? R : r_arg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  const int ldd = odd(d), nc = s + d + r;
  const FwdBufs m = fwd_bufs(smem + warp * fwd_warp_floats(d, s, r), d, s, r);

  for (int idx = lane; idx < d * d; idx += 32) m.Dl[(idx / d) * ldd + idx % d] = 0.f;
  for (int i = lane; i < d * r; i += 32) m.qd[i] = 0.f;
  __syncwarp();

  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s, dr = (long)d * r;
  for (int t = 0; t < T - 1; ++t) {
    const float* Ht = H + (b * T + t) * dd;
    const float* rzt = rz + (b * T + t) * dr;
    const long kt = b * (T - 1) + t;
    for (int idx = lane; idx < d * d; idx += 32) {
      const int i = idx / d, j = idx % d;
      m.Lm[i * ldd + j] = Ht[idx] + m.Dl[i * ldd + j];
    }
    for (int idx = lane; idx < d * r; idx += 32)
      m.W[(idx / r) * nc + s + d + idx % r] = rzt[idx] + m.qd[idx];
    __syncwarp();
    fwd_knot<R>(m, A + kt * sd, C + kt * dd, Bm + kt * sd, rnu + kt * s * r, d, s, r, delta_c,
                lane, LP + kt * dd, LS + kt * ss, XA + kt * sd, Gk ? Gk + kt * sd : nullptr,
                q + kt * dr);
  }
  // terminal block
  const float* Hf = H + (b * T + T - 1) * dd;
  for (int idx = lane; idx < d * d; idx += 32) {
    const int i = idx / d, j = idx % d;
    m.Lm[i * ldd + j] =
        0.5f * ((Hf[i * d + j] + m.Dl[i * ldd + j]) + (Hf[j * d + i] + m.Dl[j * ldd + i]));
  }
  for (int i = lane; i < d * r; i += 32) m.qv[i] = rz[(b * T + T - 1) * dr + i] + m.qd[i];
  __syncwarp();
  warp_chol(m.Lm, d, ldd, lane);
  if (LPf)
    for (int idx = lane; idx < d * d; idx += 32) LPf[b * dd + idx] = m.Lm[(idx / d) * ldd + idx % d];
  if (r == 1) {
    warp_chol_solve_vec(m.Lm, ldd, m.qv, d, lane);
  } else {
    warp_chol_solve(m.Lm, ldd, m.qv, d, r, r, lane);
  }
  for (int i = lane; i < d * r; i += 32) dz[(b * T + T - 1) * dr + i] = m.qv[i];
}

// One knot of the lanes_scan forward elimination (kernel 6), one column,
// every instance: the full carry P (B,d,d) and q (B,d) in, P' = sym(H_{t+1})
// + Delta' and q' = rz_{t+1} + qd' out, and the knot's L_P, L_S, X_A and q
// written at knot t of LP, LS, XA, qs.
__global__ void fwd_step(const float* __restrict__ P, const float* __restrict__ qin,
                         const float* __restrict__ H, const float* __restrict__ C,
                         const float* __restrict__ A, const float* __restrict__ Bm,
                         const float* __restrict__ rz, const float* __restrict__ rnu, int Bn,
                         int T, int d, int s, int t, float delta_c, float* __restrict__ Pn,
                         float* __restrict__ qn, float* __restrict__ LP, float* __restrict__ LS,
                         float* __restrict__ XA, float* __restrict__ qs) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  const int ldd = odd(d), nc = s + d + 1;
  const FwdBufs m = fwd_bufs(smem + warp * fwd_warp_floats(d, s, 1), d, s, 1);
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  const long kt = b * (T - 1) + t;
  for (int idx = lane; idx < d * d; idx += 32) m.Lm[(idx / d) * ldd + idx % d] = P[b * dd + idx];
  for (int i = lane; i < d; i += 32) m.W[i * nc + s + d] = qin[b * d + i];
  __syncwarp();
  fwd_knot<1>(m, A + kt * sd, C + kt * dd, Bm + kt * sd, rnu + kt * s, d, s, 1, delta_c, lane,
              LP + kt * dd, LS + kt * ss, XA + kt * sd, nullptr, qs + kt * d);
  const float* Hn = H + (b * T + t + 1) * dd;
  for (int idx = lane; idx < d * d; idx += 32) {
    const int i = idx / d, j = idx % d;
    Pn[b * dd + idx] = 0.5f * (Hn[i * d + j] + Hn[j * d + i]) + m.Dl[i * ldd + j];
  }
  for (int i = lane; i < d; i += 32) qn[b * d + i] = rz[(b * T + t + 1) * d + i] + m.qd[i];
}

__host__ __device__ inline int bwd_warp_floats(int d, int s, int r) {
  return d * d + s * s + (2 * d + s) * r;
}

// Back substitution of one knot, shared by the fused sweep (kernel 3) and
// the per-knot step (kernel 7): from dz_{t+1} in dzn (d x r, shared),
//   u = q_t - C dz_{t+1};  v = rnu_t - B dz_{t+1};  x = P^-1 u;
//   y = S^-1 (A x - v);    dz_t = x - X_A y;       nu_t = y,
// written to dzo and nuo; dzn then holds dz_t.  R as in fwd_knot.
template <int R>
__device__ void bwd_knot(float* Lp, float* Ls, float* dzn, float* xv, float* yv,
                         const float* __restrict__ LPt, const float* __restrict__ LSt,
                         const float* __restrict__ XAt, const float* __restrict__ qt,
                         const float* __restrict__ Ct, const float* __restrict__ At,
                         const float* __restrict__ Bt, const float* __restrict__ rnut, int d,
                         int s, int r_arg, int lane, float* __restrict__ dzo,
                         float* __restrict__ nuo) {
  const int r = R > 0 ? R : r_arg;
  for (int idx = lane; idx < d * d; idx += 32) Lp[idx] = LPt[idx];
  for (int idx = lane; idx < s * s; idx += 32) Ls[idx] = LSt[idx];
  for (int idx = lane; idx < d * r; idx += 32) {
    const int i = idx / r, c = idx % r;
    float v = qt[idx];
    for (int j = 0; j < d; ++j) v -= Ct[i * d + j] * dzn[j * r + c];
    xv[idx] = v;
  }
  __syncwarp();
  if (r == 1) {
    warp_chol_solve_vec(Lp, d, xv, d, lane);
  } else {
    warp_chol_solve(Lp, d, xv, d, r, r, lane);
  }
  for (int idx = lane; idx < s * r; idx += 32) {
    const int k = idx / r, c = idx % r;
    float v = -rnut[idx];
    for (int j = 0; j < d; ++j) v += Bt[k * d + j] * dzn[j * r + c] + At[k * d + j] * xv[j * r + c];
    yv[idx] = v;
  }
  __syncwarp();
  if (r == 1) {
    warp_chol_solve_vec(Ls, s, yv, s, lane);
  } else {
    warp_chol_solve(Ls, s, yv, s, r, r, lane);
  }
  for (int idx = lane; idx < d * r; idx += 32) {
    const int i = idx / r, c = idx % r;
    float v = xv[idx];
    for (int k = 0; k < s; ++k) v -= XAt[i * s + k] * yv[k * r + c];
    dzo[idx] = v;
  }
  for (int idx = lane; idx < s * r; idx += 32) nuo[idx] = yv[idx];
  __syncwarp();
  for (int idx = lane; idx < d * r; idx += 32) dzn[idx] = dzo[idx];
  __syncwarp();
}

template <int R>
__global__ void bwd_sweep(const float* __restrict__ LP, const float* __restrict__ LS,
                          const float* __restrict__ XA, const float* __restrict__ q,
                          const float* __restrict__ C, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ rnu, int Bn,
                          int T, int d, int s, int r_arg, float* __restrict__ dz,
                          float* __restrict__ nu) {
  extern __shared__ float smem[];
  const int r = R > 0 ? R : r_arg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  float* Lp = smem + warp * bwd_warp_floats(d, s, r);  // L_P   d x d
  float* Ls = Lp + d * d;                               // L_S   s x s
  float* dzn = Ls + s * s;                              // dz_{t+1}  d x r
  float* xv = dzn + d * r;                              // x     d x r
  float* yv = xv + d * r;                               // y     s x r
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  const long dr = (long)d * r, sr = (long)s * r;
  for (int i = lane; i < d * r; i += 32) dzn[i] = dz[(b * T + T - 1) * dr + i];
  __syncwarp();
  for (int t = T - 2; t >= 0; --t) {
    const long kt = b * (T - 1) + t;
    bwd_knot<R>(Lp, Ls, dzn, xv, yv, LP + kt * dd, LS + kt * ss, XA + kt * sd, q + kt * dr,
                C + kt * dd, A + kt * sd, Bm + kt * sd, rnu + kt * sr, d, s, r, lane,
                dz + (b * T + t) * dr, nu + kt * sr);
  }
}

// One knot of the lanes_scan back substitution (kernel 7), one column,
// every instance: dz_{t+1} read from dz (B,T,d), dz_t and nu_t written.
__global__ void bwd_step(const float* __restrict__ LP, const float* __restrict__ LS,
                         const float* __restrict__ XA, const float* __restrict__ q,
                         const float* __restrict__ C, const float* __restrict__ A,
                         const float* __restrict__ Bm, const float* __restrict__ rnu, int Bn,
                         int T, int d, int s, int t, float* __restrict__ dz,
                         float* __restrict__ nu) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  float* Lp = smem + warp * bwd_warp_floats(d, s, 1);
  float* Ls = Lp + d * d;
  float* dzn = Ls + s * s;
  float* xv = dzn + d;
  float* yv = xv + d;
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  const long kt = b * (T - 1) + t;
  for (int i = lane; i < d; i += 32) dzn[i] = dz[(b * T + t + 1) * d + i];
  __syncwarp();
  bwd_knot<1>(Lp, Ls, dzn, xv, yv, LP + kt * dd, LS + kt * ss, XA + kt * sd, q + kt * d,
              C + kt * dd, A + kt * sd, Bm + kt * sd, rnu + kt * s, d, s, 1, lane,
              dz + (b * T + t) * d, nu + kt * s);
}

// rhs-only forward sweep (kernel 4): one warp per instance, carry qd.
__global__ void rhs_fwd_sweep(const float* __restrict__ LP, const float* __restrict__ LS,
                              const float* __restrict__ Gk, const float* __restrict__ C,
                              const float* __restrict__ A, const float* __restrict__ rz,
                              const float* __restrict__ rnu, const float* __restrict__ LPf,
                              int Bn, int T, int d, int s, float* __restrict__ q,
                              float* __restrict__ dz) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  float* Lp = smem + warp * bwd_warp_floats(d, s, 1);  // L_P, then L_Pf   d x d
  float* Ls = Lp + d * d;              // L_S              s x s
  float* qd = Ls + s * s;              // carry qd
  float* xv = qd + d;                  // x
  float* yv = xv + d;                  // y
  const long dd = (long)d * d, sd = (long)s * d;
  for (int i = lane; i < d; i += 32) qd[i] = 0.f;
  __syncwarp();
  for (int t = 0; t < T - 1; ++t) {
    const long kt = b * (T - 1) + t;
    for (int idx = lane; idx < d * d; idx += 32) Lp[idx] = LP[kt * dd + idx];
    for (int idx = lane; idx < s * s; idx += 32) Ls[idx] = LS[kt * s * s + idx];
    for (int i = lane; i < d; i += 32) {
      const float v = rz[(b * T + t) * d + i] + qd[i];
      q[kt * d + i] = v;
      xv[i] = v;
    }
    __syncwarp();
    warp_chol_solve_vec(Lp, d, xv, d, lane);
    for (int k = lane; k < s; k += 32) {
      float v = -rnu[kt * s + k];
      for (int j = 0; j < d; ++j) v += A[kt * sd + k * d + j] * xv[j];
      yv[k] = v;
    }
    __syncwarp();
    warp_chol_solve_vec(Ls, s, yv, s, lane);
    for (int i = lane; i < d; i += 32) {
      float a = 0.f, c = 0.f;
      for (int k = 0; k < s; ++k) a += Gk[kt * sd + k * d + i] * yv[k];
      for (int k = 0; k < d; ++k) c += C[kt * dd + k * d + i] * xv[k];
      qd[i] = a - c;
    }
    __syncwarp();
  }
  for (int idx = lane; idx < d * d; idx += 32) Lp[idx] = LPf[b * dd + idx];
  for (int i = lane; i < d; i += 32) xv[i] = rz[(b * T + T - 1) * d + i] + qd[i];
  __syncwarp();
  warp_chol_solve_vec(Lp, d, xv, d, lane);
  for (int i = lane; i < d; i += 32) dz[(b * T + T - 1) * d + i] = xv[i];
}

// The device's opt-in shared memory per block and SM count, read once per
// device: the launchers run several times per solver iteration.
struct DevInfo {
  int cap = 0, sms = 0;
};

DevInfo dev_info(int dev) {
  static DevInfo info[16];
  DevInfo& di = info[dev & 15];
  if (di.sms == 0) {
    cudaDeviceGetAttribute(&di.cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return di;
}

// Warps per block for a kernel needing `warp_bytes` of shared memory per
// warp: as many as fit, at most kMaxWarps, and no more than it takes to
// give every SM one warp first.  Returns 0 when not even one fits.
// `opted` is the kernel's largest dynamic shared memory set so far, per
// device, so the attribute is set only when a launch needs more.
template <typename Kernel>
int configure(Kernel kernel, int warp_bytes, int Bn, int* smem, int* opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DevInfo di = dev_info(dev);
  const int fit = di.cap / warp_bytes;
  if (fit < 1) return 0;
  int w = (Bn + di.sms - 1) / di.sms;
  w = w < 1 ? 1 : w;
  w = w < fit ? w : fit;
  w = w < kMaxWarps ? w : kMaxWarps;
  *smem = w * warp_bytes;
  int& set = opted[dev & 15];
  if (*smem > 48 * 1024 && *smem > set) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem) !=
        cudaSuccess)
      return 0;
    set = *smem;
  }
  return w;
}

// Launches `kernel` with one warp per instance and `warp_floats` floats of
// shared memory per warp; returns a CUDA error code, and
// cudaErrorInvalidConfiguration when one warp's blocks exceed the shared
// memory a block may use.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int warp_floats, int Bn, int* opted, void* stream, Args... args) {
  int smem = 0;
  const int w = configure(kernel, warp_floats * (int)sizeof(float), Bn, &smem, opted);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(Bn + w - 1) / w, 32 * w, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch-first buffers, r right-hand-side columns: H (B,T,d,d),
// C (B,T-1,d,d), A/B (B,T-1,s,d), rz (B,T,d,r), rnu (B,T-1,s,r);
// LP (B,T-1,d,d), LS (B,T-1,s,s), XA (B,T-1,d,s), q (B,T-1,d,r),
// dz (B,T,d,r): the forward sweep writes dz[:, T-1], the backward sweep the
// rest and nu (B,T-1,s,r).  With kept factors (G and LPf not null) the
// forward sweep also writes G (B,T-1,s,d) and LPf (B,d,d).  r = 1 runs the
// single-column instantiation.
extern "C" int qct_kkt_fwd_sweep(const float* H, const float* C, const float* A, const float* Bm,
                                 const float* rz, const float* rnu, int Bn, int T, int d, int s,
                                 int r, float delta_c, float* LP, float* LS, float* XA, float* q,
                                 float* dz, float* G, float* LPf, void* stream) {
  static int opted1[16] = {0}, optedr[16] = {0};
  const int wf = fwd_warp_floats(d, s, r);
  if (r == 1)
    return launch(fwd_sweep<1>, wf, Bn, opted1, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, r,
                  delta_c, LP, LS, XA, q, dz, G, LPf);
  return launch(fwd_sweep<0>, wf, Bn, optedr, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, r,
                delta_c, LP, LS, XA, q, dz, G, LPf);
}

extern "C" int qct_kkt_bwd_sweep(const float* LP, const float* LS, const float* XA,
                                 const float* q, const float* C, const float* A, const float* Bm,
                                 const float* rnu, int Bn, int T, int d, int s, int r, float* dz,
                                 float* nu, void* stream) {
  static int opted1[16] = {0}, optedr[16] = {0};
  const int wf = bwd_warp_floats(d, s, r);
  if (r == 1)
    return launch(bwd_sweep<1>, wf, Bn, opted1, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d,
                  s, r, dz, nu);
  return launch(bwd_sweep<0>, wf, Bn, optedr, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s,
                r, dz, nu);
}

// Kept factors LP, LS, G (B,T-1,s,d), LPf (B,d,d) with C and A; a new
// single-column rhs rz, rnu.  Writes q (B,T-1,d) and dz[:, T-1] for the
// backward sweep.
extern "C" int qct_kkt_rhs_fwd_sweep(const float* LP, const float* LS, const float* G,
                                     const float* C, const float* A, const float* rz,
                                     const float* rnu, const float* LPf, int Bn, int T, int d,
                                     int s, float* q, float* dz, void* stream) {
  static int opted[16] = {0};
  return launch(rhs_fwd_sweep, bwd_warp_floats(d, s, 1), Bn, opted, stream, LP, LS, G, C, A, rz,
                rnu, LPf, Bn, T, d, s, q, dz);
}

// The lanes_scan steps at knot t (0 <= t < T-1), one column, the same
// batch-first buffers as the sweeps.  Forward: the carry P (B,d,d), q (B,d)
// in, Pn, qn out; LP, LS, XA and qs (B,T-1,d) written at knot t.
// Backward: dz (B,T,d) read at t+1 and written at t, nu (B,T-1,s) at t.
extern "C" int qct_kkt_fwd_step(const float* P, const float* qin, const float* H, const float* C,
                                const float* A, const float* Bm, const float* rz,
                                const float* rnu, int Bn, int T, int d, int s, int t,
                                float delta_c, float* Pn, float* qn, float* LP, float* LS,
                                float* XA, float* qs, void* stream) {
  static int opted[16] = {0};
  return launch(fwd_step, fwd_warp_floats(d, s, 1), Bn, opted, stream, P, qin, H, C, A, Bm, rz,
                rnu, Bn, T, d, s, t, delta_c, Pn, qn, LP, LS, XA, qs);
}

extern "C" int qct_kkt_bwd_step(const float* LP, const float* LS, const float* XA,
                                const float* q, const float* C, const float* A, const float* Bm,
                                const float* rnu, int Bn, int T, int d, int s, int t, float* dz,
                                float* nu, void* stream) {
  static int opted[16] = {0};
  return launch(bwd_step, bwd_warp_floats(d, s, 1), Bn, opted, stream, LP, LS, XA, q, C, A, Bm,
                rnu, Bn, T, d, s, t, dz, nu);
}
