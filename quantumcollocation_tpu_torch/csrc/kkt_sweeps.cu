// Riccati sweeps of the batched block-tridiagonal KKT solve.
//
// Replaces: quantumcollocation_tpu/solver/kkt_lanes.py::_fwd_sweep_kernel
// (kernel 2, with the jnp terminal block that follows it, which is folded
// into the end of kkt_fwd_sweep here), ::_bwd_sweep_kernel (kernel 3) and
// ::_rhs_fwd_sweep_kernel (kernel 4, with the terminal solve of
// _resolve_kkt_lanes_impl folded in), for a single right-hand-side column.
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
// contiguous blocks, and the solver's layout needs no transpose.

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

__global__ void fwd_sweep(const float* __restrict__ H, const float* __restrict__ C,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ rz, const float* __restrict__ rnu, int Bn,
                          int T, int d, int s, float delta_c, float* __restrict__ LP,
                          float* __restrict__ LS, float* __restrict__ XA,
                          float* __restrict__ q, float* __restrict__ dz,
                          float* __restrict__ Gk, float* __restrict__ LPf) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  const int ldd = odd(d), nc = s + d + 1;
  const int per_warp = 2 * d * ldd + d * nc + s * d + d * d + s * nc + s * (d + 1) + 2 * d;
  float* Lm = smem + warp * per_warp;  // P, then L_P          d x ldd
  float* Dl = Lm + d * ldd;             // carry Delta          d x ldd
  float* W = Dl + d * ldd;              // [X_A | X_C | x]      d x nc
  float* Am = W + d * nc;               // A_t                  s x d
  float* Cm = Am + s * d;               // C_t                  d x d
  float* Mm = Cm + d * d;               // [S -> L_S | G | r]   s x nc
  float* SG = Mm + s * nc;              // [S^-1 G | y]         s x (d+1)
  float* qd = SG + s * (d + 1);         // carry qd             d
  float* qv = qd + d;                   // terminal rhs         d

  for (int idx = lane; idx < d * d; idx += 32) Dl[(idx / d) * ldd + idx % d] = 0.f;
  for (int i = lane; i < d; i += 32) qd[i] = 0.f;
  __syncwarp();

  const long dd = (long)d * d, sd = (long)s * d;
  for (int t = 0; t < T - 1; ++t) {
    const float* Ht = H + (b * T + t) * dd;
    const float* Ct = C + (b * (T - 1) + t) * dd;
    const float* At = A + (b * (T - 1) + t) * sd;
    const float* Bt = Bm + (b * (T - 1) + t) * sd;
    const float* rzt = rz + (b * T + t) * d;
    const float* rnut = rnu + (b * (T - 1) + t) * s;
    const long kt = b * (T - 1) + t;

    for (int idx = lane; idx < d * d; idx += 32) {
      const int i = idx / d, j = idx % d;
      Lm[i * ldd + j] = Ht[idx] + Dl[i * ldd + j];
      Cm[idx] = Ct[idx];
    }
    for (int idx = lane; idx < s * d; idx += 32) Am[idx] = At[idx];
    for (int idx = lane; idx < d * nc; idx += 32) {
      const int i = idx / nc, c = idx % nc;
      float v;
      if (c < s) {
        v = At[c * d + i];
      } else if (c < s + d) {
        v = Ct[i * d + (c - s)];
      } else {
        v = rzt[i] + qd[i];
        q[kt * d + i] = v;
      }
      W[idx] = v;
    }
    __syncwarp();
    warp_chol(Lm, d, ldd, lane);
    warp_chol_solve(Lm, ldd, W, d, nc, nc, lane);
    for (int c = lane; c < nc; c += 32) {
      for (int i = 0; i < s; ++i) {
        float m = 0.f;
        for (int k = 0; k < d; ++k) m += Am[i * d + k] * W[k * nc + c];
        if (c < s) {
          if (c == i) m += delta_c;
        } else if (c < s + d) {
          m -= Bt[i * d + (c - s)];
        } else {
          m -= rnut[i];
        }
        Mm[i * nc + c] = m;
        if (c >= s) SG[i * (d + 1) + (c - s)] = m;
      }
    }
    __syncwarp();
    warp_chol(Mm, s, nc, lane);
    warp_chol_solve(Mm, nc, SG, s, d + 1, d + 1, lane);
    // Delta' (unsymmetrized, into Dl) and qd' (column j = d)
    for (int j = lane; j <= d; j += 32) {
      for (int i = 0; i < d; ++i) {
        float a = 0.f, c = 0.f;
        for (int k = 0; k < s; ++k) a += Mm[k * nc + s + i] * SG[k * (d + 1) + j];
        for (int k = 0; k < d; ++k) c += Cm[k * d + i] * W[k * nc + s + j];
        if (j < d) {
          Dl[i * ldd + j] = a - c;
        } else {
          qd[i] = a - c;
        }
      }
    }
    __syncwarp();
    for (int idx = lane; idx < d * d; idx += 32) {
      const int i = idx / d, j = idx % d;
      if (j >= i) {
        const float v = 0.5f * (Dl[i * ldd + j] + Dl[j * ldd + i]);
        Dl[i * ldd + j] = v;
        Dl[j * ldd + i] = v;
      }
    }
    for (int idx = lane; idx < d * d; idx += 32) LP[kt * dd + idx] = Lm[(idx / d) * ldd + idx % d];
    for (int idx = lane; idx < s * s; idx += 32) LS[kt * s * s + idx] = Mm[(idx / s) * nc + idx % s];
    for (int idx = lane; idx < d * s; idx += 32) XA[kt * sd + idx] = W[(idx / s) * nc + idx % s];
    if (Gk)  // G = A X_C - B, still in Mm's columns s..s+d-1
      for (int idx = lane; idx < s * d; idx += 32) Gk[kt * sd + idx] = Mm[(idx / d) * nc + s + idx % d];
    __syncwarp();
  }
  // terminal block
  const float* Hf = H + (b * T + T - 1) * dd;
  for (int idx = lane; idx < d * d; idx += 32) {
    const int i = idx / d, j = idx % d;
    Lm[i * ldd + j] = 0.5f * ((Hf[i * d + j] + Dl[i * ldd + j]) + (Hf[j * d + i] + Dl[j * ldd + i]));
  }
  for (int i = lane; i < d; i += 32) qv[i] = rz[(b * T + T - 1) * d + i] + qd[i];
  __syncwarp();
  warp_chol(Lm, d, ldd, lane);
  if (LPf)
    for (int idx = lane; idx < d * d; idx += 32) LPf[b * dd + idx] = Lm[(idx / d) * ldd + idx % d];
  warp_chol_solve_vec(Lm, ldd, qv, d, lane);
  for (int i = lane; i < d; i += 32) dz[(b * T + T - 1) * d + i] = qv[i];
}

__global__ void bwd_sweep(const float* __restrict__ LP, const float* __restrict__ LS,
                          const float* __restrict__ XA, const float* __restrict__ q,
                          const float* __restrict__ C, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ rnu, int Bn,
                          int T, int d, int s, float* __restrict__ dz, float* __restrict__ nu) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = (long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= Bn) return;
  const int per_warp = d * d + s * s + 2 * d + s;
  float* Lp = smem + warp * per_warp;  // L_P   d x d
  float* Ls = Lp + d * d;              // L_S   s x s
  float* dzn = Ls + s * s;             // dz_{t+1}
  float* xv = dzn + d;                 // x
  float* yv = xv + d;                  // y
  const long dd = (long)d * d, sd = (long)s * d;
  for (int i = lane; i < d; i += 32) dzn[i] = dz[(b * T + T - 1) * d + i];
  __syncwarp();
  for (int t = T - 2; t >= 0; --t) {
    const long kt = b * (T - 1) + t;
    const float* Ct = C + kt * dd;
    const float* At = A + kt * sd;
    const float* Bt = Bm + kt * sd;
    for (int idx = lane; idx < d * d; idx += 32) Lp[idx] = LP[kt * dd + idx];
    for (int idx = lane; idx < s * s; idx += 32) Ls[idx] = LS[kt * s * s + idx];
    for (int i = lane; i < d; i += 32) {
      float v = q[kt * d + i];
      for (int j = 0; j < d; ++j) v -= Ct[i * d + j] * dzn[j];
      xv[i] = v;
    }
    __syncwarp();
    warp_chol_solve_vec(Lp, d, xv, d, lane);
    for (int k = lane; k < s; k += 32) {
      float v = -rnu[kt * s + k];
      for (int j = 0; j < d; ++j) v += Bt[k * d + j] * dzn[j] + At[k * d + j] * xv[j];
      yv[k] = v;
    }
    __syncwarp();
    warp_chol_solve_vec(Ls, s, yv, s, lane);
    for (int i = lane; i < d; i += 32) {
      float v = xv[i];
      for (int k = 0; k < s; ++k) v -= XA[kt * sd + i * s + k] * yv[k];
      dz[(b * T + t) * d + i] = v;
    }
    for (int k = lane; k < s; k += 32) nu[kt * s + k] = yv[k];
    __syncwarp();
    for (int i = lane; i < d; i += 32) dzn[i] = dz[(b * T + t) * d + i];
    __syncwarp();
  }
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
  const int per_warp = d * d + s * s + 2 * d + s;
  float* Lp = smem + warp * per_warp;  // L_P, then L_Pf   d x d
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

int fwd_warp_bytes(int d, int s) {
  const int ldd = odd(d), nc = s + d + 1;
  return (2 * d * ldd + d * nc + s * d + d * d + s * nc + s * (d + 1) + 2 * d) * (int)sizeof(float);
}

int rhs_warp_bytes(int d, int s) { return (d * d + s * s + 2 * d + s) * (int)sizeof(float); }

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

}  // namespace

// Batch-first buffers: H (B,T,d,d), C (B,T-1,d,d), A/B (B,T-1,s,d),
// rz (B,T,d), rnu (B,T-1,s); LP (B,T-1,d,d), LS (B,T-1,s,s),
// XA (B,T-1,d,s), q (B,T-1,d), dz (B,T,d): the forward sweep writes
// dz[:, T-1], the backward sweep the rest and nu (B,T-1,s).  With kept
// factors (G and LPf not null) the forward sweep also writes G (B,T-1,s,d)
// and LPf (B,d,d).  The launchers return a CUDA error code, and
// cudaErrorInvalidConfiguration when one warp's blocks exceed the shared
// memory a block may use.
extern "C" int qct_kkt_fwd_sweep(const float* H, const float* C, const float* A, const float* Bm,
                                 const float* rz, const float* rnu, int Bn, int T, int d, int s,
                                 float delta_c, float* LP, float* LS, float* XA, float* q,
                                 float* dz, float* G, float* LPf, void* stream) {
  static int opted[16] = {0};
  int smem = 0;
  const int w = configure(fwd_sweep, fwd_warp_bytes(d, s), Bn, &smem, opted);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  fwd_sweep<<<(Bn + w - 1) / w, 32 * w, smem, (cudaStream_t)stream>>>(
      H, C, A, Bm, rz, rnu, Bn, T, d, s, delta_c, LP, LS, XA, q, dz, G, LPf);
  return (int)cudaGetLastError();
}

extern "C" int qct_kkt_bwd_sweep(const float* LP, const float* LS, const float* XA,
                                 const float* q, const float* C, const float* A, const float* Bm,
                                 const float* rnu, int Bn, int T, int d, int s, float* dz,
                                 float* nu, void* stream) {
  static int opted[16] = {0};
  int smem = 0;
  const int w = configure(bwd_sweep, rhs_warp_bytes(d, s), Bn, &smem, opted);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  bwd_sweep<<<(Bn + w - 1) / w, 32 * w, smem, (cudaStream_t)stream>>>(
      LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s, dz, nu);
  return (int)cudaGetLastError();
}

// Kept factors LP, LS, G (B,T-1,s,d), LPf (B,d,d) with C and A; a new rhs
// rz, rnu.  Writes q (B,T-1,d) and dz[:, T-1] for the backward sweep.
extern "C" int qct_kkt_rhs_fwd_sweep(const float* LP, const float* LS, const float* G,
                                     const float* C, const float* A, const float* rz,
                                     const float* rnu, const float* LPf, int Bn, int T, int d,
                                     int s, float* q, float* dz, void* stream) {
  static int opted[16] = {0};
  int smem = 0;
  const int w = configure(rhs_fwd_sweep, rhs_warp_bytes(d, s), Bn, &smem, opted);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  rhs_fwd_sweep<<<(Bn + w - 1) / w, 32 * w, smem, (cudaStream_t)stream>>>(
      LP, LS, G, C, A, rz, rnu, LPf, Bn, T, d, s, q, dz);
  return (int)cudaGetLastError();
}
