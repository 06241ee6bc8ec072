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
// What bounds kernels 2 and 3 on the H100: by bytes, the forward sweep
// reads H, C, A, B, rz, rnu (868 floats a knot at d=15, s=13) and writes
// L_P, L_S, X_A, q (604); the backward sweep reads ~1232 and writes 28: at
// d=15, B=512 that is a bound of ~0.045 ms.  At d=47 the ~1.4 MFLOP a knot
// bound it at ~0.1 ms, but each knot is a chain of dependent steps: two
// factorizations and four triangular solves, ~2(d + s) pivots, each of
// which needs the previous one, and with B=128 on 132 SMs nothing else
// runs beside an instance's chain.  So the design shortens the chain and
// widens each of its steps:
// - A group of G warps per instance (G = 4 up to 32 rows and 80 columns
//   of a block, else 8), several groups per block where shared memory
//   allows, spread over the SMs; each group synchronises on its own named
//   barrier (bar.sync 1 + group, 32 G), so a group without an instance in
//   a ragged last block leaves at once and stalls no other.
// - Register tiles: each thread owns the rows ty + a TR and the columns
//   tx + b 16 of a block (TileCfg: kFwdCfg, kBwdCfg, the smallest tiles
//   that hold the shapes).  The Cholesky of P carries the forward
//   substitution of [A^T | C | q] (group_chol_solve): pivot step j
//   publishes column j of P and row j of the right-hand side in shared
//   memory, and every thread updates its own trailing entries at once; the
//   back substitution publishes a row a step.  So ~2n barrier steps per
//   factor-and-solve, where a lane per column took n^2 dependent steps.
//   The same holds for S and [G | r], and for the terminal block.
// - The products A [X_A | X_C | x], G^T S^-1 [G | y] and C^T [X_C | x]
//   are register-tiled float32 FFMA (tile_mm), MR + MC shared loads per
//   MR MC multiply-adds.  No tensor cores: the sweeps' error feeds the 1e-4
//   fractions, and the port runs float32 with TF32 off.
// - While knot t computes, cp.async copies the next knot's blocks into a
//   second shared-memory stage: forward H, C, A, B, rz, rnu of knot t+1;
//   backward L_P, L_S, X_A, q, C, A, B, rnu of knot t-1, none of which
//   depends on the carry dz_{t+1}.
// - The one-column backward sweep runs its two triangular solves on one
//   warp with the vector in registers, each solved entry broadcast by a
//   shuffle (warp_solve_vec), and its matrix-vector products on the group,
//   kParts lanes per output; with r columns it uses group_llt_solve and
//   tile_mm.
// A knot's carry (Delta, qd; dz_{t+1}) stays in shared memory.  Any d, s
// <= 64 with s + d + r <= 144 runs; the launcher returns
// cudaErrorInvalidConfiguration past that or past the shared memory of a
// block.  Buffers are batch-first, so the solver's layout needs no
// transpose.
//
// Kernel 4 (the rhs-only forward sweep, JAX _rhs_fwd_sweep_kernel) reads
// L_P, L_S, G, C, A, rz, rnu a knot (10,219 floats at d=47, s=42): a bytes
// bound of ~0.06 ms at B=128, T=40.  But its knot is four dependent
// triangular solves, 2(d + s) = 178 steps, with one instance per SM, so
// latency bounds it.  It runs on the group design: a group of G warps per
// instance (as kernel 3 picks it), cp.async prefetching knot t+1's blocks
// (none depends on the carry qd) while knot t computes, the solves on one
// warp with the vector in registers (warp_solve_vec, 1 / diag once a
// knot), A x on the group by kParts lanes per row, and C^T x on the other
// warps while warp 0 solves with L_S, so only G^T y follows that solve.
// G and C are staged as stored, a thread per output column (a stage
// transposed by the copy, for kParts-lane row products, measured a few
// percent slower).  The terminal L_Pf solve arrives as the last stage.
//
// Kernel 6 (one knot of the lanes_scan forward elimination, JAX
// _fwd_step_kernel) is kernel 2's kernel instantiated for one knot
// (fwd_sweep_group<1, ..., STEP = true>), so the two run one knot body: it
// cp.asyncs P, q and the knot's C, A, B, rnu into a stage of kernel 2's
// layout, P and q where H_t and rz_t go, with the carries Delta and qd zeroed
// (the body's P = H_t + Delta and q = rz_t + qd then read P and q
// unchanged), and writes P_{t+1} = sym(H_{t+1}) + Delta', q_{t+1} =
// rz_{t+1} + qd' to global memory (the JAX scan leaves the terminal
// Cholesky to plain array code, and so does the port).  Its bound at
// B=512, d=15 is ~1 us of bytes a launch; a launch is one knot's chain of
// ~2(d + s) barrier steps, and the carry's round trip through global memory.
//
// Kernel 7 keeps the one-warp-per-instance design (warp_chol_solve_vec,
// bwd_knot): lanes own the rows of the triangular solves' column updates
// and of the products; it is a later PR's redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;  // instances per block of kernel 7, at most

__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }  // bank-conflict-free stride

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

__host__ __device__ inline int bwd_warp_floats(int d, int s, int r) {
  return d * d + s * s + (2 * d + s) * r;
}

// Back substitution of one knot by one warp, one column (the per-knot
// step, kernel 7): from dz_{t+1} in dzn (shared),
//   u = q_t - C dz_{t+1};  v = rnu_t - B dz_{t+1};  x = P^-1 u;
//   y = S^-1 (A x - v);    dz_t = x - X_A y;       nu_t = y,
// written to dzo and nuo; dzn then holds dz_t.
__device__ void bwd_knot(float* Lp, float* Ls, float* dzn, float* xv, float* yv,
                         const float* __restrict__ LPt, const float* __restrict__ LSt,
                         const float* __restrict__ XAt, const float* __restrict__ qt,
                         const float* __restrict__ Ct, const float* __restrict__ At,
                         const float* __restrict__ Bt, const float* __restrict__ rnut, int d,
                         int s, int lane, float* __restrict__ dzo, float* __restrict__ nuo) {
  constexpr int r = 1;
  for (int idx = lane; idx < d * d; idx += 32) Lp[idx] = LPt[idx];
  for (int idx = lane; idx < s * s; idx += 32) Ls[idx] = LSt[idx];
  for (int idx = lane; idx < d * r; idx += 32) {
    const int i = idx / r, c = idx % r;
    float v = qt[idx];
    for (int j = 0; j < d; ++j) v -= Ct[i * d + j] * dzn[j * r + c];
    xv[idx] = v;
  }
  __syncwarp();
  warp_chol_solve_vec(Lp, d, xv, d, lane);
  for (int idx = lane; idx < s * r; idx += 32) {
    const int k = idx / r, c = idx % r;
    float v = -rnut[idx];
    for (int j = 0; j < d; ++j) v += Bt[k * d + j] * dzn[j * r + c] + At[k * d + j] * xv[j * r + c];
    yv[idx] = v;
  }
  __syncwarp();
  warp_chol_solve_vec(Ls, s, yv, s, lane);
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
  bwd_knot(Lp, Ls, dzn, xv, yv, LP + kt * dd, LS + kt * ss, XA + kt * sd, q + kt * d,
           C + kt * dd, A + kt * sd, Bm + kt * sd, rnu + kt * s, d, s, lane,
           dz + (b * T + t) * d, nu + kt * s);
}

// ---- Kernels 2 and 3: a group of G warps per instance ------------------ //

constexpr int kTx = 16;  // tile threads along the columns

// Thread tiles of a group of G warps: thread (ty, tx) = (tid / kTx, tid %
// kTx) owns rows ty + a TR (a < MR) and columns tx + b kTx (b < MC) of a
// block, so blocks of up to MR TR rows and MC kTx columns.
template <int G_, int MR_, int MC_>
struct Grp {
  static constexpr int G = G_, NT = 32 * G_, TR = NT / kTx, MR = MR_, MC = MC_;
};

// The tile shapes each sweep is compiled for, smallest first; a launch
// takes the first whose tiles hold the instance's blocks: the forward
// sweep's rows max(d, s) and columns s + d + r, the backward sweep's rows
// max(d, s) and columns r.  d, s <= 64 and s + d + r <= 144 run.
struct TileCfg {
  int G, MR, MC;
};
constexpr TileCfg kFwdCfg[4] = {{4, 2, 3}, {4, 4, 5}, {8, 3, 7}, {8, 4, 9}};
constexpr TileCfg kBwdCfg[4] = {{4, 2, 1}, {4, 4, 2}, {8, 3, 1}, {8, 4, 9}};

inline int pick_cfg(const TileCfg* cfg, int rows, int cols) {
  for (int i = 0; i < 4; ++i)
    if (rows <= cfg[i].MR * 2 * cfg[i].G && cols <= cfg[i].MC * kTx) return i;
  return -1;
}

__device__ __forceinline__ void group_sync(int bar, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// n floats from global src to shared dst, in flight until cp_async_wait_all.
template <int NT>
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src, int n,
                                           int tid) {
  for (int i = tid; i < n; i += NT) cp_async4(dst + i, src + i);
}

// Threads per block, at most: 8-warp groups run one per block, so that
// they may use up to 255 registers a thread.
__host__ __device__ constexpr int max_block_threads(int G) { return G == 8 ? 256 : 512; }

// Floats of one of the two publish stages of group_chol_solve (a column
// of M, then a row of Y).
__host__ __device__ constexpr int pub_floats(int G, int MR, int MC) {
  return MR * 2 * G + kTx * MC;
}

// Lower Cholesky of the n x n matrix at M (row stride ld), in place, and
// Y <- (L L^T)^-1 Y for the n x nc block Y (row stride ldy), by the group,
// with each thread's tiles of M and Y in registers (rows ty + a TR; columns
// tx + b kTx).  The factorization carries the forward substitution: step j
// eliminates below the pivot in [M | Y] (M_ik -= M_ij M_kj / M_jj, Y_i -=
// M_ij Y_j / M_jj, each thread on its own entries) from column j of M and
// row j of Y, published in one of two shared stages (pub) by their owners
// as soon as step j-1 leaves them final; so row j of Y ends as sqrt(M_jj)
// times the forward solution.  The back substitution then runs on L^T the
// same way, one published row a step: 2(n-1) barrier steps in all, each
// with independent updates of the trailing entries.  M ends holding L
// (upper triangle zeroed), invd[i] = 1 / L_ii.  A negative pivot gives NaN
// through sqrtf, never clamped, and the NaN reaches every row of Y.
template <class Cf>
__device__ __forceinline__ void group_chol_solve(float* M, int ld, float* Y, int ldy, int n,
                                                 int nc, float* invd, float* pub, int tid,
                                                 int bar) {
  constexpr int NT = Cf::NT, TR = Cf::TR, MR = Cf::MR, MC = Cf::MC;
  constexpr int MM = MR * TR / kTx;  // column blocks of M's tile
  constexpr int PC = MR * TR, PW = pub_floats(Cf::G, MR, MC);
  const int ty = tid / kTx, tx = tid % kTx;
  const int nb = (nc + kTx - 1) / kTx;
  float m[MR][MM], y[MR][MC], ik[MR], ci[MR], ck[MM], pv[MC], l[MR];
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int i = ty + a * TR;
#pragma unroll
    for (int b = 0; b < MM; ++b) {
      const int k = tx + b * kTx;
      m[a][b] = (i < n && k <= i) ? M[i * ld + k] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int c = tx + b * kTx;
      y[a][b] = (i < n && c < nc) ? Y[i * ldy + c] : 0.f;
    }
  }
  if (tx == 0)
#pragma unroll
    for (int a = 0; a < MR; ++a) pub[ty + a * TR] = m[a][0];
  if (ty == 0)
#pragma unroll
    for (int b = 0; b < MC; ++b)
      if (b < nb) pub[PC + tx + b * kTx] = y[0][b];
  for (int j = 0; j < n - 1; ++j) {
    const float* pc = pub + (j & 1) * PW;
    float* pn = pub + ((j + 1) & 1) * PW;
    group_sync(bar, NT);
    const float inv = 1.f / pc[j];
#pragma unroll
    for (int a = 0; a < MR; ++a) {
      const int i = ty + a * TR;
      ci[a] = (i > j && i < n) ? pc[i] * inv : 0.f;
    }
#pragma unroll
    for (int b = 0; b < MM; ++b) {
      const int k = tx + b * kTx;
      ck[b] = (k > j && k < n) ? pc[k] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < MC; ++b) pv[b] = b < nb ? pc[PC + tx + b * kTx] : 0.f;
    // entries above the diagonal of M take updates too; they are never read
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int b = 0; b < MM; ++b) m[a][b] -= ci[a] * ck[b];
#pragma unroll
      for (int b = 0; b < MC; ++b) y[a][b] -= ci[a] * pv[b];
    }
#pragma unroll
    for (int b = 0; b < MM; ++b)
      if (tx + b * kTx == j + 1)
#pragma unroll
        for (int a = 0; a < MR; ++a) pn[ty + a * TR] = m[a][b];
#pragma unroll
    for (int a = 0; a < MR; ++a)
      if (ty + a * TR == j + 1)
#pragma unroll
        for (int b = 0; b < MC; ++b)
          if (b < nb) pn[PC + tx + b * kTx] = y[a][b];
  }
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MM; ++b)
      if (ty + a * TR == tx + b * kTx && ty + a * TR < n) invd[ty + a * TR] = 1.f / sqrtf(m[a][b]);
  group_sync(bar, NT);
  // L into M; Y's rows to the forward solution; its last row published
  float* p0 = pub + ((n - 1) & 1) * PW + PC;
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int i = ty + a * TR;
    ik[a] = i < n ? invd[i] : 0.f;
#pragma unroll
    for (int b = 0; b < MM; ++b) {
      const int k = tx + b * kTx;
      if (i < n && k < n)
        M[i * ld + k] = k < i ? m[a][b] * invd[k] : (k == i ? sqrtf(m[a][b]) : 0.f);
    }
#pragma unroll
    for (int b = 0; b < MC; ++b) y[a][b] *= ik[a];
    if (i == n - 1)
#pragma unroll
      for (int b = 0; b < MC; ++b)
        if (b < nb) p0[tx + b * kTx] = y[a][b] * ik[a];
  }
  group_sync(bar, NT);
  // back substitution: step j publishes row n-1-j of the solution; rows
  // that a step must leave alone take l = 0 (their update is exact)
  for (int j = 0; j < n - 1; ++j) {
    const int i = n - 1 - j;
    const float* pr = pub + ((n - 1 + j) & 1) * PW + PC;
    float* pn = pub + ((n + j) & 1) * PW + PC;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
      const int k = ty + a * TR;
      l[a] = k < i ? M[i * ld + k] : 0.f;
    }
    if (j > 0) group_sync(bar, NT);
#pragma unroll
    for (int b = 0; b < MC; ++b) pv[b] = b < nb ? pr[tx + b * kTx] : 0.f;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int b = 0; b < MC; ++b) y[a][b] -= l[a] * pv[b];
      if (ty + a * TR == i - 1)
#pragma unroll
        for (int b = 0; b < MC; ++b)
          if (b < nb) pn[tx + b * kTx] = y[a][b] * ik[a];
    }
  }
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int i = ty + a * TR, c = tx + b * kTx;
      if (i < n && c < nc) Y[i * ldy + c] = y[a][b] * ik[a];
    }
  group_sync(bar, NT);
}

// In place Y <- (L L^T)^-1 Y for the n x nc block Y (row stride ldy) by the
// group, against a given factor L (invd[i] = 1 / L_ii), with each thread's
// tile of Y in registers.  Forward step i updates the rows below row i
// from row i, published (scaled by invd[i]) in one of two shared rows
// (prow) by its owner, who publishes row i+1 in the other as soon as its
// own update of it is done; backward steps run the other way.  2n
// barriers, each step (n - i) x nc independent updates.
template <class Cf>
__device__ __forceinline__ void group_llt_solve(const float* L, int ldl, const float* invd,
                                                 float* Y, int ldy, int n, int nc, float* prow,
                                                 int tid, int bar) {
  constexpr int NT = Cf::NT, TR = Cf::TR, MR = Cf::MR, MC = Cf::MC;
  constexpr int PW = pub_floats(Cf::G, MR, MC);
  const int ty = tid / kTx, tx = tid % kTx;
  const int nb = (nc + kTx - 1) / kTx;
  float y[MR][MC], ik[MR], pv[MC], l[MR];
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int i = ty + a * TR;
    ik[a] = i < n ? invd[i] : 0.f;
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int c = tx + b * kTx;
      y[a][b] = (i < n && c < nc) ? Y[i * ldy + c] : 0.f;
    }
  }
  if (ty == 0)
#pragma unroll
    for (int b = 0; b < MC; ++b)
      if (b < nb) prow[tx + b * kTx] = y[0][b] * ik[0];
  // rows that a step must leave alone take l = 0 (their update is exact)
  for (int i = 0; i < n; ++i) {
    const float* pr = prow + (i & 1) * PW;
    float* pn = prow + ((i + 1) & 1) * PW;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
      const int k = ty + a * TR;
      l[a] = (k > i && k < n) ? L[k * ldl + i] : 0.f;
    }
    group_sync(bar, NT);
#pragma unroll
    for (int b = 0; b < MC; ++b) pv[b] = b < nb ? pr[tx + b * kTx] : 0.f;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int b = 0; b < MC; ++b) y[a][b] -= l[a] * pv[b];
      if (ty + a * TR == i + 1 && i + 1 < n)
#pragma unroll
        for (int b = 0; b < MC; ++b)
          if (b < nb) pn[tx + b * kTx] = y[a][b] * ik[a];
    }
  }
  // forward result: rows scaled; row n-1 published for the backward steps
  float* p0 = prow + (n & 1) * PW;
#pragma unroll
  for (int a = 0; a < MR; ++a) {
#pragma unroll
    for (int b = 0; b < MC; ++b) y[a][b] *= ik[a];
    if (ty + a * TR == n - 1)
#pragma unroll
      for (int b = 0; b < MC; ++b)
        if (b < nb) p0[tx + b * kTx] = y[a][b] * ik[a];
  }
  for (int j = 0; j < n; ++j) {
    const int i = n - 1 - j;
    const float* pr = prow + ((n + j) & 1) * PW;
    float* pn = prow + ((n + j + 1) & 1) * PW;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
      const int k = ty + a * TR;
      l[a] = k < i ? L[i * ldl + k] : 0.f;
    }
    group_sync(bar, NT);
#pragma unroll
    for (int b = 0; b < MC; ++b) pv[b] = b < nb ? pr[tx + b * kTx] : 0.f;
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int b = 0; b < MC; ++b) y[a][b] -= l[a] * pv[b];
      if (ty + a * TR == i - 1)
#pragma unroll
        for (int b = 0; b < MC; ++b)
          if (b < nb) pn[tx + b * kTx] = y[a][b] * ik[a];
    }
  }
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int i = ty + a * TR, c = tx + b * kTx;
      if (i < n && c < nc) Y[i * ldy + c] = y[a][b] * ik[a];
    }
  group_sync(bar, NT);
}

// acc[a][b] += sum_k A(i, k) X(k, c), k < kd, over the thread's tile (i =
// ty + a TR, c = tx + b kTx), with A(i, k) = A[i ai + k ak] and X(k, c) =
// X[k ldx + c]: a register-tiled product, MR + MC shared loads per MR MC
// FMAs.  Rows past nr and columns past nc read row or column 0 and must
// not be stored.
template <class Cf>
__device__ __forceinline__ void tile_mm(float (&acc)[Cf::MR][Cf::MC], const float* A, int ai,
                                        int ak, const float* X, int ldx, int nr, int nc, int kd,
                                        int tid) {
  constexpr int TR = Cf::TR, MR = Cf::MR, MC = Cf::MC;
  const int ty = tid / kTx, tx = tid % kTx;
  int ia[MR], cb[MC];
#pragma unroll
  for (int a = 0; a < MR; ++a) ia[a] = (ty + a * TR < nr ? ty + a * TR : 0) * ai;
#pragma unroll
  for (int b = 0; b < MC; ++b) cb[b] = tx + b * kTx < nc ? tx + b * kTx : 0;
#pragma unroll 4
  for (int k = 0; k < kd; ++k) {
    float av[MR], xv[MC];
#pragma unroll
    for (int a = 0; a < MR; ++a) av[a] = A[ia[a] + k * ak];
#pragma unroll
    for (int b = 0; b < MC; ++b) xv[b] = X[k * ldx + cb[b]];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < MC; ++b) acc[a][b] += av[a] * xv[b];
  }
}

template <class Cf>
__device__ __forceinline__ void tile_zero(float (&acc)[Cf::MR][Cf::MC]) {
#pragma unroll
  for (int a = 0; a < Cf::MR; ++a)
#pragma unroll
    for (int b = 0; b < Cf::MC; ++b) acc[a][b] = 0.f;
}

// y <- (L L^T)^-1 y for one column of length n <= 64 by one warp, written
// to out (shared or global): lane l holds rows l and l + 32 in registers,
// and each step broadcasts the solved entry by a shuffle, so the chain is
// 2n shuffles with no barrier and no shared-memory round trip.
__device__ void warp_solve_vec(const float* L, int ld, const float* invd, const float* y, int n,
                               int lane, float* out) {
  const int l1 = lane + 32;
  float y0 = lane < n ? y[lane] : 0.f, y1 = l1 < n ? y[l1] : 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float xi = __shfl_sync(0xffffffffu, i < 32 ? y0 : y1, i & 31) * invd[i];
    if (lane == i) y0 = xi;
    if (l1 == i) y1 = xi;
    if (lane > i && lane < n) y0 -= L[lane * ld + i] * xi;
    if (l1 > i && l1 < n) y1 -= L[l1 * ld + i] * xi;
  }
#pragma unroll 4
  for (int i = n - 1; i >= 0; --i) {
    const float xi = __shfl_sync(0xffffffffu, i < 32 ? y0 : y1, i & 31) * invd[i];
    if (lane == i) y0 = xi;
    if (l1 == i) y1 = xi;
    if (lane < i) y0 -= L[i * ld + lane] * xi;
    if (l1 < i) y1 -= L[i * ld + l1] * xi;
  }
  if (lane < n) out[lane] = y0;
  if (l1 < n) out[l1] = y1;
}

// sum_k M[o ld + k] v[k] over k < n by kParts consecutive lanes, each
// taking every kParts-th k, reduced by shuffles.  Every lane of the warp
// must call it (the shuffles take the whole warp).
constexpr int kParts = 4;

__device__ __forceinline__ float part_dot(const float* M, int ld, int o, const float* v, int n,
                                          int part) {
  float acc = 0.f;
  for (int k = part; k < n; k += kParts) acc += M[o * ld + k] * v[k];
#pragma unroll
  for (int w = kParts / 2; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  return acc;
}

// One prefetch stage of the forward sweep: knot t's H, C, A, B, rz, rnu at
// these offsets (the terminal stage holds only H and rz).
__host__ __device__ inline int fwd_stage_floats(int d, int s, int r) {
  return 2 * d * d + 2 * s * d + (d + s) * r;
}

// Shared memory of one instance of the forward sweep (kernels 2 and 6),
// floats.
__host__ __device__ inline int fwd_group_floats(int d, int s, int r, int pw) {
  const int ldd = odd(d), nc = s + d + r;
  return 2 * d * ldd + d * nc + s * odd(nc) + s * (d + r) + 2 * d * r + d + s + 2 * pw +
         2 * fwd_stage_floats(d, s, r);
}

// Starts the copies of knot t (t = T-1: the terminal H and rz) into stage st.
template <int NT>
__device__ void fwd_prefetch(float* st, const float* __restrict__ H, const float* __restrict__ C,
                             const float* __restrict__ A, const float* __restrict__ Bm,
                             const float* __restrict__ rz, const float* __restrict__ rnu, long b,
                             int T, int t, int d, int s, int r, int tid) {
  const long dd = (long)d * d, sd = (long)s * d;
  copy_async<NT>(st, H + (b * T + t) * dd, d * d, tid);
  copy_async<NT>(st + 2 * dd + 2 * sd, rz + (b * T + t) * d * r, d * r, tid);
  if (t < T - 1) {
    const long kt = b * (T - 1) + t;
    copy_async<NT>(st + dd, C + kt * dd, d * d, tid);
    copy_async<NT>(st + 2 * dd, A + kt * sd, s * d, tid);
    copy_async<NT>(st + 2 * dd + sd, Bm + kt * sd, s * d, tid);
    copy_async<NT>(st + 2 * dd + 2 * sd + d * r, rnu + kt * s * r, s * r, tid);
  }
  cp_async_commit();
}

// Kernel 6's own buffers: the carry P (B,d,d), q (B,d) in, Pn, qn out, and
// its knot t.  Kernel 2 passes none.
struct StepIO {
  const float* P;
  const float* q;
  float* Pn;
  float* qn;
  int t;
};

// Kernel 2 (STEP = false): the forward elimination and the terminal block,
// a group of G warps per instance, several groups per block, each on its
// own named barrier (1 + its index).  Knot t+1's blocks are copied into the
// second stage while knot t computes.
// Kernel 6 (STEP = true, one column): the same kernel for the one knot
// step.t of the lanes_scan elimination, so both run one knot body.  The
// carry P and q are staged where H_t and rz_t go, with Delta and qd zero,
// so the body's P = H_t + Delta and q = rz_t + qd read them unchanged; H and
// rz of knot t+1 go to the second stage, and it writes P' = sym(H_{t+1}) +
// Delta' and q' = rz_{t+1} + qd' to Pn and qn where kernel 2 runs its
// terminal block.  (The body as a __device__ function that two kernels
// call compiled kernel 2 differently at d=15, where it runs at the
// 128-register cap of 512-thread blocks, and made it up to 9% slower.)
template <int R, int G, int MR_, int MC_, bool STEP>
__global__ void __launch_bounds__(max_block_threads(G), 1)
    fwd_sweep_group(const float* __restrict__ H, const float* __restrict__ C,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ rz, const float* __restrict__ rnu, int Bn, int T,
                    int d, int s, int r_arg, float delta_c, float* __restrict__ LP,
                    float* __restrict__ LS, float* __restrict__ XA, float* __restrict__ q,
                    float* __restrict__ dz, float* __restrict__ Gk, float* __restrict__ LPf,
                    StepIO step) {
  extern __shared__ float smem[];
  using Cf = Grp<G, MR_, MC_>;
  constexpr int NT = Cf::NT, TR = Cf::TR, MR = Cf::MR, MC = Cf::MC;
  constexpr int PW = pub_floats(G, MR, MC);
  const int r = R > 0 ? R : r_arg;
  const int grp = threadIdx.x / NT, tid = threadIdx.x % NT, bar = 1 + grp;
  const long b = (long)blockIdx.x * (blockDim.x / NT) + grp;
  if (b >= Bn) return;  // no other group waits on this group's barrier
  const int ty = tid / kTx, tx = tid % kTx;
  const int ldd = odd(d), nc = s + d + r, ldm = odd(nc), dr1 = d + r, sd0 = s + d;
  float* Lm = smem + grp * fwd_group_floats(d, s, r, PW);  // P, then L_P   d x ldd
  float* Dl = Lm + d * ldd;                                // Delta carry   d x ldd
  float* W = Dl + d * ldd;                                 // [X_A|X_C|x]   d x nc
  float* Mm = W + d * nc;                                  // [S->L_S|G|r]  s x ldm
  float* SG = Mm + s * ldm;                                // S^-1 [G|y]    s x (d+r)
  float* qd = SG + s * dr1;                                // qd carry      d x r
  float* qv = qd + d * r;                                  // terminal rhs  d x r
  float* invP = qv + d * r;                                // 1 / diag L_P
  float* invS = invP + d;                                  // 1 / diag L_S
  float* prow = invS + s;                                  // 2 x PW
  float* stage0 = prow + 2 * PW;
  const int stf = fwd_stage_floats(d, s, r);

  for (int idx = tid; idx < d * d; idx += NT) Dl[(idx / d) * ldd + idx % d] = 0.f;
  for (int i = tid; i < d * r; i += NT) qd[i] = 0.f;

  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s, dr = (long)d * r;
  int t_first = 0, t_end = T - 1;  // the knots this launch eliminates
  if constexpr (STEP) {
    t_first = step.t;
    t_end = step.t + 1;
    const long kt = b * (T - 1) + step.t;
    copy_async<NT>(stage0, step.P + b * dd, d * d, tid);
    copy_async<NT>(stage0 + dd, C + kt * dd, d * d, tid);
    copy_async<NT>(stage0 + 2 * dd, A + kt * sd, s * d, tid);
    copy_async<NT>(stage0 + 2 * dd + sd, Bm + kt * sd, s * d, tid);
    copy_async<NT>(stage0 + 2 * dd + 2 * sd, step.q + b * d, d, tid);
    copy_async<NT>(stage0 + 2 * dd + 2 * sd + d, rnu + kt * s, s, tid);
    copy_async<NT>(stage0 + stf, H + (b * T + step.t + 1) * dd, d * d, tid);
    copy_async<NT>(stage0 + stf + 2 * dd + 2 * sd, rz + (b * T + step.t + 1) * d, d, tid);
    cp_async_commit();
  } else {
    fwd_prefetch<NT>(stage0, H, C, A, Bm, rz, rnu, b, T, 0, d, s, r, tid);
  }

  for (int t = t_first; t < t_end; ++t) {
    cp_async_wait_all();
    group_sync(bar, NT);
    if constexpr (!STEP)
      fwd_prefetch<NT>(stage0 + ((t + 1) & 1) * stf, H, C, A, Bm, rz, rnu, b, T, t + 1, d, s, r,
                       tid);
    const float* Hs = STEP ? stage0 : stage0 + (t & 1) * stf;
    const float* Cs = Hs + dd;
    const float* As = Cs + dd;
    const float* Bs = As + sd;
    const float* rzs = Bs + sd;
    const float* rnus = rzs + dr;
    const long kt = b * (T - 1) + t;
    // P = H_t + Delta;  W = [A^T | C | q],  q = rz_t + qd
    for (int idx = tid; idx < d * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      Lm[i * ldd + j] = Hs[idx] + Dl[i * ldd + j];
    }
    for (int idx = tid; idx < d * sd0; idx += NT) {
      const int i = idx / sd0, c = idx % sd0;
      W[i * nc + c] = c < s ? As[c * d + i] : Cs[i * d + (c - s)];
    }
    for (int idx = tid; idx < d * r; idx += NT) {
      const float v = rzs[idx] + qd[idx];
      W[(idx / r) * nc + sd0 + idx % r] = v;
      q[kt * dr + idx] = v;
    }
    group_sync(bar, NT);
    group_chol_solve<Cf>(Lm, ldd, W, nc, d, nc, invP, prow, tid, bar);
    // [S | G | r] = A [X_A | X_C | x] + [delta_c I | -B | -rnu_t]
    {
      float acc[MR][MC];
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, As, d, 1, W, nc, s, nc, d, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, c = tx + bb * kTx;
          if (i < s && c < nc) {
            float v = acc[a][bb];
            if (c < s) {
              if (c == i) v += delta_c;
            } else if (c < sd0) {
              v -= Bs[i * d + (c - s)];
            } else {
              v -= rnus[i * r + (c - sd0)];
            }
            Mm[i * ldm + c] = v;
            if (c >= s) SG[i * dr1 + (c - s)] = v;
          }
        }
    }
    group_sync(bar, NT);
    group_chol_solve<Cf>(Mm, ldm, SG, dr1, s, dr1, invS, prow, tid, bar);
    // [Delta' | qd'] = G^T S^-1 [G | y] - C^T [X_C | x]  (Delta' unsymmetrized)
    {
      float acc[MR][MC];
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, Mm + s, 1, ldm, SG, dr1, d, dr1, s, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) acc[a][bb] = -acc[a][bb];
      tile_mm<Cf>(acc, Cs, 1, d, W + s, nc, d, dr1, d, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, j = tx + bb * kTx;
          if (i < d && j < dr1) {
            if (j < d) {
              Dl[i * ldd + j] = -acc[a][bb];
            } else {
              qd[i * r + (j - d)] = -acc[a][bb];
            }
          }
        }
    }
    group_sync(bar, NT);
    for (int idx = tid; idx < d * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      if (j > i) {
        const float v = 0.5f * (Dl[i * ldd + j] + Dl[j * ldd + i]);
        Dl[i * ldd + j] = v;
        Dl[j * ldd + i] = v;
      }
      LP[kt * dd + idx] = Lm[i * ldd + j];
    }
    for (int idx = tid; idx < s * s; idx += NT) LS[kt * ss + idx] = Mm[(idx / s) * ldm + idx % s];
    for (int idx = tid; idx < d * s; idx += NT) XA[kt * sd + idx] = W[(idx / s) * nc + idx % s];
    if (Gk)  // G = A X_C - B, still in Mm's columns s..s+d-1
      for (int idx = tid; idx < s * d; idx += NT)
        Gk[kt * sd + idx] = Mm[(idx / d) * ldm + s + idx % d];
  }
  if constexpr (STEP) {
    // P' = sym(H_{t+1}) + Delta',  q' = rz_{t+1} + qd'
    group_sync(bar, NT);
    const float* Hn = stage0 + stf;
    const float* rzn = Hn + 2 * dd + 2 * sd;
    for (int idx = tid; idx < d * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      step.Pn[b * dd + idx] = 0.5f * (Hn[i * d + j] + Hn[j * d + i]) + Dl[i * ldd + j];
    }
    for (int i = tid; i < d; i += NT) step.qn[b * d + i] = rzn[i] + qd[i];
  } else {
    // terminal block: P_f = sym(H_{T-1} + Delta), dz_{T-1} = P_f^-1 (rz_{T-1} + qd)
    cp_async_wait_all();
    group_sync(bar, NT);
    const float* Hf = stage0 + ((T - 1) & 1) * stf;
    const float* rzf = Hf + 2 * dd + 2 * sd;
    for (int idx = tid; idx < d * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      Lm[i * ldd + j] =
          0.5f * ((Hf[i * d + j] + Dl[i * ldd + j]) + (Hf[j * d + i] + Dl[j * ldd + i]));
    }
    for (int i = tid; i < d * r; i += NT) qv[i] = rzf[i] + qd[i];
    group_sync(bar, NT);
    group_chol_solve<Cf>(Lm, ldd, qv, r, d, r, invP, prow, tid, bar);
    if (LPf)
      for (int idx = tid; idx < d * d; idx += NT) LPf[b * dd + idx] = Lm[(idx / d) * ldd + idx % d];
    for (int i = tid; i < d * r; i += NT) dz[(b * T + T - 1) * dr + i] = qv[i];
  }
}

// One prefetch stage of the backward sweep: knot t's L_P, L_S, X_A, q, C,
// A, B, rnu at these offsets.
__host__ __device__ inline int bwd_stage_floats(int d, int s, int r) {
  return 2 * d * d + s * s + 3 * s * d + (d + s) * r;
}

// Shared memory of one instance of the backward sweep, floats.
__host__ __device__ inline int bwd_group_floats(int d, int s, int r, int pw) {
  return 2 * (d + s) * r + d + s + 2 * pw + 2 * bwd_stage_floats(d, s, r);
}

template <int NT>
__device__ void bwd_prefetch(float* st, const float* __restrict__ LP,
                             const float* __restrict__ LS, const float* __restrict__ XA,
                             const float* __restrict__ q, const float* __restrict__ C,
                             const float* __restrict__ A, const float* __restrict__ Bm,
                             const float* __restrict__ rnu, long kt, int d, int s, int r,
                             int tid) {
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  copy_async<NT>(st, LP + kt * dd, d * d, tid);
  copy_async<NT>(st + dd, LS + kt * ss, s * s, tid);
  copy_async<NT>(st + dd + ss, XA + kt * sd, d * s, tid);
  copy_async<NT>(st + dd + ss + sd, q + kt * d * r, d * r, tid);
  copy_async<NT>(st + dd + ss + sd + d * r, C + kt * dd, d * d, tid);
  copy_async<NT>(st + 2 * dd + ss + sd + d * r, A + kt * sd, s * d, tid);
  copy_async<NT>(st + 2 * dd + ss + 2 * sd + d * r, Bm + kt * sd, s * d, tid);
  copy_async<NT>(st + 2 * dd + ss + 3 * sd + d * r, rnu + kt * s * r, s * r, tid);
  cp_async_commit();
}

// Kernel 3: the back substitution, a group of G warps per instance, knot
// t-1's blocks (none of which depends on the carry dz_{t+1}) copied into
// the second stage while knot t computes.  One column: the triangular
// solves run on one warp (warp_solve_vec), the matrix-vector products on
// the group (kParts lanes per output); r columns: group_llt_solve and
// tiled products.
template <int R, int G, int MR_, int MC_>
__global__ void __launch_bounds__(max_block_threads(G), 1)
    bwd_sweep_group(const float* __restrict__ LP, const float* __restrict__ LS,
                    const float* __restrict__ XA, const float* __restrict__ q,
                    const float* __restrict__ C, const float* __restrict__ A,
                    const float* __restrict__ Bm, const float* __restrict__ rnu, int Bn, int T,
                    int d, int s, int r_arg, float* __restrict__ dz, float* __restrict__ nu) {
  extern __shared__ float smem[];
  using Cf = Grp<G, MR_, MC_>;
  constexpr int NT = Cf::NT, TR = Cf::TR, MR = Cf::MR, MC = Cf::MC;
  constexpr int PW = pub_floats(G, MR, MC);
  const int r = R > 0 ? R : r_arg;
  const int grp = threadIdx.x / NT, tid = threadIdx.x % NT, bar = 1 + grp;
  const long b = (long)blockIdx.x * (blockDim.x / NT) + grp;
  if (b >= Bn) return;  // no other group waits on this group's barrier
  const int ty = tid / kTx, tx = tid % kTx, lane = tid % 32, part = tid % kParts;
  float* dzn = smem + grp * bwd_group_floats(d, s, r, PW);  // dz_{t+1}, then dz_t  d x r
  float* xv = dzn + d * r;                                  // u, then x          d x r
  float* yv = xv + d * r;                                   // y                  s x r
  float* vv = yv + s * r;                                   // B dz_{t+1} - rnu_t s x r
  float* invP = vv + s * r;
  float* invS = invP + d;
  float* prow = invS + s;
  float* stage0 = prow + 2 * PW;
  const int stf = bwd_stage_floats(d, s, r);
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  const long dr = (long)d * r, sr = (long)s * r;

  for (int i = tid; i < d * r; i += NT) dzn[i] = dz[(b * T + T - 1) * dr + i];
  bwd_prefetch<NT>(stage0, LP, LS, XA, q, C, A, Bm, rnu, b * (T - 1) + T - 2, d, s, r, tid);
  for (int t = T - 2, st = 0; t >= 0; --t, ++st) {
    cp_async_wait_all();
    group_sync(bar, NT);
    const long kt = b * (T - 1) + t;
    if (t > 0)
      bwd_prefetch<NT>(stage0 + ((st + 1) & 1) * stf, LP, LS, XA, q, C, A, Bm, rnu, kt - 1, d, s,
                       r, tid);
    const float* Lp = stage0 + (st & 1) * stf;
    const float* Ls = Lp + dd;
    const float* Xa = Ls + ss;
    const float* qs = Xa + sd;
    const float* Cs = qs + dr;
    const float* As = Cs + dd;
    const float* Bs = As + sd;
    const float* rnus = Bs + sd;
    float* dzo = dz + (b * T + t) * dr;
    float* nuo = nu + kt * sr;
    for (int i = tid; i < d; i += NT) invP[i] = 1.f / Lp[i * d + i];
    for (int i = tid; i < s; i += NT) invS[i] = 1.f / Ls[i * s + i];
    if (R == 1) {
      // u = q_t - C dz_{t+1} (into xv) and B dz_{t+1} - rnu_t (into vv)
      for (int o0 = 0; o0 < d + s; o0 += NT / kParts) {
        const int o = o0 + tid / kParts;
        const int oc = o < d + s ? o : 0;
        const bool isc = oc < d;
        const float v = part_dot(isc ? Cs : Bs, d, isc ? oc : oc - d, dzn, d, part);
        if (o < d + s && part == 0) {
          if (isc) {
            xv[oc] = qs[oc] - v;
          } else {
            vv[oc - d] = v - rnus[oc - d];
          }
        }
      }
      group_sync(bar, NT);
      if (tid < 32) warp_solve_vec(Lp, d, invP, xv, d, lane, xv);  // x = P^-1 u
      group_sync(bar, NT);
      for (int o0 = 0; o0 < s; o0 += NT / kParts) {  // A x - v
        const int o = o0 + tid / kParts;
        const float v = part_dot(As, d, o < s ? o : 0, xv, d, part);
        if (o < s && part == 0) yv[o] = vv[o] + v;
      }
      group_sync(bar, NT);
      if (tid < 32) warp_solve_vec(Ls, s, invS, yv, s, lane, yv);  // y = S^-1 (A x - v)
      group_sync(bar, NT);
      for (int i = tid; i < s; i += NT) nuo[i] = yv[i];
      for (int o0 = 0; o0 < d; o0 += NT / kParts) {  // dz_t = x - X_A y
        const int o = o0 + tid / kParts;
        const float v = part_dot(Xa, s, o < d ? o : 0, yv, s, part);
        if (o < d && part == 0) {
          const float z = xv[o] - v;
          dzn[o] = z;
          dzo[o] = z;
        }
      }
    } else {
      float acc[MR][MC];
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, Cs, d, 1, dzn, r, d, r, d, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, c = tx + bb * kTx;
          if (i < d && c < r) xv[i * r + c] = qs[i * r + c] - acc[a][bb];
        }
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, Bs, d, 1, dzn, r, s, r, d, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, c = tx + bb * kTx;
          if (i < s && c < r) vv[i * r + c] = acc[a][bb] - rnus[i * r + c];
        }
      group_sync(bar, NT);
      group_llt_solve<Cf>(Lp, d, invP, xv, r, d, r, prow, tid, bar);
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, As, d, 1, xv, r, s, r, d, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, c = tx + bb * kTx;
          if (i < s && c < r) yv[i * r + c] = vv[i * r + c] + acc[a][bb];
        }
      group_sync(bar, NT);
      group_llt_solve<Cf>(Ls, s, invS, yv, r, s, r, prow, tid, bar);
      for (int i = tid; i < s * r; i += NT) nuo[i] = yv[i];
      tile_zero<Cf>(acc);
      tile_mm<Cf>(acc, Xa, s, 1, yv, r, d, r, s, tid);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int bb = 0; bb < MC; ++bb) {
          const int i = ty + a * TR, c = tx + bb * kTx;
          if (i < d && c < r) {
            const float z = xv[i * r + c] - acc[a][bb];
            dzn[i * r + c] = z;
            dzo[i * r + c] = z;
          }
        }
    }
  }
}

// One prefetch stage of the rhs-only forward sweep: knot t's L_P, L_S, G,
// C, A, rz, rnu at these offsets (the terminal stage: L_Pf in L_P's place,
// and rz_{T-1}).
__host__ __device__ inline int rhs_stage_floats(int d, int s) {
  return 2 * d * d + s * s + 2 * s * d + d + s;
}

// Shared memory of one instance of the rhs-only forward sweep, floats:
// qd, x, C^T x, 1 / diag L_P (d each), y, 1 / diag L_S (s each), two stages.
__host__ __device__ inline int rhs_group_floats(int d, int s) {
  return 4 * d + 2 * s + 2 * rhs_stage_floats(d, s);
}

// Warps per instance of kernel 4, as kernel 3 picks them for one column.
__host__ __device__ inline int rhs_group_warps(int d, int s) { return d > 32 || s > 32 ? 8 : 4; }

// Starts the copies of knot t (t = T-1: L_Pf and rz_{T-1}) into stage st.
template <int NT>
__device__ void rhs_prefetch(float* st, const float* __restrict__ LP, const float* __restrict__ LS,
                             const float* __restrict__ Gk, const float* __restrict__ C,
                             const float* __restrict__ A, const float* __restrict__ rz,
                             const float* __restrict__ rnu, const float* __restrict__ LPf, long b,
                             int T, int t, int d, int s, int tid) {
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;
  if (t < T - 1) {
    const long kt = b * (T - 1) + t;
    copy_async<NT>(st, LP + kt * dd, d * d, tid);
    copy_async<NT>(st + dd, LS + kt * ss, s * s, tid);
    copy_async<NT>(st + dd + ss, Gk + kt * sd, s * d, tid);
    copy_async<NT>(st + dd + ss + sd, C + kt * dd, d * d, tid);
    copy_async<NT>(st + 2 * dd + ss + sd, A + kt * sd, s * d, tid);
    copy_async<NT>(st + 2 * dd + ss + 2 * sd + d, rnu + kt * s, s, tid);
  } else {
    copy_async<NT>(st, LPf + b * dd, d * d, tid);
  }
  copy_async<NT>(st + 2 * dd + ss + 2 * sd, rz + (b * T + t) * d, d, tid);
  cp_async_commit();
}

// Kernel 4: the rhs-only forward sweep against kept factors, one column, a
// group of G warps per instance on its own named barrier; knot t+1's blocks
// (last, L_Pf and rz_{T-1}) are copied into the second stage while knot t
// computes.  A knot, with the carry qd in shared memory:
//   warp 0: q = rz_t + qd (written out), x = L_P^-T L_P^-1 q;  the others: 1 / diag L_S
//   group:  y = A x - rnu_t, kParts lanes per row
//   warp 0: y = L_S^-T L_S^-1 y;                             the others: C^T x
//   group:  qd' = G^T y - C^T x
// then warp 0 solves dz_{T-1} = L_Pf^-T L_Pf^-1 (rz_{T-1} + qd).
template <int G>
__global__ void __launch_bounds__(max_block_threads(G), 1)
    rhs_fwd_sweep_group(const float* __restrict__ LP, const float* __restrict__ LS,
                        const float* __restrict__ Gk, const float* __restrict__ C,
                        const float* __restrict__ A, const float* __restrict__ rz,
                        const float* __restrict__ rnu, const float* __restrict__ LPf, int Bn,
                        int T, int d, int s, float* __restrict__ q, float* __restrict__ dz) {
  extern __shared__ float smem[];
  constexpr int NT = 32 * G, NR = NT - 32;  // NR: the threads beside warp 0
  const int grp = threadIdx.x / NT, tid = threadIdx.x % NT, bar = 1 + grp;
  const long b = (long)blockIdx.x * (blockDim.x / NT) + grp;
  if (b >= Bn) return;  // no other group waits on this group's barrier
  const int lane = tid % 32, part = tid % kParts;
  float* qd = smem + grp * rhs_group_floats(d, s);  // qd carry
  float* xv = qd + d;                               // q, then x
  float* cx = xv + d;                               // C^T x
  float* invP = cx + d;                             // 1 / diag L_P (L_Pf)
  float* yv = invP + d;                             // A x - rnu_t, then y
  float* invS = yv + s;                             // 1 / diag L_S
  float* stage0 = invS + s;
  const int stf = rhs_stage_floats(d, s);
  const long dd = (long)d * d, sd = (long)s * d, ss = (long)s * s;

  for (int i = tid; i < d; i += NT) qd[i] = 0.f;
  rhs_prefetch<NT>(stage0, LP, LS, Gk, C, A, rz, rnu, LPf, b, T, 0, d, s, tid);
  for (int t = 0; t < T - 1; ++t) {
    cp_async_wait_all();
    group_sync(bar, NT);
    rhs_prefetch<NT>(stage0 + ((t + 1) & 1) * stf, LP, LS, Gk, C, A, rz, rnu, LPf, b, T, t + 1,
                     d, s, tid);
    const float* Lp = stage0 + (t & 1) * stf;
    const float* Ls = Lp + dd;
    const float* Gs = Ls + ss;
    const float* Cs = Gs + sd;
    const float* As = Cs + dd;
    const float* rzs = As + sd;
    const float* rnus = rzs + d;
    const long kt = b * (T - 1) + t;
    if (tid < 32) {
      for (int i = lane; i < d; i += 32) {
        invP[i] = 1.f / Lp[i * d + i];
        const float v = rzs[i] + qd[i];
        q[kt * d + i] = v;
        xv[i] = v;
      }
      __syncwarp();
      warp_solve_vec(Lp, d, invP, xv, d, lane, xv);
    } else {
      for (int i = tid - 32; i < s; i += NR) invS[i] = 1.f / Ls[i * s + i];
    }
    group_sync(bar, NT);
    for (int o0 = 0; o0 < s; o0 += NT / kParts) {
      const int o = o0 + tid / kParts;
      const float v = part_dot(As, d, o < s ? o : 0, xv, d, part);
      if (o < s && part == 0) yv[o] = v - rnus[o];
    }
    group_sync(bar, NT);
    if (tid < 32) {
      warp_solve_vec(Ls, s, invS, yv, s, lane, yv);
    } else {  // column products: neighbouring threads on neighbouring columns
      for (int i = tid - 32; i < d; i += NR) {
        float v = 0.f;
        for (int k = 0; k < d; ++k) v += Cs[k * d + i] * xv[k];
        cx[i] = v;
      }
    }
    group_sync(bar, NT);
    for (int i = tid; i < d; i += NT) {
      float v = 0.f;
      for (int k = 0; k < s; ++k) v += Gs[k * d + i] * yv[k];
      qd[i] = v - cx[i];
    }
  }
  cp_async_wait_all();
  group_sync(bar, NT);
  if (tid < 32) {
    const float* Lf = stage0 + ((T - 1) & 1) * stf;
    const float* rzf = Lf + 2 * dd + ss + 2 * sd;
    for (int i = lane; i < d; i += 32) {
      invP[i] = 1.f / Lf[i * d + i];
      xv[i] = rzf[i] + qd[i];
    }
    __syncwarp();
    warp_solve_vec(Lf, d, invP, xv, d, lane, dz + (b * T + T - 1) * d);
  }
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

// Lets `kernel` use `smem` bytes of dynamic shared memory.  `opted` is the
// kernel's largest setting so far, per device, so the attribute is set
// only when a launch needs more.  False when the device refuses.
template <typename Kernel>
bool opt_in(Kernel kernel, int smem, int* opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& set = opted[dev & 15];
  if (smem > 48 * 1024 && smem > set) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess)
      return false;
    set = smem;
  }
  return true;
}

// Warps per block for a kernel needing `warp_bytes` of shared memory per
// warp: as many as fit, at most kMaxWarps, and no more than it takes to
// give every SM one warp first.  Returns 0 when not even one fits.
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
  return opt_in(kernel, *smem, opted) ? w : 0;
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

// Instances per block for the group kernels 2, 3, 4, 6 (a group of nt threads and
// `group_bytes` of shared memory each): as many as fit the block's shared
// memory, at most max_block_threads and 15 groups (named barriers 1..15), and no
// more than it takes to give every SM one group first.  Returns 0 when
// not even one fits.
int group_config(int group_bytes, int nt, int Bn, int* smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DevInfo di = dev_info(dev);
  const int fit = di.cap / group_bytes;
  if (fit < 1) return 0;
  int g = (Bn + di.sms - 1) / di.sms;
  g = g < 1 ? 1 : g;
  g = g < fit ? g : fit;
  g = g < max_block_threads(nt / 32) / nt ? g : max_block_threads(nt / 32) / nt;
  g = g < 15 ? g : 15;
  *smem = g * group_bytes;
  return g;
}

// Launches a group kernel with `nt` threads and `group_floats` floats of
// shared memory per instance; `opted` as in opt_in.
template <typename Kernel, typename... Args>
int launch_group(Kernel kernel, int group_floats, int nt, int Bn, int* opted, void* stream,
                 Args... args) {
  int smem = 0;
  const int g = group_config(group_floats * (int)sizeof(float), nt, Bn, &smem);
  if (g == 0 || !opt_in(kernel, smem, opted)) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(Bn + g - 1) / g, nt * g, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// What a group kernel launches with for these shapes: its instantiation
// (an index into kFwdCfg or kBwdCfg; for kernel 4, 0 for 4 warps and 1 for
// 8), threads per instance and shared floats per instance; cfg = -1 where
// the launcher refuses the shapes.  The launchers and qct_kkt_sweep_config
// both read it.
struct GroupShape {
  int cfg, nt, floats;
};

GroupShape fwd_shape(int d, int s, int r) {  // kernel 2
  const int i = pick_cfg(kFwdCfg, d > s ? d : s, s + d + r);
  if (i < 0) return {-1, 0, 0};
  const TileCfg c = kFwdCfg[i];
  return {i, 32 * c.G, fwd_group_floats(d, s, r, pub_floats(c.G, c.MR, c.MC))};
}

GroupShape bwd_shape(int d, int s, int r) {  // kernel 3
  const int i = pick_cfg(kBwdCfg, d > s ? d : s, r);
  if (i < 0) return {-1, 0, 0};
  const TileCfg c = kBwdCfg[i];
  return {i, 32 * c.G, bwd_group_floats(d, s, r, pub_floats(c.G, c.MR, c.MC))};
}

GroupShape rhs_shape(int d, int s) {  // kernel 4
  if (d > 64 || s > 64) return {-1, 0, 0};
  const int g = rhs_group_warps(d, s);
  return {g == 4 ? 0 : 1, 32 * g, rhs_group_floats(d, s)};
}

GroupShape step_shape(int d, int s) {  // kernel 6
  const int i = pick_cfg(kFwdCfg, d > s ? d : s, s + d + 1);
  if (i < 0) return {-1, 0, 0};
  const TileCfg c = kFwdCfg[i];
  return {i, 32 * c.G, fwd_group_floats(d, s, 1, pub_floats(c.G, c.MR, c.MC))};
}

// The instantiation C = g.cfg of a sweep, for column count r (R = 1 for one
// column, R = 0 for r read at run time); opted[C][R] as in opt_in.
template <int C>
int launch_fwd(GroupShape g, int r, int (*opted)[2][16], void* stream, const float* H,
               const float* Cb, const float* A, const float* Bm, const float* rz, const float* rnu,
               int Bn, int T, int d, int s, float delta_c, float* LP, float* LS, float* XA,
               float* q, float* dz, float* G, float* LPf) {
  constexpr TileCfg c = kFwdCfg[C];
  if (r == 1)
    return launch_group(fwd_sweep_group<1, c.G, c.MR, c.MC, false>, g.floats, g.nt, Bn,
                        opted[C][1], stream, H, Cb, A, Bm, rz, rnu, Bn, T, d, s, r, delta_c, LP,
                        LS, XA, q, dz, G, LPf, StepIO{});
  return launch_group(fwd_sweep_group<0, c.G, c.MR, c.MC, false>, g.floats, g.nt, Bn, opted[C][0],
                      stream, H, Cb, A, Bm, rz, rnu, Bn, T, d, s, r, delta_c, LP, LS, XA, q, dz, G,
                      LPf, StepIO{});
}

template <int C>
int launch_bwd(GroupShape g, int r, int (*opted)[2][16], void* stream, const float* LP,
               const float* LS, const float* XA, const float* q, const float* Cb, const float* A,
               const float* Bm, const float* rnu, int Bn, int T, int d, int s, float* dz,
               float* nu) {
  constexpr TileCfg c = kBwdCfg[C];
  if (r == 1)
    return launch_group(bwd_sweep_group<1, c.G, c.MR, c.MC>, g.floats, g.nt, Bn, opted[C][1],
                        stream, LP, LS, XA, q, Cb, A, Bm, rnu, Bn, T, d, s, r, dz, nu);
  return launch_group(bwd_sweep_group<0, c.G, c.MR, c.MC>, g.floats, g.nt, Bn, opted[C][0],
                      stream, LP, LS, XA, q, Cb, A, Bm, rnu, Bn, T, d, s, r, dz, nu);
}

template <int C>
int launch_step(GroupShape g, int (*opted)[16], void* stream, const float* P, const float* qin,
                const float* H, const float* Cb, const float* A, const float* Bm, const float* rz,
                const float* rnu, int Bn, int T, int d, int s, int t, float delta_c, float* Pn,
                float* qn, float* LP, float* LS, float* XA, float* qs) {
  constexpr TileCfg c = kFwdCfg[C];
  return launch_group(fwd_sweep_group<1, c.G, c.MR, c.MC, true>, g.floats, g.nt, Bn, opted[C],
                      stream, H, Cb, A, Bm, rz, rnu, Bn, T, d, s, 1, delta_c, LP, LS, XA, qs,
                      nullptr, nullptr, nullptr, StepIO{P, qin, Pn, qn, t});
}

}  // namespace

// Batch-first buffers, r right-hand-side columns: H (B,T,d,d),
// C (B,T-1,d,d), A/B (B,T-1,s,d), rz (B,T,d,r), rnu (B,T-1,s,r);
// LP (B,T-1,d,d), LS (B,T-1,s,s), XA (B,T-1,d,s), q (B,T-1,d,r),
// dz (B,T,d,r): the forward sweep writes dz[:, T-1], the backward sweep the
// rest and nu (B,T-1,s,r).  With kept factors (G and LPf not null) the
// forward sweep also writes G (B,T-1,s,d) and LPf (B,d,d).  r = 1 runs the
// single-column instantiation.  cudaErrorInvalidConfiguration: an instance
// does not fit (d or s > 64, s + d + r > 144, or its shared memory).
extern "C" int qct_kkt_fwd_sweep(const float* H, const float* C, const float* A, const float* Bm,
                                 const float* rz, const float* rnu, int Bn, int T, int d, int s,
                                 int r, float delta_c, float* LP, float* LS, float* XA, float* q,
                                 float* dz, float* G, float* LPf, void* stream) {
  static int opted[4][2][16] = {};
  const GroupShape g = fwd_shape(d, s, r);
  switch (g.cfg) {
    case 0:
      return launch_fwd<0>(g, r, opted, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, delta_c, LP, LS,
                           XA, q, dz, G, LPf);
    case 1:
      return launch_fwd<1>(g, r, opted, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, delta_c, LP, LS,
                           XA, q, dz, G, LPf);
    case 2:
      return launch_fwd<2>(g, r, opted, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, delta_c, LP, LS,
                           XA, q, dz, G, LPf);
    case 3:
      return launch_fwd<3>(g, r, opted, stream, H, C, A, Bm, rz, rnu, Bn, T, d, s, delta_c, LP, LS,
                           XA, q, dz, G, LPf);
  }
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int qct_kkt_bwd_sweep(const float* LP, const float* LS, const float* XA,
                                 const float* q, const float* C, const float* A, const float* Bm,
                                 const float* rnu, int Bn, int T, int d, int s, int r, float* dz,
                                 float* nu, void* stream) {
  static int opted[4][2][16] = {};
  const GroupShape g = bwd_shape(d, s, r);
  switch (g.cfg) {
    case 0:
      return launch_bwd<0>(g, r, opted, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s, dz, nu);
    case 1:
      return launch_bwd<1>(g, r, opted, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s, dz, nu);
    case 2:
      return launch_bwd<2>(g, r, opted, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s, dz, nu);
    case 3:
      return launch_bwd<3>(g, r, opted, stream, LP, LS, XA, q, C, A, Bm, rnu, Bn, T, d, s, dz, nu);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// The launch configuration of kernel 2 (which = 0), 3 (1), 4 (2) or 6 (3)
// for these shapes (r columns; kernels 4 and 6 take one): out = {threads
// per instance, instances per block, shared bytes per block}.  Returns 0,
// or cudaErrorInvalidConfiguration where the launch would be refused.
extern "C" int qct_kkt_sweep_config(int which, int Bn, int d, int s, int r, int* out) {
  const GroupShape g = which == 0   ? fwd_shape(d, s, r)
                       : which == 1 ? bwd_shape(d, s, r)
                       : which == 2 ? rhs_shape(d, s)
                                    : step_shape(d, s);
  int smem = 0;
  const int ipb = g.cfg < 0 ? 0 : group_config(g.floats * (int)sizeof(float), g.nt, Bn, &smem);
  if (ipb == 0) return (int)cudaErrorInvalidConfiguration;
  out[0] = g.nt;
  out[1] = ipb;
  out[2] = smem;
  return 0;
}

// Kept factors LP, LS, G (B,T-1,s,d), LPf (B,d,d) with C and A; a new
// single-column rhs rz, rnu.  Writes q (B,T-1,d) and dz[:, T-1] for the
// backward sweep.  cudaErrorInvalidConfiguration: d or s > 64, or an
// instance's two stages exceed the shared memory of a block.
extern "C" int qct_kkt_rhs_fwd_sweep(const float* LP, const float* LS, const float* G,
                                     const float* C, const float* A, const float* rz,
                                     const float* rnu, const float* LPf, int Bn, int T, int d,
                                     int s, float* q, float* dz, void* stream) {
  static int opted[2][16] = {};
  const GroupShape g = rhs_shape(d, s);
  if (g.cfg < 0) return (int)cudaErrorInvalidConfiguration;
  if (g.cfg == 0)
    return launch_group(rhs_fwd_sweep_group<4>, g.floats, g.nt, Bn, opted[0], stream, LP, LS, G, C,
                        A, rz, rnu, LPf, Bn, T, d, s, q, dz);
  return launch_group(rhs_fwd_sweep_group<8>, g.floats, g.nt, Bn, opted[1], stream, LP, LS, G, C,
                      A, rz, rnu, LPf, Bn, T, d, s, q, dz);
}

// The lanes_scan steps at knot t (0 <= t < T-1), one column, the same
// batch-first buffers as the sweeps.  Forward: the carry P (B,d,d), q (B,d)
// in, Pn, qn out; LP, LS, XA and qs (B,T-1,d) written at knot t.
// Backward: dz (B,T,d) read at t+1 and written at t, nu (B,T-1,s) at t.
// cudaErrorInvalidConfiguration where kernel 2 would refuse the shapes.
extern "C" int qct_kkt_fwd_step(const float* P, const float* qin, const float* H, const float* C,
                                const float* A, const float* Bm, const float* rz,
                                const float* rnu, int Bn, int T, int d, int s, int t,
                                float delta_c, float* Pn, float* qn, float* LP, float* LS,
                                float* XA, float* qs, void* stream) {
  static int opted[4][16] = {};
  const GroupShape g = step_shape(d, s);
  switch (g.cfg) {
    case 0:
      return launch_step<0>(g, opted, stream, P, qin, H, C, A, Bm, rz, rnu, Bn, T, d, s, t, delta_c,
                            Pn, qn, LP, LS, XA, qs);
    case 1:
      return launch_step<1>(g, opted, stream, P, qin, H, C, A, Bm, rz, rnu, Bn, T, d, s, t, delta_c,
                            Pn, qn, LP, LS, XA, qs);
    case 2:
      return launch_step<2>(g, opted, stream, P, qin, H, C, A, Bm, rz, rnu, Bn, T, d, s, t, delta_c,
                            Pn, qn, LP, LS, XA, qs);
    case 3:
      return launch_step<3>(g, opted, stream, P, qin, H, C, A, Bm, rz, rnu, Bn, T, d, s, t, delta_c,
                            Pn, qn, LP, LS, XA, qs);
  }
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int qct_kkt_bwd_step(const float* LP, const float* LS, const float* XA,
                                const float* q, const float* C, const float* A, const float* Bm,
                                const float* rnu, int Bn, int T, int d, int s, int t, float* dz,
                                float* nu, void* stream) {
  static int opted[16] = {0};
  return launch(bwd_step, bwd_warp_floats(d, s, 1), Bn, opted, stream, LP, LS, XA, q, C, A, Bm,
                rnu, Bn, T, d, s, t, dz, nu);
}
