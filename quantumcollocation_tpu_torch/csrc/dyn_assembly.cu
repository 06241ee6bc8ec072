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
// in place of the N family.  That branch has B = I and no Cc term.
//
// What bounds it: bytes.  Per pair it reads 2d + s floats and writes
// s + 2sd + 2d^2 floats (853 at d=15, s=13: 87 MB at B=512, T=51, a bound
// of ~0.027 ms); the bank is ~2*10^4 flops on 4x4 matrices (~3*10^4 in the
// exponential branch).  Design:
// - A team of n^2 threads per pair, thread (i, j) owning entry (i, j) of
//   every matrix of the N and D families in registers.  A Horner step
//   publishes the families to the team's shared memory and each thread
//   forms its new entries from row i of X, dX_k (its registers) and column
//   j of the published matrices; the team syncs by __syncwarp (a team lies
//   in one warp).  The exponential branch's Gauss-Jordan, products and
//   squarings run the same way, so no thread holds a whole bank and
//   nothing spills.
// - A block takes a run of consecutive pairs m = b(T-1) + t.  In the
//   batch-first layout they own one contiguous range of each of F, A, Bm
//   and Cc, and of Hc too with the last knot of each instance that ends in
//   the run.  The block zeroes that slab in shared memory, the teams
//   scatter their nonzeros into it (the += into Hc is a shared-memory sum),
//   and then the whole block writes each range once, neighbouring threads
//   on neighbouring addresses, 16 bytes a store: each range's slab starts
//   at the same offset modulo 16 bytes as its destination.  No output is
//   zero-filled or read back in device memory.
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
// A member has ncols <= n (pack_spec checks it).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // threads per block, at most
constexpr int kMaxBlockBytes = 64 << 10;  // shared memory per block, at most, where a block has
                                          // more than a warp's worth of pairs

__host__ __device__ constexpr int round4(long n) { return (int)((n + 3) / 4 * 4); }

// Floats of one team's scratch: the N and D families (1 + K + Kp matrices
// each), U, U' and Lambda of a member; the exponential branch adds the
// Gauss-Jordan pair and the numerators of dP and d2P.
__host__ __device__ constexpr int team_floats(int N, int K, bool exp) {
  const int TP = N * N, KP = K * (K + 1) / 2, NM = 1 + K + KP;
  return round4(2 * NM * TP + 3 * TP + (exp ? 2 * TP + KP * TP : 0));
}

// The block's slab: F, A, Bm, Cc of P pairs and Hc of at most nh knots, each
// range padded by up to 3 floats so that it can start at its destination's
// offset modulo 16 bytes.
struct SlabShape {
  int f, a, c, h;  // floats of the F, A (and Bm), Cc and Hc ranges
};

__host__ __device__ inline SlabShape slab_shape(int P, int nh, int d, int s) {
  return {round4((long)P * s + 3), round4((long)P * s * d + 3), round4((long)P * d * d + 3),
          round4((long)nh * d * d + 3)};
}

// Hc knots a run of P pairs can touch: its P knots, and the last knot of
// each instance that ends in the run.
__host__ __device__ inline int max_knots(int P, int Tm1) { return P + 1 + (P - 1 + Tm1 - 1) / Tm1; }

__host__ __device__ inline long block_floats(int P, int N, int K, bool exp, int d, int s, int Tm1) {
  const SlabShape sh = slab_shape(P, max_knots(P, Tm1), d, s);
  return round4(d + s) + sh.f + 2L * sh.a + sh.c + sh.h + (long)P * team_floats(N, K, exp);
}

// Pairs per block: kThreads / n^2, halved while the block's shared memory
// exceeds kMaxBlockBytes and a block keeps at least a warp.
inline int pairs_per_block(int N, int K, bool exp, int d, int s, int Tm1) {
  int P = kThreads / (N * N);
  while (P * N * N > 32 && block_floats(P, N, K, exp, d, s, Tm1) * 4 > kMaxBlockBytes) P /= 2;
  return P;
}

// sum_q x[q] y[q * N] (a row of registers against a column of a team
// matrix in shared memory), in the order of the plain loop.
template <int N>
__device__ __forceinline__ float dot_col(const float (&x)[N], const float* y) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N; ++q) acc += x[q] * y[q * N];
  return acc;
}

// sum_q a[i N + q] b[q N + j] over two team matrices in shared memory.
template <int N>
__device__ __forceinline__ float dot_mm(const float* a, const float* b, int i, int j) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N; ++q) acc += a[i * N + q] * b[q * N + j];
  return acc;
}

// n floats from shared src to global dst by the block, dst and src
// congruent modulo 16 bytes: scalars up to dst's next 16-byte boundary,
// then 16-byte stores with neighbouring threads on neighbouring addresses.
__device__ __forceinline__ void copy_out(float* __restrict__ dst, const float* src, int n,
                                         int tid, int nt) {
  const int head = (4 - (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3;
  const int h = head < n ? head : n;
  if (tid < h) dst[tid] = src[tid];
  const int n4 = (n - h) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + h);
  float4* d4 = reinterpret_cast<float4*>(dst + h);
  for (int v = tid; v < n4; v += nt) d4[v] = s4[v];
  for (int k = h + 4 * n4 + tid; k < n; k += nt) dst[k] = src[k];
}

__device__ __forceinline__ int shift4(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// At most 128 registers a thread (4 blocks an SM, about what the shared
// memory allows): ptxas then spills nothing at any instantiation, where
// without the minimum it picked occupancy-tier register counts and spilled.
template <int N, int K, bool EXP>
__global__ void __launch_bounds__(kThreads, 4)
    assembly_kernel(const float* __restrict__ Z, const float* __restrict__ lam, int Bt, int T,
                    int d, int s, const int* __restrict__ ispec, const float* __restrict__ fspec,
                    float* __restrict__ F, float* __restrict__ A, float* __restrict__ Bm,
                    float* __restrict__ Hc, float* __restrict__ Cc, int P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int TP = N * N, KP = K * (K + 1) / 2, NM = 1 + K + KP;
  // pair and knot indices in 32 bits (a 64-bit division is a call, whose
  // saved registers ptxas counts as spills); offsets into the outputs in 64
  const int Tm1 = T - 1, nt = blockDim.x, tid = threadIdx.x;
  const int npairs = Bt * Tm1, m0 = blockIdx.x * P;
  const int np = npairs - m0 < P ? npairs - m0 : P;  // pairs of this block
  const int mL = m0 + np - 1;
  const int hk0 = m0 + m0 / Tm1;  // Hc knot b T + t of pair m = m + b
  const int nh = mL + mL / Tm1 + 1 + (mL % Tm1 == Tm1 - 1 ? 1 : 0) - hk0;

  // shared memory: vs, ds; the slab; the teams' scratch
  float* vs = smem;
  float* ds = vs + d;
  const SlabShape sh = slab_shape(P, max_knots(P, Tm1), d, s);
  float* slab = smem + round4(d + s);
  const int slab_n = sh.f + 2 * sh.a + sh.c + sh.h;
  float* const gF = F + (long)m0 * s;  // the block's ranges of the outputs
  float* const gA = A + (long)m0 * s * d;
  float* const gB = Bm + (long)m0 * s * d;
  float* const gC = Cc + (long)m0 * d * d;
  float* const gH = Hc + (long)hk0 * d * d;
  float* sF = slab + shift4(gF);
  float* sA = slab + sh.f + shift4(gA);
  float* sB = slab + sh.f + sh.a + shift4(gB);
  float* sC = slab + sh.f + 2 * sh.a + shift4(gC);
  float* sH = slab + sh.f + 2 * sh.a + sh.c + shift4(gH);
  {
    float4* z4 = reinterpret_cast<float4*>(slab);
    for (int v = tid; v < slab_n / 4; v += nt) z4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = tid; k < d; k += nt) vs[k] = fspec[k];
    for (int k = tid; k < s; k += nt) ds[k] = fspec[d + k];
  }
  __syncthreads();

  const int team = tid / TP, lane = tid % TP, i = lane / N, j = lane % N;
  const bool live = team < np;  // a team past the last pair computes pair mL and writes nothing
  const int m = live ? m0 + team : mL;
  const int b = m / Tm1, t = m % Tm1;
  const float* zt = Z + ((long)b * T + t) * d;
  const float* ztp1 = zt + d;
  const float* lm = lam + (long)m * s;
  float* Fm = sF + team * s;
  float* Am = sA + team * s * d;
  float* Bmm = sB + team * s * d;
  float* Cm = sC + team * d * d;
  float* Hm = sH + (m + b - hk0) * d * d;  // the slab holds at most max_knots knots
  float* fam = slab + slab_n + team * team_floats(N, K, EXP);
  float* famN = fam;  // N, dN_k, d2N_p; P and its derivatives in the exponential branch
  float* famD = famN + NM * TP;
  float* U0s = famD + NM * TP;  // U (r, c) at r N + c
  float* U1s = U0s + TP;
  float* Ls = U1s + TP;
  float* GM = Ls + TP;  // exponential branch: Gauss-Jordan working matrix, D^-1
  float* GR = GM + TP;
  float* TW = GR + TP;  // numerators of dP_k, d2P_p

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

    // row i of X, of the directions dX_k and of the drives G_k
    float Xr[N], dXr[K][N], Gr[K][N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float g = Gd[i * N + q];
      for (int k = 0; k < na; ++k) g += zt[a0 + k] * vs[a0 + k] * Gs[(k * N + i) * N + q];
      Xr[q] = g * dt;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        Gr[k][q] = k < na ? Gs[(k * N + i) * N + q] : 0.f;
        dXr[k][q] = k < na ? Gr[k][q] * dt : g;
      }
    }
    int theta[K];
#pragma unroll
    for (int k = 0; k < K; ++k) theta[k] = k < na ? a0 + k : dt_col;

    // Horner for q(+X) (family 0, N) and q(-X) (family 1, D) with first and
    // second theta-derivatives; d2X is nonzero only for (k < na, l = na)
    // with a free dt, where it is G_k.  Entry (i, j) of each in registers.
    float acc[2], dacc[2][K], d2acc[2][KP];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      acc[f] = i == j ? coeffs[ncoef - 1] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dacc[f][k] = 0.f;
#pragma unroll
      for (int p = 0; p < KP; ++p) d2acc[f][p] = 0.f;
    }
    for (int ci = ncoef - 1; ci >= 0; --ci) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        float* Mf = f ? famD : famN;
        Mf[lane] = acc[f];
#pragma unroll
        for (int k = 0; k < K; ++k) Mf[(1 + k) * TP + lane] = dacc[f][k];
#pragma unroll
        for (int p = 0; p < KP; ++p) Mf[(1 + K + p) * TP + lane] = d2acc[f][p];
      }
      __syncwarp();
      if (ci == 0) break;  // the families stay published
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float sgn = f ? -1.f : 1.f;
        const float* Mc = (f ? famD : famN) + j;  // column j
        {
          int p = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int l = k; l < K; ++l, ++p) {
              float nw = 0.f;
              nw += sgn * dot_col<N>(Xr, Mc + (1 + K + p) * TP);
              nw += sgn * dot_col<N>(dXr[k], Mc + (1 + l) * TP);
              nw += sgn * dot_col<N>(dXr[l], Mc + (1 + k) * TP);
              if (free_dt && k < na && l == na) nw += sgn * dot_col<N>(Gr[k], Mc);
              d2acc[f][p] = nw;
            }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float nw = 0.f;
          nw += sgn * dot_col<N>(dXr[k], Mc);
          nw += sgn * dot_col<N>(Xr, Mc + (1 + k) * TP);
          dacc[f][k] = nw;
        }
        acc[f] = (i == j ? coeffs[ci - 1] : 0.f) + sgn * dot_col<N>(Xr, Mc);
      }
      __syncwarp();
    }

    if constexpr (EXP) {
      // D^-1 by Gauss-Jordan without pivoting: this thread's entries of the
      // working matrix (mw) and of the inverse (rw), published a column a step
      float mw = acc[1], rw = i == j ? 1.f : 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        GM[lane] = mw;
        GR[lane] = rw;
        __syncwarp();
        const float inv = 1.f / GM[c * N + c];
        const float mcj = GM[c * N + j] * inv, rcj = GR[c * N + j] * inv, f = GM[i * N + c];
        __syncwarp();
        if (i == c) {
          mw = mcj;
          rw = rcj;
        } else {
          mw -= f * mcj;
          rw -= f * rcj;
        }
      }
      GR[lane] = rw;
      __syncwarp();
      // P = D^-1 N
      const float pij = dot_mm<N>(GR, famN, i, j);
      __syncwarp();
      famN[lane] = pij;
      __syncwarp();
      // dP_k = D^-1 (dN_k - dD_k P)
#pragma unroll
      for (int k = 0; k < K; ++k)
        TW[k * TP + lane] = dacc[0][k] + -1.f * dot_mm<N>(famD + (1 + k) * TP, famN, i, j);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < K; ++k) dacc[0][k] = dot_mm<N>(GR, TW + k * TP, i, j);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < K; ++k) famN[(1 + k) * TP + lane] = dacc[0][k];
      __syncwarp();
      // d2P = D^-1 (d2N - d2D P - dD_k dP_l - dD_l dP_k)
      {
        int p = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int l = k; l < K; ++l, ++p) {
            float tw = d2acc[0][p];
            tw += -1.f * dot_mm<N>(famD + (1 + K + p) * TP, famN, i, j);
            tw += -1.f * dot_mm<N>(famD + (1 + k) * TP, famN + (1 + l) * TP, i, j);
            tw += -1.f * dot_mm<N>(famD + (1 + l) * TP, famN + (1 + k) * TP, i, j);
            TW[p * TP + lane] = tw;
          }
      }
      __syncwarp();
#pragma unroll
      for (int p = 0; p < KP; ++p) d2acc[0][p] = dot_mm<N>(GR, TW + p * TP, i, j);
      __syncwarp();
#pragma unroll
      for (int p = 0; p < KP; ++p) famN[(1 + K + p) * TP + lane] = d2acc[0][p];
      __syncwarp();
      // squarings: d2P first (it reads the old dP and P), then dP, then P
      for (int sq = 0; sq < nsq; ++sq) {
        {
          int p = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int l = k; l < K; ++l, ++p) {
              const float* D2 = famN + (1 + K + p) * TP;
              float nw = 0.f;
              nw += dot_mm<N>(D2, famN, i, j);
              nw += dot_mm<N>(famN, D2, i, j);
              nw += dot_mm<N>(famN + (1 + k) * TP, famN + (1 + l) * TP, i, j);
              nw += dot_mm<N>(famN + (1 + l) * TP, famN + (1 + k) * TP, i, j);
              d2acc[0][p] = nw;
            }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* D1 = famN + (1 + k) * TP;
          float nw = 0.f;
          nw += dot_mm<N>(D1, famN, i, j);
          nw += dot_mm<N>(famN, D1, i, j);
          dacc[0][k] = nw;
        }
        acc[0] = 0.f + dot_mm<N>(famN, famN, i, j);
        __syncwarp();
        famN[lane] = acc[0];
#pragma unroll
        for (int k = 0; k < K; ++k) famN[(1 + k) * TP + lane] = dacc[0][k];
#pragma unroll
        for (int p = 0; p < KP; ++p) famN[(1 + K + p) * TP + lane] = d2acc[0][p];
        __syncwarp();
      }
    }

    for (int mi = 0; mi < nmem; ++mi) {
      const int u0 = mem[5 * mi], r0 = mem[5 * mi + 2], ncols = mem[5 * mi + 4];
      if (j < ncols) {  // (r, c) = (i, j)
        const int zi = u0 + j * N + i, li = r0 + j * N + i;
        U0s[lane] = zt[zi] * vs[zi];
        U1s[lane] = ztp1[zi] * vs[zi];
        Ls[lane] = lm[li] * ds[li];
      }
      __syncwarp();
      if (live) {
        if (j < ncols) {  // the defect and its theta-columns, (r, c) = (i, j)
          const int row = r0 + j * N + i;
          float res = 0.f;
          if constexpr (EXP) {  // u' - P u
            float pu = 0.f;
#pragma unroll
            for (int q = 0; q < N; ++q) pu += famN[i * N + q] * U0s[q * N + j];
            res = U1s[lane] - pu;
          } else {
#pragma unroll
            for (int q = 0; q < N; ++q)
              res += famD[i * N + q] * U1s[q * N + j] - famN[i * N + q] * U0s[q * N + j];
          }
          Fm[row] = res * ds[row];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float* dN = famN + (1 + k) * TP + i * N;
            const float* dD = famD + (1 + k) * TP + i * N;
            float dc = 0.f;
            if constexpr (EXP) {
#pragma unroll
              for (int q = 0; q < N; ++q) dc -= dN[q] * U0s[q * N + j];
            } else {
#pragma unroll
              for (int q = 0; q < N; ++q) dc += dD[q] * U1s[q * N + j] - dN[q] * U0s[q * N + j];
            }
            Am[row * d + theta[k]] = dc * (ds[row] * vs[theta[k]]);
          }
        }
        for (int c = 0; c < ncols; ++c) {  // the u-columns, (r, rp) = (i, j)
          const int row = r0 + c * N + i, col = u0 + c * N + j;
          Am[row * d + col] = -famN[lane] * (ds[row] * vs[col]);
          if constexpr (EXP) {
            if (i == j) Bmm[row * d + col] = ds[row] * vs[col];
          } else {
            Bmm[row * d + col] = famD[lane] * (ds[row] * vs[col]);
          }
        }
      }
      // curvature of -lam.F: W = Lam U^T, entry (i, j); its sums against
      // d2N (and d2D) reduced over the team
      float w0 = 0.f, w1 = 0.f;
      for (int c = 0; c < ncols; ++c) {
        w0 += Ls[i * N + c] * U0s[j * N + c];
        w1 += Ls[i * N + c] * U1s[j * N + c];
      }
      {
        int p = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int l = k; l < K; ++l, ++p) {
            float h;
            if constexpr (EXP)
              h = famN[(1 + K + p) * TP + lane] * w0;
            else
              h = famN[(1 + K + p) * TP + lane] * w0 - famD[(1 + K + p) * TP + lane] * w1;
#pragma unroll
            for (int o = TP / 2; o > 0; o /= 2) h += __shfl_xor_sync(0xffffffffu, h, o);
            if (live && lane == p % TP) {
              const int ck = theta[k], cl = theta[l];
              const float hv = h * (vs[ck] * vs[cl]);
              Hm[ck * d + cl] += hv;
              if (ck != cl) Hm[cl * d + ck] += hv;
            }
          }
      }
      __syncwarp();
      if (live && j < ncols) {  // the (u, theta) curvature, (r, c) = (i, j)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int ck = theta[k];
          float mt = 0.f, mp = 0.f;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            mt += famN[(1 + k) * TP + q * N + i] * Ls[q * N + j];
            if constexpr (!EXP) mp += famD[(1 + k) * TP + q * N + i] * Ls[q * N + j];
          }
          const int ui = u0 + j * N + i;
          const float sc = vs[ui] * vs[ck];
          Hm[ui * d + ck] += mt * sc;
          Hm[ck * d + ui] += mt * sc;
          if constexpr (!EXP) Cm[ck * d + ui] += -mp * sc;  // D' u' has no exp counterpart
        }
      }
      __syncwarp();
    }
  }

  for (int ri = 0; ri < nderiv; ++ri, ip += 7, fp += 1) {
    const int x0 = ip[0], x1 = ip[1], dx0 = ip[2], r0 = ip[4], dt_col = ip[6];
    const float dt = dt_col >= 0 ? zt[dt_col] * vs[dt_col] : fp[0];
    if (live)
      for (int e = lane; e < x1 - x0; e += TP) {
        const int row = r0 + e, xi = x0 + e, dxi = dx0 + e;
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
    __syncwarp();
  }

  for (int ri = 0; ri < ndteq; ++ri, ip += 4) {
    const int c0 = ip[0], c1 = ip[1], r0 = ip[2];
    if (live)
      for (int e = lane; e < c1 - c0; e += TP) {
        const int row = r0 + e, ci = c0 + e;
        Fm[row] = (ztp1[ci] * vs[ci] - zt[ci] * vs[ci]) * ds[row];
        Am[row * d + ci] = -ds[row] * vs[ci];
        Bmm[row * d + ci] = ds[row] * vs[ci];
      }
  }

  __syncthreads();
  copy_out(gF, sF, np * s, tid, nt);
  copy_out(gA, sA, np * s * d, tid, nt);
  copy_out(gB, sB, np * s * d, tid, nt);
  copy_out(gC, sC, np * d * d, tid, nt);
  copy_out(gH, sH, nh * d * d, tid, nt);
}

// The launch configuration for these shapes: pairs per block and shared
// bytes per block.
struct Config {
  int pairs, bytes;
};

template <int N, int K, bool EXP>
Config config(int T, int d, int s) {
  const int P = pairs_per_block(N, K, EXP, d, s, T - 1);
  return {P, (int)(block_floats(P, N, K, EXP, d, s, T - 1) * 4)};
}

template <int N, int K, bool EXP>
int launch(const float* Z, const float* lam, int Bt, int T, int d, int s, const int* ispec,
           const float* fspec, float* F, float* A, float* Bm, float* Hc, float* Cc,
           cudaStream_t stream) {
  static int opted[16] = {};  // per device: the largest opt-in so far
  const Config c = config<N, K, EXP>(T, d, s);
  int dev = 0;
  cudaGetDevice(&dev);
  int& set = opted[dev & 15];
  if (c.bytes > 48 * 1024 && c.bytes > set) {
    if (cudaFuncSetAttribute(assembly_kernel<N, K, EXP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             c.bytes) != cudaSuccess)
      return (int)cudaErrorInvalidConfiguration;
    set = c.bytes;
  }
  const long M = (long)Bt * (T - 1);
  const int blocks = (int)((M + c.pairs - 1) / c.pairs);
  assembly_kernel<N, K, EXP><<<blocks, c.pairs * N * N, c.bytes, stream>>>(
      Z, lam, Bt, T, d, s, ispec, fspec, F, A, Bm, Hc, Cc, c.pairs);
  return (int)cudaGetLastError();
}

}  // namespace

#define QCT_CASES                                 \
  QCT_CASE(2, 1) QCT_CASE(2, 2) QCT_CASE(2, 3) \
  QCT_CASE(4, 1) QCT_CASE(4, 2) QCT_CASE(4, 3)

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
  QCT_CASES
#undef QCT_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch configuration of qct_dyn_assembly for these shapes: out =
// {threads per pair, pairs per block, shared bytes per block}.  Returns 0,
// or cudaErrorInvalidValue for an (n, K) without an instantiation.
extern "C" int qct_dyn_assembly_config(int T, int d, int s, int n, int K, int exp_kind, int* out) {
  Config c{0, 0};
#define QCT_CASE(NN, KK) \
  if (n == NN && K == KK) c = exp_kind ? config<NN, KK, true>(T, d, s) : config<NN, KK, false>(T, d, s);
  QCT_CASES
#undef QCT_CASE
  if (c.pairs == 0) return (int)cudaErrorInvalidValue;
  out[0] = n * n;
  out[1] = c.pairs;
  out[2] = c.bytes;
  return 0;
}
