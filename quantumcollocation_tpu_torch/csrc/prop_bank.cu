// Propagator-derivative bank, batched over (instance, knot) pairs.
//
// Replaces: quantumcollocation_tpu/ops/pallas_prop_bank.py::_bank_kernel,
// Padé and exponential branches (bank_kernel<N, FREE, EXP>; past its drive
// count, entry_bank_kernel<N> and entry_exp_bank_kernel<N>).
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
// dynamics/expm.py::pade_poly_frechet: per step
//   d2acc'_p = sX d2acc_p + s dX_k dacc_l + s dX_l dacc_k + s d2X_p acc
//   dacc'_k  = s dX_k acc + sX dacc_k
//   acc'     = sX acc + c I.
// The exponential branch (EXP) turns both signs into P = exp(X) with its
// derivatives, as dynamics/expm.py::expm_frechet_bank: the generators
// scaled by 2^-nsq (exact), D inverted by Gauss-Jordan without pivoting
// (the scaled denominator is diagonally dominant), P = D^-1 N, dP_k =
// D^-1 (dN_k - dD_k P), d2P_p = D^-1 (d2N_p - d2D_p P - dD_k dP_l - dD_l
// dP_k), then nsq squarings; only the P family is written.
//
// What bounds it: at the two-qubit sizes (n=8, K=5, fixed dt, 4,992
// pairs) the Padé branch writes 10,752 bytes a pair (53.7 MB), ~0.016 ms
// at the card's 3.35 TB/s, and its one full Horner step needs ~8.4*10^4
// flops a pair, so bytes bound it.  The exponential branch needs ~6 times
// the arithmetic (three full steps a sign, the solves, the squarings) and
// writes half the bytes, so operations bound it.  What held the entry
// design below (one thread per matrix entry) back was neither: every
// multiply-add of every product read both of its operands from shared
// memory, one float at a time, and shared memory delivers 32 floats a
// cycle to an SM, so it ran ~8 times slower than the arithmetic.
//
// Strip design (bank_kernel): a thread owns row i, columns j0..j0+W-1 of
// every matrix of its pair (W = 4 at n=8: 16 threads a pair; a whole row
// at n = 2, 4, 6).  Its rows i of G and of the drives' generators live in
// registers, so a product reads only the other operand's rows, W floats in
// one 16- or 8-byte load.  A Horner step reads each derivative's rows once
// for every product that has it on the right (X dacc_l and each dX_k
// dacc_l), and the cross term dX_l dacc_k of a pair (k, l), formed in
// dacc_k's pass, waits in registers for dacc_l's: the entry design reads
// each state matrix 2K times a step.  The first step from acc = c_m I with
// zero derivatives is written in closed form: the entry design runs it as
// a full step of products of zeros.  Every entry keeps the entry design's
// sums, r = 0..n-1 in order, and their combination as written above, so
// the two designs' outputs round alike.  A pair's threads lie in one warp:
// they meet at __syncwarp and trade Gauss-Jordan rows by shuffles, and a
// step updates the state in place in shared memory (results formed in
// registers, a warp sync, then the writes), so a Padé pair holds one Q x n
// x n state, an exponential pair two (the N and D families, the D buffer
// then the squarings' second).  A Padé branch's last step writes its
// outputs from registers, 16-byte stores of neighbouring threads on
// neighbouring addresses.  The register tiles need static indices and a
// pair's state static offsets: a free dt is a template parameter, and the
// kernel holds max_drives<N> drives (2 at n = 2, 4, 6; 5 at n = 8), the
// paths' and the templates' counts.  Fewer drives run the missing ones on
// zero generators, which write nothing out (16 kernels).
//
// Entry design (entry_bank_kernel, entry_exp_bank_kernel), for more drives
// than that, and the only design at n = 18: one thread per matrix entry
// (i, j) of a pair, n*n threads a pair; the whole state of a pair sits in
// shared memory twice, the previous step and the next, and a thread reads
// row i of the directions and column j of the state and writes only its
// own entry.  The exponential branch keeps three state buffers a pair and
// publishes each Gauss-Jordan column to shared memory between two
// barriers.  At n = 18 (two coupled three-level transmons, four drives and
// a free dt, second order: Q = 21) a pair is 324 threads and
// (324 + 2 * 21 * 324) * 4 = 55,728 shared bytes, plus the block's 5,184
// of drive generators: one pair a block, three blocks an SM.  There the
// Padé branch writes 54,432 bytes a pair, while its products, every operand
// read from shared memory, need ~1.4 * 10^6 multiply-adds a pair: shared
// memory's 32 floats a cycle an SM bound it, far above both the bytes'
// and the arithmetic's bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;  // warps a block of the strip design

// The drives the strip design holds at n (its register tiles keep every
// drive's rows and, at second order, the pending cross terms): the paths'
// and the templates' counts
template <int N>
__host__ __device__ constexpr int max_drives() {
  return N == 8 ? 5 : 2;
}

// A thread's share of a pair: row i, W columns of every matrix
template <int N>
struct Tile {
  static constexpr int W = N == 8 ? 4 : N;  // columns a thread
  static constexpr int SPR = N / W;         // threads a row
  static constexpr int TPP = N * SPR;       // threads a pair
  static constexpr int PPW = 32 / TPP;      // pairs a warp
  static constexpr int LANES = PPW * TPP;   // lanes in use (30 at n=6)
  static constexpr int NN = N * N;
};

// L consecutive floats in 16-byte (L a multiple of 4) or 8-byte accesses:
// every row and strip of the state and of the outputs is so aligned
template <int L>
__device__ __forceinline__ void ld(const float* p, float (&v)[L]) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < L / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

template <int L>
__device__ __forceinline__ void st(float* p, const float (&v)[L]) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < L / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  }
}

// A thread's rows i of the left-hand generators (drives past na zero)
template <int N, int NAM>
struct Gen {
  float g[N];        // G (scaled by 2^-nsq in the exponential branch)
  float r[NAM][N];   // the drives' G_k
};

// Index of the pair (k, l), k <= l, of K directions in frechet_pairs order
__host__ __device__ __forceinline__ constexpr int pidx(int k, int l, int K) {
  return k * K - k * (k - 1) / 2 + (l - k);
}

// The static directions k = 0..KM-1: the drives 0..NAM-1, of which the
// first na are present, then a free dt at NAM.  A pair's state keeps a
// slot for each static direction and pair, so that its shared-memory
// offsets are constants: acc at 0, dacc_k at dq(k), d2acc_(k,l) at
// pq(k, l).  The outputs hold only the present ones: direction k at
// oq(k) of dN (a free dt's is na), the pair (k, l) at op(k, l) of d2N.
template <int NAM, bool FREE>
struct Dirs {
  static constexpr int KM = NAM + FREE;
  int na;
  __device__ __forceinline__ bool on(int k) const { return k < na || (FREE && k == NAM); }
  __device__ __forceinline__ int K() const { return na + FREE; }
  __device__ __forceinline__ int oq(int k) const { return FREE && k == NAM ? na : k; }
  __device__ __forceinline__ int op(int k, int l) const { return pidx(oq(k), oq(l), K()); }
  __device__ static constexpr int dq(int k) { return 1 + k; }
  __device__ static constexpr int pq(int k, int l) { return 1 + KM + pidx(k, l, KM); }
  // state slots a pair: acc, KM first and, at second order, KM(KM+1)/2
  // second derivatives
  __host__ __device__ static constexpr int slots(bool second) {
    return 1 + KM + (second ? KM * (KM + 1) / 2 : 0);
  }
};

// Direction k's generator, entry (i, r): G_k for a drive, G for a free dt
// (k and r static after unrolling, so this is a register)
template <int N, int NAM, bool FREE>
__device__ __forceinline__ float dir(const Gen<N, NAM>& A, int k, int r) {
  return FREE && k == NAM ? A.g[r] : A.r[k][r];
}

// Where a step's results go: in place into the pair's state S (slot s at
// S + s n^2), or, with S null, to the batch-first outputs of pair m, only
// if the pair is live and the result present (on): family 0 (N, D, P), 1
// (their first derivatives, at index o) or 2 (second derivatives, at
// index o)
struct Dst {
  float* S;
  float *o0, *o1, *o2;
  long m;
  int K, Kp;
  bool live;
};

template <int N>
__device__ __forceinline__ void put(const Dst& d, int s, int fam, int o, bool on, int e,
                                    const float (&v)[Tile<N>::W]) {
  constexpr int NN = N * N;
  if (d.S) {
    st(d.S + s * NN + e, v);
  } else if (d.live && on) {
    float* p = fam == 0   ? d.o0 + d.m * NN
               : fam == 1 ? d.o1 + (d.m * d.K + o) * NN
                          : d.o2 + (d.m * d.Kp + o) * NN;
    st(p + e, v);
  }
}

// The thread's W columns of a row held whole (static indices only)
template <int N>
__device__ __forceinline__ float pick(const float (&row)[N], int jq, int t) {
  constexpr int W = Tile<N>::W;
  float x = row[t];
#pragma unroll
  for (int s = 1; s < Tile<N>::SPR; ++s)
    if (jq == s) x = row[s * W + t];
  return x;
}

// The first Horner step from acc = c_m I with zero derivatives.  Each entry
// is what the full step's sums come to (every term left out adds an exact
// zero): acc = sX c_m + c_{m-1} I, dacc_k = s dX_k c_m, d2acc_p = s d2X_p
// c_m, nonzero only for the pairs (a_k, dt) of a free dt, from the
// thread's columns jq of G's and the drives' rows i (picked here, not held
// through the steps; zero for the drives past na, whose slots of the state
// so hold zeros throughout).
// skip_zeros: leave the zero second-derivative slots of the state
// unwritten (a full step follows, and it reads none of them).
template <int N, int NAM, bool FREE>
__device__ __forceinline__ void horner_first(const Dst& d, const Dirs<NAM, FREE>& D,
                                             const Gen<N, NAM>& A, float cm, float cn, float sx,
                                             float sgn, bool second, bool skip_zeros, int i,
                                             int jq, int j0, int e) {
  using Ds = Dirs<NAM, FREE>;
  constexpr int W = Tile<N>::W, KM = Ds::KM;
  float gs[W], rs[NAM][W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    gs[t] = pick<N>(A.g, jq, t);
#pragma unroll
    for (int k = 0; k < NAM; ++k) rs[k][t] = pick<N>(A.r[k], jq, t);
  }
  float v[W];
#pragma unroll
  for (int t = 0; t < W; ++t) v[t] = sx * (gs[t] * cm) + (i == j0 + t ? cn : 0.f);
  put<N>(d, 0, 0, 0, true, e, v);
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const bool dk = FREE && k == NAM;
    const float sk = dk ? sgn : sx;
#pragma unroll
    for (int t = 0; t < W; ++t) v[t] = sk * ((dk ? gs[t] : rs[k][t]) * cm);
    put<N>(d, Ds::dq(k), 1, D.oq(k), D.on(k), e, v);
  }
  if (!second) return;
#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int l = k; l < KM; ++l) {
      const bool ex = FREE && l == NAM && k < NAM;
      if (!ex && skip_zeros) continue;
#pragma unroll
      for (int t = 0; t < W; ++t) v[t] = ex ? sgn * (rs[k][t] * cm) : 0.f;
      put<N>(d, Ds::pq(k, l), 2, D.op(k, l), D.on(k) && D.on(l), e, v);
    }
}

// One full Horner step with coefficient c from the pair's state S, to d (in
// place when IN_PLACE, then a warp sync parts each read of a slot from its
// overwrite).  Every entry is the entry design's sum over r = 0..n-1 in
// order and its combination of sums.  Pass l reads the rows of dacc_l once
// and forms every product that has it on the right: X dacc_l and each dX_k
// dacc_l (second order); then, with those consumed, the rows of acc for
// dX_l acc (and at l = 0, always a drive, X acc).  A pair (a_k, dt) of a
// free dt forms its d2X acc = dX_k acc beside its X d2acc.  x2_live: d2acc
// is nonzero for every pair (false on the step after the closed-form one,
// where it is nonzero only for the (a_k, dt) pairs).  The drives past na
// run too, on zeros, and write only to the state: no branch parts the
// unrolled passes.
template <int N, int NAM, bool FREE, bool IN_PLACE>
__device__ __forceinline__ void horner_step(const float* S, const Dst& d, const Gen<N, NAM>& A,
                                            const Dirs<NAM, FREE>& D, float sx, float sgn,
                                            float c, bool second, bool x2_live, int i, int j0,
                                            int e, unsigned mask) {
  using Ds = Dirs<NAM, FREE>;
  constexpr int W = Tile<N>::W, NN = N * N, KM = Ds::KM;
  float acc_new[W];
  float pend[KM][KM][W];  // [k][l], k < l: dX_l dacc_k from dacc_k's pass
#pragma unroll
  for (int l = 0; l < KM; ++l) {
    const bool dt_pass = FREE && l == NAM;
    const float sl = dt_pass ? sgn : sx;
    float c2[W], pk[KM][W];  // X dacc_l, dX_k dacc_l
#pragma unroll
    for (int t = 0; t < W; ++t) {
      c2[t] = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k) pk[k][t] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float bd[W];
      ld(S + Ds::dq(l) * NN + r * N + j0, bd);
#pragma unroll
      for (int t = 0; t < W; ++t) {
        c2[t] += A.g[r] * bd[t];
        if (second) {
#pragma unroll
          for (int k = 0; k < KM; ++k) pk[k][t] += dir<N, NAM, FREE>(A, k, r) * bd[t];
        }
      }
    }
    float v[W];
    if (second) {
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k > l) continue;
        const bool ex = dt_pass && k < NAM;
        const float sk = (FREE && k == NAM) ? sgn : sx;
        float x2[W], xa[W];  // X d2acc_p, d2X_p acc
#pragma unroll
        for (int t = 0; t < W; ++t) x2[t] = xa[t] = 0.f;
        if (x2_live || ex) {
#pragma unroll
          for (int r = 0; r < N; ++r) {
            float b[W], ba[W];
            ld(S + Ds::pq(k, l) * NN + r * N + j0, b);
            if (ex) ld(S + r * N + j0, ba);
#pragma unroll
            for (int t = 0; t < W; ++t) {
              x2[t] += A.g[r] * b[t];
              if (ex) xa[t] += A.r[k][r] * ba[t];
            }
          }
        }
#pragma unroll
        for (int t = 0; t < W; ++t)
          v[t] = sx * x2[t] + sk * pk[k][t] + sl * (k == l ? pk[l][t] : pend[k][l][t]) +
                 sgn * xa[t];
        if constexpr (IN_PLACE) __syncwarp(mask);  // slot p and dacc_l read by all
        put<N>(d, Ds::pq(k, l), 2, D.op(k, l), D.on(k) && D.on(l), e, v);
      }
#pragma unroll
      for (int l2 = 0; l2 < KM; ++l2)
        if (l2 > l) {
#pragma unroll
          for (int t = 0; t < W; ++t) pend[l][l2][t] = pk[l2][t];
        }
    }
    float c0[W], c1[W];  // X acc, dX_l acc
#pragma unroll
    for (int t = 0; t < W; ++t) c0[t] = c1[t] = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float ba[W];
      ld(S + r * N + j0, ba);
#pragma unroll
      for (int t = 0; t < W; ++t) {
        if (l == 0) c0[t] += A.g[r] * ba[t];
        c1[t] += dir<N, NAM, FREE>(A, l, r) * ba[t];
      }
    }
    if (l == 0) {
#pragma unroll
      for (int t = 0; t < W; ++t) acc_new[t] = sx * c0[t] + (i == j0 + t ? c : 0.f);
    }
#pragma unroll
    for (int t = 0; t < W; ++t) v[t] = sl * c1[t] + sx * c2[t];
    if constexpr (IN_PLACE) {
      if (!second) __syncwarp(mask);  // dacc_l read by all
    }
    put<N>(d, Ds::dq(l), 1, D.oq(l), D.on(l), e, v);
  }
  if constexpr (IN_PLACE) __syncwarp(mask);  // acc read by all
  put<N>(d, 0, 0, 0, true, e, acc_new);
  if constexpr (IN_PLACE) __syncwarp(mask);  // the writes before the next reads
}

// Gauss-Jordan inverse of the pair's n x n matrix at Db, without pivoting:
// a thread holds its strip of the working matrix and of the inverse and
// per column takes row c's strip, its own row's entry in column c and the
// pivot from their owners by shuffles.  Returns row i of the inverse.
template <int N>
__device__ __forceinline__ void gauss_jordan(const float* Db, float (&di)[N], int i, int jq,
                                             int pb, unsigned mask) {
  constexpr int W = Tile<N>::W, SPR = Tile<N>::SPR;
  float mw[W], rw[W];
  ld(Db + i * N + jq * W, mw);
#pragma unroll
  for (int t = 0; t < W; ++t) rw[t] = i == jq * W + t ? 1.f : 0.f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int cq = c / W, ct = c % W, row_c = pb + c * SPR + jq;
    const float piv = __shfl_sync(mask, mw[ct], pb + c * SPR + cq);
    const float f = __shfl_sync(mask, mw[ct], pb + i * SPR + cq);
    const float inv = 1.f / piv;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const float mc = __shfl_sync(mask, mw[t], row_c) * inv;
      const float rc = __shfl_sync(mask, rw[t], row_c) * inv;
      if (i == c) {
        mw[t] = mc;
        rw[t] = rc;
      } else {
        mw[t] -= f * mc;
        rw[t] -= f * rc;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SPR; ++s)
#pragma unroll
    for (int t = 0; t < W; ++t) di[s * W + t] = __shfl_sync(mask, rw[t], pb + i * SPR + s);
}

// Row-i strip of D^-1 Y for the pair's Y at Y (di: row i of D^-1)
template <int N>
__device__ __forceinline__ void left_inv(const float (&di)[N], const float* Y, int j0,
                                         float (&out)[Tile<N>::W]) {
  constexpr int W = Tile<N>::W;
#pragma unroll
  for (int t = 0; t < W; ++t) out[t] = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float b[W];
    ld(Y + r * N + j0, b);
#pragma unroll
    for (int t = 0; t < W; ++t) out[t] += di[r] * b[t];
  }
}

// The exponential branch after the two Horner sweeps: N family at Nb, D
// family at Db (a pair's state slots each; the drives past na zero, and
// so they stay).  The P family replaces the N family in Nb; the squarings
// alternate between Nb and Db.  Returns the buffer holding the result.
template <int N, int NAM, bool FREE>
__device__ __forceinline__ float* exp_finish(float* Nb, float* Db, const Dirs<NAM, FREE>& D,
                                             bool second, int nsq, int i, int jq, int j0, int e,
                                             int pb, unsigned mask) {
  using Ds = Dirs<NAM, FREE>;
  constexpr int W = Tile<N>::W, NN = N * N, KM = Ds::KM;
  float di[N];
  gauss_jordan<N>(Db, di, i, jq, pb, mask);
  float v[W], Ps[N][W];  // Ps: the thread's columns of P's rows
  left_inv<N>(di, Nb, j0, v);  // P = D^-1 N
  __syncwarp(mask);
  st(Nb + e, v);
  __syncwarp(mask);
  float dr[KM][N];  // dD_k's rows i, then dP_k's in the squarings
#pragma unroll
  for (int r = 0; r < N; ++r) ld(Nb + r * N + j0, Ps[r]);
#pragma unroll
  for (int k = 0; k < KM; ++k) {  // numerators dN_k - dD_k P, in place of dN_k
    ld(Db + Ds::dq(k) * NN + i * N, dr[k]);
    ld(Nb + Ds::dq(k) * NN + e, v);
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int t = 0; t < W; ++t) v[t] -= dr[k][r] * Ps[r][t];
    st(Nb + Ds::dq(k) * NN + e, v);
  }
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < KM; ++k) {  // dP_k = D^-1 (dN_k - dD_k P), in place
    left_inv<N>(di, Nb + Ds::dq(k) * NN, j0, v);
    __syncwarp(mask);
    st(Nb + Ds::dq(k) * NN + e, v);
  }
  __syncwarp(mask);
  if (second) {
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int l = k; l < KM; ++l) {  // d2N_p - d2D_p P - dD_k dP_l - dD_l dP_k
        const int p = Ds::pq(k, l);
        float a1[N];
        ld(Db + p * NN + i * N, a1);
        ld(Nb + p * NN + e, v);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          float bl[W], bk[W];
          ld(Nb + Ds::dq(l) * NN + r * N + j0, bl);
          ld(Nb + Ds::dq(k) * NN + r * N + j0, bk);
#pragma unroll
          for (int t = 0; t < W; ++t)
            v[t] -= a1[r] * Ps[r][t] + dr[k][r] * bl[t] + dr[l][r] * bk[t];
        }
        st(Nb + p * NN + e, v);
      }
    __syncwarp(mask);
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int l = k; l < KM; ++l) {  // d2P_p = D^-1 (...), in place
        left_inv<N>(di, Nb + Ds::pq(k, l) * NN, j0, v);
        __syncwarp(mask);
        st(Nb + Ds::pq(k, l) * NN + e, v);
      }
    __syncwarp(mask);
  }

  // squarings: every new entry reads the old P family only
  float* cur = Nb;
  float* nxt = Db;
  for (int sq = 0; sq < nsq; ++sq) {
    float po[N];  // P's row i
    ld(cur + i * N, po);
#pragma unroll
    for (int r = 0; r < N; ++r) ld(cur + r * N + j0, Ps[r]);
#pragma unroll
    for (int k = 0; k < KM; ++k) ld(cur + Ds::dq(k) * NN + i * N, dr[k]);
    if (second) {
#pragma unroll
      for (int k = 0; k < KM; ++k)
#pragma unroll
        for (int l = k; l < KM; ++l) {
          const int p = Ds::pq(k, l);
          float a1[N];
          ld(cur + p * NN + i * N, a1);
#pragma unroll
          for (int t = 0; t < W; ++t) v[t] = 0.f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            float bd[W], bl[W], bk[W];
            ld(cur + p * NN + r * N + j0, bd);
            ld(cur + Ds::dq(l) * NN + r * N + j0, bl);
            ld(cur + Ds::dq(k) * NN + r * N + j0, bk);
#pragma unroll
            for (int t = 0; t < W; ++t)
              v[t] += a1[r] * Ps[r][t] + po[r] * bd[t] + dr[k][r] * bl[t] + dr[l][r] * bk[t];
          }
          st(nxt + p * NN + e, v);
        }
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) {
#pragma unroll
      for (int t = 0; t < W; ++t) v[t] = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        float bk[W];
        ld(cur + Ds::dq(k) * NN + r * N + j0, bk);
#pragma unroll
        for (int t = 0; t < W; ++t) v[t] += dr[k][r] * Ps[r][t] + po[r] * bk[t];
      }
      st(nxt + Ds::dq(k) * NN + e, v);
    }
#pragma unroll
    for (int t = 0; t < W; ++t) v[t] = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int t = 0; t < W; ++t) v[t] += po[r] * Ps[r][t];
    st(nxt + e, v);
    __syncwarp(mask);
    float* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  return cur;
}

// The outputs of pair m as a step writes them.  BASED: the pair's base
// pointers formed once (m = 0 after), else each store's address formed
// from m.  ptxas holds the n=8 kernels without a spill only so: based
// where the outputs are written after the solves (exponential) or at a
// free dt, from m for the Padé kernel at a fixed dt (based, it ran 0.042
// against 0.033 ms at the CNOT inputs on the H100).
template <int N, bool BASED>
__device__ __forceinline__ Dst outputs(float* o0, float* o1, float* o2, long m, int K, int Kp,
                                       bool live) {
  constexpr int NN = N * N;
  if constexpr (BASED)
    return Dst{nullptr, o0 + m * NN, o1 + m * K * NN, o2 + m * Kp * NN, 0, K, Kp, live};
  else
    return Dst{nullptr, o0, o1, o2, m, K, Kp, live};
}

// A pair's state slots at fin to its outputs (the P family after the
// squarings; the n=8 Padé kernel at a free dt after its last step)
template <int N, int NAM, bool FREE>
__device__ __forceinline__ void write_out(const float* fin, const Dst& out,
                                          const Dirs<NAM, FREE>& D, bool second, int e) {
  using Ds = Dirs<NAM, FREE>;
  constexpr int W = Tile<N>::W, NN = N * N, KM = Ds::KM;
  float v[W];
  ld(fin + e, v);
  put<N>(out, 0, 0, 0, true, e, v);
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    ld(fin + Ds::dq(k) * NN + e, v);
    put<N>(out, 0, 1, D.oq(k), D.on(k), e, v);
  }
  if (second) {
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int l = k; l < KM; ++l) {
        ld(fin + Ds::pq(k, l) * NN + e, v);
        put<N>(out, 0, 2, D.op(k, l), D.on(k) && D.on(l), e, v);
      }
  }
}

// Blocks an SM is to hold at once (__launch_bounds__'s minimum), stated
// rather than left to ptxas, whose own choice spilled at n=6.  Each of an
// SM's four schedulers holds the registers of its warps, 16,384: at 64
// threads a block, 5 blocks need <= 168 registers a thread, 4 allow 255.
// n=8, exponential, fixed dt: 5 blocks, as many as the shared memory holds
// (43,008 bytes a block), at 168 registers without a spill; elsewhere 1.
template <int N, bool FREE, bool EXP>
constexpr int min_blocks() {
  return N == 8 && EXP && !FREE ? 5 : 1;
}

// Padé outputs N, dN, d2N, D, dD, d2D in o0..o5; exponential P, dP, d2P in
// o0..o2.  1 <= na <= max_drives<N>; second: Kp = K(K+1)/2 second
// derivatives, else none.
template <int N, bool FREE, bool EXP>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<N, FREE, EXP>())
    bank_kernel(const float* __restrict__ a, const float* __restrict__ dt,
                const float* __restrict__ Gd, const float* __restrict__ Gs,
                const float* __restrict__ coeffs, int ncoef, int M, int na, int second, int nsq,
                float* o0, float* o1, float* o2, float* o3, float* o4, float* o5) {
  using T = Tile<N>;
  constexpr int W = T::W, NN = T::NN, NAM = max_drives<N>();
  using Ds = Dirs<NAM, FREE>;
  extern __shared__ float4 smem_v[];
  const int lane = threadIdx.x & 31;
  if (lane >= T::LANES) return;  // n=6: the two lanes past five pairs
  const unsigned mask = T::LANES == 32 ? 0xffffffffu : (1u << T::LANES) - 1u;
  const int pw = lane / T::TPP, tp = lane % T::TPP, pb = pw * T::TPP;
  const int i = tp / T::SPR, jq = tp % T::SPR, j0 = jq * W, e = i * N + j0;
  const int pl = (threadIdx.x >> 5) * T::PPW + pw;  // the pair's slot in the block
  // The n=8 Padé kernel at a free dt runs its last step in place too and
  // writes its outputs from the state: with the outputs' addresses in that
  // step ptxas spills it (255 registers).
  constexpr bool VIA_STATE = !EXP && N == 8 && FREE;
  const Ds D{na};
  const int K = D.K(), Kp = second ? K * (K + 1) / 2 : 0, QS = Ds::slots(second);
  float* S0 = reinterpret_cast<float*>(smem_v) + pl * (EXP ? 2 : 1) * QS * NN;
  float* S1 = S0 + QS * NN;

  long m = (long)blockIdx.x * (kWarps * T::PPW) + pl;
  const bool live = m < M;
  if (!live) m = M - 1;  // idle pairs compute a copy and write nothing
  const float scale = EXP ? ldexpf(1.f, -nsq) : 1.f;
  Gen<N, NAM> A;
  float av[NAM];
#pragma unroll
  for (int k = 0; k < NAM; ++k) av[k] = k < na ? __ldg(a + m * na + k) : 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float g = __ldg(Gd + i * N + r) * scale;
#pragma unroll
    for (int k = 0; k < NAM; ++k) {
      const float gk = k < na ? __ldg(Gs + (k * N + i) * N + r) * scale : 0.f;
      A.r[k][r] = gk;
      if (k < na) g += av[k] * gk;
    }
    A.g[r] = g;
  }
  const float h = __ldg(dt + m);
  const float cm = __ldg(coeffs + ncoef - 1), cn = __ldg(coeffs + ncoef - 2);

#pragma unroll 1
  for (int sg = 0; sg < 2; ++sg) {
    const float sgn = sg == 0 ? 1.f : -1.f, sx = sgn * h;
    float* S = EXP && sg ? S1 : S0;
    const Dst state{S, nullptr, nullptr, nullptr, m, K, Kp, live};
    const Dst out = outputs<N, FREE>(sg ? o3 : o0, sg ? o4 : o1, sg ? o5 : o2, m, K, Kp, live);
    if (!EXP && !VIA_STATE && ncoef == 2)  // the one step: straight to the outputs
      horner_first<N, NAM, FREE>(out, D, A, cm, cn, sx, sgn, second, false, i, jq, j0, e);
    else  // into the state; the zero slots only where no full step follows
      horner_first<N, NAM, FREE>(state, D, A, cm, cn, sx, sgn, second, ncoef > 2, i, jq, j0,
                                 e);
    __syncwarp(mask);
    for (int ci = ncoef - 3; ci >= 0; --ci) {
      const float c = __ldg(coeffs + ci);
      const bool x2_live = ci < ncoef - 3;
      if (!EXP && !VIA_STATE && ci == 0)
        horner_step<N, NAM, FREE, false>(S, out, A, D, sx, sgn, c, second, x2_live, i, j0, e,
                                         mask);
      else
        horner_step<N, NAM, FREE, true>(S, state, A, D, sx, sgn, c, second, x2_live, i, j0, e,
                                        mask);
    }
    if constexpr (VIA_STATE) write_out<N, NAM, FREE>(S, out, D, second, e);
    __syncwarp(mask);  // the next sign rewrites the state just read
  }
  if constexpr (EXP) {
    const float* fin = exp_finish<N, NAM, FREE>(S0, S1, D, second, nsq, i, jq, j0, e, pb, mask);
    write_out<N, NAM, FREE>(fin, outputs<N, true>(o0, o1, o2, m, K, Kp, live), D, second, e);
  }
}

// One sign of the entry design's Horner recursion of q(sgn X), X = h G,
// with first and second theta-derivatives, in a pair's two Q x NN buffers
// b0 and b1 (Q = 1 + K + Kp: acc, first, second derivatives); returns the
// buffer with the result.  Every thread of the block calls it (it holds
// barriers).
template <int N>
__device__ __forceinline__ float* entry_horner(float* b0, float* b1, const float* G,
                                               const float* Gs_s, const float* coeffs, int ncoef,
                                               float sgn, float h, int na, int K, int Kp,
                                               int free_dt, int i, int j, int e) {
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
__global__ void entry_bank_kernel(const float* __restrict__ a, const float* __restrict__ dt,
                                  const float* __restrict__ Gd, const float* __restrict__ Gs,
                                  const float* __restrict__ coeffs, int ncoef, int M, int na,
                                  int K, int Kp, int free_dt, float* __restrict__ Nm,
                                  float* __restrict__ dN, float* __restrict__ d2N,
                                  float* __restrict__ Dm, float* __restrict__ dD,
                                  float* __restrict__ d2D) {
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
    const float* fin = entry_horner<N>(bufs[0], bufs[1], G, Gs_s, coeffs, ncoef,
                                       sg == 0 ? 1.f : -1.f, h, na, K, Kp, free_dt, i, j, e);
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
__global__ void entry_exp_bank_kernel(const float* __restrict__ a, const float* __restrict__ dt,
                                      const float* __restrict__ Gd, const float* __restrict__ Gs,
                                      const float* __restrict__ coeffs, int ncoef, int M, int na,
                                      int K, int Kp, int free_dt, int nsq,
                                      float* __restrict__ Pm, float* __restrict__ dP,
                                      float* __restrict__ d2P) {
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

  float* Nb =
      entry_horner<N>(b0, b1, G, Gs_s, coeffs, ncoef, 1.f, h, na, K, Kp, free_dt, i, j, e);
  float* other = Nb == b0 ? b1 : b0;
  const float* Db = entry_horner<N>(other, b2, G, Gs_s, coeffs, ncoef, -1.f, h, na, K, Kp,
                                    free_dt, i, j, e);
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

// The sizes the strip design is built for: its register tiles keep a
// thread's rows of every drive, which fit up to n = 8.  Past that (n = 18,
// two coupled three-level transmons) only the entry design is instantiated.
template <int N>
constexpr bool has_strip() {
  return N <= 8;
}

// Whether the strip design takes na drives at n
template <int N>
bool strip(int na) {
  if constexpr (has_strip<N>())
    return na >= 1 && na <= max_drives<N>();
  else
    return false;
}

// The shape of a launch: threads a pair, pairs a block, shared bytes a
// block.  Entry design: as many pairs as fill 256 threads, fewer where the
// block's shared memory would pass the card's opt-in cap.
struct Shape {
  int tpp, pairs, smem;
};

template <int N>
Shape shape(int na, bool free, int Kp, bool exp, int cap) {
  const int K = na + free;
  constexpr int NN = N * N;
  const int Q = 1 + K + Kp;
  if constexpr (has_strip<N>()) {
    if (strip<N>(na)) {
      const int QS = free ? Dirs<max_drives<N>(), true>::slots(Kp > 0)
                          : Dirs<max_drives<N>(), false>::slots(Kp > 0);
      return {Tile<N>::TPP, kWarps * Tile<N>::PPW,
              kWarps * Tile<N>::PPW * (exp ? 2 : 1) * QS * NN * (int)sizeof(float)};
    }
  }
  const int fixed = na * NN * (int)sizeof(float);
  const int per_pair = (exp ? 4 * NN + 3 * Q * NN : NN + 2 * Q * NN) * (int)sizeof(float);
  int P = 256 / NN > 0 ? 256 / NN : 1;  // pairs a block: >= 128 threads for n >= 4
  while (P > 1 && fixed + P * per_pair > cap) --P;
  return {NN, P, fixed + P * per_pair};
}

// The card's opt-in shared memory a block, read once per device
int smem_cap() {
  static int caps[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = caps[dev & 15];
  if (cap == 0) cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cap;
}

// Opts kernel in to smem bytes of dynamic shared memory where that passes
// 48 KB; opted: the most set so far for this kernel, per device (set once,
// not on every launch)
int opt_in(const void* kernel, int smem, int (&opted)[16]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && smem > opted[dev & 15]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev & 15] = smem;
  }
  return 0;
}

// The launch of one kernel.  Padé outputs: N, dN, d2N, D, dD, d2D;
// exponential: P, dP, d2P in the first three.
template <int N, bool FREE, bool EXP>
int launch_strip(const float* a, const float* dt, const float* Gd, const float* Gs,
                 const float* coeffs, int ncoef, int M, int na, int Kp, int nsq, const Shape& s,
                 float* o0, float* o1, float* o2, float* o3, float* o4, float* o5,
                 cudaStream_t stream) {
  static int opted[16] = {0};
  if (int err = opt_in((const void*)bank_kernel<N, FREE, EXP>, s.smem, opted)) return err;
  bank_kernel<N, FREE, EXP><<<(M + s.pairs - 1) / s.pairs, kWarps * 32, s.smem, stream>>>(
      a, dt, Gd, Gs, coeffs, ncoef, M, na, Kp > 0, nsq, o0, o1, o2, o3, o4, o5);
  return (int)cudaGetLastError();
}

template <int N, bool EXP>
int launch_entry(const float* a, const float* dt, const float* Gd, const float* Gs,
                 const float* coeffs, int ncoef, int M, int na, int K, int Kp, int free_dt,
                 int nsq, const Shape& s, float* o0, float* o1, float* o2, float* o3, float* o4,
                 float* o5, cudaStream_t stream) {
  static int opted[16] = {0};
  const void* kernel = EXP ? (const void*)entry_exp_bank_kernel<N> : (const void*)entry_bank_kernel<N>;
  if (int err = opt_in(kernel, s.smem, opted)) return err;
  const int blocks = (M + s.pairs - 1) / s.pairs, threads = s.pairs * N * N;
  if constexpr (EXP)
    entry_exp_bank_kernel<N><<<blocks, threads, s.smem, stream>>>(
        a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, nsq, o0, o1, o2);
  else
    entry_bank_kernel<N><<<blocks, threads, s.smem, stream>>>(
        a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, o0, o1, o2, o3, o4, o5);
  return (int)cudaGetLastError();
}

template <int N>
int launch(const float* a, const float* dt, const float* Gd, const float* Gs, const float* coeffs,
           int ncoef, int M, int na, int K, int Kp, int free_dt, int exp_kind, int nsq, float* o0,
           float* o1, float* o2, float* o3, float* o4, float* o5, cudaStream_t st) {
  const int cap = smem_cap();
  const Shape s = shape<N>(na, free_dt != 0, Kp, exp_kind != 0, cap);
  if (s.smem > cap) return (int)cudaErrorInvalidConfiguration;
  if (!strip<N>(na))
    return exp_kind ? launch_entry<N, true>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt,
                                            nsq, s, o0, o1, o2, o3, o4, o5, st)
                    : launch_entry<N, false>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt,
                                             0, s, o0, o1, o2, o3, o4, o5, st);
  if constexpr (has_strip<N>()) {
#define QCT_STRIP(FV)                                                                          \
  return exp_kind ? launch_strip<N, FV, true>(a, dt, Gd, Gs, coeffs, ncoef, M, na, Kp, nsq, s,  \
                                              o0, o1, o2, o3, o4, o5, st)                       \
                  : launch_strip<N, FV, false>(a, dt, Gd, Gs, coeffs, ncoef, M, na, Kp, 0, s,   \
                                               o0, o1, o2, o3, o4, o5, st);
    if (free_dt) QCT_STRIP(true)
    QCT_STRIP(false)
#undef QCT_STRIP
  }
  return (int)cudaErrorNotSupported;  // not reached: strip<N> is false without the design
}

}  // namespace

// The sizes n the kernels are instantiated for (18: the entry design only)
#define QCT_SIZES(X) X(2) X(4) X(6) X(8) X(18)

// a (M, na), dt (M,), Gd (n, n), Gs (na, n, n), coeffs (ncoef >= 2) on the
// device, K = na + free_dt; Kp = 0 (first order) or K(K+1)/2; outputs
// batch-first as above (the second-order ones unused when Kp = 0; o3..o5
// unused for exp_kind = 1, whose nsq squarings follow the Padé step).
// Returns cudaErrorNotSupported for an n without a kernel.
extern "C" int qct_prop_bank(const float* a, const float* dt, const float* Gd, const float* Gs,
                             const float* coeffs, int ncoef, int M, int n, int na, int K, int Kp,
                             int free_dt, int exp_kind, int nsq, float* o0, float* o1, float* o2,
                             float* o3, float* o4, float* o5, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0) return 0;
  if (ncoef < 2 || na < 0 || K != na + (free_dt ? 1 : 0) || (Kp != 0 && Kp != K * (K + 1) / 2))
    return (int)cudaErrorInvalidValue;
#define QCT_CASE(NV)                                                                       \
  if (n == NV)                                                                             \
    return launch<NV>(a, dt, Gd, Gs, coeffs, ncoef, M, na, K, Kp, free_dt, exp_kind, nsq, \
                      o0, o1, o2, o3, o4, o5, st);
  QCT_SIZES(QCT_CASE)
#undef QCT_CASE
  return (int)cudaErrorNotSupported;
}

// Launch configuration for n x n generators, na drives, a free dt or not,
// second order or not: threads per pair, pairs per block, shared bytes per
// block, 1 for the strip design or 0 for the entry design (out[0..3]).
// Returns cudaErrorNotSupported for an n without a kernel.
extern "C" int qct_prop_bank_config(int n, int na, int free_dt, int second, int exp_kind,
                                    int* out) {
  const int K = na + (free_dt ? 1 : 0), Kp = second ? K * (K + 1) / 2 : 0;
#define QCT_CASE(NV)                                                  \
  if (n == NV) {                                                      \
    const Shape s = shape<NV>(na, free_dt != 0, Kp, exp_kind != 0, smem_cap());  \
    out[0] = s.tpp;                                                   \
    out[1] = s.pairs;                                                 \
    out[2] = s.smem;                                                  \
    out[3] = strip<NV>(na);                                           \
    return 0;                                                         \
  }
  QCT_SIZES(QCT_CASE)
#undef QCT_CASE
  return (int)cudaErrorNotSupported;
}
