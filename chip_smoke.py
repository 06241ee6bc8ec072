"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. environment: torch/CUDA versions and the card (the nvidia-smi name and
     power-limit line is printed on its own line); TF32 off;
  2. build: every CUDA kernel of the port, compiled from csrc/ in parallel;
  3. kernels, Hadamard shapes: each kernel of that path against its plain
     PyTorch version on the card, on the inputs of the first IPM iteration
     of the phase-4 problem, with times (CUDA events, median of 20 after
     warm-up) and bounds; the bank kernel runs there only for the
     multiplier initialisation's Jacobian;
  4. main path, Hadamard: the batched smooth-pulse solve (B=512, T=51,
     Q=1e4, R=1e-3, 48 iterations, filter line search, kappa_mu 0.2,
     tol 1e-5, float32) through UnitarySmoothPulseProblem; one discarded
     warm-up solve, then a timed one with the kernels' launch counts;
     checked by a float64 rollout (converged_frac at infidelity <= 1e-4);
  5. reference, Hadamard: the kernel path's KKT step on the first
     iteration's real system against the float64 CPU solve, beside the
     plain float32 path;
  6. kernels, CNOT shapes: the bank kernel (4,992 pairs, n=8, K=5), the
     forward sweep with kept factors, the backward sweep and the rhs-only
     forward sweep (B=128, T=40, d=47, s=42) against their plain versions;
  7. main path, CNOT (BASELINE #3): the two-qubit smooth-pulse solve at
     fixed time (B=128, T=40, Δt=0.3, Q=1e4, R=1e-3, 80 iterations,
     kkt_backend "lanes", so the fused assembly is off and each KKT
     attempt is refined once through its kept factors), seeds from
     multistart_initial_decisions; one discarded warm-up solve of a few
     iterations, then the timed one; checked by a float64 rollout (the
     fractions at infidelity <= 1e-4, 1e-3, 1e-2; frac@1e-4 >= 0.9);
  8. reference, CNOT: on the first iteration's real KKT system, the
     float32 kernel path's error against the float64 CPU solve with 0 and
     with 1 refinement pass, beside the plain float32 path's;
  9. kernels, ket_exp shapes: the exponential branches of the fused
     assembly (B=512, T=50, d=15, s=13, one squaring) and of the bank (first
     order, 25,088 pairs, n=4, K=3, as the path runs it), the forward and
     the backward sweep, against their plain versions, on the first
     iteration's inputs of the phase-10 problem; and that iteration's real
     KKT system as in phase 5;
 10. main path, ket_exp: the two-ket state transfer |0>->|1>, |1>->|0> with
     one shared pulse (0.1 Z drift, X and Y drives, T=50, Δt=0.2 free,
     Q=1e4, R=1e-3, the exponential integrator, 48 iterations, filter line
     search, kappa_mu 0.2, tol 1e-5, B=512, seeds as phase 4's) through
     QuantumStateSmoothPulseProblem; an instance counts when both kets
     reach infidelity <= 1e-4 by the float64 rollout (fraction >= 0.9);
 11. kernels, cnot_exp shapes: the bank's exponential branch (second
     order, 4,992 pairs, n=8, K=5, two squarings) and the three sweeps, as
     phase 6;
 12. main path, cnot_exp: phase 7's problem with the exponential
     integrator (fixed time, so the fused assembly is off and the bank's
     exponential branch runs in every iteration); frac@1e-4 >= 0.9;
 13. reference, cnot_exp: phase 8 on this problem's first iteration;
 14. kernels, L-BFGS shapes: phase 4's problem with
     PiccoloOptions(eval_hessian=False) (lbfgs_memory 6); on the real KKT
     system of its iteration 8, once the memory holds 6 pairs (H = σI +
     barrier, C = 0, right-hand side [rz | U], r = 13 columns), the forward
     and backward sweeps and the first-order bank against their plain
     versions, with the system's float32 error against float64 as in
     phase 5; and a seeded d=47, s=42, r=13, B=128 case of the two sweeps;
 15. main path, hadamard_lbfgs: that problem, B=512, 300 iterations, the
     seeds of phase 4; one discarded warm-up solve of a few iterations, then
     the timed one; the fractions at infidelity <= 1e-2, 1e-3, 1e-4 by the
     float64 rollout (frac@1e-3 >= 0.9), and the launch checks: no
     assembly, no rhs-only sweep, forward = backward sweeps = KKT attempts
     + 1 (the multiplier initialisation), a bank launch per iteration;
 16. kernels, scan shapes: the per-knot steps (kernels 6 and 7) against
     fwd_step_reference / bwd_step_reference, one knot and a whole
     solve_kkt_lanes_scan solve, on seeded blocks of the Hadamard shapes;
     times (per launch and per solve) on the first iteration's real blocks;
 17. main path, hadamard_scan: phase 4's problem with kkt_backend
     "lanes_scan", 48 iterations (frac@1e-4 >= 0.9); each step kernel
     launches (T-1) x (KKT attempts + 1) times and the fused sweeps never.
The exponential bank's rows also time its library counterpart
(exp_bank_library: torch.linalg.matrix_exp on block-triangular matrices).
Then the kernels line, and last {"ok": true, "device": {...}}.  Each main
path checks its own kernels' launch counts.  Any failed check exits
nonzero before the last line.  Without CUDA it exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, T, ITERS = 512, 51, 48
CX_B, CX_T, CX_DT, CX_ITERS, CX_WARM = 128, 40, 0.3, 80, 3
KET_T = 50  # ket_exp: B and ITERS as the Hadamard path
QN_ITERS, QN_AT, NEW_WARM = 300, 8, 3  # hadamard_lbfgs; warm-up of the new paths
# float32 tolerances, relative to the largest entry of the plain output:
# the kernel and its plain version round in different orders (a Horner
# chain per thread vs batched matmuls; scalar Cholesky loops vs batched
# LAPACK-style factorizations), and the sweeps' error grows with the
# conditioning of the regularized KKT blocks
TOL = 1e-4
SRC = "quantumcollocation_tpu_torch/csrc/"
REPLACES = {
    "dyn_assembly": "quantumcollocation_tpu/ops/pallas_dyn_assembly.py:188",
    "prop_bank": "quantumcollocation_tpu/ops/pallas_prop_bank.py:68",
    "kkt_fwd_sweep": "quantumcollocation_tpu/solver/kkt_lanes.py:484",
    "kkt_bwd_sweep": "quantumcollocation_tpu/solver/kkt_lanes.py:565",
    "kkt_rhs_fwd_sweep": "quantumcollocation_tpu/solver/kkt_lanes.py:540",
    "kkt_fwd_step": "quantumcollocation_tpu/solver/kkt_lanes.py:311",
    "kkt_bwd_step": "quantumcollocation_tpu/solver/kkt_lanes.py:346",
}
SOURCE = {"dyn_assembly": SRC + "dyn_assembly.cu", "prop_bank": SRC + "prop_bank.cu",
          **{k: SRC + "kkt_sweeps.cu" for k in ("kkt_fwd_sweep", "kkt_bwd_sweep",
                                                "kkt_rhs_fwd_sweep", "kkt_fwd_step",
                                                "kkt_bwd_step")}}
F4 = 4  # bytes per float32


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card_rates(name):
    """(bytes/s, float32 FLOP/s outside the tensor cores): NVIDIA's data
    sheets for the H100 variants, dense."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def rel_err(out, ref, keep=None):
    """(max abs error, relative to max(1, max |ref|)) over the instances
    (leading axis) in keep."""
    if keep is not None:
        out, ref = out[keep], ref[keep]
    err = (out.double() - ref.double()).abs().max().item()
    scale = max(1.0, ref.double().abs().max().item())
    return err, err / scale


def seeded_kkt(Bn, Tn, d, s, device, r=None):
    """Seeded blocks of the given shapes, shaped like dynamics defects
    (A ≈ -I, B ≈ I) and definite, so that float32 resolves them (their
    float32 error against float64 is ~1e-6 relative at d=15).  At the
    two-qubit size the noise shrinks with d, and B ≈ I/2 makes the chain
    contract: with B ≈ I the eliminated blocks sum H along the 40 knots,
    and the carried rhs reaches ~7e3, where float32 rounding alone is
    ~8e-5 of it (a CPU float32-vs-float64 probe).  With r, the two
    right-hand sides have r columns."""
    rng = np.random.default_rng(0)
    cols = () if r is None else (r,)
    small = d <= 16
    w = 0.3 if small else 1.0 / np.sqrt(d)
    Hs = np.eye(d) * 3 + w * rng.normal(size=(Bn, Tn, d, d))
    E = np.eye(s, d)
    out = [0.5 * (Hs + np.swapaxes(Hs, -1, -2)),
           (0.2 if small else 0.7 * w) * rng.normal(size=(Bn, Tn - 1, d, d)),
           -E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           (1.0 if small else 0.5) * E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols))]
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in out]


def sweep_counts(Bn, Tn, d, s, kernel, factors=False, r=1):
    """(bytes, flops) of one sweep call with r right-hand-side columns:
    each input read once, each output written once; flops of the
    elimination's products and triangular solves."""
    Tm1 = Tn - 1
    if kernel == "kkt_fwd_sweep":
        # chol(P); P^-1 [A^T | C | q]; A [X_A | X_C | x]; chol(S);
        # S^-1 [G | r]; G^T (S^-1 [G | r]) and C^T [X_C | x], once each
        per_knot = (d**3 / 3 + 2 * d * d * (s + d + r) + 2 * s * d * (s + d + r)
                    + s**3 / 3 + 2 * s * s * (d + r) + 2 * d * s * (d + r)
                    + 2 * d * d * (d + r))
        flops = Bn * (Tm1 * per_knot + d**3 / 3 + 2 * d * d * r)
        reads = Tn * d * d + Tm1 * (d * d + 2 * s * d + s * r) + Tn * d * r
        writes = Tm1 * (d * d + s * s + d * s + d * r) + d * r
        if factors:
            writes += Tm1 * s * d + d * d
        return F4 * Bn * (reads + writes), flops
    if kernel == "kkt_bwd_sweep":
        per_knot = r * (2 * d * d + 4 * s * d + 2 * d * d + 2 * s * s + 2 * d * s)
        nbytes = F4 * Bn * (Tm1 * (d * d + s * s + d * s + d * r + d * d + 2 * s * d + s * r)
                            + d * r + Tm1 * (d + s) * r)
        return nbytes, Bn * Tm1 * per_knot
    # kkt_rhs_fwd_sweep: L_P, L_S, G, C, A, rz, rnu, L_Pf in; q, dz_{T-1} out
    per_knot = 2 * d * d + 2 * s * d + 2 * s * s + 2 * s * d + 2 * d * d + 3 * d + s
    reads = Tm1 * (d * d + s * s + s * d + d * d + s * d + s) + Tn * d + d * d
    writes = Tm1 * d + d
    return F4 * Bn * (reads + writes), Bn * (Tm1 * per_knot + 2 * d * d + d)


def step_counts(Bn, Tn, d, s):
    """(bytes, flops) of one solve through the per-knot kernels of the
    lanes_scan backend (kernels 6 and 7), T-1 calls each: every call reads
    and writes its blocks as listed in the JAX pallas_call specs, the
    Riccati carry included."""
    fwd_io = 3 * d * d + 2 * d + 2 * s * d + s + (2 * d * d + 2 * d + s * s + d * s)
    fwd_fl = (d**3 / 3 + 2 * d * d * s + 2 * d**3 + 2 * d * d + 2 * s * s * d + s**3 / 3
              + 2 * s * d * d + 2 * s * d + 2 * s * s + 2 * s * s * d + 2 * d**3
              + 2 * d * d * s + 2 * d * d + 2 * s * d)
    bwd_io = 2 * d + 2 * d * d + s * s + d * s + 2 * s * d + s + (d + s)
    bwd_fl = 2 * d * d + 2 * s * d + 2 * d * d + 2 * s * d + 2 * s * s + 2 * d * s
    Tm1 = Tn - 1
    return {"kkt_fwd_step": (F4 * Bn * Tm1 * fwd_io, Bn * Tm1 * fwd_fl),
            "kkt_bwd_step": (F4 * Bn * Tm1 * bwd_io, Bn * Tm1 * bwd_fl)}


def bank_counts(M, n, na, free_dt, order=4, second_order=True):
    """(bytes, flops) of one bank call: a and dt in, the generators once,
    N, D and their derivatives out; the products the Horner recursion
    needs.  Its first step starts from acc = c I with zero derivatives, so
    it only scales (n^2 per output matrix); after it, d2acc is nonzero only
    for the (a_k, dt) pairs of a free dt until the third step."""
    K = na + int(free_dt)
    Kp = K * (K + 1) // 2 if second_order else 0
    extra = na if free_dt and second_order else 0  # pairs (a_k, dt): d2X_p = G_k
    products = 0
    for step in range(2, order // 2 + 1):
        # X acc, dX_k acc + X dacc_k, dX_k dacc_l + dX_l dacc_k, d2X_p acc,
        # X d2acc_p where d2acc_p is nonzero
        products += 1 + 2 * K + 2 * Kp + extra + (Kp if step > 2 else extra)
    per_sign = (1 + K + Kp) * n * n + products * 2 * n**3
    flops = M * (2 * na * n * n + 2 * per_sign)
    nbytes = F4 * (M * (na + 1) + (na + 1) * n * n + 2 * M * (1 + K + Kp) * n * n)
    return nbytes, flops


def exp_bank_counts(M, n, na, free_dt, nsq, second_order=True):
    """(bytes, flops) of one exponential bank call: a and dt in, the
    generators once, P and its derivatives out (one family); the order-8
    Horner products of both signs (bank_counts), then per pair the
    Gauss-Jordan inverse of D (4 n^2 (n-1)), P = D^-1 N, the K numerators
    and solves of dP, the Kp of d2P (three products and a solve each), and
    per squaring 4 products for each d2P, 2 for each dP and 1 for P."""
    K = na + int(free_dt)
    Kp = K * (K + 1) // 2 if second_order else 0
    mm = 2 * n**3
    per_pair = (4 * n * n * (n - 1) + mm + K * (2 * mm + n * n) + Kp * (4 * mm + 3 * n * n)
                + nsq * (Kp * (4 * mm + 3 * n * n) + K * (2 * mm + n * n) + mm))
    flops = bank_counts(M, n, na, free_dt, order=8, second_order=second_order)[1] + M * per_pair
    nbytes = F4 * (M * (na + 1) + (na + 1) * n * n + M * (1 + K + Kp) * n * n)
    return nbytes, flops


def exp_bank_library(a, dt, Gd, Gs, free_dt, second_order):
    """The exponential bank through one torch.linalg.matrix_exp call on
    block upper-triangular matrices (Van Loan; Mathias): exp([[X, E], [0,
    X]]) holds P and L(X, E) in its top row; exp([[X, E_k, 0], [0, X,
    E_l], [0, 0, X]]) holds in its corner the ordered term whose sum over
    (k, l) and (l, k) is d2P_kl when X is linear in θ.  So first order
    takes (M, K) blocks of 2n, second order (M, K, K) blocks of 3n and
    fixed Δt (a free Δt's (a_k, Δt) cross term needs L(X, G_k) as well).
    Returns (P, dP, d2P or None) as prop_bank_reference."""
    M, na = a.shape
    n = Gd.shape[0]
    G = Gd + torch.tensordot(a, Gs, dims=1)
    X = G * dt[:, None, None]
    E = Gs[None] * dt[:, None, None, None]
    if free_dt:
        E = torch.cat([E, G[:, None]], dim=1)
    K = E.shape[1]
    if not second_order:
        W = X.new_zeros(M, K, 2 * n, 2 * n)
        W[..., :n, :n] = W[..., n:, n:] = X[:, None]
        W[..., :n, n:] = E
        Q = torch.linalg.matrix_exp(W)
        return Q[:, 0, :n, :n], Q[..., :n, n:], None
    if free_dt:
        raise ValueError("second order with a free Δt has no block form here")
    W = X.new_zeros(M, K, K, 3 * n, 3 * n)
    for i in range(3):
        W[..., i * n:(i + 1) * n, i * n:(i + 1) * n] = X[:, None, None]
    W[..., :n, n:2 * n] = E[:, :, None]
    W[..., n:2 * n, 2 * n:] = E[:, None, :]
    Q = torch.linalg.matrix_exp(W)
    ks, ls = zip(*[(k, l) for k in range(K) for l in range(k, K)])
    C = Q[..., :n, 2 * n:]
    return Q[:, 0, 0, :n, :n], Q[:, :, 0, :n, n:2 * n], C[:, ks, ls] + C[:, ls, ks]


def member_flops(n, K, ncols, exp):
    """flops of one member's writes in the fused assembly per pair: the
    defect, the K θ-columns, λU^T, the Kp curvature sums and the K (u, θ)
    curvature columns (Padé: both N and D terms; exponential: P only)."""
    Kp = K * (K + 1) // 2
    f = 1 if exp else 2
    return f * (2 * n * n * ncols * (2 + 2 * K) + 2 * Kp * n * n)


def finish(results, bw, f32_peak):
    for r in results.values():
        r["bound_ms"] = 1e3 * max(r["bytes"] / bw, r["flops"] / f32_peak)
        r["bound_by"] = "bytes" if r["bytes"] / bw >= r["flops"] / f32_peak else "operations"
        r["tol"] = TOL
        r["ok"] = bool(r["max_rel_err"] <= TOL)
        r.setdefault("library_ms", None)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import quantumcollocation_tpu_torch as q
    from quantumcollocation_tpu_torch.ops import build
    from quantumcollocation_tpu_torch.ops import prop_bank as pb
    from quantumcollocation_tpu_torch.ops.dyn_assembly import (
        dyn_assembly_cuda,
        dyn_assembly_reference,
    )
    from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
    from quantumcollocation_tpu_torch.solver.kkt import solve_kkt
    from quantumcollocation_tpu_torch.solver.lbfgs import lbfgs_rhs

    # ---- 1. environment ---------------------------------------------- #
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "tf32": False})
    bw, f32_peak = card_rates(kind)
    t_start = time.perf_counter()

    # ---- 2. build ------------------------------------------------------ #
    build_s = build.build_all()
    emit({"phase": "build", "sources": sorted(build.SOURCES.values()), "build_s": build_s})

    def bank_entry(Z, analytic, v, second_order=True):
        """The bank kernel against its plain version on the pairs of Z, in
        the kind (Padé or exponential) of the problem's group."""
        (g,) = analytic.groups
        Zp = Z * torch.as_tensor(v, dtype=Z.dtype, device=Z.device)
        na = g.G_drives.shape[0]
        a = Zp[:, :-1, g.a_slice[0]:g.a_slice[1]].reshape(-1, na).contiguous()
        free = g.dt_col is not None
        dt = (Zp[:, :-1, g.dt_col].reshape(-1).contiguous() if free
              else torch.full((a.shape[0],), g.dt_static, dtype=Z.dtype, device=Z.device))
        Gd = torch.as_tensor(g.G_drift, dtype=Z.dtype, device=Z.device)
        Gs = torch.as_tensor(g.G_drives, dtype=Z.dtype, device=Z.device)
        kw = dict(kind=g.kind, order=g.order, num_squarings=g.num_squarings, free_dt=free,
                  second_order=second_order)
        k_out = pb.prop_bank_cuda(a, dt, Gd, Gs, **kw)
        r_out = pb.prop_bank_reference(a, dt, Gd, Gs, **kw)
        errs = [rel_err(x, y) for x, y in zip(k_out, r_out) if y is not None]
        lib = {}
        if g.kind == "exp":
            nbytes, flops = exp_bank_counts(a.shape[0], Gd.shape[0], na, free, g.num_squarings,
                                            second_order)
            # the library counterpart, block set-up included, and its
            # agreement with the plain version (printed, not a check)
            l_out = exp_bank_library(a, dt, Gd, Gs, free, second_order)
            lib = dict(
                library_ms=time_ms(lambda: exp_bank_library(a, dt, Gd, Gs, free, second_order)),
                library_max_rel_err=max(rel_err(x, y)[1] for x, y in zip(l_out, r_out)
                                        if y is not None))
        else:
            nbytes, flops = bank_counts(a.shape[0], Gd.shape[0], na, free, g.order)
        return dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: pb.prop_bank_cuda(a, dt, Gd, Gs, **kw)),
            plain_ms=time_ms(lambda: pb.prop_bank_reference(a, dt, Gd, Gs, **kw)),
            bytes=nbytes, flops=flops, **lib,
            shapes={"M": a.shape[0], "n": Gd.shape[0], "K": na + int(free), "free_dt": free,
                    "kind": g.kind, "num_squarings": g.num_squarings,
                    "second_order": second_order},
        )

    def sweep_entries(real, Bn, Tn, delta_c, factors, r=None):
        """Kernels 2, 3 (and 4 with factors) against their plain versions
        on seeded blocks of the path's shapes (r right-hand-side columns
        where r is given); times on the path's real blocks (H with the
        accepted δ_w)."""
        d, s = real[0].shape[-1], real[2].shape[-2]
        dev = real[0].device
        seeded = seeded_kkt(Bn, Tn, d, s, dev, r)
        mats, rhs, rhs2 = seeded[:4], seeded[4:6], seeded[6:]
        out = {}
        k_f = list(kl.fwd_sweep_cuda(*mats, *rhs, delta_c, want_factors=factors))
        k_f[4] = k_f[4][:, -1]
        ref_f = kl.fwd_sweep_reference(*mats, *rhs, delta_c, want_factors=factors)
        errs = [rel_err(a, b) for a, b in zip(k_f, ref_f[:5] + ref_f[6:])]
        nbytes, flops = sweep_counts(Bn, Tn, d, s, "kkt_fwd_sweep", factors, r or 1)
        out["kkt_fwd_sweep"] = dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: kl.fwd_sweep_cuda(*real, delta_c, want_factors=factors)),
            plain_ms=time_ms(lambda: kl.fwd_sweep_reference(*real, delta_c, factors)),
            bytes=nbytes, flops=flops, kept_factors=factors, columns=r or 1,
        )

        def bwd_args(L_P, L_S, X_A, qs, dz_last, C_, A_, B_, rnu_):
            dz0 = torch.empty(Bn, Tn, *dz_last.shape[1:], dtype=L_P.dtype, device=dev)
            dz0[:, -1] = dz_last
            return (L_P, L_S, X_A, qs, C_, A_, B_, rnu_, dz0)

        L_P, L_S, X_A, qs, dz_last = ref_f[:5]
        sC, sA, sB, srnu = mats[1], mats[2], mats[3], rhs[1]
        dz_k, nu_k = kl.bwd_sweep_cuda(*bwd_args(L_P, L_S, X_A, qs, dz_last, sC, sA, sB, srnu))
        dz_r, nu_r = kl.bwd_sweep_reference(L_P, L_S, X_A, qs, sC, sA, sB, srnu, dz_last)
        errs = [rel_err(dz_k, dz_r), rel_err(nu_k, nu_r)]
        rf = kl.fwd_sweep_reference(*real, delta_c, factors)
        C, A, Bj, rnu = real[1], real[2], real[3], real[5]
        real_bwd = bwd_args(*rf[:5], C, A, Bj, rnu)
        nbytes, flops = sweep_counts(Bn, Tn, d, s, "kkt_bwd_sweep", r=r or 1)
        out["kkt_bwd_sweep"] = dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: kl.bwd_sweep_cuda(*real_bwd)),
            plain_ms=time_ms(lambda: kl.bwd_sweep_reference(*rf[:4], C, A, Bj, rnu, rf[4])),
            bytes=nbytes, flops=flops, columns=r or 1,
        )
        if factors:
            G, L_Pf = ref_f[6].contiguous(), ref_f[7].contiguous()
            q_k, dz_k = kl.rhs_fwd_sweep_cuda(L_P, L_S, G, sC, sA, *rhs2, L_Pf)
            q_r, dzl_r = kl.rhs_fwd_sweep_reference(L_P, L_S, G, sC, sA, *rhs2, L_Pf)
            errs = [rel_err(q_k, q_r), rel_err(dz_k[:, -1], dzl_r)]
            rz, rG, rL_Pf = real[4], rf[6].contiguous(), rf[7].contiguous()
            nbytes, flops = sweep_counts(Bn, Tn, d, s, "kkt_rhs_fwd_sweep")
            out["kkt_rhs_fwd_sweep"] = dict(
                max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                ms=time_ms(lambda: kl.rhs_fwd_sweep_cuda(rf[0], rf[1], rG, C, A, rz, rnu,
                                                         rL_Pf)),
                plain_ms=time_ms(lambda: kl.rhs_fwd_sweep_reference(rf[0], rf[1], rG, C, A, rz,
                                                                    rnu, rL_Pf)),
                bytes=nbytes, flops=flops,
            )
        return out

    def first_iteration(solver, Z0):
        """The first IPM iteration's state, KKT blocks (H with the accepted
        δ_w) and δ_w."""
        st = solver.init_state(Z0)
        kkt_in, _ = solver._iteration_pre(st)
        out = solver._solve_kkt_batched(kkt_in, st.delta_w, st, False)
        dw = out[3]
        H, C, A, Bj, rz, rnu = [x.contiguous() for x in kkt_in]
        Hreg = (H + dw[:, None, None, None] * torch.eye(H.shape[-1], device=H.device)).contiguous()
        return st, (H, C, A, Bj, rz, rnu), (Hreg, C, A, Bj, rz, rnu), dw

    def kkt_reference(path, real):
        """The kernel path's KKT solve (kernels 2 and 3) on a first
        iteration's real system: float32 error of it and of the plain path
        against the float64 CPU solve of the same (float32) blocks; the
        kernel path must be no worse than ten times the plain one (the
        blocks are near-singular at this iteration, so both carry visible
        rounding)."""
        Bn = real[0].shape[0]
        with torch.no_grad():
            dz_k, nu_k, ok_k = kl.solve_kkt_lanes(*real, delta_c)
            dz_p, nu_p, ok_p = solve_kkt(*real, delta_c)
            dz_r, nu_r, ok_r = solve_kkt(*[x.double().cpu() for x in real], delta_c)
            keep = ok_r & ok_k.cpu() & ok_p.cpu()
            e_k = max(rel_err(dz_k.cpu(), dz_r, keep)[1], rel_err(nu_k.cpu(), nu_r, keep)[1])
            e_p = max(rel_err(dz_p.cpu(), dz_r, keep)[1], rel_err(nu_p.cpu(), nu_r, keep)[1])
        emit({"phase": "reference", "path": path, "batch": Bn, "kernel_rel_err_vs_f64": e_k,
              "plain_rel_err_vs_f64": e_p, "compared": int(keep.sum()),
              "ok_kernel": int(ok_k.sum()), "ok_plain": int(ok_p.sum()),
              "ok_f64": int(ok_r.sum())})
        if not (e_k <= 10 * e_p + 1e-6 and int(keep.sum()) >= Bn - Bn // 100):
            fail(f"the {path} kernel KKT solve is less accurate than the plain float32 solve")

    # ---- the Hadamard problem -------------------------------------------- #
    sysq = q.QuantumSystem(q.GATES["Z"], [q.GATES["X"], q.GATES["Y"]])
    prob = q.UnitarySmoothPulseProblem(
        sysq, q.GATES["H"], T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=q.SolverOptions(
            print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter"
        ),
        piccolo_options=q.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    solver = prob.solver
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    dt_sl = prob.trajectory.comp_slice("Δt")

    def seeds(seed):
        rng = np.random.default_rng(seed)
        Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
        Z0[:, 1:-1, a_sl] += 0.1 * rng.standard_normal((B, T - 2, a_sl.stop - a_sl.start))
        return Z0

    # ---- 3. kernels on the first Hadamard iteration's inputs -------------- #
    with torch.no_grad():
        st, _, real, _ = first_iteration(solver, seeds(7))
        analytic = solver.nlp.analytic
        Z, lam = st.Z.contiguous(), st.lam.contiguous()
        d, s = Z.shape[-1], lam.shape[-1]
        delta_c = solver.options.delta_c
        results = {}

        # kernel 1: fused assembly
        k_out = dyn_assembly_cuda(analytic, Z, lam)
        r_out = dyn_assembly_reference(analytic, Z, lam)
        errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
        n_pairs = B * (T - 1)
        n, K = 4, 3
        KP = K * (K + 1) // 2
        member = (2 * (1 + K) * n * n * 2 + 2 * KP * n * n + 4 * K * n * n * 2)
        flops = bank_counts(n_pairs, n, K - 1, True)[1] + n_pairs * member
        nbytes = F4 * (Z.numel() + lam.numel() + sum(x.numel() for x in k_out))
        results["dyn_assembly"] = dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: dyn_assembly_cuda(analytic, Z, lam)),
            plain_ms=time_ms(lambda: dyn_assembly_reference(analytic, Z, lam)),
            bytes=nbytes, flops=flops,
        )
        # kernels 2 and 3: the first iteration's real blocks are
        # near-singular in float32, where both versions carry rounding
        # error of order one, so they are held against each other on
        # seeded blocks and phase 5 checks the real ones against float64
        results.update(sweep_entries(real, B, T, delta_c, factors=False))
        # kernel 5 at these shapes: the path runs it only for the Jacobian
        # of the multiplier initialisation (first order); its iterations
        # run kernel 1
        results["prop_bank"] = bank_entry(Z, analytic, solver.var_scale)
    finish(results, bw, f32_peak)
    shapes = {"B": B, "T": T, "d": d, "s": s, "dtype": "float32"}
    for name, r in results.items():
        emit({"phase": "kernel", "path": "hadamard", "name": name,
              "shapes": r.pop("shapes", shapes), **r})
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the Hadamard shapes: {bad}")

    # ---- 4. Hadamard main path -------------------------------------------- #
    solver.solve(seeds(6), max_iter=ITERS)  # discarded warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver.solve(seeds(42), max_iter=ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    iters = solver.last_steps

    def had_infid(res, path):
        """Per-instance infidelity of a Hadamard solve, float64 rollout."""
        Zs = res.Z.double().cpu().numpy()
        if Zs.shape != (B, T, d) or not np.isfinite(Zs).all():
            fail(f"{path} solution has shape {Zs.shape} or non-finite values")
        return 1.0 - q.batched_rollout_fidelity(
            Zs[:, :, a_sl], Zs[:, :, dt_sl][:, :, 0], sysq,
            prob.trajectory.goal["Ũ⃗"], prob.trajectory.initial["Ũ⃗"], device="cuda",
        )

    infid = had_infid(res, "hadamard")
    frac = float(np.mean(infid <= 1e-4))
    retries = counts["kkt_fwd_sweep"] - iters
    emit({"phase": "main_path", "path": "hadamard", "batch": B, "T": T, "ipm_iters": iters,
          "wall_s": wall, "solves_per_s": B * frac / wall,
          "ipm_ms_per_iter": 1e3 * wall / max(iters, 1),
          "converged_frac": frac, "best_infid": float(infid.min()),
          "median_infid": float(np.median(infid)),
          "ipm_converged_frac": float(res.converged.float().mean()),
          "launches": counts, "kkt_retries": retries,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    had_kernels = ("dyn_assembly", "prop_bank", "kkt_fwd_sweep", "kkt_bwd_sweep")
    if min(counts[k] for k in had_kernels) <= 0:
        fail(f"a kernel of the Hadamard path was not launched: {counts}")
    if counts["kkt_rhs_fwd_sweep"] != 0:
        fail(f"the Hadamard path re-solved through kept factors: {counts}")
    if frac < 0.9:
        fail(f"converged_frac {frac} < 0.9")
    had_counts = counts

    # ---- 5. reference: the first Hadamard iteration's real KKT system ---- #
    kkt_reference("hadamard", real)
    emit({"phase": "launches_per_iter", "path": "hadamard",
          **{k: v / max(iters, 1) for k, v in counts.items()}})

    # ---- the CNOT problem (BASELINE #3), Padé and exponential ------------- #
    P, kron = q.PAULIS, np.kron
    sys2 = q.QuantumSystem(0.1 * kron(P["Z"], P["Z"]),
                           [kron(P["Z"], P["X"]), kron(P["X"], P["I"]), kron(P["Y"], P["I"]),
                            kron(P["I"], P["X"]), kron(P["I"], P["Y"])])

    def cnot_phases(path, integrator):
        """Phases 6-8 (integrator "pade") or 11-13 ("exponential"): the
        kernels at this path's shapes, the timed B=128 solve with its
        checks, and the first iteration's KKT system against float64.
        Returns (kernel results, launch counts of the timed solve)."""
        prob2 = q.UnitarySmoothPulseProblem(
            sys2, q.GATES["CX"], CX_T, CX_DT, Q=1e4, R=1e-3,
            ipopt_options=q.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2,
                                          line_search="filter", kkt_backend="lanes"),
            piccolo_options=q.PiccoloOptions(verbose=False, free_time=False,
                                             integrator=integrator),
            rng=np.random.default_rng(7),
        )
        solver2 = prob2.solver
        if (solver2.fused_assembly_on, solver2.kkt_refine_n) != (False, 1):
            fail(f"{path} modes {(solver2.fused_assembly_on, solver2.kkt_refine_n)} != (False, 1)")
        a2_sl = prob2.trajectory.comp_slice("a")

        def seeds2(seed):
            return prob2.multistart_initial_decisions(CX_B, sigma=0.3,
                                                      rng=np.random.default_rng(seed))

        # ---- kernels on the first iteration's inputs --------------------- #
        with torch.no_grad():
            st2, raw2, real2, dw2 = first_iteration(solver2, seeds2(7))
            Z2 = st2.Z.contiguous()
            d2, s2 = Z2.shape[-1], st2.lam.shape[-1]
            results2 = {"prop_bank": bank_entry(Z2, solver2.nlp.analytic, solver2.var_scale)}
            results2.update(sweep_entries(real2, CX_B, CX_T, delta_c, factors=True))
        finish(results2, bw, f32_peak)
        shapes2 = {"B": CX_B, "T": CX_T, "d": d2, "s": s2, "dtype": "float32"}
        for name, r in results2.items():
            emit({"phase": "kernel", "path": path, "name": name,
                  "shapes": r.pop("shapes", shapes2), **r})
        bad = [n for n, r in results2.items() if not r["ok"]]
        if bad:
            fail(f"kernels disagree with their plain versions at the {path} shapes: {bad}")

        # ---- main path ---------------------------------------------------- #
        solver2.solve(seeds2(6), max_iter=CX_WARM)  # discarded warm-up
        Z0 = seeds2(42)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res2 = solver2.solve(Z0, max_iter=CX_ITERS)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        counts2 = dict(build.launch_counts)
        iters2 = solver2.last_steps
        Zs2 = res2.Z.double().cpu().numpy()
        if Zs2.shape != (CX_B, CX_T, d2) or not np.isfinite(Zs2).all():
            fail(f"{path} solution has shape {Zs2.shape} or non-finite values")
        fids2 = q.batched_rollout_fidelity(
            Zs2[:, :, a2_sl], np.full((CX_B, CX_T), CX_DT), sys2,
            prob2.trajectory.goal["Ũ⃗"], prob2.trajectory.initial["Ũ⃗"], device="cuda",
        )
        infid2 = 1.0 - fids2
        fr = {f"frac_infid_{t}": float(np.mean(infid2 <= float(t)))
              for t in ("1e-4", "1e-3", "1e-2")}
        emit({"phase": "main_path", "path": path, "batch": CX_B, "T": CX_T, "ipm_iters": iters2,
              "wall_s": wall2, "ipm_ms_per_iter": 1e3 * wall2 / max(iters2, 1),
              "solves_per_s_at_1e-4": CX_B * fr["frac_infid_1e-4"] / wall2, **fr,
              "best_infid": float(infid2.min()), "median_infid": float(np.median(infid2)),
              "ipm_converged_frac": float(res2.converged.float().mean()),
              "launches": counts2, "kkt_attempts_per_iter": (counts2["kkt_fwd_sweep"] - 1)
              / max(iters2, 1), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        cx_kernels = ("prop_bank", "kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
        if min(counts2[k] for k in cx_kernels) <= 0:
            fail(f"a kernel of the {path} path was not launched: {counts2}")
        if counts2["dyn_assembly"] != 0:
            fail(f"the fused assembly ran on the {path} path: {counts2}")
        if counts2["prop_bank"] < iters2:
            fail(f"fewer bank launches than iterations: {counts2}, {iters2} iterations")
        if counts2["kkt_rhs_fwd_sweep"] != counts2["kkt_fwd_sweep"] - 1:
            fail(f"not one re-solve per KKT attempt: {counts2}")
        if fr["frac_infid_1e-4"] < 0.9:
            fail(f"{path} frac@1e-4 {fr['frac_infid_1e-4']} < 0.9")

        # ---- reference: the first iteration's real KKT system ------------- #
        # float32 error of the kernel path, unrefined and with the solver's
        # one refinement pass, against the float64 CPU solve of the same
        # blocks, beside the plain float32 path; as in phase 5 the
        # unrefined kernel path must be no worse than ten times the plain one
        with torch.no_grad():
            dz0, nu0, ok0, fac = kl.solve_kkt_lanes(*real2, delta_c, want_factors=True)
            dz1, nu1 = solver2._refine(list(raw2), dw2, dz0, nu0,
                                       lambda a, b: kl.resolve_kkt_lanes(fac, a, b))
            dz_p, nu_p, ok_p = solve_kkt(*real2, delta_c)
            dz_r, nu_r, ok_r = solve_kkt(*[x.double().cpu() for x in real2], delta_c)
            keep = ok_r & ok0.cpu() & ok_p.cpu()
            e0 = max(rel_err(dz0.cpu(), dz_r, keep)[1], rel_err(nu0.cpu(), nu_r, keep)[1])
            e1 = max(rel_err(dz1.cpu(), dz_r, keep)[1], rel_err(nu1.cpu(), nu_r, keep)[1])
            e_p = max(rel_err(dz_p.cpu(), dz_r, keep)[1], rel_err(nu_p.cpu(), nu_r, keep)[1])
        emit({"phase": "reference", "path": path, "batch": CX_B,
              "kernel_rel_err_vs_f64_refine0": e0, "kernel_rel_err_vs_f64_refine1": e1,
              "plain_rel_err_vs_f64": e_p, "compared": int(keep.sum()),
              "ok_kernel": int(ok0.sum()), "ok_plain": int(ok_p.sum()),
              "ok_f64": int(ok_r.sum()), "dw_max": float(dw2.max())})
        if int(keep.sum()) < CX_B - CX_B // 100 or not np.isfinite(e1):
            fail(f"the {path} KKT solve failed on the first iteration's system")
        if not e0 <= 10 * e_p + 1e-6:
            fail(f"the {path} kernel KKT solve is less accurate than the plain float32 solve")
        emit({"phase": "launches_per_iter", "path": path,
              **{k: v / max(iters2, 1) for k, v in counts2.items()}})
        return results2, counts2

    results2, counts2 = cnot_phases("cnot", "pade")

    # ---- the two-ket exponential problem (ket_exp) ------------------------ #
    sysk = q.QuantumSystem(0.1 * q.PAULIS["Z"], [q.PAULIS["X"], q.PAULIS["Y"]])
    probk = q.QuantumStateSmoothPulseProblem(
        sysk, [[1, 0], [0, 1]], [[0, 1], [1, 0]], KET_T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=q.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2,
                                      line_search="filter"),
        piccolo_options=q.PiccoloOptions(verbose=False, integrator="exponential"),
        rng=np.random.default_rng(1),
    )
    solverk = probk.solver
    (gk,) = solverk.nlp.analytic.groups
    if (solverk.fused_assembly_on, gk.kind, gk.num_squarings) != (True, "exp", 1):
        fail(f"ket_exp modes {(solverk.fused_assembly_on, gk.kind, gk.num_squarings)}")
    zk = probk.initial_decision(1)[0]
    ak_sl = probk.trajectory.comp_slice("a")
    dtk_sl = probk.trajectory.comp_slice("Δt")

    def seedsk(seed):
        rng = np.random.default_rng(seed)
        Z0 = np.broadcast_to(zk, (B, *zk.shape)).copy()
        Z0[:, 1:-1, ak_sl] += 0.1 * rng.standard_normal((B, KET_T - 2, ak_sl.stop - ak_sl.start))
        return Z0

    # ---- 9. kernels on the first ket_exp iteration's inputs --------------- #
    with torch.no_grad():
        stk, _, realk, _ = first_iteration(solverk, seedsk(7))
        ank = solverk.nlp.analytic
        Zk, lamk = stk.Z.contiguous(), stk.lam.contiguous()
        dk, sk = Zk.shape[-1], lamk.shape[-1]
        k_out = dyn_assembly_cuda(ank, Zk, lamk)
        r_out = dyn_assembly_reference(ank, Zk, lamk)
        errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
        n_pairs = B * (KET_T - 1)
        nk, Kk = gk.G_drift.shape[0], gk.G_drives.shape[0] + 1
        flops = (exp_bank_counts(n_pairs, nk, Kk - 1, True, gk.num_squarings)[1]
                 + n_pairs * sum(member_flops(nk, Kk, m[4], True) for m in gk.members))
        resultsk = {"dyn_assembly": dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: dyn_assembly_cuda(ank, Zk, lamk)),
            plain_ms=time_ms(lambda: dyn_assembly_reference(ank, Zk, lamk)),
            bytes=F4 * (Zk.numel() + lamk.numel() + sum(x.numel() for x in k_out)),
            flops=flops, cc_max_abs=float(k_out[4].abs().max()),
        )}
        # the path runs the bank once per solve, first order (the multiplier
        # initialisation's Jacobian)
        resultsk["prop_bank"] = bank_entry(Zk, ank, solverk.var_scale, second_order=False)
        # kernels 2 and 3 on this path's own blocks (exponential dynamics,
        # B = I), as phase 3
        resultsk.update(sweep_entries(realk, B, KET_T, delta_c, factors=False))
    finish(resultsk, bw, f32_peak)
    shapesk = {"B": B, "T": KET_T, "d": dk, "s": sk, "dtype": "float32"}
    for name, r in resultsk.items():
        emit({"phase": "kernel", "path": "ket_exp", "name": name,
              "shapes": r.pop("shapes", shapesk), **r})
    bad = [n for n, r in resultsk.items() if not r["ok"]]
    if bad or resultsk["dyn_assembly"]["cc_max_abs"] != 0.0:
        fail(f"kernels disagree with their plain versions at the ket_exp shapes: {bad}")
    kkt_reference("ket_exp", realk)

    # ---- 10. ket_exp main path ------------------------------------------- #
    solverk.solve(seedsk(6), max_iter=ITERS)  # discarded warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resk = solverk.solve(seedsk(42), max_iter=ITERS)
    torch.cuda.synchronize()
    wallk = time.perf_counter() - t0
    countsk = dict(build.launch_counts)
    itersk = solverk.last_steps
    Zsk = resk.Z.double().cpu().numpy()
    if Zsk.shape != (B, KET_T, dk) or not np.isfinite(Zsk).all():
        fail(f"ket_exp solution has shape {Zsk.shape} or non-finite values")
    # an instance counts when both kets reach the threshold
    infidk = np.max([1.0 - q.batched_ket_rollout_fidelity(
        Zsk[:, :, ak_sl], Zsk[:, :, dtk_sl][:, :, 0], sysk, probk.trajectory.goal[name],
        probk.trajectory.initial[name], device="cuda") for name in ("ψ̃1", "ψ̃2")], axis=0)
    frk = {f"frac_infid_{t}": float(np.mean(infidk <= float(t))) for t in ("1e-4", "1e-3", "1e-2")}
    emit({"phase": "main_path", "path": "ket_exp", "batch": B, "T": KET_T, "ipm_iters": itersk,
          "wall_s": wallk, "ipm_ms_per_iter": 1e3 * wallk / max(itersk, 1),
          "solves_per_s_at_1e-4": B * frk["frac_infid_1e-4"] / wallk, **frk,
          "best_infid": float(infidk.min()), "median_infid": float(np.median(infidk)),
          "ipm_converged_frac": float(resk.converged.float().mean()),
          "launches": countsk, "kkt_attempts_per_iter": (countsk["kkt_fwd_sweep"] - 1)
          / max(itersk, 1), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if countsk["dyn_assembly"] < itersk or min(countsk["kkt_fwd_sweep"],
                                               countsk["kkt_bwd_sweep"]) <= 0:
        fail(f"a kernel of the ket_exp path was not launched: {countsk}")
    if countsk["prop_bank"] != 1 or countsk["kkt_rhs_fwd_sweep"] != 0:
        fail(f"ket_exp: not one bank launch per solve, or a re-solve: {countsk}")
    if frk["frac_infid_1e-4"] < 0.9:
        fail(f"ket_exp frac@1e-4 {frk['frac_infid_1e-4']} < 0.9")
    emit({"phase": "launches_per_iter", "path": "ket_exp",
          **{k: v / max(itersk, 1) for k, v in countsk.items()}})

    # ---- 11-13. the CNOT problem with the exponential integrator ---------- #
    resultsx, countsx = cnot_phases("cnot_exp", "exponential")

    # ---- the Hadamard problem with other solver modes ---------------------- #
    def had_variant(solver_kw, piccolo_kw):
        """Phase 4's problem with other solver or framework options."""
        return q.UnitarySmoothPulseProblem(
            sysq, q.GATES["H"], T, 0.2, Q=1e4, R=1e-3,
            ipopt_options=q.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2,
                                          line_search="filter", **solver_kw),
            piccolo_options=q.PiccoloOptions(verbose=False, **piccolo_kw),
            rng=np.random.default_rng(0),
        ).solver

    def timed_solve(solver_, iters_):
        """A discarded warm-up solve of a few iterations, then the timed
        solve of phase 4's seeds: (result, wall s, launch counts,
        iterations, KKT attempts)."""
        solver_.solve(seeds(6), max_iter=NEW_WARM)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res_ = solver_.solve(seeds(42), max_iter=iters_)
        torch.cuda.synchronize()
        return (res_, time.perf_counter() - t0, dict(build.launch_counts), solver_.last_steps,
                solver_.kkt_attempts)

    def main_path_line(path, res_, wall_, counts_, iters_, att_):
        infid_ = had_infid(res_, path)
        fr_ = {f"frac_infid_{t}": float(np.mean(infid_ <= float(t)))
               for t in ("1e-4", "1e-3", "1e-2")}
        emit({"phase": "main_path", "path": path, "batch": B, "T": T, "ipm_iters": iters_,
              "wall_s": wall_, "ipm_ms_per_iter": 1e3 * wall_ / max(iters_, 1),
              "converged_frac": fr_["frac_infid_1e-4"],
              "solves_per_s_at_1e-4": B * fr_["frac_infid_1e-4"] / wall_, **fr_,
              "best_infid": float(infid_.min()), "median_infid": float(np.median(infid_)),
              "ipm_converged_frac": float(res_.converged.float().mean()),
              "hadamard_converged_frac": frac, "launches": counts_, "kkt_attempts": att_,
              "kkt_attempts_per_iter": att_ / max(iters_, 1),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        emit({"phase": "launches_per_iter", "path": path,
              **{k: v / max(iters_, 1) for k, v in counts_.items()}})
        return fr_

    # ---- 14. kernels on the hadamard_lbfgs system with a full memory ------ #
    solverq = had_variant({}, dict(eval_hessian=False))
    modes = (solverq.qn_lbfgs, solverq.fused_assembly_on, solverq.resto_on, solverq.kkt_refine_n)
    if modes != (True, False, False, 0):
        fail(f"hadamard_lbfgs modes {modes} != (True, False, False, 0)")
    with torch.no_grad():
        stq = solverq.init_state(seeds(7))
        for _ in range(QN_AT - 1):
            stq = solverq.step(stq)
        kkt_q, aux_q = solverq._iteration_pre(stq)
        dwq = solverq._solve_kkt_batched(kkt_q, stq.delta_w, stq, False, aux_q.lowrank)[3]
        Hq, Cq, Aq, Bq, rzq, rnuq = [x.contiguous() for x in kkt_q]
        Hq = (Hq + dwq[:, None, None, None] * torch.eye(d, device=Hq.device)).contiguous()
        realq = (Hq, Cq, Aq, Bq, *lbfgs_rhs(rzq, rnuq, aux_q.lowrank[0]))
        ncols = realq[4].shape[-1]
        resultsq = {"prop_bank": bank_entry(stq.Z.contiguous(), solverq.nlp.analytic,
                                            solverq.var_scale, second_order=False)}
        resultsq.update(sweep_entries(realq, B, T, delta_c, factors=False, r=ncols))
        real47 = tuple(seeded_kkt(CX_B, CX_T, 47, 42, Hq.device, ncols)[:6])
        results47 = sweep_entries(real47, CX_B, CX_T, delta_c, factors=False, r=ncols)
    finish(resultsq, bw, f32_peak)
    finish(results47, bw, f32_peak)
    memq = aux_q.qn["qn_count"].float()
    for path, res_, shp in (("hadamard_lbfgs", resultsq, dict(shapes, r=ncols)),
                            ("seeded_d47", results47, {"B": CX_B, "T": CX_T, "d": 47, "s": 42,
                                                       "r": ncols, "dtype": "float32"})):
        for name, r in res_.items():
            emit({"phase": "kernel", "path": path, "name": name,
                  "shapes": r.pop("shapes", shp), **r})
    emit({"phase": "lbfgs_system", "iteration": QN_AT, "columns": ncols,
          "memory_pairs_min": float(memq.min()), "memory_pairs_mean": float(memq.mean()),
          "sigma_median": float(stq.qn_sigma.median()), "dw_max": float(dwq.max())})
    bad = [n for res_ in (resultsq, results47) for n, r in res_.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the L-BFGS shapes: {bad}")
    kkt_reference("hadamard_lbfgs", realq)

    # ---- 15. hadamard_lbfgs main path --------------------------------------- #
    resq, wallq, countsq, itq, attq = timed_solve(solverq, QN_ITERS)
    frq = main_path_line("hadamard_lbfgs", resq, wallq, countsq, itq, attq)
    if countsq["dyn_assembly"] != 0 or countsq["kkt_rhs_fwd_sweep"] != 0:
        fail(f"hadamard_lbfgs ran the fused assembly or a re-solve: {countsq}")
    if not countsq["kkt_fwd_sweep"] == countsq["kkt_bwd_sweep"] == attq + 1:
        fail(f"hadamard_lbfgs: sweeps {countsq} != KKT attempts {attq} + 1")
    if countsq["prop_bank"] < itq or countsq["kkt_fwd_step"] + countsq["kkt_bwd_step"] != 0:
        fail(f"hadamard_lbfgs: fewer bank launches than iterations, or a step: {countsq}")
    if frq["frac_infid_1e-3"] < 0.9:
        fail(f"hadamard_lbfgs frac@1e-3 {frq['frac_infid_1e-3']} < 0.9")

    # ---- 16. the per-knot steps (kernels 6, 7) at the Hadamard shapes ----- #
    def step_buffers(Bn, Tn, d_, s_, like):
        new = dict(dtype=like.dtype, device=like.device)
        return (torch.empty(Bn, Tn - 1, d_, d_, **new), torch.empty(Bn, Tn - 1, s_, s_, **new),
                torch.empty(Bn, Tn - 1, d_, s_, **new), torch.empty(Bn, Tn - 1, d_, **new))

    def step_entries(real_, Bn, Tn):
        """Kernels 6 and 7 against their plain versions on seeded blocks
        (one knot each, and a whole scan solve against the plain KKT solve);
        per-solve times (T-1 launches) on the real blocks."""
        d_, s_ = real_[0].shape[-1], real_[2].shape[-2]
        dev = real_[0].device
        Hs, Cs, As, Bs, rzs, rnus = seeded_kkt(Bn, Tn, d_, s_, dev)[:6]
        LP, LS, XA, qs = step_buffers(Bn, Tn, d_, s_, Hs)
        k_f = kl.fwd_step_cuda(Hs[:, 0].contiguous(), rzs[:, 0].contiguous(), Hs, Cs, As, Bs,
                               rzs, rnus, 0, delta_c, LP, LS, XA, qs)
        r_f = kl.fwd_step_reference(Hs[:, 0], rzs[:, 0], Hs[:, 1], Cs[:, 0], As[:, 0],
                                    Bs[:, 0], rzs[:, 1], rnus[:, 0], delta_c)
        errs_f = [rel_err(a, b) for a, b in zip(k_f + (LP[:, 0], LS[:, 0], XA[:, 0], qs[:, 0]),
                                                 r_f[:6])]
        dz = Hs.new_zeros(Bn, Tn, d_)
        nu = Hs.new_zeros(Bn, Tn - 1, s_)
        dz[:, 1] = rzs[:, 1]
        kl.bwd_step_cuda(LP, LS, XA, qs, Cs, As, Bs, rnus, dz, nu, 0)
        r_b = kl.bwd_step_reference(dz[:, 1], LP[:, 0], LS[:, 0], XA[:, 0], qs[:, 0], Cs[:, 0],
                                    As[:, 0], Bs[:, 0], rnus[:, 0])
        errs_b = [rel_err(dz[:, 0], r_b[0]), rel_err(nu[:, 0], r_b[1])]
        dz_s, nu_s, ok_s = kl.solve_kkt_lanes_scan(Hs, Cs, As, Bs, rzs, rnus, delta_c)
        dz_p, nu_p, ok_p = solve_kkt(Hs, Cs, As, Bs, rzs, rnus, delta_c)
        errs_s = [rel_err(dz_s, dz_p), rel_err(nu_s, nu_p)]
        if not (bool(ok_s.all()) and bool(ok_p.all())):
            fail("the seeded scan solve failed")

        H_, C_, A_, B_, rz_, rnu_ = real_
        bufs = step_buffers(Bn, Tn, d_, s_, H_)

        def fwd_kernel():
            P, qc = H_[:, 0].contiguous(), rz_[:, 0].contiguous()
            for t in range(Tn - 1):
                P, qc = kl.fwd_step_cuda(P, qc, H_, C_, A_, B_, rz_, rnu_, t, delta_c, *bufs)

        def fwd_plain():
            P, qc = H_[:, 0], rz_[:, 0]
            for t in range(Tn - 1):
                P, qc, *_ = kl.fwd_step_reference(P, qc, H_[:, t + 1], C_[:, t], A_[:, t],
                                                  B_[:, t], rz_[:, t + 1], rnu_[:, t], delta_c)

        fwd_kernel()
        dzr = H_.new_zeros(Bn, Tn, d_)
        nur = H_.new_zeros(Bn, Tn - 1, s_)

        def bwd_kernel():
            for t in reversed(range(Tn - 1)):
                kl.bwd_step_cuda(*bufs, C_, A_, B_, rnu_, dzr, nur, t)

        def bwd_plain():
            dzn = dzr[:, -1]
            for t in reversed(range(Tn - 1)):
                dzn, _ = kl.bwd_step_reference(dzn, *[x[:, t] for x in bufs], C_[:, t], A_[:, t],
                                               B_[:, t], rnu_[:, t])

        counts_ = step_counts(Bn, Tn, d_, s_)
        solve_ms = time_ms(lambda: kl.solve_kkt_lanes_scan(*real_, delta_c))
        out = {}
        for name, errs, kern, plain in (("kkt_fwd_step", errs_f, fwd_kernel, fwd_plain),
                                        ("kkt_bwd_step", errs_b + errs_s, bwd_kernel, bwd_plain)):
            ms = time_ms(kern)
            out[name] = dict(
                max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                ms=ms, ms_per_launch=ms / (Tn - 1), plain_ms=time_ms(plain, n=5),
                scan_solve_ms=solve_ms, scan_solve_max_rel_err=max(e[1] for e in errs_s),
                bytes=counts_[name][0], flops=counts_[name][1], launches_timed=Tn - 1,
            )
        return out

    with torch.no_grad():
        resultss = step_entries(real, B, T)
    finish(resultss, bw, f32_peak)
    for name, r in resultss.items():
        emit({"phase": "kernel", "path": "hadamard_scan", "name": name, "shapes": shapes, **r})
    bad = [n for n, r in resultss.items() if not r["ok"]]
    if bad:
        fail(f"step kernels disagree with their plain versions: {bad}")

    # ---- 17. hadamard_scan main path ---------------------------------------- #
    solvers = had_variant(dict(kkt_backend="lanes_scan"), {})
    if (solvers.scan, solvers.fused_assembly_on, solvers.kkt_refine_n) != (True, True, 0):
        fail(f"hadamard_scan modes {(solvers.scan, solvers.fused_assembly_on)}")
    ress, walls, countss, its, atts = timed_solve(solvers, ITERS)
    frs = main_path_line("hadamard_scan", ress, walls, countss, its, atts)
    sweeps = ("kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if any(countss[k] for k in sweeps):
        fail(f"hadamard_scan launched a fused sweep: {countss}")
    if not countss["kkt_fwd_step"] == countss["kkt_bwd_step"] == (T - 1) * (atts + 1):
        fail(f"hadamard_scan: steps {countss} != (T-1) x (KKT attempts {atts} + 1)")
    if countss["dyn_assembly"] < its or countss["prop_bank"] != 1:
        fail(f"hadamard_scan: assembly not in every iteration or not one bank: {countss}")
    if frs["frac_infid_1e-4"] < 0.9:
        fail(f"hadamard_scan frac@1e-4 {frs['frac_infid_1e-4']} < 0.9")

    emit({"phase": "total", "script_s_after_environment": time.perf_counter() - t_start})

    entries = [("hadamard", n, r, had_counts) for n, r in results.items()]
    entries += [("cnot", n, r, counts2) for n, r in results2.items()]
    entries += [("ket_exp", n, r, countsk) for n, r in resultsk.items()]
    entries += [("cnot_exp", n, r, countsx) for n, r in resultsx.items()]
    entries += [("hadamard_lbfgs", n, r, countsq) for n, r in resultsq.items()]
    entries += [("hadamard_scan", n, results[n], countss) for n in ("dyn_assembly", "prop_bank")]
    entries += [("hadamard_scan", n, r, countss) for n, r in resultss.items()]
    emit({"kernels": [
        {"name": name, "path": path, "branch": "exp" if path.endswith("_exp") else "pade",
         "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": cnt[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"], "ok": r["ok"],
         "columns": r.get("columns", 1)}
        for path, name, r, cnt in entries
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
