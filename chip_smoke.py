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
     on the first iteration's real blocks, device time per launch (a CUDA
     graph of a solve's T-1 launches, replayed between two events; the
     rows' ms, plain_ms and bound are per launch) and, on a line before the
     rows, the host-bound time of a solve's launches from Python;
 17. main path, hadamard_scan: phase 4's problem with kkt_backend
     "lanes_scan", 48 iterations (frac@1e-4 >= 0.9); each step kernel
     launches (T-1) x (KKT attempts + 1) times and the fused sweeps never;
 18. kernels, su4 shapes (BASELINE #5: UnitaryMultiGoalProblem, phase 7's
     two qubits, T=33, Δt=0.3 fixed, Q=1e4, R=1e-3, kkt_backend "lanes"):
     the bank (second order, 16,384 pairs, n=8, K=5) and the three sweeps
     with kept factors (B=512, d=47, s=42), on the first iteration's
     inputs, as phase 6;
 19. main path, su4: one wave of 128 Haar goals (random_su,
     default_rng(2024)) x 4 seeds (multigoal_initial_decisions, σ=0.2,
     default_rng(100)) = B 512, 80 iterations, after a discarded warm-up
     solve of a few iterations on other seeds (default_rng(300)); checked
     per instance against its own goal by the float64
     multigoal_rollout_fidelities (frac@1e-4 >= 0.9);
 20. min_time warm stage (BASELINE #2): B=1 fixed-time Hadamard (T=51,
     Δt=0.2, Q=1e4, R=1e-3, tol 1e-7, recalc_y with feasibility tolerance
     1e1, kkt_backend "xla", 80 iterations): recalc_y keeps the fused
     assembly off, so the bank runs in every iteration; its row is on the
     warm stage's first-iteration inputs;
 21. kernels, min_time shapes: the minimum-time problem (the free-time
     trajectory rolled out from the warm controls, floor 0.99995, D=1000,
     tol 1e-6, kkt_backend "lanes", m=1: the ρJᵀJ lift and the retry warm
     start on): the fused assembly on its first iteration's (Z, λ), and
     kernel 2 with kept factors, kernels 4 and 3 (B=512, d=15, s=13) on
     lifted blocks (H + δ_w I + ρS_AA, C + ρS_AB, rz + ρJᵀrnu): held
     against their plain versions on seeded blocks of these shapes lifted
     by the solver's own ρ rule, timed on the first iteration's lifted
     blocks; then their float32 error against the float64 solve of the
     unlifted system, unrefined and after the one refinement pass;
 22. main path, min_time: B=512 seeds (the initial decision with 1e-4
     control noise), 48 iterations after a discarded warm-up; an instance
     succeeds at float64 fidelity >= 0.9999 and a duration below the warm
     one (success_frac >= 0.9, median duration below the warm one); every
     attempt is refined once through its kept factors (the lift's pass);
 23. kernels, leakage shapes (BASELINE #4: a three-level transmon, the X
     gate embedded on its qubit subspace, leakage suppression through L1
     slack rows (m=8), T=40, Δt=0.2 fixed, kkt_backend "lanes", so no
     fused assembly, one refinement pass and the lift): the bank (second
     order, 9,984 pairs, n=6, 2 drives, fixed Δt) and kernel 2 with kept
     factors, kernels 4 and 3 (B=256, d=28, s=22) on lifted blocks, as
     phase 21;
 24. reference, leakage: the first iteration's lifted system, as phase 21's;
 25. main path, leakage: B=256 seeds (the initial decision with 0.05 σ
     control noise, the bench's), 120 iterations after a discarded
     warm-up; checked by a float64 rollout on the qubit subspace (the
     fractions at subspace infidelity <= 1e-3, 1e-2, 1e-4; frac@1e-3 >=
     0.9);
 26. kernels, sampling shapes (example 04: UnitarySamplingProblem over the
     drift samples ζ ∈ {-0.05, 0, 0.05} of ζ Z with X, Y drives, the H
     gate, T=50, Δt=0.2 free, Q=1e4, R=1e-3, kkt_backend "lanes"; d=31,
     s=29, so no fused assembly and one refinement pass): the bank once
     for each of the three propagator groups (second order, 25,088 pairs,
     n=4, K=3) and the three sweeps with kept factors (B=512), as phase 6;
 27. main path, sampling: B=512 seeds (the initial decision with 0.1 σ
     control noise), 150 iterations after a discarded warm-up; an instance
     counts when its float64 rollout reaches infidelity <= 1e-3 on all
     three sampled systems (fraction >= 0.9), and the median of the
     rollout fidelities summed over ζ ∈ -0.05:0.01:0.05 must beat that of
     the plain UnitarySmoothPulseProblem at ζ = 0 solved with the same
     settings, seeds and iterations (BASELINE.md's sampling comparison);
     at least three bank launches (one per group) an iteration;
 28. kernels at robustness shapes (the robustness warm start of the JAX
     package's template test: a drift-free qubit, X and Y drives, the X
     gate by a constant π pulse, T=51, Δt=0.2 free, tol 1e-7, kkt_backend
     "lanes"; UnitaryRobustnessProblem against H_error = Z, floor 0.99:
     d=23, s=21, m=1, no analytic assembly, so the AD route gives the
     blocks): kernel 2 with kept factors, kernels 4 and 3 (B=256) on
     lifted blocks, as phase 21, and the first iteration's lifted system
     against float64, as phase 24;
 29. main path, robustness: B=256 seeds (the warm decision with 0.02 σ
     control noise, default_rng(5)), 160 iterations after a discarded
     warm-up; an instance counts when the float64 Magnus cost of its
     rollout falls below half its seed's and its float64 fidelity is >=
     0.989 (fraction >= 0.9); kernels 1 and 5 never launch (the AD route);
 30. kernels, cnot_soc shapes (phase 7's problem with soc=True): the bank
     and the three sweeps with kept factors on the first iteration, as
     phase 6, and the first iteration's second-order-correction rhs
     re-solved on each instance's kept factors by kernel 4 and kernel 3
     against their plain versions on the same factors;
 31. main path, cnot_soc: phase 7's seeds and 80 iterations after a
     discarded warm-up; the iterations that tried the correction and the
     instances an iteration that took it; the launches against the
     prediction from the run's own KKT attempts A and iterations I
     (kernel 2: A + 1, kernel 4: A + I, kernel 3: 2A + I + 1, the one
     solve of the multiplier initialisation included); frac@1e-4 >= 0.9;
 32. hadamard_gn: phase 4's problem with PiccoloOptions(eval_hessian=False)
     and quasi_newton="gauss-newton": the bank (first order), kernels 2 and
     3 on its first iteration, then 48 iterations: a bank launch an
     iteration, no kernel 1; gate: a median infidelity at most
     GN_MEDIAN_GATE and the seeds';
 33. hadamard_adaptive: phase 4's problem with mu_strategy="adaptive"
     (kernels 1, 5, 2, 3 as phase 3, on its own first iteration); μ's range
     over the solve and the filter resets; frac@1e-3 >= AD_GATE;
 34. hadamard_watchdog: phase 4's problem with watchdog_trials=3; the
     activations and rewinds and the instances they touched;
     frac@1e-4 >= WD_GATE;
 35. the live iteration table: a 5-iteration hadamard solve at
     print_level=5 with stdout captured; its header against the JAX
     package's and its row count;
 36. kernels at the free-phase shapes: kernel 1 on the free_phase
     problem's first iteration (a drift-free qubit, an X drive alone, the Y
     gate up to a global Z phase ϕ: d=13, s=11, the global column last)
     and on the bang-bang problem with that phase (d=16, s=11, m=4), each
     writing into outputs poisoned with NaN, against its plain version, its
     global column's A, B, Hc and Cc entries zero; kernels 2 and 3 on the
     free_phase first iteration's blocks as phase 3; the bank first order
     (the multiplier initialisation);
 37. main path, free_phase (JAX tests/test_free_phase_chaining.py: T=31,
     Δt=0.2 free, tol 1e-6, rng 1234): B=512 seeds (0.1-σ control noise
     and π N(0, 1) phases), 60 iterations after a discarded warm-up; the
     float64 rollout fidelity up to each instance's phase (frac at
     infidelity <= 1e-3 >= FP_GATE) and without it (median below 0.5: the
     phase carries the gate); launches against the prediction from the
     run's KKT attempts A (kernels 2 and 3: A + 1, kernel 4: 0);
 38. free_phase_min_time: a B=1 free_phase warm stage (60 iterations), then
     UnitaryMinimumTimeProblem(phase_operators=[Z], D=50, floor 0.98): m=1,
     lifted; kernel 1 and kernels 2, 4, 3 on its first iteration's lifted
     blocks as phase 21 (and against float64 as phase 24); B=512 seeds
     (1e-4 control noise), 100 iterations; success = free-phase fidelity
     >= 0.98 - 1e-4 and a duration below 0.9 of the warm stage's
     (fraction >= FPM_GATE); launches: kernel 2 A + 1, kernel 4 A, kernel
     3 2A + 1;
 39. bang_bang (JAX tests/test_problem_templates.py: Z drift, X and Y
     drives, H, T=51, R_bang_bang 0.5, da_bound 1.0): d=15, s=11, m=4
     (L1 slack rows on da), lifted; kernels as phase 38; B=512 seeds
     (0.1-σ control noise), 40 iterations; frac at infidelity <= BB_BAR
     >= BB_GATE, and the median count of |da| > 5e-2 no larger than the
     hadamard path's (phase 4); launches as phase 38;
 40. kernels at the density shapes (example 05's open-system problem:
     drift Z, drives X and Y, one dissipator 0.05 a, ρ0 = |0⟩⟨0|, the goal
     |1⟩, T=30, Δt=0.2 free, Q=100, R=1e-2: d=15, s=13, m=0, the AD route):
     kernels 2 and 3 on the first iteration's AD-route blocks as phase 3,
     that iteration's real KKT system against float64 as phase 5; in
     float64 on the card, lindblad_action against the dense generator's
     product and the "expv" open rollout against the "expm" one, on the
     seeds' controls and states;
 41. main path, density: B=512 seeds (0.1-σ control noise), DN_ITERS
     iterations after a discarded warm-up; the float64 open-rollout
     fidelity ⟨ψ|ρ_T|ψ⟩ of every instance (frac at infidelity <= DN_BAR
     >= DN_GATE, and a median infidelity below the seeds'); launches
     against the prediction from the run's KKT attempts A (kernels 2 and
     3: A + 1, kernels 1, 4 and 5: 0).
The sweep rows of phases 18, 21, 23, 26, 28 and 30-34 also give device_ms (a CUDA graph of
the call, replayed).  The exponential bank's rows also time its library counterpart
(exp_bank_library: torch.linalg.matrix_exp on block-triangular matrices);
the bank's rows give, beside a call's time (ms, the host's enqueue
included), its device time (device_ms: a CUDA graph of the call,
replayed); the rows of kernels 2, 3, 4, 6 and 7 report their launch
configuration (threads per instance, instances per block, shared bytes per
block), and the rows of kernels 1 and 5 their own (threads per pair, pairs
per block, shared bytes per block).
Then the kernels line, and last {"ok": true, "device": {...}}.  Each main
path checks its own kernels' launch counts.  Any failed check exits
nonzero before the last line.  Without CUDA it exits 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B, T, ITERS = 512, 51, 48
CX_B, CX_T, CX_DT, CX_ITERS, CX_WARM = 128, 40, 0.3, 80, 3
KET_T = 50  # ket_exp: B and ITERS as the Hadamard path
QN_ITERS, QN_AT, NEW_WARM = 300, 8, 3  # hadamard_lbfgs; warm-up of the new paths
# the solver-mode paths' gates (phases 32-34), from the JAX package's
# float32 solves of the same problem, seeds and 48 iterations on the CPU
# (B=16, scripts/solver_modes_gate_jax.py): adaptive μ's fraction at
# infidelity 1e-3 (0.5625) and the watchdog's at 1e-4 (1.0), each less two
# instances' share of 16; Gauss-Newton reaches no instance at 1e-3 there
# (it trails the exact Hessian, JAX tests/test_unitary_smooth_pulse.py:86),
# so its gate is a median infidelity at most 1.5 times JAX's float32
# median (0.20936329440805868)
GN_MEDIAN_GATE, AD_GATE, WD_GATE = 1.5 * 0.20936329440805868, 0.5625 - 0.125, 1.0 - 0.125
LIVE_ITERS = 5
# the free-phase and bang-bang paths (phases 36-39): T, iterations, the
# minimum-time floor (the JAX package's free-phase tests), and their gates,
# from the JAX package's float32 solves of the same problems and seeds on the
# CPU (B=16, scripts/free_phase_gate_jax.py)
FP_T, FP_ITERS, FPM_ITERS, FPM_FLOOR, BB_T, BB_ITERS = 31, 60, 100, 0.98, 51, 40
FP_GATE, FPM_GATE, BB_BAR, BB_GATE = 0.9, 0.9, 1e-1, 0.9
# the density path (phases 40-41): T, iterations and its gate, fixed from
# the JAX package's float32 solves of the same problem and seeds on the CPU
# (scripts/density_gate_jax.py): after 300 iterations 47 of 48 instances
# at infidelity 1e-2 (15 of 16 at B=16); the Lindblad decay keeps every
# instance's infidelity above ~4e-3 there
DN_T, DN_ITERS, DN_BAR, DN_GATE = 30, 300, 1e-2, 0.9
# float64 agreement on the card of lindblad_action with the dense
# generator's product, and of the "expv" open rollout with the "expm" one
DN_ACTION_TOL, DN_EXPV_TOL = 1e-12, 1e-10
LIVE_HEADER = ("iter      objective    inf_pr    inf_du  lg(mu)     ||d||  lg(rg)  alpha_du  "
               "alpha_pr  ls")
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
        assembly_config,
        dyn_assembly_cuda,
        dyn_assembly_reference,
    )
    from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
    from quantumcollocation_tpu_torch.solver.kkt import solve_kkt
    from quantumcollocation_tpu_torch.solver.lbfgs import lbfgs_rhs
    from quantumcollocation_tpu_torch import bench_util as bu
    from quantumcollocation_tpu_torch.bench_util import bank_args, graph_ms, seeded_kkt, time_ms

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

    def bank_entry(Z, analytic, v, second_order=True, group=0):
        """The bank kernel against its plain version on the pairs of Z, in
        the kind (Padé or exponential) of one of the problem's groups."""
        a, dt, Gd, Gs, kw = bank_args(analytic, Z, v, second_order, group)
        M, n, na = a.shape[0], Gd.shape[0], Gs.shape[0]
        kind, free, nsq = kw["kind"], kw["free_dt"], kw["num_squarings"]
        k_out = pb.prop_bank_cuda(a, dt, Gd, Gs, **kw)
        r_out = pb.prop_bank_reference(a, dt, Gd, Gs, **kw)
        errs = [rel_err(x, y) for x, y in zip(k_out, r_out) if y is not None]
        lib = {}
        if kind == "exp":
            nbytes, flops = exp_bank_counts(M, n, na, free, nsq, second_order)
            # the library counterpart, block set-up included, and its
            # agreement with the plain version (printed, not a check)
            l_out = exp_bank_library(a, dt, Gd, Gs, free, second_order)
            lib = dict(
                library_ms=time_ms(lambda: exp_bank_library(a, dt, Gd, Gs, free, second_order)),
                library_max_rel_err=max(rel_err(x, y)[1] for x, y in zip(l_out, r_out)
                                        if y is not None))
        else:
            nbytes, flops = bank_counts(M, n, na, free, kw["order"], second_order)
        return dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: pb.prop_bank_cuda(a, dt, Gd, Gs, **kw)),
            device_ms=graph_ms(lambda: pb.prop_bank_cuda(a, dt, Gd, Gs, **kw)),
            plain_ms=time_ms(lambda: pb.prop_bank_reference(a, dt, Gd, Gs, **kw)),
            bytes=nbytes, flops=flops, **lib,
            launch=pb.bank_config(n, na, free, second_order, kind),
            shapes={"M": M, "n": n, "K": na + int(free), "free_dt": free, "kind": kind,
                    "num_squarings": nsq, "second_order": second_order},
        )

    def sweep_entries(real, Bn, Tn, delta_c, factors, r=None, lift=None, device=False):
        """Kernels 2, 3 (and 4 with factors) against their plain versions
        on seeded blocks of the path's shapes (r right-hand-side columns
        where r is given; lift maps the seeded (H, C, A, B, rz, rnu) to the
        blocks the path factors); times on the path's real blocks (H with
        the accepted δ_w), and with device their device times (a CUDA graph
        of the call)."""
        d, s = real[0].shape[-1], real[2].shape[-2]
        dev = real[0].device
        seeded = seeded_kkt(Bn, Tn, d, s, dev, r)
        if lift is not None:
            seeded = list(lift(*seeded[:6])) + seeded[6:]
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
            launch=kl.sweep_config("kkt_fwd_sweep", Bn, d, s, r or 1),
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
            launch=kl.sweep_config("kkt_bwd_sweep", Bn, d, s, r or 1),
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
                bytes=nbytes, flops=flops, launch=kl.sweep_config("kkt_rhs_fwd_sweep", Bn, d, s),
            )
        if device:
            calls = {
                "kkt_fwd_sweep": lambda: kl.fwd_sweep_cuda(*real, delta_c, want_factors=factors),
                "kkt_bwd_sweep": lambda: kl.bwd_sweep_cuda(*real_bwd),
                "kkt_rhs_fwd_sweep": lambda: kl.rhs_fwd_sweep_cuda(
                    rf[0], rf[1], rG, C, A, rz, rnu, rL_Pf),
            }
            for name in out:
                out[name]["device_ms"] = graph_ms(calls[name])
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

    def lifted_first_iteration(solver_, Z0):
        """The first iteration of a solver with the ρJᵀJ lift: (state, the
        unlifted KKT blocks, the iteration's aux, the accepted δ_w and ρ,
        the blocks lifted by ρ0 at the accepted δ_w, and the map lifting
        seeded blocks (H, C, A, B, rz, rnu) by the solver's own ρ rule)."""
        st_ = solver_.init_state(Z0)
        kkt_, aux_ = solver_._iteration_pre(st_)
        out_ = solver_._solve_kkt_batched(kkt_, st_.delta_w, st_, False, None, aux_.rho0)
        kkt_ = [x.contiguous() for x in kkt_]
        real_ = [x.contiguous() for x in solver_._lifted(
            kkt_, out_[3], aux_.rho0, solver_._lift_S(kkt_[2], kkt_[3]))]

        def lift_seeded(H_, C_, A_, B_, rz_, rnu_):
            rho = solver_.lift_scale(H_, C_, solver_.options.kkt_aug_rho_factor)
            return [x.contiguous() for x in solver_._lifted(
                (H_, C_, A_, B_, rz_, rnu_), torch.zeros_like(rho), rho,
                solver_._lift_S(A_, B_))]

        return st_, kkt_, aux_, out_[3], out_[5], real_, lift_seeded

    def lifted_reference(path, solver_, kkt_, aux_, dw_, real_):
        """The first iteration's lifted system: the kernel path's step
        (kernels 2 and 3, then the one refinement pass against the
        unlifted system on the kept factors) and the plain float32 solve of
        the lifted system, each against the float64 solves of the lifted
        and of the unlifted system (equal in exact arithmetic up to ρδ_c
        terms).  On min_time (ρ0 ~ 3e2) this system is far from float32's
        reach, so the errors are printed findings, not gates; the phase
        fails only where the kernel path's solve fails or its refined step
        is not finite."""
        Bn = real_[0].shape[0]
        with torch.no_grad():
            dz0, nu0, ok0, fac = kl.solve_kkt_lanes(*real_, delta_c, want_factors=True)
            dz1, nu1 = solver_._refine(kkt_, dw_, dz0, nu0,
                                       lambda a, b: kl.resolve_kkt_lanes(fac, a, b),
                                       rho=aux_.rho0, n_pass=1)
            dz_p, nu_p, ok_p = solve_kkt(*real_, delta_c)
            refs = {"lifted": solve_kkt(*[x.double().cpu() for x in real_], delta_c),
                    "unlifted": solve_kkt(*[x.double().cpu() for x in
                                            solver_._lifted(kkt_, dw_, None)], delta_c)}
            line = {}
            for rname, (dz_r, nu_r, ok_r) in refs.items():
                keep = ok_r & ok0.cpu()
                for tag, (a, b) in (("refine0", (dz0, nu0)), ("refine1", (dz1, nu1)),
                                    ("plain", (dz_p, nu_p))):
                    line[f"{tag}_rel_err_vs_f64_{rname}"] = max(
                        rel_err(a.cpu(), dz_r, keep)[1], rel_err(b.cpu(), nu_r, keep)[1])
                line[f"compared_{rname}"] = int(keep.sum())
                line[f"ok_f64_{rname}"] = int(ok_r.sum())
        emit({"phase": "reference", "path": path, "batch": Bn, "lifted": True, **line,
              "ok_kernel": int(ok0.sum()), "ok_plain": int(ok_p.sum()),
              "rho0_median": float(aux_.rho0.median()), "dw_max": float(dw_.max())})
        if (line["compared_unlifted"] < line["ok_f64_unlifted"] - Bn // 100
                or not np.isfinite(line["refine1_rel_err_vs_f64_unlifted"])):
            fail(f"the {path} kernel KKT solve failed on the first iteration's lifted system")

    def assembly_entry(an, Z, lam, global_slices=None):
        """Kernel 1 against its plain version, writing into memory poisoned
        with NaN just before the call (the caching allocator hands the freed
        poisoned blocks back); with global_slices, also whether the global
        columns of A, B, Hc and Cc came out zero."""
        Z, lam = Z.contiguous(), lam.contiguous()
        r_out = dyn_assembly_reference(an, Z, lam)
        dyn_assembly_cuda(an, Z, lam)  # packs the argument table first
        torch.cuda.synchronize()
        poison = [torch.full(x.shape, float("nan"), device=Z.device) for x in r_out]
        ptrs = sorted(x.data_ptr() for x in poison)
        del poison
        k_out = dyn_assembly_cuda(an, Z, lam)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
        (g,) = an.groups
        n_, na_, free_ = g.G_drift.shape[0], g.G_drives.shape[0], g.dt_col is not None
        Bn, Tn, d_ = Z.shape
        n_pairs = Bn * (Tn - 1)
        row = dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            poisoned=sorted(x.data_ptr() for x in k_out) == ptrs,
            finite=all(bool(torch.isfinite(x).all()) for x in k_out),
            ms=time_ms(lambda: dyn_assembly_cuda(an, Z, lam)),
            device_ms=graph_ms(lambda: dyn_assembly_cuda(an, Z, lam)),
            plain_ms=time_ms(lambda: dyn_assembly_reference(an, Z, lam)),
            bytes=F4 * (Z.numel() + lam.numel() + sum(x.numel() for x in k_out)),
            flops=(bank_counts(n_pairs, n_, na_, free_, g.order)[1]
                   + n_pairs * sum(member_flops(n_, na_ + int(free_), mb[4], False)
                                   for mb in g.members)),
            launch=assembly_config(an),
            shapes={"B": Bn, "T": Tn, "d": d_, "s": an.s, "dtype": "float32"},
        )
        if global_slices:
            _, A_, B_, Hc_, Cc_ = k_out
            cols = [c for gs, ge in global_slices.values() for c in range(gs, ge)]
            row["global_cols"] = cols
            row["global_cols_zero"] = row["poisoned"] and row["finite"] and all(
                bool((x[..., cols] == 0).all()) for x in (A_, B_, Hc_, Cc_)) and all(
                bool((x[..., cols, :] == 0).all()) for x in (Hc_, Cc_))
        return row

    def timed_run(solver_, Z0_, iters_):
        """The timed solve of Z0_: (result, wall s, launch counts,
        iterations, KKT attempts)."""
        torch.cuda.synchronize()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0_ = time.perf_counter()
        res_ = solver_.solve(Z0_, max_iter=iters_)
        torch.cuda.synchronize()
        return (res_, time.perf_counter() - t0_, dict(build.launch_counts), solver_.last_steps,
                solver_.kkt_attempts)

    def checked_solution(path, res_, shape):
        """The solution as float64 numpy; fails unless finite of shape."""
        Zs_ = res_.Z.double().cpu().numpy()
        if Zs_.shape != shape or not np.isfinite(Zs_).all():
            fail(f"{path} solution has shape {Zs_.shape} or non-finite values")
        return Zs_

    def launch_fields(counts_, predicted_, iters_, att_):
        """The main-path line's launch fields: the counts, the prediction
        from the run's own KKT attempts, attempts per iteration, peak memory."""
        return {"launches": counts_, "predicted_launches": predicted_, "kkt_attempts": att_,
                "kkt_attempts_per_iter": att_ / max(iters_, 1),
                "launches_per_iter": {k: v / max(iters_, 1) for k, v in counts_.items()},
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    # ---- the Hadamard problem -------------------------------------------- #
    prob = bu.hadamard_problem()
    solver, sysq = prob.solver, prob.system
    a_sl = prob.trajectory.comp_slice("a")
    dt_sl = prob.trajectory.comp_slice("Δt")

    def seeds(seed):
        return bu.hadamard_seeds(prob, B, seed)

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
            bytes=nbytes, flops=flops, launch=assembly_config(analytic),
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
    sys2 = bu.su4_system()

    def cnot_phases(path, integrator):
        """Phases 6-8 (integrator "pade") or 11-13 ("exponential"): the
        kernels at this path's shapes, the timed B=128 solve with its
        checks, and the first iteration's KKT system against float64.
        Returns (kernel results, launch counts of the timed solve)."""
        prob2 = bu.cnot_problem(integrator)
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
            flops=flops, cc_max_abs=float(k_out[4].abs().max()), launch=assembly_config(ank),
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
        return bu.hadamard_problem(piccolo=piccolo_kw, **solver_kw).solver

    def timed_solve(solver_, iters_, callback=None):
        """A discarded warm-up solve of a few iterations, then the timed
        solve of phase 4's seeds (with the callback, if given): (result,
        wall s, launch counts, iterations, KKT attempts)."""
        solver_.solve(seeds(6), max_iter=NEW_WARM)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res_ = solver_.solve(seeds(42), max_iter=iters_, callback=callback)
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
        return dict(fr_, median_infid=float(np.median(infid_)))

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
        on the real blocks, device times per launch (a CUDA graph of a
        solve's T-1 launches) and, apart, the host-bound per-solve times."""
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
        P0, q0 = H_[:, 0].contiguous(), rz_[:, 0].contiguous()

        def fwd_kernel():
            P, qc = P0, q0
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
        out, host = {}, {"scan_solve_ms": solve_ms}
        for name, errs, kern, plain in (("kkt_fwd_step", errs_f, fwd_kernel, fwd_plain),
                                        ("kkt_bwd_step", errs_b + errs_s, bwd_kernel, bwd_plain)):
            # the T-1 launches of a solve from Python read the host between
            # launches; a CUDA graph of them reads the device
            host[f"{name}_host_ms_per_solve"] = time_ms(kern)
            out[name] = dict(
                max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                ms=graph_ms(kern) / (Tn - 1), plain_ms=time_ms(plain, n=5) / (Tn - 1),
                ms_unit="device per launch (CUDA graph of a solve's T-1 launches)",
                scan_solve_ms=solve_ms, scan_solve_max_rel_err=max(e[1] for e in errs_s),
                bytes=counts_[name][0] / (Tn - 1), flops=counts_[name][1] / (Tn - 1),
                launches_per_solve=Tn - 1,
            )
        for name in out:
            out[name]["launch"] = kl.sweep_config(name, Bn, d_, s_)
        return out, host

    with torch.no_grad():
        resultss, step_host = step_entries(real, B, T)
    emit({"phase": "step_host_timing", "path": "hadamard_scan", "shapes": shapes,
          "unit": "ms per solve: T-1 launches from Python between CUDA events, host-bound",
          **step_host})
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

    # ---- 18. kernels on the first su4 iteration's inputs ------------------ #
    SU_B, SU_T, SU_DT, SU_ITERS, SU_GOALS, SU_SEEDS = 512, 33, 0.3, 80, 128, 4
    probu = bu.su4_problem(SU_T, SU_DT)
    solveru = probu.solver
    if (solveru.fused_assembly_on, solveru.kkt_refine_n, solveru.kkt_aug_on) != (False, 1, False):
        fail(f"su4 modes {(solveru.fused_assembly_on, solveru.kkt_refine_n)} != (False, 1)")
    rng_goals = np.random.default_rng(2024)
    goals = [q.random_su(4, rng_goals) for _ in range(SU_GOALS)]

    def seedsu(seed):
        return q.multigoal_initial_decisions(probu, goals, n_seeds_per_goal=SU_SEEDS, sigma=0.2,
                                             rng=np.random.default_rng(seed))

    t_init = time.perf_counter()
    Zu0, Zuw = seedsu(100), seedsu(300)
    init_s = time.perf_counter() - t_init
    with torch.no_grad():
        stu, _, realu, _ = first_iteration(solveru, Zu0)
        Zu = stu.Z.contiguous()
        du, su_ = Zu.shape[-1], stu.lam.shape[-1]
        resultsu = {"prop_bank": bank_entry(Zu, solveru.nlp.analytic, solveru.var_scale)}
        resultsu.update(sweep_entries(realu, SU_B, SU_T, delta_c, factors=True, device=True))
    finish(resultsu, bw, f32_peak)
    shapesu = {"B": SU_B, "T": SU_T, "d": du, "s": su_, "dtype": "float32"}
    for name, r in resultsu.items():
        emit({"phase": "kernel", "path": "su4", "name": name,
              "shapes": r.pop("shapes", shapesu), **r})
    bad = [n for n, r in resultsu.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the su4 shapes: {bad}")

    # ---- 19. su4 main path ------------------------------------------------ #
    solveru.solve(Zuw, max_iter=CX_WARM)  # discarded warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resu = solveru.solve(Zu0, max_iter=SU_ITERS)
    torch.cuda.synchronize()
    wallu = time.perf_counter() - t0
    countsu = dict(build.launch_counts)
    itu, attu = solveru.last_steps, solveru.kkt_attempts
    Zsu = resu.Z.double().cpu().numpy()
    if Zsu.shape != (SU_B, SU_T, du) or not np.isfinite(Zsu).all():
        fail(f"su4 solution has shape {Zsu.shape} or non-finite values")
    infidu = 1.0 - q.multigoal_rollout_fidelities(probu, Zsu, goals, n_seeds_per_goal=SU_SEEDS)
    fru = {f"frac_infid_{t}": float(np.mean(infidu <= float(t))) for t in ("1e-4", "1e-3", "1e-2")}
    goal_best = infidu.reshape(SU_GOALS, SU_SEEDS).min(axis=1)
    emit({"phase": "main_path", "path": "su4", "batch": SU_B, "goals": SU_GOALS,
          "seeds_per_goal": SU_SEEDS, "T": SU_T, "ipm_iters": itu, "wall_s": wallu,
          "ipm_ms_per_iter": 1e3 * wallu / max(itu, 1),
          "solves_per_s_at_1e-4": SU_B * fru["frac_infid_1e-4"] / wallu, **fru,
          "goal_frac_solved_1e-4": float(np.mean(goal_best <= 1e-4)),
          "best_infid": float(infidu.min()), "median_infid": float(np.median(infidu)),
          "ipm_converged_frac": float(resu.converged.float().mean()),
          "seed_build_s_two_waves": init_s, "launches": countsu, "kkt_attempts": attu,
          "kkt_attempts_per_iter": attu / max(itu, 1),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    su_kernels = ("prop_bank", "kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if min(countsu[k] for k in su_kernels) <= 0 or countsu["dyn_assembly"] != 0:
        fail(f"a kernel of the su4 path was not launched, or the fused assembly was: {countsu}")
    if countsu["prop_bank"] < itu or countsu["kkt_rhs_fwd_sweep"] != countsu["kkt_fwd_sweep"] - 1:
        fail(f"su4: fewer bank launches than iterations, or not one re-solve per attempt: "
             f"{countsu}")
    if fru["frac_infid_1e-4"] < 0.9:
        fail(f"su4 frac@1e-4 {fru['frac_infid_1e-4']} < 0.9")
    emit({"phase": "launches_per_iter", "path": "su4",
          **{k: v / max(itu, 1) for k, v in countsu.items()}})

    # ---- 20. min_time warm stage ------------------------------------------ #
    MT_ITERS, MT_WARM_ITERS = 48, 80
    warm = bu.min_time_warm(T, 0.2)
    solverw = warm.solver
    if (solverw.fused_assembly_on, solverw.kkt_aug_on) != (False, False):
        fail(f"min_time warm-stage modes {(solverw.fused_assembly_on, solverw.kkt_aug_on)}")
    with torch.no_grad():
        stw = solverw.init_state(warm.initial_decision(1))
        resultsw = {"prop_bank": bank_entry(stw.Z.contiguous(), solverw.nlp.analytic,
                                            solverw.var_scale)}
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    warm.solve(max_iter=MT_WARM_ITERS)
    torch.cuda.synchronize()
    wallw = time.perf_counter() - t0
    countsw = dict(build.launch_counts)
    fid_warm = float(q.unitary_rollout_fidelity(warm.trajectory, warm.system))
    emit({"phase": "main_path", "path": "min_time_warm", "batch": 1, "T": T,
          "ipm_iters": solverw.last_steps, "wall_s": wallw,
          "ipm_ms_per_iter": 1e3 * wallw / max(solverw.last_steps, 1), "warm_fid": fid_warm,
          "converged": bool(warm.result.converged[0]), "launches": countsw,
          "kkt_attempts": solverw.kkt_attempts})
    if countsw["prop_bank"] < solverw.last_steps or countsw["dyn_assembly"] != 0:
        fail(f"min_time warm stage: not a bank launch per iteration, or the fused assembly: "
             f"{countsw}")
    if not fid_warm > 0.999:
        fail(f"min_time warm stage fidelity {fid_warm}")

    # ---- 21. kernels on the first min_time iteration's inputs -------------- #
    mt, dur0 = bu.min_time_problem(warm)
    solverm = mt.solver
    modes = (solverm.fused_assembly_on, solverm.kkt_refine_n, solverm.kkt_aug_on,
             solverm.retry_warm_on, solverm.nlp.m)
    if modes != (True, 0, True, True, 1):
        fail(f"min_time modes {modes} != (True, 0, True, True, 1)")
    with torch.no_grad():
        stm, kkt_m, aux_m, dwm, rho_acc, realm, lift_seeded = lifted_first_iteration(
            solverm, bu.min_time_seeds(mt, B, 7))
        anm = solverm.nlp.analytic
        Zm, lamm = stm.Z.contiguous(), stm.lam.contiguous()
        dm, sm = Zm.shape[-1], lamm.shape[-1]
        k_out = dyn_assembly_cuda(anm, Zm, lamm)
        r_out = dyn_assembly_reference(anm, Zm, lamm)
        errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
        (gm,) = anm.groups
        nmm, Km = gm.G_drift.shape[0], gm.G_drives.shape[0] + 1
        n_pairs = B * (T - 1)
        resultsm = {"dyn_assembly": dict(
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: dyn_assembly_cuda(anm, Zm, lamm)),
            device_ms=graph_ms(lambda: dyn_assembly_cuda(anm, Zm, lamm)),
            plain_ms=time_ms(lambda: dyn_assembly_reference(anm, Zm, lamm)),
            bytes=F4 * (Zm.numel() + lamm.numel() + sum(x.numel() for x in k_out)),
            flops=(bank_counts(n_pairs, nmm, Km - 1, True)[1]
                   + n_pairs * sum(member_flops(nmm, Km, mb[4], False) for mb in gm.members)),
            launch=assembly_config(anm),
        )}
        resultsm.update(sweep_entries(realm, B, T, delta_c, factors=True, lift=lift_seeded,
                                      device=True))
    finish(resultsm, bw, f32_peak)
    finish(resultsw, bw, f32_peak)
    shapesm = {"B": B, "T": T, "d": dm, "s": sm, "m": 1, "dtype": "float32"}
    for name, r in resultsm.items():
        emit({"phase": "kernel", "path": "min_time", "name": name,
              "shapes": r.pop("shapes", shapesm),
              **({"lifted": True} if name.startswith("kkt") else {}), **r})
    emit({"phase": "kernel", "path": "min_time", "stage": "warm", "name": "prop_bank",
          **resultsw["prop_bank"]})
    emit({"phase": "lift_system", "path": "min_time", "rho0_median": float(aux_m.rho0.median()),
          "rho0_max": float(aux_m.rho0.max()), "dw_median": float(dwm.median()),
          "accepted_lifted_frac": float((rho_acc > 0).float().mean())})
    bad = [n for res_ in (resultsm, resultsw) for n, r in res_.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the min_time shapes: {bad}")
    lifted_reference("min_time", solverm, kkt_m, aux_m, dwm, realm)

    # ---- 22. min_time main path ------------------------------------------- #
    solverm.solve(bu.min_time_seeds(mt, B, 6), max_iter=NEW_WARM)  # discarded warm-up
    Zm0 = bu.min_time_seeds(mt, B, 42)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resm = solverm.solve(Zm0, max_iter=MT_ITERS)
    torch.cuda.synchronize()
    wallm = time.perf_counter() - t0
    countsm = dict(build.launch_counts)
    itm, attm = solverm.last_steps, solverm.kkt_attempts
    lifted_share = float(solverm.kkt_lifted_rows) / max(solverm.kkt_attempt_rows, 1)
    Zsm = resm.Z.double().cpu().numpy()
    if Zsm.shape != (B, T, dm) or not np.isfinite(Zsm).all():
        fail(f"min_time solution has shape {Zsm.shape} or non-finite values")
    trm = mt.trajectory
    am_sl, dtm_sl = trm.comp_slice("a"), trm.comp_slice("Δt")
    dtsm = Zsm[:, :, dtm_sl][:, :, 0]
    fidsm = q.batched_rollout_fidelity(Zsm[:, :, am_sl], dtsm, warm.system, trm.goal["Ũ⃗"],
                                       trm.initial["Ũ⃗"], device="cuda")
    dursm = dtsm[:, :-1].sum(axis=1)
    okm = (fidsm >= 0.9999) & (dursm < dur0)
    succ = float(okm.mean())
    emit({"phase": "main_path", "path": "min_time", "batch": B, "T": T, "ipm_iters": itm,
          "wall_s": wallm, "ipm_ms_per_iter": 1e3 * wallm / max(itm, 1),
          "success_frac": succ, "solves_per_s_at_fid_0.9999": B * succ / wallm,
          "warm_fid": fid_warm, "duration_before": dur0,
          "median_duration_after": float(np.median(dursm)), "median_fid": float(np.median(fidsm)),
          "fid_quantiles": [float(x) for x in np.quantile(fidsm, [0.0, 0.01, 0.1, 0.5, 0.9])],
          "frac_fid_0.9999": float(np.mean(fidsm >= 0.9999)),
          "frac_shorter": float(np.mean(dursm < dur0)),
          "ipm_converged_frac": float(resm.converged.float().mean()),
          "launches": countsm, "kkt_attempts": attm, "kkt_attempts_per_iter": attm / max(itm, 1),
          "lifted_attempt_share": lifted_share,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    mt_kernels = ("dyn_assembly", "kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if min(countsm[k] for k in mt_kernels) <= 0 or countsm["dyn_assembly"] < itm:
        fail(f"a kernel of the min_time path was not launched: {countsm}")
    if countsm["prop_bank"] != 1 or countsm["kkt_rhs_fwd_sweep"] != countsm["kkt_fwd_sweep"] - 1:
        fail(f"min_time: not one bank launch per solve, or not one re-solve per attempt: "
             f"{countsm}")
    if succ < 0.9 or not np.median(dursm) < dur0:
        fail(f"min_time success_frac {succ} < 0.9 or median duration {np.median(dursm)} "
             f">= {dur0}")
    emit({"phase": "launches_per_iter", "path": "min_time",
          **{k: v / max(itm, 1) for k, v in countsm.items()}})

    # ---- 23. kernels on the first leakage iteration's inputs --------------- #
    LK_B, LK_T, LK_DT, LK_ITERS = 256, 40, 0.2, 120
    probl, goall = bu.leakage_problem(LK_T, LK_DT)
    solverl = probl.solver
    modes = (solverl.fused_assembly_on, solverl.kkt_refine_n, solverl.kkt_aug_on,
             solverl.retry_warm_on, solverl.nlp.m)
    if modes != (False, 1, True, True, 8):
        fail(f"leakage modes {modes} != (False, 1, True, True, 8)")
    with torch.no_grad():
        stl, kkt_l, aux_l, dwl, rho_accl, reall, lift_seededl = lifted_first_iteration(
            solverl, bu.leakage_seeds(probl, LK_B, 7))
        Zl = stl.Z.contiguous()
        dl, sl_ = Zl.shape[-1], stl.lam.shape[-1]
        resultsl = {"prop_bank": bank_entry(Zl, solverl.nlp.analytic, solverl.var_scale)}
        resultsl.update(sweep_entries(reall, LK_B, LK_T, delta_c, factors=True,
                                      lift=lift_seededl, device=True))
    finish(resultsl, bw, f32_peak)
    shapesl = {"B": LK_B, "T": LK_T, "d": dl, "s": sl_, "m": solverl.nlp.m, "dtype": "float32"}
    for name, r in resultsl.items():
        emit({"phase": "kernel", "path": "leakage", "name": name,
              "shapes": r.pop("shapes", shapesl),
              **({"lifted": True} if name.startswith("kkt") else {}), **r})
    emit({"phase": "lift_system", "path": "leakage", "rho0_median": float(aux_l.rho0.median()),
          "rho0_max": float(aux_l.rho0.max()), "dw_median": float(dwl.median()),
          "accepted_lifted_frac": float((rho_accl > 0).float().mean())})
    bad = [n for n, r in resultsl.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the leakage shapes: {bad}")

    # ---- 24. reference: the first leakage iteration's lifted system -------- #
    lifted_reference("leakage", solverl, kkt_l, aux_l, dwl, reall)

    # ---- 25. leakage main path --------------------------------------------- #
    solverl.solve(bu.leakage_seeds(probl, LK_B, 6), max_iter=NEW_WARM)  # discarded warm-up
    Zl0 = bu.leakage_seeds(probl, LK_B, 42)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resl = solverl.solve(Zl0, max_iter=LK_ITERS)
    torch.cuda.synchronize()
    walll = time.perf_counter() - t0
    countsl = dict(build.launch_counts)
    itl, attl = solverl.last_steps, solverl.kkt_attempts
    lifted_sharel = float(solverl.kkt_lifted_rows) / max(solverl.kkt_attempt_rows, 1)
    Zsl = resl.Z.double().cpu().numpy()
    if Zsl.shape != (LK_B, LK_T, dl) or not np.isfinite(Zsl).all():
        fail(f"leakage solution has shape {Zsl.shape} or non-finite values")
    trl = probl.trajectory
    al_sl = trl.comp_slice("a")
    infidl = 1.0 - q.batched_rollout_fidelity(
        Zsl[:, :, al_sl], np.full((LK_B, LK_T), LK_DT), probl.system, trl.goal["Ũ⃗"],
        trl.initial["Ũ⃗"], subspace=goall.subspace, device="cuda")
    frl = {f"frac_subspace_infid_{t}": float(np.mean(infidl <= float(t)))
           for t in ("1e-3", "1e-2", "1e-4")}
    emit({"phase": "main_path", "path": "leakage", "batch": LK_B, "T": LK_T, "dt": LK_DT,
          "ipm_iters": itl, "wall_s": walll, "ipm_ms_per_iter": 1e3 * walll / max(itl, 1),
          "solves_per_s_at_subspace_infid_1e-3": LK_B * frl["frac_subspace_infid_1e-3"] / walll,
          **frl, "best_subspace_infid": float(infidl.min()),
          "median_subspace_infid": float(np.median(infidl)),
          "ipm_converged_frac": float(resl.converged.float().mean()),
          "launches": countsl, "kkt_attempts": attl, "kkt_attempts_per_iter": attl / max(itl, 1),
          "lifted_attempt_share": lifted_sharel,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    lk_kernels = ("prop_bank", "kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if min(countsl[k] for k in lk_kernels) <= 0 or countsl["dyn_assembly"] != 0:
        fail(f"a kernel of the leakage path was not launched, or the fused assembly was: "
             f"{countsl}")
    if countsl["prop_bank"] < itl or countsl["kkt_rhs_fwd_sweep"] != countsl["kkt_fwd_sweep"] - 1:
        fail(f"leakage: fewer bank launches than iterations, or not one re-solve per attempt: "
             f"{countsl}")
    if frl["frac_subspace_infid_1e-3"] < 0.9:
        fail(f"leakage frac@subspace infidelity 1e-3 {frl['frac_subspace_infid_1e-3']} < 0.9")
    emit({"phase": "launches_per_iter", "path": "leakage",
          **{k: v / max(itl, 1) for k, v in countsl.items()}})

    # ---- 26. kernels on the first sampling iteration's inputs -------------- #
    # 150 iterations: 48 leave 0.488 of B=512 at the gate on the card, 100
    # 0.959, 150 0.998 (PERF.md, PR 12)
    SA_B, SA_T, SA_ITERS = 512, 50, 150
    probsa = bu.sampling_problem(SA_T, 0.2)
    solversa = probsa.solver
    groups_sa = solversa.nlp.analytic.groups
    modes = (solversa.fused_assembly_on, solversa.kkt_refine_n, solversa.kkt_aug_on,
             len(groups_sa), solversa.nlp.d, solversa.nlp.s)
    if modes != (False, 1, False, 3, 31, 29):
        fail(f"sampling modes {modes} != (False, 1, False, 3, 31, 29)")
    with torch.no_grad():
        stsa, _, realsa, _ = first_iteration(solversa, bu.sampling_seeds(probsa, SA_B, 7))
        Zsa = stsa.Z.contiguous()
        resultssa = {f"prop_bank_group_{i}": bank_entry(Zsa, solversa.nlp.analytic,
                                                         solversa.var_scale, group=i)
                     for i in range(len(groups_sa))}
        resultssa.update(sweep_entries(realsa, SA_B, SA_T, delta_c, factors=True, device=True))
    finish(resultssa, bw, f32_peak)
    shapessa = {"B": SA_B, "T": SA_T, "d": solversa.nlp.d, "s": solversa.nlp.s,
                "dtype": "float32"}
    for name, r in resultssa.items():
        emit({"phase": "kernel", "path": "sampling", "name": name,
              "shapes": r.pop("shapes", shapessa), **r})
    bad = [n for n, r in resultssa.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the sampling shapes: {bad}")

    # ---- 27. sampling main path, and the plain solve it must beat --------- #
    solversa.solve(bu.sampling_seeds(probsa, SA_B, 6), max_iter=NEW_WARM)  # discarded warm-up
    Zsa0 = bu.sampling_seeds(probsa, SA_B, 42)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ressa = solversa.solve(Zsa0, max_iter=SA_ITERS)
    torch.cuda.synchronize()
    wallsa = time.perf_counter() - t0
    countssa = dict(build.launch_counts)
    itsa, attsa = solversa.last_steps, solversa.kkt_attempts
    Zssa = ressa.Z.double().cpu().numpy()
    if Zssa.shape != (SA_B, SA_T, solversa.nlp.d) or not np.isfinite(Zssa).all():
        fail(f"sampling solution has shape {Zssa.shape} or non-finite values")
    trsa = probsa.trajectory
    asa, dtsa = Zssa[:, :, trsa.comp_slice("a")], Zssa[:, :, trsa.comp_slice("Δt")][:, :, 0]
    infsa = np.stack([
        1.0 - q.batched_rollout_fidelity(asa, dtsa, bu.zeta_system(z),
                                         trsa.goal[f"Ũ⃗_system_{i + 1}"],
                                         trsa.initial[f"Ũ⃗_system_{i + 1}"], device="cuda")
        for i, z in enumerate(bu.ZETAS)])
    worst = infsa.max(axis=0)
    frsa = {f"frac_all_systems_infid_{t}": float(np.mean(worst <= float(t)))
            for t in ("1e-3", "1e-4", "1e-2")}
    sweep_sa = bu.zeta_sweep_fidelity(asa, dtsa, trsa.goal["Ũ⃗_system_1"],
                                      trsa.initial["Ũ⃗_system_1"], device="cuda")
    # the non-robust solve at ζ = 0: the same settings, seeds and iterations
    probpl = bu.sampling_plain_problem(SA_T, 0.2)
    trpl = probpl.trajectory
    Zpl0 = bu.sampling_seeds(probpl, SA_B, 42)
    if not np.array_equal(Zpl0[:, :, trpl.comp_slice("a")], Zsa0[:, :, trsa.comp_slice("a")]):
        fail("the plain solve's seeds differ from the sampled solve's controls")
    t0 = time.perf_counter()
    respl = probpl.solver.solve(Zpl0, max_iter=SA_ITERS)
    torch.cuda.synchronize()
    wallpl = time.perf_counter() - t0
    Zspl = respl.Z.double().cpu().numpy()
    if not np.isfinite(Zspl).all():
        fail("the plain solve's solution has non-finite values")
    sweep_pl = bu.zeta_sweep_fidelity(Zspl[:, :, trpl.comp_slice("a")],
                                      Zspl[:, :, trpl.comp_slice("Δt")][:, :, 0],
                                      trpl.goal["Ũ⃗"], trpl.initial["Ũ⃗"], device="cuda")
    emit({"phase": "main_path", "path": "sampling", "batch": SA_B, "T": SA_T, "zetas": bu.ZETAS,
          "ipm_iters": itsa, "wall_s": wallsa, "ipm_ms_per_iter": 1e3 * wallsa / max(itsa, 1),
          "solves_per_s_at_1e-3": SA_B * frsa["frac_all_systems_infid_1e-3"] / wallsa, **frsa,
          "median_infid_per_system": [float(x) for x in np.median(infsa, axis=1)],
          "zeta_sweep_fid_median": float(np.median(sweep_sa)),
          "plain_zeta_sweep_fid_median": float(np.median(sweep_pl)),
          "frac_beats_plain": float(np.mean(sweep_sa > sweep_pl)),
          "plain_wall_s": wallpl, "plain_ipm_iters": probpl.solver.last_steps,
          "ipm_converged_frac": float(ressa.converged.float().mean()),
          "launches": countssa, "kkt_attempts": attsa,
          "kkt_attempts_per_iter": attsa / max(itsa, 1),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    sa_kernels = ("prop_bank", "kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if min(countssa[k] for k in sa_kernels) <= 0 or countssa["dyn_assembly"] != 0:
        fail(f"a kernel of the sampling path was not launched, or the fused assembly was: "
             f"{countssa}")
    if countssa["prop_bank"] < 3 * itsa:
        fail(f"sampling: fewer than three bank launches (one per group) an iteration: "
             f"{countssa}, {itsa} iterations")
    if countssa["kkt_rhs_fwd_sweep"] != countssa["kkt_fwd_sweep"] - 1:
        fail(f"sampling: not one re-solve per KKT attempt: {countssa}")
    if frsa["frac_all_systems_infid_1e-3"] < 0.9:
        fail(f"sampling frac at infidelity 1e-3 on all systems "
             f"{frsa['frac_all_systems_infid_1e-3']} < 0.9")
    if not np.median(sweep_sa) > np.median(sweep_pl):
        fail(f"sampling: the summed ζ-sweep fidelity {np.median(sweep_sa)} does not beat the "
             f"plain solve's {np.median(sweep_pl)}")
    emit({"phase": "launches_per_iter", "path": "sampling",
          **{k: v / max(itsa, 1) for k, v in countssa.items()}})

    # ---- 28. kernels, and the lifted reference, at robustness shapes ------- #
    # 160 iterations: the JAX test's 60 leave 0.8906 of B=256 at the gate
    # on the card (float32), 100 and 120 0.914, 160 0.930 (PERF.md, PR 12)
    RB_B, RB_T, RB_ITERS = 256, 51, 160
    probrb, warmrb = bu.robustness_problem(RB_T, 0.2)
    solverrb = probrb.solver
    modes = (solverrb.nlp.analytic is None, solverrb.fused_assembly_on, solverrb.kkt_refine_n,
             solverrb.kkt_aug_on, solverrb.retry_warm_on, solverrb.nlp.m, solverrb.nlp.d,
             solverrb.nlp.s)
    if modes != (True, False, 0, True, True, 1, 23, 21):
        fail(f"robustness modes {modes} != (True, False, 0, True, True, 1, 23, 21)")
    with torch.no_grad():
        strb, kkt_rb, aux_rb, dwrb, rho_accrb, realrb, lift_seededrb = lifted_first_iteration(
            solverrb, bu.robustness_seeds(probrb, RB_B, 7))
        resultsrb = sweep_entries(realrb, RB_B, RB_T, delta_c, factors=True, lift=lift_seededrb,
                                  device=True)
    finish(resultsrb, bw, f32_peak)
    shapesrb = {"B": RB_B, "T": RB_T, "d": solverrb.nlp.d, "s": solverrb.nlp.s, "m": 1,
                "dtype": "float32"}
    for name, r in resultsrb.items():
        emit({"phase": "kernel", "path": "robustness", "name": name,
              "shapes": r.pop("shapes", shapesrb), "lifted": True, "blocks": "AD route", **r})
    emit({"phase": "lift_system", "path": "robustness",
          "rho0_median": float(aux_rb.rho0.median()), "rho0_max": float(aux_rb.rho0.max()),
          "dw_median": float(dwrb.median()),
          "accepted_lifted_frac": float((rho_accrb > 0).float().mean())})
    bad = [n for n, r in resultsrb.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the robustness shapes: {bad}")
    lifted_reference("robustness", solverrb, kkt_rb, aux_rb, dwrb, realrb)

    # ---- 29. robustness main path ------------------------------------------ #
    solverrb.solve(bu.robustness_seeds(probrb, RB_B, 6), max_iter=NEW_WARM)  # discarded warm-up
    Zrb0 = bu.robustness_seeds(probrb, RB_B, 5)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resrb = solverrb.solve(Zrb0, max_iter=RB_ITERS)
    torch.cuda.synchronize()
    wallrb = time.perf_counter() - t0
    countsrb = dict(build.launch_counts)
    itrb, attrb = solverrb.last_steps, solverrb.kkt_attempts
    lifted_sharerb = float(solverrb.kkt_lifted_rows) / max(solverrb.kkt_attempt_rows, 1)
    Zsrb = resrb.Z.double().cpu().numpy()
    if Zsrb.shape != (RB_B, RB_T, solverrb.nlp.d) or not np.isfinite(Zsrb).all():
        fail(f"robustness solution has shape {Zsrb.shape} or non-finite values")
    trrb = probrb.trajectory
    arb, dtrb = trrb.comp_slice("a"), trrb.comp_slice("Δt")

    def magnus(Zx):
        return bu.magnus_cost(Zx[:, :, arb], Zx[:, :, dtrb][:, :, 0], warmrb.system,
                              q.PAULIS["Z"], trrb.initial["Ũ⃗"], device="cuda")

    mag0, mag1 = magnus(Zrb0), magnus(Zsrb)
    fidrb = q.batched_rollout_fidelity(Zsrb[:, :, arb], Zsrb[:, :, dtrb][:, :, 0], warmrb.system,
                                       trrb.goal["Ũ⃗"], trrb.initial["Ũ⃗"], device="cuda")
    okrb = (mag1 < 0.5 * mag0) & (fidrb >= 0.989)
    fracrb = float(okrb.mean())
    emit({"phase": "main_path", "path": "robustness", "batch": RB_B, "T": RB_T,
          "ipm_iters": itrb, "wall_s": wallrb, "ipm_ms_per_iter": 1e3 * wallrb / max(itrb, 1),
          "frac_magnus_halved_at_fid_0.989": fracrb,
          "solves_per_s_at_gate": RB_B * fracrb / wallrb,
          "median_magnus_ratio": float(np.median(mag1 / mag0)),
          "magnus_ratio_quantiles": [float(x) for x in np.quantile(mag1 / mag0,
                                                                    [0.0, 0.1, 0.5, 0.9, 1.0])],
          "median_magnus_before": float(np.median(mag0)),
          "median_fid": float(np.median(fidrb)), "min_fid": float(fidrb.min()),
          "ipm_converged_frac": float(resrb.converged.float().mean()),
          "launches": countsrb, "kkt_attempts": attrb,
          "kkt_attempts_per_iter": attrb / max(itrb, 1), "lifted_attempt_share": lifted_sharerb,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    rb_kernels = ("kkt_fwd_sweep", "kkt_bwd_sweep", "kkt_rhs_fwd_sweep")
    if min(countsrb[k] for k in rb_kernels) <= 0:
        fail(f"a kernel of the robustness path was not launched: {countsrb}")
    if countsrb["dyn_assembly"] != 0 or countsrb["prop_bank"] != 0:
        fail(f"robustness: the dynamics went through kernel 1 or 5, not the AD route: "
             f"{countsrb}")
    if countsrb["kkt_rhs_fwd_sweep"] != countsrb["kkt_fwd_sweep"] - 1:
        fail(f"robustness: not one re-solve per KKT attempt: {countsrb}")
    if fracrb < 0.9:
        fail(f"robustness frac (Magnus cost halved at fidelity >= 0.989) {fracrb} < 0.9")
    emit({"phase": "launches_per_iter", "path": "robustness",
          **{k: v / max(itrb, 1) for k, v in countsrb.items()}})

    # ---- 30. kernels, and the SOC re-solve, at cnot_soc shapes ------------ #
    # phase 7's problem with soc=True: every iteration re-solves the
    # corrected rhs on each instance's kept factors (kernel 4, then 3)
    probcs = bu.cnot_problem(soc=True)
    solvercs = probcs.solver
    modes = (solvercs.soc_on, solvercs.fused_assembly_on, solvercs.kkt_refine_n)
    if modes != (True, False, 1):
        fail(f"cnot_soc modes {modes} != (True, False, 1)")

    def seedscs(seed):
        return probcs.multistart_initial_decisions(CX_B, sigma=0.3,
                                                   rng=np.random.default_rng(seed))

    with torch.no_grad():
        stcs = solvercs.init_state(seedscs(7))
        kkt_cs, aux_cs = solvercs._iteration_pre(stcs)
        dzcs, _, okcs, dwcs, _, rhocs, faccs = solvercs._solve_kkt_batched(
            kkt_cs, stcs.delta_w, stcs, False)
        kkt_cs = [x.contiguous() for x in kkt_cs]
        realcs = [x.contiguous() for x in solvercs._lifted(kkt_cs, dwcs, None)]
        resultscs = {"prop_bank": bank_entry(stcs.Z.contiguous(), solvercs.nlp.analytic,
                                             solvercs.var_scale)}
        resultscs.update(sweep_entries(realcs, CX_B, CX_T, delta_c, factors=True, device=True))
        # the first iteration's SOC rhs re-solved on the kept factors by
        # kernels 4 and 3 and by their plain versions, each against the
        # float64 re-solve on the same (float32) factors: the first
        # iteration's factors are near-singular in float32, where the two
        # orders of rounding differ by more than TOL (phase 8), so, as the
        # reference phases do, the kernels must be no worse than ten times
        # the plain version
        rz_s, rnu_s, grew_s = solvercs._soc_rhs(stcs, aux_cs, dzcs, rhocs, kkt_cs)
        dzs_k, nus_k, oks_k = kl.resolve_kkt_lanes(faccs, rz_s, rnu_s)
        f = faccs
        q_p, dzl_p = kl.rhs_fwd_sweep_reference(f.L_P, f.L_S, f.G, f.C, f.A, rz_s, rnu_s, f.L_Pf)
        dzs_p, nus_p = kl.bwd_sweep_reference(f.L_P, f.L_S, f.X_A, q_p, f.C, f.A, f.B, rnu_s,
                                              dzl_p)
        f64 = [x.double().cpu() for x in f]
        q_r, dzl_r = kl.rhs_fwd_sweep_reference(f64[0], f64[1], f64[3], f64[5], f64[6],
                                                rz_s.double().cpu(), rnu_s.double().cpu(),
                                                f64[4])
        dzs_r, nus_r = kl.bwd_sweep_reference(f64[0], f64[1], f64[2], q_r, f64[5], f64[6],
                                              f64[7], rnu_s.double().cpu(), dzl_r)
        keep = okcs.cpu() & oks_k.cpu()
        e_soc_k = max(rel_err(dzs_k.cpu(), dzs_r, keep)[1], rel_err(nus_k.cpu(), nus_r, keep)[1])
        e_soc_p = max(rel_err(dzs_p.cpu(), dzs_r, keep)[1], rel_err(nus_p.cpu(), nus_r, keep)[1])
    finish(resultscs, bw, f32_peak)
    shapescs = {"B": CX_B, "T": CX_T, "d": solvercs.nlp.d, "s": solvercs.nlp.s,
                "dtype": "float32"}
    for name, r in resultscs.items():
        emit({"phase": "kernel", "path": "cnot_soc", "name": name,
              "shapes": r.pop("shapes", shapescs), **r})
    emit({"phase": "soc_system", "path": "cnot_soc", "kernel_rel_err_vs_f64": e_soc_k,
          "plain_rel_err_vs_f64": e_soc_p, "compared": int(keep.sum()),
          "factored": int(okcs.sum()), "theta_grew": int(grew_s.sum())})
    if not (e_soc_k <= 10 * e_soc_p + 1e-6 and int(keep.sum()) == int(okcs.sum())):
        fail("the cnot_soc SOC re-solve on the kept factors is less accurate than the plain "
             "float32 re-solve, or not finite where the factorization succeeded")
    bad = [n for n, r in resultscs.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the cnot_soc shapes: {bad}")

    # ---- 31. cnot_soc main path ------------------------------------------- #
    solvercs.solve(seedscs(6), max_iter=CX_WARM)  # discarded warm-up
    Zcs0 = seedscs(42)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rescs = solvercs.solve(Zcs0, max_iter=CX_ITERS)
    torch.cuda.synchronize()
    wallcs = time.perf_counter() - t0
    countscs = dict(build.launch_counts)
    itcs, attcs = solvercs.last_steps, solvercs.kkt_attempts
    Zscs = rescs.Z.double().cpu().numpy()
    if Zscs.shape != (CX_B, CX_T, solvercs.nlp.d) or not np.isfinite(Zscs).all():
        fail(f"cnot_soc solution has shape {Zscs.shape} or non-finite values")
    infidcs = 1.0 - q.batched_rollout_fidelity(
        Zscs[:, :, probcs.trajectory.comp_slice("a")], np.full((CX_B, CX_T), CX_DT), sys2,
        probcs.trajectory.goal["Ũ⃗"], probcs.trajectory.initial["Ũ⃗"], device="cuda")
    frcs = {f"frac_infid_{t}": float(np.mean(infidcs <= float(t)))
            for t in ("1e-4", "1e-3", "1e-2")}
    trig = solvercs.mode_events("soc_trigger")
    taken = solvercs.mode_events("soc_taken")
    # the prediction, from this run's own attempts and iterations: each
    # attempt sweeps forward once and backward twice (its refinement pass
    # re-solves once on its factors), each iteration re-solves the SOC rhs
    # once, and the multiplier initialisation solves once
    predicted = {"kkt_fwd_sweep": attcs + 1, "kkt_rhs_fwd_sweep": attcs + itcs,
                 "kkt_bwd_sweep": 2 * attcs + itcs + 1}
    emit({"phase": "main_path", "path": "cnot_soc", "batch": CX_B, "T": CX_T,
          "ipm_iters": itcs, "wall_s": wallcs, "ipm_ms_per_iter": 1e3 * wallcs / max(itcs, 1),
          "solves_per_s_at_1e-4": CX_B * frcs["frac_infid_1e-4"] / wallcs, **frcs,
          "best_infid": float(infidcs.min()), "median_infid": float(np.median(infidcs)),
          "ipm_converged_frac": float(rescs.converged.float().mean()),
          "launches": countscs, "predicted_launches": predicted, "kkt_attempts": attcs,
          "kkt_attempts_per_iter": attcs / max(itcs, 1),
          "soc_trial_iterations": [int(k) for k in np.flatnonzero(trig.any(1))],
          "soc_taken_per_iteration": [int(x) for x in taken.sum(1)],
          "soc_taken_instances": int(taken.any(0).sum()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "launches_per_iter", "path": "cnot_soc",
          **{k: v / max(itcs, 1) for k, v in countscs.items()}})
    if any(countscs[k] != v for k, v in predicted.items()):
        fail(f"cnot_soc launches {countscs} != the prediction {predicted}")
    if countscs["dyn_assembly"] != 0 or countscs["prop_bank"] < itcs:
        fail(f"cnot_soc: the fused assembly ran, or fewer bank launches than iterations: "
             f"{countscs}")
    if frcs["frac_infid_1e-4"] < 0.9:
        fail(f"cnot_soc frac@1e-4 {frcs['frac_infid_1e-4']} < 0.9")

    def mode_rows(path, solver_, second_order_bank):
        """The kernels of a Hadamard-mode path on its own first iteration:
        the fused assembly where it is on, the bank and kernels 2, 3."""
        with torch.no_grad():
            st_, _, real_, _ = first_iteration(solver_, seeds(7))
            an_ = solver_.nlp.analytic
            rows = {}
            if solver_.fused_assembly_on:
                Z_, lam_ = st_.Z.contiguous(), st_.lam.contiguous()
                k_out = dyn_assembly_cuda(an_, Z_, lam_)
                r_out = dyn_assembly_reference(an_, Z_, lam_)
                errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
                rows["dyn_assembly"] = dict(results["dyn_assembly"],
                                            max_abs_err=max(e[0] for e in errs),
                                            max_rel_err=max(e[1] for e in errs),
                                            ms=time_ms(lambda: dyn_assembly_cuda(an_, Z_, lam_)),
                                            plain_ms=time_ms(
                                                lambda: dyn_assembly_reference(an_, Z_, lam_)))
                for k in ("bound_ms", "bound_by", "tol", "ok"):
                    rows["dyn_assembly"].pop(k, None)
            rows["prop_bank"] = bank_entry(st_.Z.contiguous(), an_, solver_.var_scale,
                                           second_order=second_order_bank)
            rows.update(sweep_entries(real_, B, T, delta_c, factors=False, device=True))
        finish(rows, bw, f32_peak)
        for name, r in rows.items():
            emit({"phase": "kernel", "path": path, "name": name,
                  "shapes": r.pop("shapes", shapes), **r})
        bad_ = [n for n, r in rows.items() if not r["ok"]]
        if bad_:
            fail(f"kernels disagree with their plain versions at the {path} shapes: {bad_}")
        return rows

    # ---- 32. hadamard_gn: Gauss-Newton Hessians ---------------------------- #
    solvergn = had_variant(dict(quasi_newton="gauss-newton"), dict(eval_hessian=False))
    modes = (solvergn.exact_hessian, solvergn.qn_lbfgs, solvergn.fused_assembly_on,
             solvergn.resto_on, solvergn.kkt_refine_n)
    if modes != (False, False, False, True, 0):
        fail(f"hadamard_gn modes {modes} != (False, False, False, True, 0)")
    resultsgn = mode_rows("hadamard_gn", solvergn, second_order_bank=False)
    resgn, wallgn, countsgn, itgn, attgn = timed_solve(solvergn, ITERS)
    frgn = main_path_line("hadamard_gn", resgn, wallgn, countsgn, itgn, attgn)
    # the bank once for the multiplier initialisation, once an iteration
    # (and once more for the iteration that found every instance converged)
    bank_gn = itgn + 1 + int(itgn < ITERS)
    if countsgn["dyn_assembly"] != 0 or countsgn["prop_bank"] != bank_gn:
        fail(f"hadamard_gn: kernel 1 launched, or not {bank_gn} bank launches: {countsgn}")
    if not countsgn["kkt_fwd_sweep"] == countsgn["kkt_bwd_sweep"] == attgn + 1:
        fail(f"hadamard_gn: sweeps {countsgn} != KKT attempts {attgn} + 1")
    if countsgn["kkt_rhs_fwd_sweep"] != 0:
        fail(f"hadamard_gn re-solved through kept factors: {countsgn}")
    Zseed = seeds(42)
    seed_infid = float(np.median(1.0 - q.batched_rollout_fidelity(
        Zseed[:, :, a_sl], Zseed[:, :, dt_sl][:, :, 0], sysq, prob.trajectory.goal["Ũ⃗"],
        prob.trajectory.initial["Ũ⃗"], device="cuda")))
    emit({"phase": "gauss_newton", "path": "hadamard_gn", "median_infid": frgn["median_infid"],
          "median_gate": GN_MEDIAN_GATE, "seed_median_infid": seed_infid})
    if not frgn["median_infid"] <= min(GN_MEDIAN_GATE, seed_infid):
        fail(f"hadamard_gn median infidelity {frgn['median_infid']} above the gate "
             f"{GN_MEDIAN_GATE} or the seeds' {seed_infid}")

    # ---- 33. hadamard_adaptive: the LOQO μ oracle -------------------------- #
    solverad = had_variant(dict(mu_strategy="adaptive"), {})
    if not solverad.fused_assembly_on:
        fail("hadamard_adaptive: the fused assembly is off")
    resultsad = mode_rows("hadamard_adaptive", solverad, second_order_bank=True)
    mu_hist = []
    resad, wallad, countsad, itad, attad = timed_solve(
        solverad, ITERS, callback=lambda k, st_: mu_hist.append(st_.mu.clone()))
    mus = torch.stack(mu_hist).cpu().numpy()  # (iterations, B)
    resets = solverad.mode_events("filter_reset")
    frad = main_path_line("hadamard_adaptive", resad, wallad, countsad, itad, attad)
    # μ turns NaN where a bound slack reaches its float32 floor (z/s
    # overflows; the JAX package's float32 solve does the same): such an
    # instance stops moving, and is counted here
    nan_mu = np.isnan(mus).any(0)
    emit({"phase": "adaptive_mu", "path": "hadamard_adaptive",
          "mu_min": float(np.nanmin(mus)), "mu_max": float(np.nanmax(mus)),
          "mu_median_last": float(np.nanmedian(mus[-1])),
          "mu_nan_instances": int(nan_mu.sum()),
          "filter_resets": int(resets.sum()),
          "filter_reset_iterations": int(resets.any(1).sum())})
    if countsad["dyn_assembly"] < itad or countsad["kkt_rhs_fwd_sweep"] != 0:
        fail(f"hadamard_adaptive: fewer assembly launches than iterations, or a re-solve: "
             f"{countsad}")
    if frad["frac_infid_1e-3"] < AD_GATE:
        fail(f"hadamard_adaptive frac@1e-3 {frad['frac_infid_1e-3']} < {AD_GATE}")

    # ---- 34. hadamard_watchdog --------------------------------------------- #
    solverwd = had_variant(dict(watchdog_trials=3), {})
    if not (solverwd.wd_on and solverwd.fused_assembly_on):
        fail("hadamard_watchdog: the watchdog or the fused assembly is off")
    resultswd = mode_rows("hadamard_watchdog", solverwd, second_order_bank=True)
    reswd, wallwd, countswd, itwd, attwd = timed_solve(solverwd, ITERS)
    act = solverwd.mode_events("wd_activate").reshape(-1, B)
    rew = solverwd.mode_events("wd_rewind").reshape(-1, B)
    frwd = main_path_line("hadamard_watchdog", reswd, wallwd, countswd, itwd, attwd)
    emit({"phase": "watchdog", "path": "hadamard_watchdog", "activations": int(act.sum()),
          "rewinds": int(rew.sum()), "instances_activated": [int(i) for i in
                                                              np.flatnonzero(act.any(0))],
          "instances_rewound": [int(i) for i in np.flatnonzero(rew.any(0))],
          "activation_iterations": [int(k) for k in np.flatnonzero(act.any(1))]})
    if countswd["dyn_assembly"] < itwd or countswd["kkt_rhs_fwd_sweep"] != 0:
        fail(f"hadamard_watchdog: fewer assembly launches than iterations, or a re-solve: "
             f"{countswd}")
    if frwd["frac_infid_1e-4"] < WD_GATE:
        fail(f"hadamard_watchdog frac@1e-4 {frwd['frac_infid_1e-4']} < {WD_GATE}")

    # ---- 35. the live iteration table (print_level 5) ---------------------- #
    solverlt = had_variant(dict(print_level=5), {})
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        solverlt.solve(seeds(42), max_iter=LIVE_ITERS)
    lines = table.getvalue().splitlines()
    rows_lt = [line.split() for line in lines[1:]]
    numbers_ok = all(len(r) == 10 and all(np.isfinite(float(x)) for x in r[1:-1] if x != "-")
                     for r in rows_lt)
    emit({"phase": "live_table", "path": "hadamard", "header": lines[0] if lines else None,
          "header_ok": bool(lines) and lines[0] == LIVE_HEADER, "rows": len(rows_lt),
          "iterations": solverlt.last_steps, "rows_parse": numbers_ok,
          "last_row": lines[-1] if lines else None})
    if not (lines and lines[0] == LIVE_HEADER and len(rows_lt) == solverlt.last_steps
            == LIVE_ITERS and numbers_ok
            and [int(r[0]) for r in rows_lt] == list(range(LIVE_ITERS))):
        fail(f"the live iteration table is not as expected: {lines[:2]}, {len(rows_lt)} rows")

    # ---- 36. kernels at the free-phase shapes ------------------------------ #
    probfp = bu.free_phase_problem(T=FP_T)
    solverfp = probfp.solver
    nfp = solverfp.nlp
    modes = (solverfp.fused_assembly_on, solverfp.kkt_aug_on, nfp.d, nfp.s, nfp.m)
    if modes != (True, False, 13, 11, 0):
        fail(f"free_phase modes (fused, lift, d, s, m) {modes} != (True, False, 13, 11, 0)")
    probbp = bu.bang_bang_problem(T=BB_T, phase=True)
    nbp = probbp.solver.nlp
    if (nbp.d, nbp.s, nbp.m, probbp.solver.fused_assembly_on) != (16, 11, 4, True):
        fail(f"bang_bang with a phase: (d, s, m, fused) {(nbp.d, nbp.s, nbp.m)}")

    def seedsfp(seed):
        return bu.free_phase_seeds(probfp, B, seed)

    with torch.no_grad():
        stfp, _, realfp, _ = first_iteration(solverfp, seedsfp(7))
        resultsfp = {"dyn_assembly": assembly_entry(nfp.analytic, stfp.Z, stfp.lam,
                                                    probfp.global_slices)}
        resultsfp.update(sweep_entries(realfp, B, FP_T, delta_c, factors=False, device=True))
        # the multiplier initialisation's Jacobian (first order); the
        # iterations run kernel 1
        resultsfp["prop_bank"] = bank_entry(stfp.Z.contiguous(), nfp.analytic,
                                            solverfp.var_scale, second_order=False)
        stbp = probbp.solver.init_state(bu.hadamard_seeds(probbp, B, 7))
        row_bp = {"dyn_assembly": assembly_entry(nbp.analytic, stbp.Z, stbp.lam,
                                                 probbp.global_slices)}
    finish(resultsfp, bw, f32_peak)
    finish(row_bp, bw, f32_peak)
    shapesfp = {"B": B, "T": FP_T, "d": nfp.d, "s": nfp.s, "m": 0, "dtype": "float32"}
    for path, rows in (("free_phase", resultsfp), ("bang_bang_phase", row_bp)):
        for name, r in rows.items():
            emit({"phase": "kernel", "path": path, "name": name,
                  "shapes": r.pop("shapes", shapesfp), **r})
    bad = [n for rows in (resultsfp, row_bp) for n, r in rows.items()
           if not r["ok"] or not r.get("global_cols_zero", True)]
    if bad:
        fail(f"kernels disagree with their plain versions at the free-phase shapes, or kernel 1 "
             f"left a global column unwritten: {bad}")

    # ---- 37. free_phase main path ------------------------------------------ #
    solverfp.solve(seedsfp(6), max_iter=NEW_WARM)  # discarded warm-up
    Zfp0 = seedsfp(42)
    resfp, wallfp, countsfp, itfp, attfp = timed_run(solverfp, Zfp0, FP_ITERS)
    Zsfp = checked_solution("free_phase", resfp, (B, FP_T, nfp.d))
    fidfp, plainfp = bu.free_phase_fidelity(probfp, Zsfp, probfp.system, device="cuda")
    frfp = {f"frac_infid_{t}": float(np.mean(1.0 - fidfp <= float(t)))
            for t in ("1e-4", "1e-3", "1e-2")}
    gfp = probfp.global_slices["ϕ"][0]
    predfp = {"kkt_fwd_sweep": attfp + 1, "kkt_bwd_sweep": attfp + 1, "kkt_rhs_fwd_sweep": 0}
    emit({"phase": "main_path", "path": "free_phase", "batch": B, "T": FP_T, "ipm_iters": itfp,
          "wall_s": wallfp, "ipm_ms_per_iter": 1e3 * wallfp / max(itfp, 1),
          "solves_per_s_at_1e-3": B * frfp["frac_infid_1e-3"] / wallfp, **frfp,
          "gate_frac_infid_1e-3": FP_GATE, "median_infid": float(np.median(1.0 - fidfp)),
          "median_plain_fid": float(np.median(plainfp)),
          "phase_quantiles": [float(x) for x in np.quantile(Zsfp[:, -1, gfp],
                                                            [0.0, 0.25, 0.5, 0.75, 1.0])],
          "ipm_converged_frac": float(resfp.converged.float().mean()),
          **launch_fields(countsfp, predfp, itfp, attfp)})
    emit({"phase": "launches_per_iter", "path": "free_phase",
          **{k: v / max(itfp, 1) for k, v in countsfp.items()}})
    if any(countsfp[k] != v for k, v in predfp.items()):
        fail(f"free_phase launches {countsfp} != the prediction {predfp}")
    if countsfp["dyn_assembly"] < itfp or countsfp["prop_bank"] < 1:
        fail(f"free_phase: fewer assembly launches than iterations, or no bank: {countsfp}")
    if frfp["frac_infid_1e-3"] < FP_GATE or not np.median(plainfp) < 0.5:
        fail(f"free_phase frac@1e-3 {frfp['frac_infid_1e-3']} < {FP_GATE}, or median plain "
             f"fidelity {np.median(plainfp)} >= 0.5")

    # ---- 38. free_phase_min_time: a B=1 warm stage, then B=512 lifted ------- #
    warmf = bu.free_phase_problem(T=FP_T)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    warmf.solve(max_iter=FP_ITERS)
    torch.cuda.synchronize()
    wallfw = time.perf_counter() - t0
    countsfw = dict(build.launch_counts)
    trw = warmf.trajectory
    fid_fw = float(q.unitary_rollout_fidelity(trw, warmf.system, phases=trw.global_data["ϕ"],
                                              phase_operators=[q.PAULIS["Z"]]))
    emit({"phase": "main_path", "path": "free_phase_min_time_warm", "batch": 1, "T": FP_T,
          "ipm_iters": warmf.solver.last_steps, "wall_s": wallfw,
          "ipm_ms_per_iter": 1e3 * wallfw / max(warmf.solver.last_steps, 1),
          "warm_free_phase_fid": fid_fw, "warm_phase": float(trw.global_data["ϕ"][0]),
          "converged": bool(warmf.result.converged[0]), "launches": countsfw,
          "kkt_attempts": warmf.solver.kkt_attempts})
    if not fid_fw > 0.98:
        fail(f"free_phase_min_time warm stage free-phase fidelity {fid_fw}")
    mtf, durf0 = bu.free_phase_min_time_problem(warmf)
    solvermf = mtf.solver
    nmf = solvermf.nlp
    modes = (solvermf.fused_assembly_on, solvermf.kkt_aug_on, nmf.d, nmf.s, nmf.m)
    if modes != (True, True, 13, 11, 1):
        fail(f"free_phase_min_time modes (fused, lift, d, s, m) {modes} != "
             f"(True, True, 13, 11, 1)")
    with torch.no_grad():
        stmf, kkt_mf, aux_mf, dwmf, _, realmf, lift_mf = lifted_first_iteration(
            solvermf, bu.min_time_seeds(mtf, B, 7))
        resultsmf = {"dyn_assembly": assembly_entry(nmf.analytic, stmf.Z, stmf.lam,
                                                    mtf.global_slices)}
        resultsmf.update(sweep_entries(realmf, B, FP_T, delta_c, factors=True, lift=lift_mf,
                                       device=True))
    finish(resultsmf, bw, f32_peak)
    shapesmf = {"B": B, "T": FP_T, "d": nmf.d, "s": nmf.s, "m": 1, "dtype": "float32"}
    for name, r in resultsmf.items():
        emit({"phase": "kernel", "path": "free_phase_min_time", "name": name,
              "shapes": r.pop("shapes", shapesmf),
              **({"lifted": True} if name.startswith("kkt") else {}), **r})
    bad = [n for n, r in resultsmf.items() if not r["ok"] or not r.get("global_cols_zero", True)]
    if bad:
        fail(f"kernels disagree with their plain versions at the free_phase_min_time shapes: "
             f"{bad}")
    lifted_reference("free_phase_min_time", solvermf, kkt_mf, aux_mf, dwmf, realmf)
    solvermf.solve(bu.min_time_seeds(mtf, B, 6), max_iter=NEW_WARM)  # discarded warm-up
    resmf, wallmf, countsmf, itmf, attmf = timed_run(solvermf, bu.min_time_seeds(mtf, B, 42),
                                                     FPM_ITERS)
    Zsmf = checked_solution("free_phase_min_time", resmf, (B, FP_T, nmf.d))
    fidmf, _ = bu.free_phase_fidelity(mtf, Zsmf, warmf.system, device="cuda")
    dursmf = Zsmf[:, :-1, mtf.trajectory.comp_slice("Δt")][:, :, 0].sum(1)
    okmf = (fidmf >= FPM_FLOOR - 1e-4) & (dursmf < 0.9 * durf0)
    predmf = {"kkt_fwd_sweep": attmf + 1, "kkt_rhs_fwd_sweep": attmf,
              "kkt_bwd_sweep": 2 * attmf + 1}
    emit({"phase": "main_path", "path": "free_phase_min_time", "batch": B, "T": FP_T,
          "ipm_iters": itmf, "wall_s": wallmf, "ipm_ms_per_iter": 1e3 * wallmf / max(itmf, 1),
          "success_frac": float(okmf.mean()), "gate_success_frac": FPM_GATE,
          "solves_per_s_at_success": B * float(okmf.mean()) / wallmf,
          "frac_fid": float(np.mean(fidmf >= FPM_FLOOR - 1e-4)),
          "frac_shorter": float(np.mean(dursmf < 0.9 * durf0)), "duration_before": durf0,
          "median_duration_after": float(np.median(dursmf)), "median_fid": float(np.median(fidmf)),
          "fid_quantiles": [float(x) for x in np.quantile(fidmf, [0.0, 0.01, 0.1, 0.5, 0.9])],
          "lifted_attempt_share": (float(solvermf.kkt_lifted_rows)
                                   / max(solvermf.kkt_attempt_rows, 1)),
          "ipm_converged_frac": float(resmf.converged.float().mean()),
          **launch_fields(countsmf, predmf, itmf, attmf)})
    emit({"phase": "launches_per_iter", "path": "free_phase_min_time",
          **{k: v / max(itmf, 1) for k, v in countsmf.items()}})
    if any(countsmf[k] != v for k, v in predmf.items()):
        fail(f"free_phase_min_time launches {countsmf} != the prediction {predmf}")
    if countsmf["dyn_assembly"] < itmf or countsmf["prop_bank"] != 1:
        fail(f"free_phase_min_time: fewer assembly launches than iterations, or not one bank "
             f"launch: {countsmf}")
    if float(okmf.mean()) < FPM_GATE:
        fail(f"free_phase_min_time success_frac {float(okmf.mean())} < {FPM_GATE}")

    # ---- 39. bang_bang ---------------------------------------------------- #
    probbb = bu.bang_bang_problem(T=BB_T)
    solverbb = probbb.solver
    nbb = solverbb.nlp
    modes = (solverbb.fused_assembly_on, solverbb.kkt_aug_on, nbb.d, nbb.s, nbb.m)
    if modes != (True, True, 15, 11, 4):
        fail(f"bang_bang modes (fused, lift, d, s, m) {modes} != (True, True, 15, 11, 4)")
    with torch.no_grad():
        stbb, kkt_bb, aux_bb, dwbb, _, realbb, lift_bb = lifted_first_iteration(
            solverbb, bu.hadamard_seeds(probbb, B, 7))
        resultsbb = {"dyn_assembly": assembly_entry(nbb.analytic, stbb.Z, stbb.lam)}
        resultsbb.update(sweep_entries(realbb, B, BB_T, delta_c, factors=True, lift=lift_bb,
                                       device=True))
    finish(resultsbb, bw, f32_peak)
    shapesbb = {"B": B, "T": BB_T, "d": nbb.d, "s": nbb.s, "m": 4, "dtype": "float32"}
    for name, r in resultsbb.items():
        emit({"phase": "kernel", "path": "bang_bang", "name": name,
              "shapes": r.pop("shapes", shapesbb),
              **({"lifted": True} if name.startswith("kkt") else {}), **r})
    bad = [n for n, r in resultsbb.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the bang_bang shapes: {bad}")
    lifted_reference("bang_bang", solverbb, kkt_bb, aux_bb, dwbb, realbb)
    solverbb.solve(bu.hadamard_seeds(probbb, B, 6), max_iter=NEW_WARM)  # discarded warm-up
    resbb, wallbb, countsbb, itbb, attbb = timed_run(solverbb, bu.hadamard_seeds(probbb, B, 42),
                                                     BB_ITERS)
    Zsbb = checked_solution("bang_bang", resbb, (B, BB_T, nbb.d))
    trb = probbb.trajectory
    infidbb = 1.0 - q.batched_rollout_fidelity(
        Zsbb[:, :, trb.comp_slice("a")], Zsbb[:, :, trb.comp_slice("Δt")][:, :, 0],
        probbb.system, trb.goal["Ũ⃗"], trb.initial["Ũ⃗"], device="cuda")
    frbb = {f"frac_infid_{t}": float(np.mean(infidbb <= float(t)))
            for t in ("1e-4", "1e-3", "1e-2", "1e-1")}
    da_bb = float(np.median(bu.da_count(Zsbb, trb.comp_slice("da"))))
    da_had = float(np.median(bu.da_count(res.Z.cpu().numpy(), prob.trajectory.comp_slice("da"))))
    predbb = {"kkt_fwd_sweep": attbb + 1, "kkt_rhs_fwd_sweep": attbb,
              "kkt_bwd_sweep": 2 * attbb + 1}
    emit({"phase": "main_path", "path": "bang_bang", "batch": B, "T": BB_T, "ipm_iters": itbb,
          "wall_s": wallbb, "ipm_ms_per_iter": 1e3 * wallbb / max(itbb, 1), **frbb,
          "gate": {"bar": BB_BAR, "frac": BB_GATE},
          "solves_per_s_at_bar": B * float(np.mean(infidbb <= BB_BAR)) / wallbb,
          "median_infid": float(np.median(infidbb)), "median_da_count": da_bb,
          "hadamard_median_da_count": da_had,
          "ipm_converged_frac": float(resbb.converged.float().mean()),
          **launch_fields(countsbb, predbb, itbb, attbb)})
    emit({"phase": "launches_per_iter", "path": "bang_bang",
          **{k: v / max(itbb, 1) for k, v in countsbb.items()}})
    if any(countsbb[k] != v for k, v in predbb.items()):
        fail(f"bang_bang launches {countsbb} != the prediction {predbb}")
    if countsbb["dyn_assembly"] < itbb or countsbb["prop_bank"] != 1:
        fail(f"bang_bang: fewer assembly launches than iterations, or not one bank launch: "
             f"{countsbb}")
    if float(np.mean(infidbb <= BB_BAR)) < BB_GATE or da_bb > da_had:
        fail(f"bang_bang frac@{BB_BAR} {float(np.mean(infidbb <= BB_BAR))} < {BB_GATE}, or "
             f"its median |da| > 5e-2 count {da_bb} above the hadamard path's {da_had}")

    # ---- 40. kernels at the density shapes --------------------------------- #
    probdn = bu.density_problem(T=DN_T)
    solverdn = probdn.solver
    ndn, sysdn, trdn = solverdn.nlp, probdn.system, probdn.trajectory
    modes = (ndn.analytic is None, solverdn.fused_assembly_on, solverdn.kkt_refine_n,
             solverdn.kkt_aug_on, ndn.d, ndn.s, ndn.m)
    if modes != (True, False, 0, False, 15, 13, 0):
        fail(f"density modes (AD route, fused, refine, lift, d, s, m) {modes} != "
             f"(True, False, 0, False, 15, 13, 0)")

    def seedsdn(seed):
        return bu.density_seeds(probdn, B, seed)

    with torch.no_grad():
        _, _, realdn, _ = first_iteration(solverdn, seedsdn(7))
        resultsdn = sweep_entries(realdn, B, DN_T, delta_c, factors=False, device=True)
    finish(resultsdn, bw, f32_peak)
    shapesdn = {"B": B, "T": DN_T, "d": ndn.d, "s": ndn.s, "m": 0, "dtype": "float32"}
    for name, r in resultsdn.items():
        emit({"phase": "kernel", "path": "density", "name": name,
              "shapes": r.pop("shapes", shapesdn), "blocks": "AD route", **r})
    bad = [n for n, r in resultsdn.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the density shapes: {bad}")
    kkt_reference("density", realdn)
    Zdn0 = seedsdn(42)
    f64 = dict(dtype=torch.float64, device="cuda")
    a_dn, dt_dn = Zdn0[:, :, trdn.comp_slice("a")], Zdn0[:, :, trdn.comp_slice("Δt")][:, :, 0]
    a64 = torch.as_tensor(a_dn, **f64)
    rho64 = torch.as_tensor(Zdn0[:, :, trdn.comp_slice("ρ⃗̃")], **f64)
    act = sysdn.lindblad_action(a64, rho64)
    dense = (sysdn.lindblad_generator(a64) @ rho64.unsqueeze(-1)).squeeze(-1)
    err_act = float((act - dense).abs().max())
    r0dn = trdn.initial["ρ⃗̃"]
    roll = {integ: q.open_rollout(r0dn, a_dn, dt_dn, sysdn, integrator=integ, device="cuda")
            for integ in ("expm", "expv")}
    err_expv = float((roll["expv"] - roll["expm"]).abs().max())
    emit({"phase": "lindblad_check", "path": "density", "batch": B, "T": DN_T,
          "action_max_abs_err_vs_dense": err_act, "action_tol": DN_ACTION_TOL,
          "expv_max_abs_err_vs_expm": err_expv, "expv_tol": DN_EXPV_TOL,
          "dtype": "float64", "krylov_dim": 24, "substeps": 8})
    if not (err_act <= DN_ACTION_TOL and err_expv <= DN_EXPV_TOL):
        fail(f"density: lindblad_action off the dense generator by {err_act}, or the expv "
             f"rollout off the expm one by {err_expv}")

    # ---- 41. density main path ---------------------------------------------- #
    solverdn.solve(seedsdn(6), max_iter=NEW_WARM)  # discarded warm-up
    resdn, walldn, countsdn, itdn, attdn = timed_run(solverdn, Zdn0, DN_ITERS)
    Zsdn = checked_solution("density", resdn, (B, DN_T, ndn.d))
    infdn = 1.0 - bu.density_fidelity(probdn, Zsdn, device="cuda")
    infdn0 = 1.0 - bu.density_fidelity(probdn, Zdn0, device="cuda")
    fracdn = float(np.mean(infdn <= DN_BAR))
    frdn = {f"frac_infid_{t}": float(np.mean(infdn <= float(t)))
            for t in ("5e-3", "1e-2", "2e-2", "5e-2", "1e-1")}
    preddn = {"kkt_fwd_sweep": attdn + 1, "kkt_bwd_sweep": attdn + 1, "kkt_rhs_fwd_sweep": 0,
              "dyn_assembly": 0, "prop_bank": 0}
    emit({"phase": "main_path", "path": "density", "batch": B, "T": DN_T, "ipm_iters": itdn,
          "wall_s": walldn, "ipm_ms_per_iter": 1e3 * walldn / max(itdn, 1), **frdn,
          "gate": {"bar": DN_BAR, "frac": DN_GATE}, "frac_at_bar": fracdn,
          "solves_per_s_at_bar": B * fracdn / walldn,
          "median_infid": float(np.median(infdn)), "min_infid": float(infdn.min()),
          "seeds_median_infid": float(np.median(infdn0)),
          "infid_quantiles": [float(x) for x in np.quantile(infdn, [0.0, 0.1, 0.5, 0.9, 1.0])],
          "ipm_converged_frac": float(resdn.converged.float().mean()),
          **launch_fields(countsdn, preddn, itdn, attdn)})
    emit({"phase": "launches_per_iter", "path": "density",
          **{k: v / max(itdn, 1) for k, v in countsdn.items()}})
    if any(countsdn[k] != v for k, v in preddn.items()):
        fail(f"density launches {countsdn} != the prediction {preddn}")
    if fracdn < DN_GATE or not np.median(infdn) < np.median(infdn0):
        fail(f"density frac@{DN_BAR} {fracdn} < {DN_GATE}, or median infidelity "
             f"{np.median(infdn)} not below the seeds' {np.median(infdn0)}")

    emit({"phase": "total", "script_s_after_environment": time.perf_counter() - t_start})

    entries = [("hadamard", n, r, had_counts) for n, r in results.items()]
    entries += [("cnot", n, r, counts2) for n, r in results2.items()]
    entries += [("ket_exp", n, r, countsk) for n, r in resultsk.items()]
    entries += [("cnot_exp", n, r, countsx) for n, r in resultsx.items()]
    entries += [("hadamard_lbfgs", n, r, countsq) for n, r in resultsq.items()]
    entries += [("hadamard_scan", n, results[n], countss) for n in ("dyn_assembly", "prop_bank")]
    entries += [("hadamard_scan", n, r, countss) for n, r in resultss.items()]
    entries += [("su4", n, r, countsu) for n, r in resultsu.items()]
    entries += [("min_time", n, r, countsm) for n, r in resultsm.items()]
    entries += [("min_time", "prop_bank", dict(resultsw["prop_bank"], stage="warm"), countsw)]
    entries += [("leakage", n, r, countsl) for n, r in resultsl.items()]
    entries += [("sampling", "prop_bank", dict(r, group=int(n.rsplit("_", 1)[1])), countssa)
                if n.startswith("prop_bank") else ("sampling", n, r, countssa)
                for n, r in resultssa.items()]
    entries += [("robustness", n, r, countsrb) for n, r in resultsrb.items()]
    entries += [("cnot_soc", n, r, countscs) for n, r in resultscs.items()]
    entries += [("hadamard_gn", n, r, countsgn) for n, r in resultsgn.items()]
    entries += [("hadamard_adaptive", n, r, countsad) for n, r in resultsad.items()]
    entries += [("hadamard_watchdog", n, r, countswd) for n, r in resultswd.items()]
    entries += [("free_phase", n, r, countsfp) for n, r in resultsfp.items()]
    entries += [("free_phase_min_time", n, r, countsmf) for n, r in resultsmf.items()]
    entries += [("bang_bang", n, r, countsbb) for n, r in resultsbb.items()]
    entries += [("density", n, r, countsdn) for n, r in resultsdn.items()]
    emit({"kernels": [
        {"name": name, "path": path, "branch": "exp" if path.endswith("_exp") else "pade",
         "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": cnt[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"], "ok": r["ok"],
         "columns": r.get("columns", 1),
         **{k: r[k] for k in ("launch", "ms_unit", "device_ms", "stage", "group") if k in r}}
        for path, name, r, cnt in entries
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
