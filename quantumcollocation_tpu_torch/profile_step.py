"""Where one IPM iteration of a main-path solve spends its time.

    python -m quantumcollocation_tpu_torch.profile_step
        [--config hadamard|hadamard_lbfgs|hadamard_scan|hadamard_gn|cnot|cnot_soc|ket_exp|
                  cnot_exp|su4|min_time|leakage|sampling|robustness|free_phase|bang_bang|
                  density|state_sampling|direct_sum|cz]
        [--steps 3] [--batch B]

Builds the problem of one of chip_smoke.py's main paths: "hadamard" (B=512,
T=51, Q=1e4, R=1e-3, filter line search, seeds = the initial guess plus
0.1-σ control noise), "hadamard_lbfgs" (hadamard with
PiccoloOptions(eval_hessian=False): the L-BFGS mode, profiled after 8
iterations so that its memory is full), "hadamard_scan" (hadamard with
kkt_backend "lanes_scan"), "hadamard_gn" (hadamard with
PiccoloOptions(eval_hessian=False) and quasi_newton="gauss-newton": the
bank first order, no defect curvature), "ket_exp" (the two-ket transfer |0>->|1>, |1>->|0>
with the exponential integrator, T=50, seeds as hadamard's), "cnot"
(BASELINE #3: two qubits, fixed Δt=0.3, B=128, T=40, kkt_backend "lanes",
seeds from multistart_initial_decisions), "cnot_soc" (cnot with soc=True:
the second-order correction re-solves on the kept factors every
iteration, bench_util.cnot_problem), "cnot_exp" (cnot with the
exponential integrator), "su4" (BASELINE #5: 128 Haar goals x 4 seeds,
T=33, Δt=0.3 fixed, kkt_backend "lanes", bench_util.su4_problem) or
"min_time" (BASELINE #2's minimum-time stage, B=512, after its B=1 warm
stage has solved for 80 iterations; bench_util.min_time_problem) or
"leakage" (BASELINE #4: the three-level transmon's embedded X gate with
L1 leakage slacks, B=256, T=40, Δt=0.2 fixed, kkt_backend "lanes",
bench_util.leakage_problem and leakage_seeds), "sampling" (example 04:
three drift samples ζ ∈ {-0.05, 0, 0.05}, H, T=50, Δt=0.2 free,
kkt_backend "lanes", B=512; bench_util.sampling_problem and
sampling_seeds) or "robustness" (the robustness warm start against
H_error = Z, floor 0.99, B=256: the AD route; bench_util.robustness_problem
and robustness_seeds) or "free_phase" (an X-only drive to the Y gate up to
a global Z phase, T=31, B=512, d=13 with the phase column;
bench_util.free_phase_problem and free_phase_seeds) or "bang_bang"
(UnitaryBangBangProblem, H, T=51, B=512, d=15, m=4 L1 rows, lifted;
bench_util.bang_bang_problem, hadamard's seeds) or "density" (example 05's
open-system problem: the Lindblad density ρ⃗̃ of a damped qubit, |0⟩ to |1⟩,
T=30, B=512, d=15: the AD route; bench_util.density_problem and
density_seeds) or "state_sampling" (QuantumStateSamplingProblem: one ket
|0⟩ → |1⟩ under the three drift samples, T=50, B=512, d=19, the fused
assembly over three groups; bench_util.state_sampling_problem and
multistart_seeds) or "direct_sum" (UnitaryDirectSumProblem of the H and X
Hadamard-system problems, each first solved by solve_multistart(8) for 30
iterations, T=31, B=512, d=30, m=2, lifted, one bank per part;
bench_util.direct_sum_parts, direct_sum_problem and direct_sum_seeds)
or "cz" (BASELINE #5: two three-level transmons, CZ embedded on their
qubit subspace, T=75, Δt=1.0 free, B=256, d=175, s=171: the bank at
n = 18 and the KKT route past 64, solver/kkt.py; bench_util.cz_problem and
cz_seeds), float32 on CUDA.  Runs two warm-up iterations
(eight for hadamard_lbfgs), then profiles `--steps` iterations with
torch.profiler and prints one JSON line: host wall per iteration,
device-busy time per iteration (the sum of kernel times), the idle share,
the CUDA launch count, and the kernels with the most device time.  The
profiler slows the host, so the wall and idle share read high; the kernel
times do not.  Then, without the profiler, the wall per iteration and, on
the AD route, the time of its dynamics blocks (F, A, B by jacrev and the
curvature -λ·∇²F, CUDA events around the calls) and their share of the
iteration; past the sweep kernels' 64 (the "riccati_torch" route), the
time of one KKT attempt of the route (factor_kkt and solve_with_factors on
the iteration's blocks, CUDA events), the attempts an iteration and the
route's share of the iteration.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import bench_util as bu
from .solver.kkt import factor_kkt, solve_with_factors
from . import (
    PAULIS,
    PiccoloOptions,
    QuantumStateSmoothPulseProblem,
    QuantumSystem,
    SolverOptions,
    multigoal_initial_decisions,
    random_su,
)


def build(config, batch):
    """(solver, Z0) of a main-path configuration; batch None = its own."""
    rng = np.random.default_rng(42)
    if config == "su4":
        prob = bu.su4_problem()
        n_goals = (batch or 512) // 4
        goal_rng = np.random.default_rng(2024)
        goals = [random_su(4, goal_rng) for _ in range(n_goals)]
        return prob.solver, multigoal_initial_decisions(
            prob, goals, n_seeds_per_goal=4, sigma=0.2, rng=np.random.default_rng(100))
    if config == "leakage":
        prob, _ = bu.leakage_problem()
        return prob.solver, bu.leakage_seeds(prob, batch or 256, 42)
    if config == "sampling":
        prob = bu.sampling_problem()
        return prob.solver, bu.sampling_seeds(prob, batch or 512, 42)
    if config == "robustness":
        prob, _ = bu.robustness_problem()
        return prob.solver, bu.robustness_seeds(prob, batch or 256, 42)
    if config == "free_phase":
        prob = bu.free_phase_problem()
        return prob.solver, bu.free_phase_seeds(prob, batch or 512, 42)
    if config == "density":
        prob = bu.density_problem()
        return prob.solver, bu.density_seeds(prob, batch or 512, 42)
    if config == "cz":
        prob, _ = bu.cz_problem()
        return prob.solver, bu.cz_seeds(prob, batch or 256, 42)
    if config == "state_sampling":
        prob = bu.state_sampling_problem()
        return prob.solver, bu.multistart_seeds(prob, batch or 512, 42)
    if config == "direct_sum":
        parts = bu.direct_sum_parts()
        for p in parts:
            p.solve_multistart(8, sigma=0.1, rng=np.random.default_rng(0), max_iter=30)
        prob = bu.direct_sum_problem(parts)
        return prob.solver, bu.direct_sum_seeds(prob, parts, batch or 512, 42)
    if config == "bang_bang":
        prob = bu.bang_bang_problem()
        return prob.solver, bu.hadamard_seeds(prob, batch or 512, 42)
    if config == "min_time":
        warm = bu.min_time_warm()
        warm.solve(max_iter=80)
        prob, _ = bu.min_time_problem(warm)
        return prob.solver, bu.min_time_seeds(prob, batch or 512, 42)
    if config.startswith("cnot"):
        prob = bu.cnot_problem("exponential" if config == "cnot_exp" else "pade",
                               soc=config == "cnot_soc")
        return prob.solver, prob.multistart_initial_decisions(batch or 128, sigma=0.3, rng=rng)
    if config.startswith("hadamard"):
        solver_kw, piccolo = {
            "hadamard": ({}, {}),
            "hadamard_lbfgs": ({}, dict(eval_hessian=False)),
            "hadamard_scan": (dict(kkt_backend="lanes_scan"), {}),
            "hadamard_gn": (dict(quasi_newton="gauss-newton"), dict(eval_hessian=False)),
        }[config]
        prob = bu.hadamard_problem(piccolo=piccolo, **solver_kw)
        return prob.solver, bu.hadamard_seeds(prob, batch or 512, 42)
    B, T = batch or 512, 50
    sysq = QuantumSystem(0.1 * PAULIS["Z"], [PAULIS["X"], PAULIS["Y"]])
    prob = QuantumStateSmoothPulseProblem(
        sysq, [[1, 0], [0, 1]], [[0, 1], [1, 0]], T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter"),
        piccolo_options=PiccoloOptions(verbose=False, integrator="exponential"),
        rng=np.random.default_rng(1),
    )
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    Z0[:, 1:-1, a_sl] += 0.1 * rng.standard_normal((B, T - 2, 2))
    return prob.solver, Z0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("hadamard", "hadamard_lbfgs", "hadamard_scan",
                                         "hadamard_gn", "cnot", "cnot_soc", "ket_exp",
                                         "cnot_exp", "su4", "min_time", "leakage", "sampling",
                                         "robustness", "free_phase", "bang_bang", "density",
                                         "state_sampling", "direct_sum", "cz"),
                    default="hadamard")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA GPU")
    solver, Z0 = build(args.config, args.batch)
    B = Z0.shape[0]
    st = solver.init_state(Z0)
    for _ in range(8 if args.config == "hadamard_lbfgs" else 2):
        st = solver.step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            st = solver.step(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: an aten op's own device time repeats its kernels'
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    print(json.dumps({
        "phase": "profile", "config": args.config, "device": torch.cuda.get_device_name(0),
        "batch": B,
        "steps": args.steps, "wall_ms_per_iter": 1e3 * wall / args.steps,
        "device_ms_per_iter": 1e-3 * device_us / args.steps,
        "idle_share": 1.0 - 1e-6 * device_us / wall,
        "kernel_launches_per_iter": sum(e.count for e in events) / args.steps,
        "top": [
            {"name": e.key[:80], "device_ms_per_iter": 1e-3 * e.self_device_time_total / args.steps,
             "count_per_iter": e.count / args.steps}
            for e in top
        ],
    }), flush=True)
    attempts = solver.kkt_attempts
    t0 = time.perf_counter()
    for _ in range(args.steps):
        st = solver.step(st)
    torch.cuda.synchronize()
    line = {"phase": "unprofiled", "config": args.config, "kkt_route": solver.kkt_route,
            "wall_ms_per_iter": 1e3 * (time.perf_counter() - t0) / args.steps,
            "kkt_attempts_per_iter": (solver.kkt_attempts - attempts) / args.steps}
    if solver.kkt_route == "riccati_torch":
        with torch.no_grad():
            kkt_in, _ = solver._iteration_pre(st)
            H, C, A, Bj, rz, rnu = [x.contiguous() for x in kkt_in]
            dc = solver.options.delta_c
            line["route_ms_per_attempt"] = bu.time_ms(
                lambda: solve_with_factors(factor_kkt(H, C, A, Bj, dc), rz, rnu), n=3, warm=1)
        line["route_share"] = (line["route_ms_per_attempt"] * line["kkt_attempts_per_iter"]
                               / line["wall_ms_per_iter"])
    f = solver.funcs
    if f.dyn_eval is not None:
        Z, lam = st.Z, st.lam
        line["ad_dyn_eval_ms"] = bu.time_ms(lambda: f.dyn_eval(Z), n=5, warm=1)
        line["ad_curvature_ms"] = bu.time_ms(lambda: f.defect_curvature(Z, lam), n=5, warm=1)
        line["ad_route_share"] = ((line["ad_dyn_eval_ms"] + line["ad_curvature_ms"])
                                  / line["wall_ms_per_iter"])
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
