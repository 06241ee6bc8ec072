"""Where one IPM iteration of a main-path solve spends its time.

    python -m quantumcollocation_tpu_torch.profile_step
        [--config hadamard|hadamard_lbfgs|hadamard_scan|cnot|ket_exp|cnot_exp]
        [--steps 3] [--batch B]

Builds the problem of one of chip_smoke.py's main paths: "hadamard" (B=512,
T=51, Q=1e4, R=1e-3, filter line search, seeds = the initial guess plus
0.1-σ control noise), "hadamard_lbfgs" (hadamard with
PiccoloOptions(eval_hessian=False): the L-BFGS mode, profiled after 8
iterations so that its memory is full), "hadamard_scan" (hadamard with
kkt_backend "lanes_scan"), "ket_exp" (the two-ket transfer |0>->|1>, |1>->|0>
with the exponential integrator, T=50, seeds as hadamard's), "cnot"
(BASELINE #3: two qubits, fixed Δt=0.3, B=128, T=40, kkt_backend "lanes",
seeds from multistart_initial_decisions) or "cnot_exp" (cnot with the
exponential integrator), float32 on CUDA.  Runs two warm-up iterations
(eight for hadamard_lbfgs), then profiles `--steps`
iterations with torch.profiler and prints one JSON line: host wall per
iteration, device-busy time per iteration (the sum of kernel times), the
idle share, the CUDA launch count, and the kernels with the most device
time.  The profiler slows the host, so the wall and idle share read high;
the kernel times do not.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import (
    GATES,
    PAULIS,
    PiccoloOptions,
    QuantumStateSmoothPulseProblem,
    QuantumSystem,
    SolverOptions,
    UnitarySmoothPulseProblem,
)


def build(config, batch):
    """(solver, Z0) of a main-path configuration; batch None = its own."""
    opts = dict(print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter")
    rng = np.random.default_rng(42)
    integrator = "exponential" if config.endswith("_exp") else "pade"
    if config.startswith("cnot"):
        P, k = PAULIS, np.kron
        sysq = QuantumSystem(0.1 * k(P["Z"], P["Z"]), [k(P["Z"], P["X"]), k(P["X"], P["I"]),
                                                      k(P["Y"], P["I"]), k(P["I"], P["X"]),
                                                      k(P["I"], P["Y"])])
        prob = UnitarySmoothPulseProblem(
            sysq, GATES["CX"], 40, 0.3, Q=1e4, R=1e-3,
            ipopt_options=SolverOptions(kkt_backend="lanes", **opts),
            piccolo_options=PiccoloOptions(verbose=False, free_time=False,
                                           integrator=integrator),
            rng=np.random.default_rng(7),
        )
        return prob.solver, prob.multistart_initial_decisions(batch or 128, sigma=0.3, rng=rng)
    B = batch or 512
    if config == "ket_exp":
        T = 50
        sysq = QuantumSystem(0.1 * PAULIS["Z"], [PAULIS["X"], PAULIS["Y"]])
        prob = QuantumStateSmoothPulseProblem(
            sysq, [[1, 0], [0, 1]], [[0, 1], [1, 0]], T, 0.2, Q=1e4, R=1e-3,
            ipopt_options=SolverOptions(**opts),
            piccolo_options=PiccoloOptions(verbose=False, integrator=integrator),
            rng=np.random.default_rng(1),
        )
    else:
        T = 51
        sysq = QuantumSystem(GATES["Z"], [GATES["X"], GATES["Y"]])
        backend = "lanes_scan" if config == "hadamard_scan" else "xla"
        prob = UnitarySmoothPulseProblem(
            sysq, GATES["H"], T, 0.2, Q=1e4, R=1e-3,
            ipopt_options=SolverOptions(kkt_backend=backend, **opts),
            piccolo_options=PiccoloOptions(verbose=False,
                                           eval_hessian=config != "hadamard_lbfgs"),
            rng=np.random.default_rng(0),
        )
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    Z0[:, 1:-1, a_sl] += 0.1 * rng.standard_normal((B, T - 2, 2))
    return prob.solver, Z0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("hadamard", "hadamard_lbfgs", "hadamard_scan", "cnot",
                                         "ket_exp", "cnot_exp"), default="hadamard")
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


if __name__ == "__main__":
    main()
