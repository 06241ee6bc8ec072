"""The solver-mode paths' gates, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/solver_modes_gate_jax.py
        --mode gn|adaptive|watchdog [--dtype float32|float64] [--batch 16]
        [--iters 48]

The Hadamard problem of chip_smoke.py's phase 4 built in the JAX package
(Z drift, X and Y drives, T=51, Δt=0.2 free, Q=1e4, R=1e-3, filter line
search, κ_μ 0.2, tol 1e-5; the JAX package's XLA KKT backend) in one
solver mode: "gn" (PiccoloOptions(eval_hessian=False) with
quasi_newton="gauss-newton"), "adaptive" (mu_strategy="adaptive") or
"watchdog" (watchdog_trials=3); the first --batch rows of the timed seeds
of chip_smoke.py (the initial decision plus 0.1-σ noise on the interior
controls, default_rng(42), drawn for B=512), solved for --iters iterations
in --dtype (float32 runs with x64 off, as the JAX package runs on its
chip).  Then the same solve by the port on the CPU in the same dtype
(bench_util.hadamard_problem and hadamard_seeds).  Prints one JSON line
for each package: the fractions of instances at infidelity ≤ 1e-4, 1e-3,
1e-2 and 1e-1 by the port's float64 rollout, the median infidelity, and
the instances whose μ ended NaN.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MODES = {
    "gn": (dict(quasi_newton="gauss-newton"), dict(eval_hessian=False)),
    "adaptive": (dict(mu_strategy="adaptive"), {}),
    "watchdog": (dict(watchdog_trials=3), {}),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=sorted(MODES), required=True)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=48)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import quantumcollocation_tpu as qct
    import quantumcollocation_tpu_torch as qt
    from quantumcollocation_tpu_torch import bench_util as bu

    T, B_SEEDS = 51, 512
    solver_kw, piccolo_kw = MODES[args.mode]
    prob = qct.UnitarySmoothPulseProblem(
        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]), qct.GATES["H"], T,
        0.2, Q=1e4, R=1e-3,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2,
                                        line_search="filter", dtype=args.dtype, **solver_kw),
        piccolo_options=qct.PiccoloOptions(verbose=False, **piccolo_kw),
        rng=np.random.default_rng(0),
    )
    z0 = np.asarray(prob.initial_decision(1))[0]
    a_sl, dt_sl = prob.trajectory.comp_slice("a"), prob.trajectory.comp_slice("Δt")
    Z0 = np.broadcast_to(z0, (B_SEEDS, *z0.shape)).copy()
    Z0[:, 1:-1, a_sl] += 0.1 * np.random.default_rng(42).standard_normal((B_SEEDS, T - 2, 2))
    Z0 = Z0[: args.batch]
    res = prob.solver.solve(Z0, max_iter=args.iters)
    tr = prob.trajectory
    system = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    goal, init = np.asarray(tr.goal["Ũ⃗"]), np.asarray(tr.initial["Ũ⃗"])

    def line(package, res_):
        Z = np.asarray(res_.Z, dtype=np.float64)
        infid = 1.0 - qt.batched_rollout_fidelity(
            Z[:, :, a_sl], Z[:, :, dt_sl][:, :, 0], system, goal, init)
        print(json.dumps({
            "package": package, "mode": args.mode, "dtype": args.dtype,
            "batch": args.batch, "iters": args.iters,
            **{f"frac_infid_{t}": float(np.mean(infid <= float(t)))
               for t in ("1e-4", "1e-3", "1e-2", "1e-1")},
            "median_infid": float(np.median(infid)),
            "mu_nan_instances": int(np.isnan(np.asarray(res_.mu, dtype=np.float64)).sum()),
        }), flush=True)

    line("quantumcollocation_tpu", res)
    import torch

    torch.set_num_threads(4)
    probt = bu.hadamard_problem(device="cpu", piccolo=piccolo_kw, dtype=args.dtype, **solver_kw)
    Z0t = bu.hadamard_seeds(probt, B_SEEDS, 42)[: args.batch]
    rest = probt.solver.solve(Z0t, max_iter=args.iters)
    line("quantumcollocation_tpu_torch", rest._replace(Z=rest.Z.cpu().numpy(),
                                                       mu=rest.mu.cpu().numpy()))

if __name__ == "__main__":
    main()
