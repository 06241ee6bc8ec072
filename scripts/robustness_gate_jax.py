"""The robustness path's gate, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/robustness_gate_jax.py [--dtype float32|float64]
        [--batch 16] [--iters 60]

The robustness problem of chip_smoke.py's phase 29 built in the JAX
package (the drift-free X/Y qubit's constant-π-pulse X gate, T=51,
Δt=0.2, tol 1e-7, then UnitaryRobustnessProblem against H_error = Z with
floor 0.99; the JAX package's XLA KKT backend), the port's seeds
(bench_util.robustness_seeds: the warm decision plus 0.02-σ noise on the
controls from default_rng(5)), solved for --iters iterations in --dtype
(float32 runs with x64 off, as the JAX package runs on its chip).  Prints
one JSON line: the fraction of instances whose float64 Magnus cost falls
below half their seed's at float64 fidelity ≥ 0.989 (the port's
bench_util measures), with the Magnus ratios' quantiles.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import quantumcollocation_tpu as qct
    import quantumcollocation_tpu_torch as qt
    from quantumcollocation_tpu_torch import bench_util as bu

    T, dt = 51, 0.2
    system = qct.QuantumSystem(None, [qct.PAULIS["X"], qct.PAULIS["Y"]])
    a_guess = np.zeros((T, 2))
    a_guess[:, 0] = (np.pi / 2) / ((T - 1) * dt)
    warm = qct.UnitarySmoothPulseProblem(
        system, qct.GATES["X"], T, dt, a_guess=a_guess,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-7, dtype=args.dtype),
        piccolo_options=qct.PiccoloOptions(verbose=False),
    )
    prob = qct.UnitaryRobustnessProblem(qct.PAULIS["Z"], warm, system, final_fidelity=0.99)
    Z0 = bu.robustness_seeds(prob, args.batch, 5)
    Z = np.asarray(prob.solver.solve(Z0, max_iter=args.iters).Z, dtype=np.float64)
    tr = prob.trajectory
    a, dts = tr.comp_slice("a"), tr.comp_slice("Δt")
    port_system = qt.QuantumSystem(None, [qt.PAULIS["X"], qt.PAULIS["Y"]])
    init, goal = np.asarray(tr.initial["Ũ⃗"]), np.asarray(tr.goal["Ũ⃗"])

    def magnus(Zx):
        return bu.magnus_cost(Zx[:, :, a], Zx[:, :, dts][:, :, 0], port_system, qt.PAULIS["Z"],
                              init)

    ratio = magnus(Z) / magnus(Z0)
    fid = qt.batched_rollout_fidelity(Z[:, :, a], Z[:, :, dts][:, :, 0], port_system, goal, init)
    print(json.dumps({
        "package": "quantumcollocation_tpu", "dtype": args.dtype, "batch": args.batch,
        "iters": args.iters, "frac": float(np.mean((ratio < 0.5) & (fid >= 0.989))),
        "ratio_quantiles": [float(x) for x in np.quantile(ratio, [0, 0.1, 0.5, 0.9, 1])],
        "min_fid": float(fid.min()),
    }))


if __name__ == "__main__":
    main()
