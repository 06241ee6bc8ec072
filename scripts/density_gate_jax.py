"""The density path's gate, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/density_gate_jax.py
        [--iters 60] [--dtype float32|float64] [--batch 16]

Builds chip_smoke.py's `density` path (example 05's open-system problem:
drift Z, drives X and Y, one dissipator 0.05 a, ρ0 = |0⟩⟨0|, the goal |1⟩,
T=30, Δt=0.2 free, Q=100, R=1e-2, tol 1e-6, κ_μ 0.2, filter line search,
rng default_rng(0)) in the JAX package and in the port (bench_util's
density_problem; the same numpy draws) and solves the first --batch rows
of its timed seeds (bench_util.density_seeds, default_rng(42), drawn for
B=512) for --iters iterations in --dtype (float32 runs with x64 off, as
the JAX package runs on its chip; the port on the CPU in the same dtype).

Prints one JSON line for each package: the fractions of instances whose
float64 open-rollout infidelity 1 - ⟨ψ|ρ_T|ψ⟩ (the port's rollout) is at
most 5e-3, 1e-2, 2e-2, 5e-2 and 1e-1, the median and largest infidelity, and
the seeds' median infidelity.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B_SEEDS = 512
BARS = ("5e-3", "1e-2", "2e-2", "5e-2", "1e-1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import torch

    import quantumcollocation_tpu as qct
    from quantumcollocation_tpu_torch import bench_util as bu

    torch.set_num_threads(4)
    port = bu.density_problem(device="cpu", dtype=args.dtype)
    Z0 = bu.density_seeds(port, B_SEEDS, 42)[: args.batch]
    seeds_infid = 1.0 - bu.density_fidelity(port, Z0)
    for pkg in ("quantumcollocation_tpu", "port"):
        if pkg == "port":
            prob = port
        else:
            prob = qct.DensityOperatorSmoothPulseProblem(
                qct.OpenQuantumSystem(qct.PAULIS["Z"], [qct.PAULIS["X"], qct.PAULIS["Y"]],
                                      [0.05 * qct.annihilate(2)]),
                np.array([[1, 0], [0, 0]], dtype=complex), bu.DENSITY_GOAL, 30, 0.2,
                ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, kappa_mu=0.2,
                                                line_search="filter", dtype=args.dtype),
                piccolo_options=qct.PiccoloOptions(verbose=False),
                rng=np.random.default_rng(0))
            if not np.allclose(np.asarray(prob.nlp.z0, np.float64), port.nlp.z0, rtol=1e-6,
                               atol=1e-7):
                raise SystemExit("the two packages built different initial decisions")
        res = prob.solver.solve(Z0, max_iter=args.iters)
        Z = res.Z.double().cpu().numpy() if pkg == "port" else np.asarray(res.Z, np.float64)
        infid = 1.0 - bu.density_fidelity(port, Z)
        print(json.dumps({
            "package": pkg, "path": "density", "dtype": args.dtype, "batch": args.batch,
            "iters": args.iters,
            **{f"frac_infid_{b}": float(np.mean(infid <= float(b))) for b in BARS},
            "median_infid": float(np.median(infid)), "max_infid": float(infid.max()),
            "seeds_median_infid": float(np.median(seeds_infid)),
            "finite": bool(np.isfinite(Z).all())}), flush=True)


if __name__ == "__main__":
    main()
