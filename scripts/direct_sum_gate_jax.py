"""The direct_sum path's gate, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/direct_sum_gate_jax.py
        [--iters 100] [--warm-iters 30] [--dtype float32|float64] [--batch 16]

Builds chip_smoke.py's `direct_sum` path in the JAX package and in the
port (bench_util; the same numpy draws): the JAX package's direct-sum
test's subproblems (hadamard's system, the H gate from default_rng(0) and
the X gate from default_rng(1), T=31, Δt=0.2 free, Q=100, R=1e-2, tol
1e-6), each solved by solve_multistart(8, σ=0.1, default_rng(0),
--warm-iters iterations), then UnitaryDirectSumProblem(final_fidelity
0.99, drive_reset_ratio 0.25, rng default_rng(2)), and solves --batch
resets of its seeds (bench_util.direct_sum_seeds, default_rng(42), each
package on its own solved parts) for --iters iterations in --dtype
(float32 runs with x64 off, as the JAX package runs on its chip; the port
on the CPU in the same dtype).

Prints one JSON line for each package: the parts' fidelities after the
warm solves, and over the batch the fraction whose two parts both rise
from their seeds' rollout fidelities, the fractions at which both reach
fidelity 0.9, 0.95, 0.989, 0.99, 0.999 (each also rising), and each part's
median fidelity before and after, all by the port's float64 rollout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BARS = ("0.9", "0.95", "0.989", "0.99", "0.999")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--warm-iters", type=int, default=30)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import torch

    import quantumcollocation_tpu as qct
    import quantumcollocation_tpu_torch as qt
    from quantumcollocation_tpu_torch import bench_util as bu

    torch.set_num_threads(4)
    system = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    for pkg in ("quantumcollocation_tpu", "port"):
        ports = bu.direct_sum_parts(device="cpu", dtype=args.dtype)
        if pkg == "port":
            parts = ports
        else:
            parts = [qct.UnitarySmoothPulseProblem(
                qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]),
                qct.GATES[gate], 31, 0.2,
                ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, dtype=args.dtype),
                piccolo_options=qct.PiccoloOptions(verbose=False),
                rng=np.random.default_rng(seed)) for gate, seed in (("H", 0), ("X", 1))]
        for p, pp in zip(parts, ports):
            if not np.allclose(np.asarray(p.nlp.z0, np.float64), pp.nlp.z0, rtol=1e-6,
                               atol=1e-7):
                raise SystemExit("the two packages built different initial decisions")
            p.solve_multistart(8, sigma=0.1, rng=np.random.default_rng(0),
                               max_iter=args.warm_iters)
            if pkg != "port":
                # the JAX solution on the port's part: the seeds' layout
                pp.trajectory = pp.trajectory.with_data(np.asarray(p.trajectory.data,
                                                                   np.float64))
        warm_fid = [qt.unitary_rollout_fidelity(pp.trajectory, system) for pp in ports]
        ds_port = bu.direct_sum_problem(ports)
        Z0 = bu.direct_sum_seeds(ds_port, ports, args.batch, 42)
        if pkg == "port":
            res = ds_port.solver.solve(Z0, max_iter=args.iters)
            Z = res.Z.double().cpu().numpy()
        else:
            ds = qct.UnitaryDirectSumProblem(
                parts, bu.DS_FINAL_FIDELITY, drive_reset_ratio=bu.DS_RESET_RATIO,
                drive_derivative_sigma=bu.DS_RESET_SIGMA,
                rng=np.random.default_rng(bu.DS_RESET_SEED))
            if not np.allclose(np.asarray(ds.nlp.z0, np.float64), ds_port.nlp.z0, rtol=1e-5,
                               atol=1e-6):
                raise SystemExit("the two packages built different direct sums")
            Z = np.asarray(ds.solver.solve(Z0, max_iter=args.iters).Z, np.float64)
        before = bu.direct_sum_fidelities(ds_port, Z0, system)
        after = bu.direct_sum_fidelities(ds_port, Z, system)
        rise = (after > before).all(axis=0)
        print(json.dumps({
            "package": pkg, "path": "direct_sum", "dtype": args.dtype, "batch": args.batch,
            "iters": args.iters, "warm_iters": args.warm_iters, "warm_fidelities": warm_fid,
            "frac_both_rise": float(np.mean(rise)),
            **{f"frac_both_rise_and_fid_{b}": float(np.mean(rise & (after.min(0) >= float(b))))
               for b in BARS},
            "median_fid_before": [float(x) for x in np.median(before, axis=1)],
            "median_fid_after": [float(x) for x in np.median(after, axis=1)],
            "finite": bool(np.isfinite(Z).all())}), flush=True)


if __name__ == "__main__":
    main()
