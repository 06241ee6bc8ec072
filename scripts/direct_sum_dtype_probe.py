"""The direct_sum path in float32 or float64, on one device.

    python scripts/direct_sum_dtype_probe.py [--device cuda|cpu] [--batch 512]
        [--dtypes float32 [float64]]

Builds chip_smoke.py's `direct_sum` path in the port only (bench_util;
no JAX): the two parts, each solved by solve_multistart(8, σ=0.1,
default_rng(0), 30 iterations), the direct sum over them, --batch seeds
from bench_util.direct_sum_seeds(default_rng(42)) and a solve of 100
iterations, once for each of --dtypes (the parts solved again in that
dtype).  The first HEAD = 48 seeds are those of
scripts/direct_sum_gate_jax.py at --batch 48, so the fractions over them
compare with that script's.

Prints one JSON line for each dtype: the parts' fidelities after the
warm solves, the fractions whose two parts both rise from their seeds'
rollout fidelities and reach 0.989 and 0.99 (over the batch and over the
head), the KKT attempts an iteration, the share of instances the solver
counts converged, each part's median fidelity after, and the wall time.
The CUDA kernels take float32 only, so float64 runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BARS = ("0.989", "0.99")
ITERS, HEAD = 100, 48  # chip_smoke.py's DS_ITERS; the gate script's batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dtypes", nargs="+", default=["float32"])
    args = ap.parse_args()

    import quantumcollocation_tpu_torch as qt
    from quantumcollocation_tpu_torch import bench_util as bu

    for dtype in args.dtypes:
        parts = bu.direct_sum_parts(device=args.device, dtype=dtype)
        for p in parts:
            p.solve_multistart(8, sigma=0.1, rng=np.random.default_rng(0), max_iter=30)
        warm = [qt.unitary_rollout_fidelity(p.trajectory, p.system) for p in parts]
        prob = bu.direct_sum_problem(parts)
        solver = prob.solver
        Z0 = bu.direct_sum_seeds(prob, parts, args.batch, 42)
        if args.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(Z0, max_iter=ITERS)
        if args.device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        Z = res.Z.double().cpu().numpy()
        system = parts[0].system
        before = bu.direct_sum_fidelities(prob, Z0, system, device=args.device)
        after = bu.direct_sum_fidelities(prob, Z, system, device=args.device)
        rise = (after > before).all(axis=0)
        fracs = {}
        for b in BARS:
            ok = rise & (after.min(axis=0) >= float(b))
            fracs[f"frac_both_rise_and_fid_{b}"] = float(ok.mean())
            fracs[f"head_frac_both_rise_and_fid_{b}"] = float(ok[:HEAD].mean())
        print(json.dumps({
            "path": "direct_sum", "device": args.device, "dtype": dtype, "batch": args.batch,
            "head": HEAD, "iters": solver.last_steps, "warm_fidelities": warm, **fracs,
            "kkt_attempts_per_iter": solver.kkt_attempts / max(solver.last_steps, 1),
            "ipm_converged_frac": float(res.converged.float().mean()),
            "median_fid_after": [float(x) for x in np.median(after, axis=1)],
            "wall_s": wall, "finite": bool(np.isfinite(Z).all())}), flush=True)


if __name__ == "__main__":
    main()
