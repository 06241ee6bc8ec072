"""The cz path's gate, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/cz_gate_jax.py
        [--checkpoints 20,40,60] [--dtype float32|float64] [--batch 16]
        [--packages quantumcollocation_tpu,port]

Builds chip_smoke.py's `cz` path (BASELINE #5's canonical configuration,
JAX tests/test_baseline_configs.py:54-80 at the upstream T=75: two
three-level transmons, CZ embedded on their qubit subspace, Δt=1.0 free,
a_bound 0.1, Q=100, R=1e-2, Padé-4, tol 1e-6, rng default_rng(5)) in each
package (the port's from bench_util.cz_problem; the same numpy draws), and
steps the first --batch rows of the timed seeds (bench_util.cz_seeds:
multistart_initial_decisions at σ = 0.02 from default_rng(42), drawn for
B=256) in --dtype (float32 runs with x64 off, as the JAX package runs on
its chip; the port on the CPU in the same dtype), reading the solution at
each checkpoint iteration.

Prints one JSON line for each package and checkpoint: the fractions of
instances whose float64 subspace rollout (the port's) reaches infidelity
1e-4, 1e-3 and 1e-2, the median infidelity, the fraction whose fidelity
rose from its seed's, instance 0's fidelity (the template's own controls,
the instance JAX's tests/test_baseline_configs.py solves) and whether it
rose, and the seeds' median.  The gate is the tightest of those levels
that >= 0.9 of the JAX package's instances reach at the path's iteration
count; without one (as at 40 iterations), chip_smoke.py holds the port
to JAX's numbers: the median of the first --batch instances no lower than
JAX's less 1e-3, the fraction rising no lower than JAX's less two of its
standard errors, and instance 0 no lower than JAX's less 1e-3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B_SEEDS = 256
BARS = ("1e-4", "1e-3", "1e-2")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoints", default="20,40,60")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--packages", default="quantumcollocation_tpu,port")
    args = ap.parse_args()
    checkpoints = sorted(int(c) for c in args.checkpoints.split(","))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import torch

    import quantumcollocation_tpu as qct
    from quantumcollocation_tpu_torch import bench_util as bu

    torch.set_num_threads(4)
    port, goal = bu.cz_problem(device="cpu", dtype=args.dtype)
    seeds = bu.cz_seeds(port, B_SEEDS, 42)[: args.batch]
    fid0 = bu.cz_fidelities(port, goal, seeds)

    def jax_problem():
        sysq = qct.MultiTransmonSystem(omegas=[4.0, 4.5], deltas=[0.2, 0.2],
                                       gs=[[0.0, 0.01], [0.01, 0.0]], levels_per_transmon=3)
        return qct.UnitarySmoothPulseProblem(
            sysq, qct.EmbeddedOperator(qct.GATES["CZ"], sysq), 75, 1.0, a_bound=0.1,
            ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, dtype=args.dtype),
            piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(5))

    for pkg in args.packages.split(","):
        prob = port if pkg == "port" else jax_problem()
        if not np.allclose(np.asarray(prob.nlp.z0, np.float64), port.nlp.z0, rtol=1e-6,
                           atol=1e-7):
            raise SystemExit("the two packages built different initial decisions")
        t0 = time.perf_counter()
        if pkg == "port":
            st = prob.solver.init_state(torch.as_tensor(seeds, dtype=prob.dtype))
        else:
            st = prob.solver._init_state_jit(seeds.astype(args.dtype))
        for k in range(1, checkpoints[-1] + 1):
            st = prob.solver.step(st)
            if k not in checkpoints:
                continue
            Z = np.asarray(st.Z.cpu() if pkg == "port" else st.Z, np.float64) * np.asarray(
                prob.solver.var_scale, np.float64)
            infid = 1.0 - bu.cz_fidelities(port, goal, Z)
            print(json.dumps({
                "package": pkg, "path": "cz", "dtype": args.dtype, "batch": args.batch,
                "iters": k, "wall_s": time.perf_counter() - t0,
                **{f"frac_subspace_infid_{b}": float(np.mean(infid <= float(b))) for b in BARS},
                "median_subspace_infid": float(np.median(infid)),
                "median_fid": float(np.median(1.0 - infid)),
                "frac_rise": float(np.mean(1.0 - infid > fid0)),
                "fid_instance_0": float(1.0 - infid[0]),
                "rise_instance_0": bool(1.0 - infid[0] > fid0[0]),
                "median_fid_seeds": float(np.median(fid0)),
                "finite": bool(np.isfinite(Z).all())}), flush=True)


if __name__ == "__main__":
    main()
