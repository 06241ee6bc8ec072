"""The free-phase and bang-bang paths' gates, solved by the JAX package on
the CPU.

    JAX_PLATFORMS=cpu python scripts/free_phase_gate_jax.py
        --path free_phase|free_phase_min_time|bang_bang
        [--dtype float32|float64] [--batch 16]

Builds one of chip_smoke.py's paths in the JAX package and in the port
(bench_util's problem functions; the same numpy draws) and solves the
first --batch rows of its timed seeds (default_rng(42), drawn for B=512)
in --dtype (float32 runs with x64 off, as the JAX package runs on its
chip; the port on the CPU in the same dtype):

  free_phase           an X-only drive to the Y gate up to a global Z
                       phase (JAX tests/test_free_phase_chaining.py: T=31,
                       Δt=0.2 free, tol 1e-6, rng 1234), 60 iterations;
                       seeds with 0.1-σ control noise and π N(0, 1) phases;
  free_phase_min_time  that problem solved at B=1 for 60 iterations, then
                       UnitaryMinimumTimeProblem(phase_operators=[Z],
                       D=50, final_fidelity=0.98), 100 iterations from seeds
                       with 1e-4 control noise;
  bang_bang            UnitaryBangBangProblem (JAX
                       tests/test_problem_templates.py: Z drift, X and Y
                       drives, H, T=51, R_bang_bang 0.5, da_bound 1.0),
                       40 iterations, seeds with 0.1-σ control noise.

Prints one JSON line for each package, every fidelity by the port's
float64 rollout: free_phase the fractions at free-phase infidelity ≤ 1e-4,
1e-3, 1e-2 and the median plain fidelity; free_phase_min_time the
fraction with free-phase fidelity ≥ 0.98 - 1e-4 and a duration below 0.9
of the warm stage's, and the two parts; bang_bang the fractions at
infidelity ≤ 1e-4, 1e-3, 1e-2, 1e-1 and the median count of |da| > 5e-2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ITERS = {"free_phase": 60, "free_phase_min_time": 100, "bang_bang": 40}
WARM_ITERS, B_SEEDS = 60, 512


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=sorted(ITERS), required=True)
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

    def jax_free_phase():
        return qct.UnitarySmoothPulseProblem(
            qct.QuantumSystem([qct.PAULIS["X"]]), qct.GATES["Y"], 31, 0.2,
            phase_operators=[qct.PAULIS["Z"]],
            ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, dtype=args.dtype),
            piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(1234))

    def solve(pkg, prob, Z0):
        res = prob.solver.solve(Z0, max_iter=ITERS[args.path])
        Z = res.Z.double().cpu().numpy() if pkg == "port" else np.asarray(res.Z, np.float64)
        return Z

    def measure(pkg, prob, Z, extra=None):
        line = {"package": pkg, "path": args.path, "dtype": args.dtype, "batch": args.batch,
                "iters": ITERS[args.path]}
        if args.path == "bang_bang":
            traj = prob.trajectory
            sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
            infid = 1.0 - qt.batched_rollout_fidelity(
                Z[:, :, traj.comp_slice("a")], Z[:, :, traj.comp_slice("Δt")][:, :, 0], sysq,
                np.asarray(traj.goal["Ũ⃗"]), np.asarray(traj.initial["Ũ⃗"]))
            line.update({f"frac_infid_{t}": float(np.mean(infid <= float(t)))
                         for t in ("1e-4", "1e-3", "1e-2", "1e-1")})
            line["median_infid"] = float(np.median(infid))
            line["median_da_count"] = float(np.median(bu.da_count(Z, traj.comp_slice("da"))))
        else:
            fid, plain = bu.free_phase_fidelity(prob, Z, qt.QuantumSystem([qt.PAULIS["X"]]))
            if args.path == "free_phase":
                line.update({f"frac_infid_{t}": float(np.mean(1.0 - fid <= float(t)))
                             for t in ("1e-4", "1e-3", "1e-2")})
                line["median_infid"] = float(np.median(1.0 - fid))
                line["median_plain_fid"] = float(np.median(plain))
            else:
                dur0 = extra
                dur = Z[:, :-1, prob.trajectory.comp_slice("Δt")][:, :, 0].sum(1)
                fid_ok, short = fid >= 0.98 - 1e-4, dur < 0.9 * dur0
                line.update(success_frac=float(np.mean(fid_ok & short)),
                            frac_fid=float(np.mean(fid_ok)), frac_shorter=float(np.mean(short)),
                            duration_before=dur0, median_duration=float(np.median(dur)),
                            median_fid=float(np.median(fid)))
        print(json.dumps(line), flush=True)

    for pkg in ("quantumcollocation_tpu", "port"):
        extra = None
        if args.path == "bang_bang":
            prob = (bu.bang_bang_problem(device="cpu", dtype=args.dtype) if pkg == "port" else
                    qct.UnitaryBangBangProblem(
                        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]),
                        qct.GATES["H"], 51, 0.2, R_bang_bang=0.5, da_bound=1.0,
                        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6,
                                                        dtype=args.dtype),
                        piccolo_options=qct.PiccoloOptions(verbose=False),
                        rng=np.random.default_rng(1234)))
            Z0 = bu.hadamard_seeds(prob, B_SEEDS, 42)
        else:
            prob = (bu.free_phase_problem(device="cpu", dtype=args.dtype) if pkg == "port"
                    else jax_free_phase())
            if args.path == "free_phase":
                Z0 = bu.free_phase_seeds(prob, B_SEEDS, 42)
            else:
                prob.solve(max_iter=WARM_ITERS)
                if pkg == "port":
                    prob, extra = bu.free_phase_min_time_problem(prob)
                else:
                    extra = float(prob.trajectory.duration())
                    prob = qct.UnitaryMinimumTimeProblem(prob, phase_operators=[qct.PAULIS["Z"]],
                                                         D=50.0, final_fidelity=0.98)
                Z0 = bu.min_time_seeds(prob, B_SEEDS, 42)
        Z = solve(pkg, prob, Z0[: args.batch])
        measure(pkg, prob, Z, extra)


if __name__ == "__main__":
    main()
