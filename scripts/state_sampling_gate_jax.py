"""The state_sampling path's gate, solved by the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/state_sampling_gate_jax.py
        [--iters 100] [--dtype float32|float64] [--batch 16]

Builds chip_smoke.py's `state_sampling` path (QuantumStateSamplingProblem
over the drift samples ζ Z, ζ ∈ {-0.05, 0, 0.05}, drives X and Y,
|0⟩ → |1⟩, T=50, Δt=0.2 free, Q=100, R=1e-2, tol 1e-6, κ_μ 0.2, filter line
search, rng default_rng(0)) and its plain counterpart
(QuantumStateSmoothPulseProblem at ζ = 0, the same settings) in the JAX
package and in the port (bench_util; the same numpy draws), and solves the
first --batch rows of the timed seeds (multistart_initial_decisions at
σ = 0.1 from default_rng(42), drawn for B=512) for --iters iterations in
--dtype (float32 runs with x64 off, as the JAX package runs on its chip;
the port on the CPU in the same dtype).

Prints one JSON line for each package: the fractions of instances whose
float64 ket rollout (the port's) reaches infidelity 1e-4, 1e-3, 1e-2 on
all three systems, the median of each system's infidelity, and the median
fidelities summed over ζ ∈ -0.05:0.01:0.05 of the sampled and the plain
solves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B_SEEDS = 512
BARS = ("1e-4", "1e-3", "1e-2")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
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
    port = {"sampled": bu.state_sampling_problem(device="cpu", dtype=args.dtype),
            "plain": bu.state_sampling_plain_problem(device="cpu", dtype=args.dtype)}
    seeds = {k: bu.multistart_seeds(p, B_SEEDS, 42)[: args.batch] for k, p in port.items()}
    a_sl = port["sampled"].trajectory.comp_slice("a")
    if not np.array_equal(seeds["sampled"][:, :, a_sl],
                          seeds["plain"][:, :, port["plain"].trajectory.comp_slice("a")]):
        raise SystemExit("the plain seeds' controls differ from the sampled seeds'")

    def jax_problems():
        opts = qct.SolverOptions(print_level=1, tol=1e-6, kappa_mu=0.2, line_search="filter",
                                 dtype=args.dtype)
        quiet = qct.PiccoloOptions(verbose=False)
        systems = [qct.QuantumSystem(z * qct.PAULIS["Z"], [qct.PAULIS["X"], qct.PAULIS["Y"]])
                   for z in bu.ZETAS]
        return {
            "sampled": qct.QuantumStateSamplingProblem(
                systems, bu.KET_INIT, bu.KET_GOAL, 50, 0.2, Q=100.0, R=1e-2,
                ipopt_options=opts, piccolo_options=quiet, rng=np.random.default_rng(0)),
            "plain": qct.QuantumStateSmoothPulseProblem(
                systems[1], bu.KET_INIT, bu.KET_GOAL, 50, 0.2, Q=100.0, R=1e-2,
                ipopt_options=opts, piccolo_options=quiet, rng=np.random.default_rng(0)),
        }

    for pkg in ("quantumcollocation_tpu", "port"):
        probs = port if pkg == "port" else jax_problems()
        out = {}
        for key, prob in probs.items():
            if not np.allclose(np.asarray(prob.nlp.z0, np.float64), port[key].nlp.z0,
                               rtol=1e-6, atol=1e-7):
                raise SystemExit("the two packages built different initial decisions")
            res = prob.solver.solve(seeds[key], max_iter=args.iters)
            out[key] = (res.Z.double().cpu().numpy() if pkg == "port"
                        else np.asarray(res.Z, np.float64))
        sp = port["sampled"].trajectory
        infid = 1.0 - bu.ket_fidelities(port["sampled"], out["sampled"])
        worst = infid.max(axis=0)
        pt = port["plain"].trajectory
        sweep = {k: bu.ket_zeta_sweep_fidelity(
            out[k][:, :, tr.comp_slice("a")], out[k][:, :, tr.comp_slice("Δt")][:, :, 0])
            for k, tr in (("sampled", sp), ("plain", pt))}
        print(json.dumps({
            "package": pkg, "path": "state_sampling", "dtype": args.dtype,
            "batch": args.batch, "iters": args.iters,
            **{f"frac_all_systems_infid_{b}": float(np.mean(worst <= float(b))) for b in BARS},
            "median_infid_per_system": [float(x) for x in np.median(infid, axis=1)],
            "zeta_sweep_fid_median": float(np.median(sweep["sampled"])),
            "plain_zeta_sweep_fid_median": float(np.median(sweep["plain"])),
            "finite": bool(all(np.isfinite(z).all() for z in out.values()))}), flush=True)


if __name__ == "__main__":
    main()
