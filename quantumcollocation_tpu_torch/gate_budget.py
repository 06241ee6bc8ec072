"""The sampling and robustness paths' gate fractions against the iteration
count.

    python -m quantumcollocation_tpu_torch.gate_budget --path sampling|robustness
        [--batch B] [--checkpoints 48,100,150] [--device cuda|cpu]
        [--dtype float32|float64] [--no-lift]

Builds chip_smoke.py's problem of the path (bench_util.sampling_problem or
robustness_problem) and its timed seeds (sampling_seeds(·, B, 42),
robustness_seeds(·, B, 5)), steps the solver and prints one JSON line at
each checkpoint: the fraction that passes the path's gate by a float64
rollout (sampling: infidelity ≤ 1e-3 on all three sampled systems;
robustness: the Magnus cost below half the seed's at fidelity ≥ 0.989),
with its parts and the median KKT error.  On the card (the default) this
is how the paths' iteration counts were chosen; on the CPU, with
--dtype, it rehearses them at a small batch.  --no-lift solves the
robustness path without the ρJᵀJ lift (SolverOptions(kkt_aug=False)).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import PAULIS, batched_rollout_fidelity
from . import bench_util as bu


def _sampling(device, dtype, batch):
    prob = bu.sampling_problem(device=device, dtype=dtype)
    Z0 = bu.sampling_seeds(prob, batch, 42)
    tr = prob.trajectory

    def gate(Z):
        a, dts = Z[:, :, tr.comp_slice("a")], Z[:, :, tr.comp_slice("Δt")][:, :, 0]
        names = [f"Ũ⃗_system_{i + 1}" for i in range(len(bu.ZETAS))]
        worst = np.max([
            1.0 - batched_rollout_fidelity(a, dts, bu.zeta_system(z), tr.goal[n], tr.initial[n],
                                           device=device)
            for n, z in zip(names, bu.ZETAS)], axis=0)
        return {"frac": float(np.mean(worst <= 1e-3)),
                "median_worst_infid": float(np.median(worst))}

    return prob, Z0, gate


def _robustness(device, dtype, batch, options):
    prob, warm = bu.robustness_problem(device=device, dtype=dtype, **options)
    Z0 = bu.robustness_seeds(prob, batch, 5)
    tr = prob.trajectory
    a, dt = tr.comp_slice("a"), tr.comp_slice("Δt")

    def magnus(Z):
        return bu.magnus_cost(Z[:, :, a], Z[:, :, dt][:, :, 0], warm.system, PAULIS["Z"],
                              tr.initial["Ũ⃗"], device=device)

    m0 = magnus(Z0)

    def gate(Z):
        ratio = magnus(Z) / m0
        fid = batched_rollout_fidelity(Z[:, :, a], Z[:, :, dt][:, :, 0], warm.system,
                                       tr.goal["Ũ⃗"], tr.initial["Ũ⃗"], device=device)
        return {"frac": float(np.mean((ratio < 0.5) & (fid >= 0.989))),
                "frac_ratio_below_half": float(np.mean(ratio < 0.5)),
                "frac_fid_0.989": float(np.mean(fid >= 0.989)),
                "ratio_quantiles": [float(x) for x in np.quantile(ratio, [0, 0.1, 0.5, 0.9, 1])]}

    return prob, Z0, gate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("sampling", "robustness"), required=True)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--checkpoints", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--no-lift", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gate_budget on the card needs a CUDA GPU; pass --device cpu to rehearse")
    options = {"kkt_aug": False} if args.no_lift else {}
    if args.path == "sampling":
        batch = args.batch or 512
        prob, Z0, gate = _sampling(args.device, args.dtype, batch)
        checkpoints = args.checkpoints or "48,100,150"
    else:
        batch = args.batch or 256
        prob, Z0, gate = _robustness(args.device, args.dtype, batch, options)
        checkpoints = args.checkpoints or "40,60,80,100,120,140,160"
    checkpoints = sorted(int(c) for c in checkpoints.split(","))
    solver = prob.solver
    device_name = (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else f"cpu ({torch.get_num_threads()} threads)")
    st = solver.init_state(Z0)
    t0 = time.perf_counter()
    for k in range(1, checkpoints[-1] + 1):
        st = solver.step(st)
        if k in checkpoints:
            Z = (st.Z * solver._v).double().cpu().numpy()
            print(json.dumps({
                "path": args.path, "device": device_name, "dtype": str(solver.dtype),
                "batch": batch, "iters": k, **gate(Z),
                "kkt_err_median": float(st.kkt_err.median()), "options": options,
                "wall_s": time.perf_counter() - t0,
            }), flush=True)


if __name__ == "__main__":
    main()
