"""torch.func's batched curvature through a linear solve, per instance.

    python scripts/vmap_solve_hessian_probe.py [--device cpu|cuda] [--batch 4]

The AD dynamics route (quantumcollocation_tpu_torch/solver/stage_nlp.py)
takes the curvature of λ·F as vmap over instances of vmap over unit vectors
of jvp(grad(λ·F)).  This probe runs that recipe on a density-like defect
term f(x) = λ·(P(X) ρ), X = (D0 + Σ_k a_k D_k) Δt, x = (ρ, a, Δt), with
random 8 x 8 D0, D_k (two drives) and float64 inputs drawn from
default_rng(0), for P = expm_squaring (Padé 8 and 6 squarings: a
torch.linalg.solve) and P = expm_taylor (degree 12 and 6 squarings:
matmuls only).  It prints, per instance, the largest gap between the
batched curvature and torch.func.hessian of that instance alone, and
between the two exponentials' unbatched Hessians, as one JSON line per
exponential, then the device and torch version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quantumcollocation_tpu_torch.dynamics.expm import expm_squaring, expm_taylor  # noqa: E402

N, K = 8, 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    f64 = dict(dtype=torch.float64, device=dev)
    D0 = torch.as_tensor(0.5 * rng.standard_normal((N, N)), **f64)
    Ds = torch.as_tensor(0.5 * rng.standard_normal((K, N, N)), **f64)
    x = torch.as_tensor(np.concatenate([rng.standard_normal((args.batch, N)),
                                        rng.uniform(-1, 1, (args.batch, K)),
                                        rng.uniform(0.1, 0.3, (args.batch, 1))], 1), **f64)
    lam = torch.as_tensor(rng.standard_normal((args.batch, N)), **f64)
    exps = {"expm_squaring": lambda X: expm_squaring(X, order=8, num_squarings=6),
            "expm_taylor": lambda X: expm_taylor(X, 12, 6)}
    plain = {}
    for name, expm in exps.items():
        def f(xx, ll, expm=expm):
            X = (D0 + torch.tensordot(xx[N:N + K], Ds, dims=1)) * xx[-1]
            return (ll * (expm(X) @ xx[:N])).sum()

        g = grad(f)
        E = torch.eye(x.shape[1], **f64)

        def cols(xx, ll, g=g):
            return vmap(lambda e: jvp(lambda y: g(y, ll), (xx,), (e,))[1])(E)

        batched = vmap(cols)(x, lam)
        plain[name] = torch.stack([hessian(f)(x[b], lam[b]) for b in range(args.batch)])
        gaps = (batched - plain[name]).abs().flatten(1).max(1).values
        print(json.dumps({"exp": name, "batch": args.batch,
                          "batched_vs_unbatched_per_instance": [float(v) for v in gaps],
                          "finite": bool(torch.isfinite(batched).all()),
                          "hessian_scale": float(plain[name].abs().max())}), flush=True)
    gap = (plain["expm_taylor"] - plain["expm_squaring"]).abs().flatten(1).max(1).values
    print(json.dumps({"taylor_vs_squaring_unbatched_per_instance": [float(v) for v in gap]}))
    print(json.dumps({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "torch": torch.__version__, "cuda": torch.version.cuda}))


if __name__ == "__main__":
    main()
