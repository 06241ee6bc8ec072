"""Why the free-phase rotation R(φ) = exp(K(φ)) uses `expm_taylor`.

    python scripts/free_phase_expm_probe.py [--device cpu|cuda]

Prints one JSON line, float64 on --device:
  - the largest entry error of torch.linalg.matrix_exp and of the port's
    `expm_taylor` (degree 18, 6 squarings) against scipy's expm on 400
    seeded real antisymmetric 4x4 matrices (the iso generators of a
    qubit's phase rotation) with 1-norms from 1e-4 to 60, and the norm
    where each error peaks;
  - whether torch.func's vmap of a Hessian through torch.linalg.solve and
    through `expm_taylor` returns finite values for each of two instances.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import scipy.linalg as sla
import torch
from torch.func import hessian, vmap

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    from quantumcollocation_tpu_torch.dynamics.expm import expm_taylor

    f64 = dict(dtype=torch.float64, device=args.device)
    rng = np.random.default_rng(0)
    worst = {"matrix_exp": (0.0, 0.0), "expm_taylor": (0.0, 0.0)}
    for norm in np.geomspace(1e-4, 60.0, 400):
        K = rng.standard_normal((4, 4))
        K = K - K.T
        K *= norm / np.linalg.norm(K, 1)
        ref = sla.expm(K)
        Kt = torch.as_tensor(K, **f64)
        for name, out in (("matrix_exp", torch.linalg.matrix_exp(Kt)),
                          ("expm_taylor", expm_taylor(Kt))):
            err = float(np.abs(out.cpu().numpy() - ref).max())
            if err > worst[name][0]:
                worst[name] = (err, float(norm))

    K0 = torch.as_tensor(np.kron(np.eye(2), [[0.0, -1.0], [1.0, 0.0]]), **f64)
    eye = torch.eye(4, **f64)
    phases = torch.as_tensor([[0.3], [0.4]], **f64)
    finite = {
        "linalg_solve": vmap(hessian(
            lambda p: torch.linalg.solve(eye + p[0] * K0, eye).sum()))(phases),
        "expm_taylor": vmap(hessian(lambda p: expm_taylor(p[0] * K0).sum()))(phases),
    }
    print(json.dumps({
        "torch": torch.__version__, "device": args.device,
        **{f"{k}_max_err": v[0] for k, v in worst.items()},
        **{f"{k}_max_err_at_norm": v[1] for k, v in worst.items()},
        **{f"vmap_hessian_{k}_finite": [bool(torch.isfinite(x).all()) for x in v]
           for k, v in finite.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
