"""The first lifted KKT system of the min_time and robustness paths in
float32: the port's CUDA kernels against the JAX package's float32 kernels
on the same blocks.

On the card (the port only; no JAX there):

    python scripts/lift_float32_probe.py --dump min_time|robustness OUT.npz [--batch 48]

builds the path's problem as chip_smoke.py does (bench_util), takes the
first iteration's KKT blocks of `--batch` seeded instances with the
accepted δ_w and the lift's ρ, lifts them (H + δ_w I + ρS_AA, C + ρS_AB,
rz + ρJᵀrnu), solves them through kernels 2 and 3 and refines once through
kernels 4 and 3, and saves the float32 blocks with the kernel path's
steps.  Then on the CPU, with JAX:

    JAX_PLATFORMS=cpu python scripts/lift_float32_probe.py --compare OUT.npz

solves the same float32 lifted blocks with the JAX package's lanes
kernel (Pallas, interpret mode) and its XLA Riccati solve, refines each
once as its solver does (the residual of the regularized, unlifted system
against the kept factors), and prints, for each of the three, how many
instances its factorization solved and the per-instance errors
(median, 90th percentile, largest) against the float64 solve of the
unlifted system, unrefined and refined, over all its solved instances
and over those all three solved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quantumcollocation_tpu_torch.solver.kkt import solve_kkt  # noqa: E402
from quantumcollocation_tpu_torch.solver.stage_nlp import jt_blocks  # noqa: E402


def dump(path, out, batch):
    from quantumcollocation_tpu_torch import bench_util as bu
    from quantumcollocation_tpu_torch.solver import kkt_lanes as kl

    if path == "robustness":
        prob, _ = bu.robustness_problem()
        Z0 = bu.robustness_seeds(prob, batch, 7)
    else:
        warm = bu.min_time_warm()
        warm.solve(max_iter=80)
        prob, _ = bu.min_time_problem(warm)
        Z0 = bu.min_time_seeds(prob, batch, 7)
    s = prob.solver
    with torch.no_grad():
        st = s.init_state(Z0)
        kkt, aux = s._iteration_pre(st)
        dw = s._solve_kkt_batched(kkt, st.delta_w, st, False, None, aux.rho0)[3]
        kkt = [x.contiguous() for x in kkt]
        lifted = [x.contiguous() for x in s._lifted(kkt, dw, aux.rho0,
                                                    s._lift_S(kkt[2], kkt[3]))]
        dz0, nu0, ok0, fac = kl.solve_kkt_lanes(*lifted, s.options.delta_c, want_factors=True)
        dz1, nu1 = s._refine(kkt, dw, dz0, nu0, lambda a, b: kl.resolve_kkt_lanes(fac, a, b),
                             rho=aux.rho0, n_pass=1)
    arr = {k: v.cpu().numpy() for k, v in zip(("H", "C", "A", "B", "rz", "rnu"), kkt)}
    arr.update({k + "_l": v.cpu().numpy() for k, v in zip(("H", "C", "rz"),
                                                         (lifted[0], lifted[1], lifted[4]))})
    arr.update(dw=dw.cpu().numpy(), rho=aux.rho0.cpu().numpy(), dz0=dz0.cpu().numpy(),
               nu0=nu0.cpu().numpy(), dz1=dz1.cpu().numpy(), nu1=nu1.cpu().numpy(),
               delta_c=s.options.delta_c, device=torch.cuda.get_device_name(0), path=path)
    np.savez_compressed(out, **arr)
    print(json.dumps({"dump": path, "out": out, "batch": batch,
                      "kernel_solved": int(ok0.sum())}))


def compare(src):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from quantumcollocation_tpu.solver.kkt import factor_kkt, solve_with_factors
    from quantumcollocation_tpu.solver.kkt_lanes import resolve_kkt_lanes, solve_kkt_lanes

    z = np.load(src)
    dc = float(z["delta_c"])
    H, C, A, B, rz, rnu = [torch.as_tensor(z[k]) for k in ("H", "C", "A", "B", "rz", "rnu")]
    dw, rho = torch.as_tensor(z["dw"]), torch.as_tensor(z["rho"])
    Hreg = H + dw[:, None, None, None] * torch.eye(H.shape[-1])
    ref_dz, ref_nu, _ = solve_kkt(*[x.double() for x in (Hreg, C, A, B, rz, rnu)], dc)
    lifted = [jnp.asarray(x) for x in (z["H_l"], z["C_l"], z["A"], z["B"], z["rz_l"], z["rnu"])]

    def refine(dz, nu, resolve):
        """One pass of the solver's refinement (solver/ipm.py::_refine)."""
        Hdz = torch.einsum("btij,btj->bti", H, dz) + dw[:, None, None] * dz
        Hdz[:, :-1] += torch.einsum("btij,btj->bti", C, dz[:, 1:])
        Hdz[:, 1:] += torch.einsum("btji,btj->bti", C, dz[:, :-1])
        r1 = Hdz + jt_blocks(A, B, nu) - rz
        r2 = (torch.einsum("btsd,btd->bts", A, dz[:, :-1])
              + torch.einsum("btsd,btd->bts", B, dz[:, 1:]) - dc * nu - rnu)
        ez, enu, ok = resolve(-r1 - rho[:, None, None] * jt_blocks(A, B, r2), -r2)
        keep = torch.as_tensor(np.asarray(ok), dtype=torch.bool)[:, None, None]
        return dz + torch.where(keep, ez, 0.0 * ez), nu + torch.where(keep, enu, 0.0 * enu)

    def err(dz, nu):
        e = [(x.double() - r).abs().flatten(1).max(1).values
             / r.abs().flatten(1).max(1).values.clamp_min(1.0)
             for x, r in ((dz, ref_dz), (nu, ref_nu))]
        return torch.maximum(*e).numpy()

    def torch_of(*xs):
        return [torch.as_tensor(np.asarray(x)) for x in xs]

    rows = {"port_kernels": (err(torch.as_tensor(z["dz0"]), torch.as_tensor(z["nu0"])),
                             err(torch.as_tensor(z["dz1"]), torch.as_tensor(z["nu1"])))}
    dz, nu, _, lf = solve_kkt_lanes(*lifted, dc, interpret=True, want_factors=True,
                                    vec_min_dim=1)

    def lanes_resolve(a, b):
        return torch_of(*resolve_kkt_lanes(lf, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                           interpret=True, vec_min_dim=1))

    dz, nu = torch_of(dz, nu)
    rows["jax_lanes"] = (err(dz, nu), err(*refine(dz, nu, lanes_resolve)))
    fac = jax.jit(jax.vmap(lambda h, c, a, b: factor_kkt(h, c, a, b, jnp.float32(dc))))(
        *lifted[:4])
    solve = jax.jit(jax.vmap(solve_with_factors))

    def xla_resolve(a, b):
        return torch_of(*solve(fac, jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))

    dz, nu = torch_of(*solve(fac, lifted[4], lifted[5])[:2])
    rows["jax_xla"] = (err(dz, nu), err(*refine(dz, nu, xla_resolve)))
    common = np.all([np.isfinite(r[0]) & np.isfinite(r[1]) for r in rows.values()], axis=0)

    def stats(v):
        return {"median": float(np.median(v)), "q90": float(np.quantile(v, 0.9)),
                "max": float(v.max())}

    out = {"path": str(z["path"]), "dumped_on": str(z["device"]), "instances": len(common),
           "rho0_median": float(rho.median()), "dw_median": float(dw.median()),
           "solved_by_all": int(common.sum())}
    for name, (e0, e1) in rows.items():
        ok = np.isfinite(e0) & np.isfinite(e1)
        out[name] = {"solved": int(ok.sum()), "unrefined": stats(e0[ok]),
                     "refined": stats(e1[ok]), "unrefined_common": stats(e0[common]),
                     "refined_common": stats(e1[common])}
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", nargs=2, metavar=("PATH", "OUT"))
    ap.add_argument("--compare", metavar="NPZ")
    ap.add_argument("--batch", type=int, default=48)
    args = ap.parse_args()
    if args.dump:
        if not torch.cuda.is_available():
            raise SystemExit("--dump needs the card: it runs the CUDA kernels")
        dump(args.dump[0], args.dump[1], args.batch)
    elif args.compare:
        compare(args.compare)
    else:
        ap.error("give --dump PATH OUT or --compare NPZ")


if __name__ == "__main__":
    main()
