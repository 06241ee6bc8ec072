"""How far the float32 KKT solve's error on a real system moves with rounding.

    python -m quantumcollocation_tpu_torch.kkt_accuracy_probe
        [--config hadamard cnot cnot_exp] [--perturb 8]
        [--other path/to/another/kkt_sweeps.cu]

For each configuration of profile_step.py, the first IPM iteration's KKT
system (H with the accepted δ_w, as chip_smoke.py phases 5, 8 and 13 take
it, with profile_step's seeds), then `--perturb` copies of it whose
float32 blocks are each multiplied elementwise by (1 + u 2^-23), u drawn
from {-1, 0, 1} with numpy's generator seeded by the copy's index: changes
of about one rounding.  For the system and each copy it measures, against
the float64 CPU solve of the same float32 blocks and relative to its
largest entry: the sweep kernels' solve (solve_kkt_lanes, unrefined), the
plain float32 solve, and, with --other, the sweep kernels built from
another kkt_sweeps.cu (an earlier commit's, say) with the same C
interface.  Where the configuration refines its KKT solves (cnot,
cnot_exp), also each kernel build's solve refined once as the solver does
it (solver._refine: the residual re-solved by kernel 4 then kernel 3 on
the kept factors, as resolve_kkt_lanes).  With --other it also reports the
largest difference between the two builds' unrefined outputs (dz, nu and
kernel 2's kept factors): 0 where they agree bit for bit.  Prints one JSON
line per configuration: the unperturbed system's numbers and the min,
median and max over the copies.  The first iteration's systems are
near-singular in float32, so these errors are of order 0.1 and move with
rounding alone; the spread says how far.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from .ops import build as kbuild
from .profile_step import build
from .solver import kkt_lanes as kl
from .solver.kkt import solve_kkt


def _solve_with(lib, H, C, A, B, rz, rnu, delta_c):
    """(dz, nu, kept factors) of kernels 2 and 3 of `lib` on single-column
    blocks."""
    Bn, T, d, _ = H.shape
    s = A.shape[2]
    new = dict(dtype=torch.float32, device=H.device)
    LP, LS = torch.empty(Bn, T - 1, d, d, **new), torch.empty(Bn, T - 1, s, s, **new)
    XA, q = torch.empty(Bn, T - 1, d, s, **new), torch.empty(Bn, T - 1, d, **new)
    G, LPf = torch.empty(Bn, T - 1, s, d, **new), torch.empty(Bn, d, d, **new)
    dz, nu = torch.empty(Bn, T, d, **new), torch.empty(Bn, T - 1, s, **new)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (H, C, A, B, rz, rnu)]
    kbuild.check(lib.qct_kkt_fwd_sweep(*ptrs, Bn, T, d, s, 1, float(delta_c),
                                       *[x.data_ptr() for x in (LP, LS, XA, q, dz, G, LPf)],
                                       stream), "other kkt_fwd_sweep")
    kbuild.check(lib.qct_kkt_bwd_sweep(*[x.data_ptr() for x in (LP, LS, XA, q, C, A, B, rnu)], Bn,
                                       T, d, s, 1, dz.data_ptr(), nu.data_ptr(), stream),
                 "other kkt_bwd_sweep")
    return dz, nu, kl.LanesFactors(LP, LS, XA, G, LPf, C, A, B)


def _resolve_with(lib, fac, rz, rnu):
    """resolve_kkt_lanes through `lib`: kernel 4, then kernel 3."""
    Bn, Tm1, d, _ = fac.L_P.shape
    s = fac.L_S.shape[2]
    new = dict(dtype=torch.float32, device=rz.device)
    q, dz = torch.empty(Bn, Tm1, d, **new), torch.empty(Bn, Tm1 + 1, d, **new)
    nu = torch.empty(Bn, Tm1, s, **new)
    rz, rnu = rz.contiguous(), rnu.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    kbuild.check(lib.qct_kkt_rhs_fwd_sweep(
        *[x.data_ptr() for x in (fac.L_P, fac.L_S, fac.G, fac.C, fac.A, rz, rnu, fac.L_Pf)], Bn,
        Tm1 + 1, d, s, q.data_ptr(), dz.data_ptr(), stream), "other kkt_rhs_fwd_sweep")
    kbuild.check(lib.qct_kkt_bwd_sweep(
        *[x.data_ptr() for x in (fac.L_P, fac.L_S, fac.X_A, q, fac.C, fac.A, fac.B, rnu)], Bn,
        Tm1 + 1, d, s, 1, dz.data_ptr(), nu.data_ptr(), stream), "other kkt_bwd_sweep")
    return dz, nu, torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)


def _rel(out, ref, keep):
    err = (out.cpu().double()[keep] - ref[keep]).abs().max().item()
    return err / max(1.0, ref[keep].abs().max().item())


def first_system(config):
    """The first IPM iteration's float32 KKT blocks (H with the accepted
    δ_w) and the solver."""
    solver, Z0 = build(config, None)
    with torch.no_grad():
        st = solver.init_state(Z0)
        kkt_in, _ = solver._iteration_pre(st)
        dw = solver._solve_kkt_batched(kkt_in, st.delta_w, st, False)[3]
    H, C, A, B, rz, rnu = [x.contiguous() for x in kkt_in]
    H = (H + dw[:, None, None, None] * torch.eye(H.shape[-1], device=H.device)).contiguous()
    return (H, C, A, B, rz, rnu), solver


def errors(blocks, solver, other):
    """Errors of the solves of one system against its float64 CPU solve."""
    delta_c = solver.options.delta_c
    refine = solver.kkt_refine_n > 0
    no_dw = torch.zeros(blocks[0].shape[0], dtype=blocks[0].dtype, device=blocks[0].device)
    with torch.no_grad():
        dz_r, nu_r, ok_r = solve_kkt(*[x.double().cpu() for x in blocks], delta_c)
        dz_k, nu_k, ok_k, fac = kl.solve_kkt_lanes(*blocks, delta_c, want_factors=True)
        dz_p, nu_p, ok_p = solve_kkt(*blocks, delta_c)
        keep = ok_r & ok_k.cpu() & ok_p.cpu()
        solves = {"kernel": (dz_k, nu_k), "plain": (dz_p, nu_p)}
        if refine:
            solves["kernel_refined1"] = solver._refine(
                list(blocks), no_dw, dz_k, nu_k, lambda a, b: kl.resolve_kkt_lanes(fac, a, b))
        if other is not None:
            dz_o, nu_o, fac_o = _solve_with(other, *blocks, delta_c)
            keep &= (torch.isfinite(dz_o).flatten(1).all(1)
                     & torch.isfinite(nu_o).flatten(1).all(1)).cpu()
            solves["other"] = (dz_o, nu_o)
            if refine:
                solves["other_refined1"] = solver._refine(
                    list(blocks), no_dw, dz_o, nu_o, lambda a, b: _resolve_with(other, fac_o, a, b))
        out = {k: max(_rel(dz, dz_r, keep), _rel(nu, nu_r, keep)) for k, (dz, nu) in solves.items()}
        if other is not None:
            pairs = [(dz_k, dz_o), (nu_k, nu_o)] + list(zip(fac[:5], fac_o[:5]))
            out["max_abs_diff_vs_other"] = max(
                (a[keep.to(a.device)] - b[keep.to(b.device)]).abs().max().item() for a, b in pairs)
        out["compared"] = int(keep.sum())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", nargs="+", default=["hadamard", "cnot", "cnot_exp"],
                    choices=("hadamard", "cnot", "ket_exp", "cnot_exp"))
    ap.add_argument("--perturb", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kkt_accuracy_probe needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    other = (kl.set_signatures(kbuild.build_other(args.other, "kkt_sweeps_probe"))
             if args.other else None)
    for config in args.config:
        blocks, solver = first_system(config)
        base = errors(blocks, solver, other)
        runs = []
        for i in range(args.perturb):
            rng = np.random.default_rng(i)
            copy = [x * (1.0 + torch.as_tensor(rng.integers(-1, 2, size=x.shape) * 2.0**-23,
                                               dtype=x.dtype, device=x.device))
                    for x in blocks]
            runs.append(errors(copy, solver, other))
        summary = {k: {"min": min(r[k] for r in runs),
                       "median": statistics.median(r[k] for r in runs),
                       "max": max(r[k] for r in runs)}
                   for k in base if k != "compared"}
        print(json.dumps({"config": config, "device": torch.cuda.get_device_name(0),
                          "perturbed_copies": args.perturb, "unperturbed": base,
                          "perturbed": summary}), flush=True)


if __name__ == "__main__":
    main()
