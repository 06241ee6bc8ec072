"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. environment: torch/CUDA versions and the card (the nvidia-smi name and
     power-limit line is printed on its own line); TF32 off;
  2. build: every CUDA kernel of the port, compiled from csrc/ in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the inputs of the first IPM iteration of the phase-4 problem, with
     times (CUDA events, median of 20 after warm-up) and bounds;
  4. main path: the batched Hadamard smooth-pulse solve (B=512, T=51,
     Q=1e4, R=1e-3, 48 iterations, filter line search, kappa_mu 0.2,
     tol 1e-5, float32) through UnitarySmoothPulseProblem; one discarded
     warm-up solve, then a timed one with the kernels' launch counts;
     checked by a float64 rollout (converged_frac at infidelity <= 1e-4);
  5. reference: the kernel path's KKT step on the first iteration's real
     system against the float64 CPU solve, beside the plain float32 path;
then the kernels line, and last {"ok": true, "device": {...}}.  Any failed
check exits nonzero before the last line.  Without CUDA it exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, T, ITERS = 512, 51, 48
# float32 tolerances, relative to the largest entry of the plain output:
# the kernel and its plain version round in different orders (a Horner
# chain per thread vs batched matmuls; scalar Cholesky loops vs batched
# LAPACK-style factorizations), and the sweeps' error grows with the
# conditioning of the regularized KKT blocks
TOL = {"dyn_assembly": 1e-4, "kkt_fwd_sweep": 1e-4, "kkt_bwd_sweep": 1e-4}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card_rates(name):
    """(bytes/s, float32 FLOP/s outside the tensor cores): NVIDIA's data
    sheets for the H100 variants, dense."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def rel_err(out, ref, keep=None):
    """(max abs error, relative to max(1, max |ref|)) over the instances
    (leading axis) in keep."""
    if keep is not None:
        out, ref = out[keep], ref[keep]
    err = (out.double() - ref.double()).abs().max().item()
    scale = max(1.0, ref.double().abs().max().item())
    return err, err / scale


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import quantumcollocation_tpu_torch as q
    from quantumcollocation_tpu_torch.ops import build
    from quantumcollocation_tpu_torch.ops.dyn_assembly import (
        dyn_assembly_cuda,
        dyn_assembly_reference,
    )
    from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
    from quantumcollocation_tpu_torch.solver.kkt import solve_kkt

    # ---- 1. environment ---------------------------------------------- #
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "tf32": False})
    bw, f32_peak = card_rates(kind)

    # ---- 2. build ------------------------------------------------------ #
    build_s = build.build_all()
    emit({"phase": "build", "sources": sorted(build.SOURCES.values()), "build_s": build_s})

    # ---- the main-path problem ------------------------------------------ #
    sysq = q.QuantumSystem(q.GATES["Z"], [q.GATES["X"], q.GATES["Y"]])
    prob = q.UnitarySmoothPulseProblem(
        sysq, q.GATES["H"], T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=q.SolverOptions(
            print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter"
        ),
        piccolo_options=q.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    solver = prob.solver
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    dt_sl = prob.trajectory.comp_slice("Δt")

    def seeds(seed):
        rng = np.random.default_rng(seed)
        Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
        Z0[:, 1:-1, a_sl] += 0.1 * rng.standard_normal((B, T - 2, a_sl.stop - a_sl.start))
        return Z0

    # ---- 3. kernels on the first iteration's inputs --------------------- #
    with torch.no_grad():
        st = solver.init_state(seeds(7))
        kkt_in, _ = solver._iteration_pre(st)
        out = solver._solve_kkt_batched(kkt_in, st.delta_w, st, False)
        dw = out[3]
        H, C, A, Bj, rz, rnu = [x.contiguous() for x in kkt_in]
        H = (H + dw[:, None, None, None] * torch.eye(H.shape[-1], device=H.device)).contiguous()
        analytic = solver.nlp.analytic
        Z, lam = st.Z.contiguous(), st.lam.contiguous()
        d, s = Z.shape[-1], lam.shape[-1]
        delta_c = solver.options.delta_c
        results = {}
        f4 = 4

        # kernel 1: fused assembly
        k_out = dyn_assembly_cuda(analytic, Z, lam)
        r_out = dyn_assembly_reference(analytic, Z, lam)
        errs = [rel_err(a, b) for a, b in zip(k_out, r_out)]
        n_pairs = B * (T - 1)
        n, K = 4, 3
        KP = K * (K + 1) // 2
        mm = 2 * n**3
        horner = 2 * 2 * (3 * KP + 2 + 2 * K + 1) * mm  # two signs, two steps (order 4)
        member = (2 * (1 + K) * n * n * 2 + 2 * KP * n * n + 4 * K * n * n * 2)
        flops = n_pairs * (horner + member)
        nbytes = f4 * (Z.numel() + lam.numel() + sum(x.numel() for x in k_out))
        results["dyn_assembly"] = dict(
            source="quantumcollocation_tpu_torch/csrc/dyn_assembly.cu",
            replaces="quantumcollocation_tpu/ops/pallas_dyn_assembly.py:188",
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: dyn_assembly_cuda(analytic, Z, lam)),
            plain_ms=time_ms(lambda: dyn_assembly_reference(analytic, Z, lam)),
            bytes=nbytes, flops=flops,
        )

        # kernels 2 and 3 are held against their plain versions on seeded
        # blocks of the main path's shapes, shaped like dynamics defects
        # (A ≈ -I, B ≈ I) so that float32 resolves them (their float32 error
        # against float64 is ~3e-6 relative); the first iteration's real
        # blocks are near-singular in float32, where both versions carry
        # rounding error of order one, and phase 5 checks those against
        # float64.  The times are taken on the real blocks.
        rng = np.random.default_rng(0)
        Hs = np.eye(d) * 3 + 0.3 * rng.normal(size=(B, T, d, d))
        E = np.eye(s, d)
        seeded = [0.5 * (Hs + np.swapaxes(Hs, -1, -2)),
                  0.2 * rng.normal(size=(B, T - 1, d, d)),
                  -E + 0.1 * rng.normal(size=(B, T - 1, s, d)),
                  E + 0.1 * rng.normal(size=(B, T - 1, s, d)),
                  rng.normal(size=(B, T, d)), rng.normal(size=(B, T - 1, s))]
        seeded = [torch.as_tensor(x, dtype=torch.float32, device=Z.device) for x in seeded]
        k_f = list(kl.fwd_sweep_cuda(*seeded, delta_c))
        k_f[4] = k_f[4][:, -1]
        ref_f = kl.fwd_sweep_reference(*seeded, delta_c)
        errs = [rel_err(a, b) for a, b in zip(k_f, ref_f[:5])]
        real = (H, C, A, Bj, rz, rnu)
        per_knot = (d**3 / 3 + 2 * d * d * s + 2 * d**3 + 2 * d * d + 2 * s * s * d
                    + s**3 / 3 + 2 * s * d * d + 2 * s * d + 2 * s * s + 2 * s * s * d
                    + 4 * d * d * s + 4 * d**3 + 2 * d * s + 2 * d * d)
        flops = B * ((T - 1) * per_knot + d**3 / 3 + 2 * d * d)
        nbytes = f4 * (sum(x.numel() for x in real)
                       + B * ((T - 1) * (d * d + s * s + d * s + d) + d))
        results["kkt_fwd_sweep"] = dict(
            source="quantumcollocation_tpu_torch/csrc/kkt_sweeps.cu",
            replaces="quantumcollocation_tpu/solver/kkt_lanes.py:484",
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: kl.fwd_sweep_cuda(*real, delta_c)),
            plain_ms=time_ms(lambda: kl.fwd_sweep_reference(*real, delta_c)),
            bytes=nbytes, flops=flops,
        )

        # kernel 3: backward sweep, fed the plain version's factors
        def bwd_args(L_P, L_S, X_A, qs, dz_last, C_, A_, B_, rnu_):
            dz0 = torch.empty(B, T, d, device=Z.device)
            dz0[:, -1] = dz_last
            return (L_P, L_S, X_A, qs, C_, A_, B_, rnu_, dz0)

        L_P, L_S, X_A, qs, dz_last = ref_f[:5]
        sC, sA, sB, srnu = seeded[1], seeded[2], seeded[3], seeded[5]
        dz_k, nu_k = kl.bwd_sweep_cuda(*bwd_args(L_P, L_S, X_A, qs, dz_last, sC, sA, sB, srnu))
        dz_r, nu_r = kl.bwd_sweep_reference(L_P, L_S, X_A, qs, sC, sA, sB, srnu, dz_last)
        errs = [rel_err(dz_k, dz_r), rel_err(nu_k, nu_r)]
        rL_P, rL_S, rX_A, rqs, rdz_last, _ = kl.fwd_sweep_reference(*real, delta_c)
        real_bwd = bwd_args(rL_P, rL_S, rX_A, rqs, rdz_last, C, A, Bj, rnu)
        per_knot = 2 * d * d + 4 * s * d + 2 * d * d + 2 * s * s + 2 * d * s
        nbytes = f4 * B * ((T - 1) * (d * d + s * s + d * s + d + d * d + 2 * s * d + s)
                           + d + (T - 1) * (d + s))
        results["kkt_bwd_sweep"] = dict(
            source="quantumcollocation_tpu_torch/csrc/kkt_sweeps.cu",
            replaces="quantumcollocation_tpu/solver/kkt_lanes.py:565",
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: kl.bwd_sweep_cuda(*real_bwd)),
            plain_ms=time_ms(lambda: kl.bwd_sweep_reference(
                rL_P, rL_S, rX_A, rqs, C, A, Bj, rnu, rdz_last)),
            bytes=nbytes, flops=B * (T - 1) * per_knot,
        )
    for name, r in results.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / bw, r["flops"] / f32_peak)
        r["bound_by"] = "bytes" if r["bytes"] / bw >= r["flops"] / f32_peak else "operations"
        r["kernel_ms"], r["bound_us"] = r["ms"], 1e3 * r["bound_ms"]
        r["tol"] = TOL[name]
        r["ok"] = bool(r["max_rel_err"] <= TOL[name])
        emit({"phase": "kernel", "name": name, "library_ms": None, "shapes":
              {"B": B, "T": T, "d": d, "s": s, "dtype": "float32"}, **r})
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # ---- 4. main path ---------------------------------------------------- #
    solver.solve(seeds(6), max_iter=ITERS)  # discarded warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(seeds(42), max_iter=ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    iters = solver.last_steps
    Zs = res.Z.double().cpu().numpy()
    if Zs.shape != (B, T, d) or not np.isfinite(Zs).all():
        fail(f"solution has shape {Zs.shape} or non-finite values")
    fids = q.batched_rollout_fidelity(
        Zs[:, :, a_sl], Zs[:, :, dt_sl][:, :, 0], sysq,
        prob.trajectory.goal["Ũ⃗"], prob.trajectory.initial["Ũ⃗"], device="cuda",
    )
    infid = 1.0 - fids
    frac = float(np.mean(infid <= 1e-4))
    retries = counts["kkt_fwd_sweep"] - iters
    emit({"phase": "main_path", "batch": B, "T": T, "ipm_iters": iters, "wall_s": wall,
          "solves_per_s": B * frac / wall, "ipm_ms_per_iter": 1e3 * wall / max(iters, 1),
          "converged_frac": frac, "best_infid": float(infid.min()),
          "median_infid": float(np.median(infid)),
          "ipm_converged_frac": float(res.converged.float().mean()),
          "launches": counts, "kkt_retries": retries,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if min(counts.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {counts}")
    if frac < 0.9:
        fail(f"converged_frac {frac} < 0.9")

    # ---- 5. reference: the first iteration's real KKT system ------------ #
    # float32 error of the kernel path and of the plain path against the
    # float64 CPU solve of the same (float32) blocks; the kernel path must
    # be no worse than ten times the plain one (the blocks are
    # near-singular at this iteration, so both carry visible rounding)
    with torch.no_grad():
        dz_k, nu_k, ok_k = kl.solve_kkt_lanes(*real, delta_c)
        dz_p, nu_p, ok_p = solve_kkt(*real, delta_c)
        dz_r, nu_r, ok_r = solve_kkt(*[x.double().cpu() for x in real], delta_c)
        keep = ok_r & ok_k.cpu() & ok_p.cpu()
        e_k = max(rel_err(dz_k.cpu(), dz_r, keep)[1], rel_err(nu_k.cpu(), nu_r, keep)[1])
        e_p = max(rel_err(dz_p.cpu(), dz_r, keep)[1], rel_err(nu_p.cpu(), nu_r, keep)[1])
    emit({"phase": "reference", "batch": B, "kernel_rel_err_vs_f64": e_k,
          "plain_rel_err_vs_f64": e_p, "compared": int(keep.sum()),
          "ok_kernel": int(ok_k.sum()), "ok_plain": int(ok_p.sum()), "ok_f64": int(ok_r.sum())})
    if not (e_k <= 10 * e_p + 1e-6 and int(keep.sum()) >= B - B // 100):
        fail("the kernel KKT solve is less accurate than the plain float32 solve")

    launches_per_iter = {k: v / max(iters, 1) for k, v in counts.items()}
    emit({"phase": "launches_per_iter", **launches_per_iter})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None, "ok": r["ok"]}
        for name, r in results.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
