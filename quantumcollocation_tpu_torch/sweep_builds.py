"""Times builds of the sweep kernels, of the fused assembly and of the
propagator bank against each other, and checks that their outputs agree.

    python -m quantumcollocation_tpu_torch.sweep_builds
        [--build NAME=SOURCE ...] [--assembly-build NAME=SOURCE ...]
        [--bank-build NAME=SOURCE ...] [--repeat 20]

Builds each --build, a kkt_sweeps.cu with the port's C interface (an
earlier commit's, or a variant of this one), each --assembly-build, a
dyn_assembly.cu with the port's C interface, and each --bank-build, a
prop_bank.cu with the port's C interface, beside this tree's own builds
("this").  On seeded blocks (bench_util.seeded_kkt) at the main paths'
shapes, the hadamard shape (B=512, T=51, d=15, s=13) and the cnot shape
(B=128, T=40, d=47, s=42), and on the hadamard path's first IPM
iteration's real system (profile_step's seeds, as kkt_accuracy_probe takes
it: near-singular blocks), it times, build after build and then again in
reverse order:
  - kernel 2, the forward sweep (kept factors at the cnot shape; also
    with the 13 columns of hadamard_lbfgs's [rz | U] at the hadamard shape);
  - kernel 3, the backward sweep, one column, at both shapes (on this
    tree's kernel-2 factors);
  - kernel 4, the rhs-only forward sweep (cnot shape);
  - kernels 6 and 7, the forward and backward steps (hadamard shape):
    device time per launch, the T-1 launches of a solve captured in one
    CUDA graph and replayed between two events;
  - kernel 1, the fused assembly, on the first IPM iteration's Z and
    multipliers of the hadamard (Padé) and ket_exp (exponential) paths
    (profile_step's problems and seeds);
  - kernel 5, the propagator bank, on the first IPM iteration's Z of the
    cnot (Padé, second order), cnot_exp (exponential, second order),
    hadamard_lbfgs (Padé, first order, 25,600 pairs) and ket_exp
    (exponential, first order) paths, and on a seeded n=6 case of transmon
    leakage's shape (Padé, second order, fixed Δt, 2 drives, 9,984 pairs);
each as the median of --repeat calls after warm-up (kernel 5 also as the
device time of one call, a CUDA graph of it replayed: "device_ms"), and
reports each
build's largest difference from this tree's outputs of each case (0.0:
bit for bit).  A NAME given to more than one of --build, --assembly-build
and --bank-build is one build.  Prints the card's name and power limit, then one JSON line per
build.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from . import profile_step
from .bench_util import bank_args, graph_ms, seeded_bank, seeded_kkt, time_ms
from .kkt_accuracy_probe import first_system
from .ops import build as kbuild
from .ops import dyn_assembly as da
from .ops import prop_bank as pb
from .solver import kkt_lanes as kl

HAD = (512, 51, 15, 13)
CX = (128, 40, 47, 42)
DELTA_C = 1e-8


class Build:
    """The sweep kernels of one kkt_sweeps.cu library, the fused assembly of
    one dyn_assembly.cu library and the bank of one prop_bank.cu library
    (any may be None)."""

    def __init__(self, lib, asm=None, bank=None):
        self.lib = lib
        self.asm = asm
        self.bank = bank

    def prop_bank(self, a, dt, Gd, Gs, kw):
        """Kernel 5: the bank's outputs that are not None."""
        return [x for x in pb.run_library(self.bank, a, dt, Gd, Gs, **kw) if x is not None]

    def assembly(self, an, Z, lam):
        """Kernel 1 on the problem `an`'s Z (B, T, d) and lam (B, T-1, s)."""
        Bn, T, d = Z.shape
        s = an.s
        ispec, fspec, (n, K), kind = da._device_spec(an, Z.device)
        new = dict(dtype=torch.float32, device=Z.device)
        out = [torch.empty(Bn, T - 1, s, **new), torch.empty(Bn, T - 1, s, d, **new),
               torch.empty(Bn, T - 1, s, d, **new), torch.empty(Bn, T, d, d, **new),
               torch.empty(Bn, T - 1, d, d, **new)]
        kbuild.check(self.asm.qct_dyn_assembly(
            Z.data_ptr(), lam.data_ptr(), Bn, T, d, s, ispec.data_ptr(), fspec.data_ptr(),
            *[x.data_ptr() for x in out], n, K, int(kind == "exp"),
            torch.cuda.current_stream().cuda_stream), "dyn_assembly")
        return out

    def bwd(self, LP, LS, XA, q, C, A, B, rnu, dz_last):
        """Kernel 3, one column: (dz (B, T, d), nu)."""
        Bn, Tm1, d, _ = LP.shape
        s = LS.shape[2]
        dz = torch.empty(Bn, Tm1 + 1, d, dtype=torch.float32, device=LP.device)
        dz[:, -1] = dz_last
        nu = torch.empty(Bn, Tm1, s, dtype=torch.float32, device=LP.device)
        kbuild.check(self.lib.qct_kkt_bwd_sweep(
            *[x.data_ptr() for x in (LP, LS, XA, q, C, A, B, rnu)], Bn, Tm1 + 1, d, s, 1,
            dz.data_ptr(), nu.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "kkt_bwd_sweep")
        return dz, nu

    def bwd_scan(self, LP, LS, XA, q, C, A, B, rnu, dz_last):
        """A callable running the T-1 backward steps (kernel 7) of one solve
        on fixed buffers, and its outputs (dz, nu)."""
        Bn, Tm1, d, _ = LP.shape
        s = LS.shape[2]
        dz = torch.empty(Bn, Tm1 + 1, d, dtype=torch.float32, device=LP.device)
        dz[:, -1] = dz_last
        nu = torch.empty(Bn, Tm1, s, dtype=torch.float32, device=LP.device)
        blocks = [x.data_ptr() for x in (LP, LS, XA, q, C, A, B, rnu)]

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            for t in reversed(range(Tm1)):
                kbuild.check(self.lib.qct_kkt_bwd_step(*blocks, Bn, Tm1 + 1, d, s, t,
                                                       dz.data_ptr(), nu.data_ptr(), stream),
                             "kkt_bwd_step")

        return run, (dz, nu)

    def fwd(self, H, C, A, B, rz, rnu, factors):
        """Kernel 2; rz (B, T, d) for one column, (B, T, d, r) for r."""
        Bn, T, d, _ = H.shape
        s = A.shape[2]
        cols = tuple(rz.shape[3:])
        new = dict(dtype=torch.float32, device=H.device)
        out = [torch.empty(Bn, T - 1, d, d, **new), torch.empty(Bn, T - 1, s, s, **new),
               torch.empty(Bn, T - 1, d, s, **new), torch.empty(Bn, T - 1, d, *cols, **new),
               torch.empty(Bn, T, d, *cols, **new)]
        if factors:
            out += [torch.empty(Bn, T - 1, s, d, **new), torch.empty(Bn, d, d, **new)]
        ptrs = [x.data_ptr() for x in out] + ([] if factors else [None, None])
        kbuild.check(self.lib.qct_kkt_fwd_sweep(
            *[x.data_ptr() for x in (H, C, A, B, rz, rnu)], Bn, T, d, s, (cols or (1,))[0],
            DELTA_C, *ptrs,
            torch.cuda.current_stream().cuda_stream), "kkt_fwd_sweep")
        out[4] = out[4][:, -1]
        return out

    def rhs(self, LP, LS, G, C, A, rz, rnu, LPf):
        Bn, Tm1, d, _ = LP.shape
        s = LS.shape[2]
        q = torch.empty(Bn, Tm1, d, dtype=torch.float32, device=LP.device)
        dz = torch.empty(Bn, Tm1 + 1, d, dtype=torch.float32, device=LP.device)
        kbuild.check(self.lib.qct_kkt_rhs_fwd_sweep(
            *[x.data_ptr() for x in (LP, LS, G, C, A, rz, rnu, LPf)], Bn, Tm1 + 1, d, s,
            q.data_ptr(), dz.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "kkt_rhs_fwd_sweep")
        return q, dz[:, -1]

    def scan(self, H, C, A, B, rz, rnu):
        """A callable running the T-1 forward steps of one solve on fixed
        buffers (so that a CUDA graph can hold it), and its outputs."""
        Bn, T, d, _ = H.shape
        s = A.shape[2]
        new = dict(dtype=torch.float32, device=H.device)
        first = (H[:, 0].clone(), rz[:, 0].clone())
        carry = [(torch.empty(Bn, d, d, **new), torch.empty(Bn, d, **new)) for _ in range(2)]
        fac = [torch.empty(Bn, T - 1, d, d, **new), torch.empty(Bn, T - 1, s, s, **new),
               torch.empty(Bn, T - 1, d, s, **new), torch.empty(Bn, T - 1, d, **new)]
        blocks = [x.data_ptr() for x in (H, C, A, B, rz, rnu)]

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            for t in range(T - 1):
                P, q = first if t == 0 else carry[(t - 1) % 2]
                Pn, qn = carry[t % 2]
                kbuild.check(self.lib.qct_kkt_fwd_step(
                    P.data_ptr(), q.data_ptr(), *blocks, Bn, T, d, s, t, DELTA_C, Pn.data_ptr(),
                    qn.data_ptr(), *[x.data_ptr() for x in fac], stream), "kkt_fwd_step")

        return run, carry[(T - 2) % 2] + tuple(fac)


def max_diff(outs, refs):
    return max((a.double() - b.double()).abs().max().item() for a, b in zip(outs, refs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[],
                    help="NAME=SOURCE, another kkt_sweeps.cu build to set beside this tree's")
    ap.add_argument("--assembly-build", action="append", default=[],
                    help="NAME=SOURCE, another dyn_assembly.cu build to set beside this tree's")
    ap.add_argument("--bank-build", action="append", default=[],
                    help="NAME=SOURCE, another prop_bank.cu build to set beside this tree's")
    ap.add_argument("--repeat", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_builds needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    specs = [spec.split("=", 1) for spec in args.build]
    asm_specs = [spec.split("=", 1) for spec in args.assembly_build]
    bank_specs = [spec.split("=", 1) for spec in args.bank_build]
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(specs) + len(asm_specs) + len(bank_specs) + 3) as ex:
        this = ex.submit(kl._lib)
        this_asm = ex.submit(da._lib)
        this_bank = ex.submit(pb._lib)
        others = [ex.submit(kbuild.build_other, source, f"kkt_sweeps_{name}")
                  for name, source in specs]
        asm_others = [ex.submit(kbuild.build_other, source, f"dyn_assembly_{name}")
                      for name, source in asm_specs]
        bank_others = [ex.submit(kbuild.build_other, source, f"prop_bank_{name}")
                       for name, source in bank_specs]
        builds = {"this": Build(this.result(), this_asm.result(), this_bank.result())}
        for (name, _), lib in zip(specs, others):
            builds[name] = Build(kl.set_signatures(lib.result()))
        for (name, _), lib in zip(asm_specs, asm_others):
            builds.setdefault(name, Build(None)).asm = da.set_signatures(lib.result())
        for (name, _), lib in zip(bank_specs, bank_others):
            builds.setdefault(name, Build(None)).bank = pb.set_signatures(lib.result())

    had = seeded_kkt(*HAD, "cuda", seed=0)[:6]
    had13 = seeded_kkt(*HAD, "cuda", r=13, seed=2)[:6]  # hadamard_lbfgs's [rz | U]
    cx = seeded_kkt(*CX, "cuda", seed=1)
    cx, rhs2 = cx[:6], cx[6:]
    had_real = first_system("hadamard")[0]
    ref = builds["this"]
    fac = ref.fwd(*cx, True)
    rhs_in = (fac[0], fac[1], fac[5], cx[1], cx[2], *rhs2, fac[6])
    with torch.no_grad():
        fh = ref.fwd(*had, False)
    bwd_had = (*fh[:4], *had[1:4], had[5], fh[4])
    bwd_cx = (*fac[:4], *cx[1:4], cx[5], fac[4])
    asm_in, bank_in = {}, {}
    for config in ("hadamard", "ket_exp", "cnot", "cnot_exp", "hadamard_lbfgs"):
        solver, Z0 = profile_step.build(config, None)
        with torch.no_grad():
            st = solver.init_state(Z0)
        an, Z = solver.nlp.analytic, st.Z.contiguous()
        if config in ("hadamard", "ket_exp"):
            asm_in[config] = (an, Z, st.lam.contiguous())
        if config != "hadamard":
            bank_in[config] = bank_args(an, Z, solver.var_scale,
                                        second_order=config.startswith("cnot"))
    # transmon leakage's bank: B=256, T=40, n=6, two drives, Δt=0.2 fixed
    a6, dt6, Gd6, Gs6 = seeded_bank(256 * 39, 6, 2, "cuda", seed=6, a_scale=0.5,
                                    dt_range=(0.2, 0.2))
    bank_in["seeded_n6"] = (a6, dt6, Gd6, Gs6, dict(kind="pade", order=4, free_dt=False,
                                                    second_order=True))
    cases = {  # name: (run, is_scan, library)
        "kkt_fwd_sweep_hadamard": (lambda b: b.fwd(*had, False), False, "lib"),
        "kkt_fwd_sweep_hadamard_real": (lambda b: b.fwd(*had_real, False), False, "lib"),
        "kkt_fwd_sweep_hadamard_r13": (lambda b: b.fwd(*had13, False), False, "lib"),
        "kkt_fwd_sweep_cnot": (lambda b: b.fwd(*cx, True), False, "lib"),
        "kkt_bwd_sweep_hadamard": (lambda b: b.bwd(*bwd_had), False, "lib"),
        "kkt_bwd_sweep_cnot": (lambda b: b.bwd(*bwd_cx), False, "lib"),
        "kkt_rhs_fwd_sweep_cnot": (lambda b: b.rhs(*rhs_in), False, "lib"),
        "kkt_fwd_step_hadamard": (lambda b: b.scan(*had), True, "lib"),
        "kkt_bwd_step_hadamard": (lambda b: b.bwd_scan(*bwd_had), True, "lib"),
        "dyn_assembly_hadamard": (lambda b: b.assembly(*asm_in["hadamard"]), False, "asm"),
        "dyn_assembly_ket_exp": (lambda b: b.assembly(*asm_in["ket_exp"]), False, "asm"),
        **{f"prop_bank_{config}": (lambda b, c=config: b.prop_bank(*bank_in[c]), False, "bank")
           for config in bank_in},
    }
    results = {name: {} for name in builds}
    with torch.no_grad():
        refs = {}
        for case, (make, is_scan, _) in cases.items():
            if is_scan:
                run, outs = make(ref)
                run()
                refs[case] = outs
            else:
                refs[case] = make(ref)
        order = list(builds) + list(reversed(builds))
        for name in order:
            b = builds[name]
            for case, (make, is_scan, which) in cases.items():
                if getattr(b, which) is None:
                    continue
                if is_scan:
                    run, outs = make(b)
                    ms = graph_ms(run, args.repeat) / (HAD[1] - 1)
                    run()
                else:
                    outs = make(b)
                    ms = time_ms(lambda: make(b), args.repeat)
                r = results[name].setdefault(case, {"ms": [], "max_abs_diff_vs_this": 0.0})
                r["ms"].append(ms)
                if which == "bank":  # a call's device time, without the host's enqueue
                    r.setdefault("device_ms", []).append(graph_ms(lambda: make(b), args.repeat))
                r["max_abs_diff_vs_this"] = max(r["max_abs_diff_vs_this"],
                                                max_diff(outs, refs[case]))
    for name, res in results.items():
        print(json.dumps({"build": name, "device": torch.cuda.get_device_name(0),
                          "ms_unit": {k: "per launch" if "step" in k else "per call"
                                      for k in res}, **res}), flush=True)


if __name__ == "__main__":
    main()
