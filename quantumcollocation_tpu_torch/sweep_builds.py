"""Times builds of the sweep kernels against each other, and checks that
their outputs agree.

    python -m quantumcollocation_tpu_torch.sweep_builds
        [--build NAME=SOURCE ...] [--repeat 20]

Builds each --build, a kkt_sweeps.cu with the port's C interface (an
earlier commit's, or a variant of this one), beside this tree's own build
("this").  On seeded blocks (bench_util.seeded_kkt) at the main paths'
shapes, the hadamard shape (B=512, T=51, d=15, s=13) and the cnot shape
(B=128, T=40, d=47, s=42), and on the hadamard path's first IPM
iteration's real system (profile_step's seeds, as kkt_accuracy_probe takes
it: near-singular blocks), it times, build after build and then again in
reverse order:
  - kernel 2, the forward sweep (kept factors at the cnot shape; also
    with the 13 columns of hadamard_lbfgs's [rz | U] at the hadamard shape);
  - kernel 4, the rhs-only forward sweep (cnot shape);
  - kernel 6, the forward step (hadamard shape): device time per launch,
    the T-1 launches of a solve captured in one CUDA graph and replayed
    between two events;
each as the median of --repeat calls after warm-up, and reports each
build's largest difference from this tree's outputs of the three kernels
(0.0: bit for bit).  Prints the card's name and power limit, then one JSON
line per build.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from .bench_util import graph_ms, seeded_kkt, time_ms
from .kkt_accuracy_probe import first_system
from .ops import build as kbuild
from .solver import kkt_lanes as kl

HAD = (512, 51, 15, 13)
CX = (128, 40, 47, 42)
DELTA_C = 1e-8


class Build:
    """The kernels 2, 4 and 6 of one library, on preallocated outputs."""

    def __init__(self, lib):
        self.lib = lib

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
                    help="NAME=SOURCE, another build to set beside this tree's")
    ap.add_argument("--repeat", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_builds needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    specs = [spec.split("=", 1) for spec in args.build]
    with ThreadPoolExecutor(len(specs) + 1) as ex:  # one nvcc per source, all at once
        this = ex.submit(kl._lib)
        others = [ex.submit(kbuild.build_other, source, f"kkt_sweeps_{name}")
                  for name, source in specs]
        builds = {"this": Build(this.result())}
        for (name, _), lib in zip(specs, others):
            builds[name] = Build(kl.set_signatures(lib.result()))

    had = seeded_kkt(*HAD, "cuda", seed=0)[:6]
    had13 = seeded_kkt(*HAD, "cuda", r=13, seed=2)[:6]  # hadamard_lbfgs's [rz | U]
    cx = seeded_kkt(*CX, "cuda", seed=1)
    cx, rhs2 = cx[:6], cx[6:]
    had_real = first_system("hadamard")[0]
    ref = builds["this"]
    fac = ref.fwd(*cx, True)
    rhs_in = (fac[0], fac[1], fac[5], cx[1], cx[2], *rhs2, fac[6])
    cases = {
        "kkt_fwd_sweep_hadamard": (lambda b: b.fwd(*had, False), False),
        "kkt_fwd_sweep_hadamard_real": (lambda b: b.fwd(*had_real, False), False),
        "kkt_fwd_sweep_hadamard_r13": (lambda b: b.fwd(*had13, False), False),
        "kkt_fwd_sweep_cnot": (lambda b: b.fwd(*cx, True), False),
        "kkt_rhs_fwd_sweep_cnot": (lambda b: b.rhs(*rhs_in), False),
        "kkt_fwd_step_hadamard": (lambda b: b.scan(*had), True),
    }
    results = {name: {} for name in builds}
    with torch.no_grad():
        refs = {}
        for case, (make, is_scan) in cases.items():
            if is_scan:
                run, outs = make(ref)
                run()
                refs[case] = outs
            else:
                refs[case] = make(ref)
        order = list(builds) + list(reversed(builds))
        for name in order:
            b = builds[name]
            for case, (make, is_scan) in cases.items():
                if is_scan:
                    run, outs = make(b)
                    ms = graph_ms(run, args.repeat) / (HAD[1] - 1)
                    run()
                else:
                    outs = make(b)
                    ms = time_ms(lambda: make(b), args.repeat)
                r = results[name].setdefault(case, {"ms": [], "max_abs_diff_vs_this": 0.0})
                r["ms"].append(ms)
                r["max_abs_diff_vs_this"] = max(r["max_abs_diff_vs_this"],
                                                max_diff(outs, refs[case]))
    for name, res in results.items():
        print(json.dumps({"build": name, "device": torch.cuda.get_device_name(0),
                          "ms_unit": {k: "per launch" if "step" in k else "per call"
                                      for k in res}, **res}), flush=True)


if __name__ == "__main__":
    main()
