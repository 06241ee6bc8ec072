"""Fused dynamics assembly: F, A, B, Hc and Cc in one kernel launch.

Replaces the Pallas kernel quantumcollocation_tpu/ops/pallas_dyn_assembly.py
::_assembly_kernel (with _group_bank) by a hand-written CUDA kernel,
csrc/dyn_assembly.cu: one thread per (instance, knot) pair evaluates the
Padé bank N = q(X), D = q(-X) with first and second θ-derivatives by Horner
and writes the defects, the Jacobian blocks and the curvature of -λ·F.  For
exponential groups it turns the bank into P = exp(X) = (D⁻¹N)^(2^s) with its
derivatives (Gauss-Jordan inverse, then s squarings) before the writes.

The problem structure (propagator groups with their squaring counts,
derivative and Δt-equality rows, variable and defect scales, the generators
and Padé coefficients) travels as a small argument table, so a new problem
needs no new build.  An exponential group's generators go into the table
already scaled by 2^-s, so the kernel's Horner code is the Padé branch's.
The table is packed once per (analytic dynamics, device) and kept on the
device.

`dyn_assembly_reference` is the plain PyTorch version (the batched
dyn_eval on banks_reference + defect_curvature of solver/analytic.py).
`dyn_assembly` takes it only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..dynamics.expm import pade_coefficients
from . import build

__all__ = ["dyn_assembly", "dyn_assembly_reference", "dyn_assembly_cuda", "pack_spec"]

# (n, K) combinations the kernel is instantiated for (csrc/dyn_assembly.cu)
SUPPORTED_NK = {(2, 1), (2, 2), (2, 3), (4, 1), (4, 2), (4, 3)}


def dyn_assembly_reference(analytic, Z, lam):
    """Plain version: (F (B,T-1,s), A, B (B,T-1,s,d), Hc (B,T,d,d) with a
    zero last knot, Cc (B,T-1,d,d)) in scaled units."""
    F, A, Bj, aux = analytic.dyn_eval(Z, analytic.banks_reference(Z))
    Hc, Cc = analytic.defect_curvature(lam, aux)
    return F, A, Bj, Hc, Cc


def pack_spec(analytic):
    """(ispec int32, fspec float64 numpy, (n, K), kind) argument table; the
    layout is documented in csrc/dyn_assembly.cu.  All groups of one
    problem share one (n, K) and one kind ("pade" or "exp")."""
    d, s = analytic.d, analytic.s
    ispec = [len(analytic.groups), len(analytic.deriv_rows), len(analytic.dteq_rows)]
    vs = np.ones(d) if analytic.var_scale is None else np.asarray(analytic.var_scale)
    ds = np.ones(s) if analytic.defect_scale is None else np.asarray(analytic.defect_scale)
    fspec = [vs, ds]
    nk, kinds = set(), set()
    for g in analytic.groups:
        n, na = g.G_drift.shape[0], g.G_drives.shape[0]
        free = g.dt_col is not None
        nk.add((n, na + int(free)))
        kinds.add(g.kind)
        nsq = g.num_squarings if g.kind == "exp" else 0
        ispec += [n, na, g.a_slice[0], g.dt_col if free else -1, nsq, len(g.members)]
        for m in g.members:
            ispec += list(m)
        coeffs = pade_coefficients(g.order)
        scale = 2.0 ** -nsq  # exact: X = G dt 2^-s from scaled generators
        fspec += [
            [0.0 if free else g.dt_static, len(coeffs)], list(coeffs),
            scale * np.asarray(g.G_drift).ravel(), scale * np.asarray(g.G_drives).ravel(),
        ]
    for r in analytic.deriv_rows:
        ispec += [r.x0, r.x1, r.dx0, r.dx1, r.r0, r.r1,
                  r.dt_col if r.dt_col is not None else -1]
        fspec.append([0.0 if r.dt_col is not None else r.dt_static])
    for r in analytic.dteq_rows:
        ispec += [r.c0, r.c1, r.r0, r.r1]
    if len(nk) > 1:
        raise NotImplementedError(f"groups of different (n, K) {sorted(nk)}")
    if len(kinds) > 1:
        raise NotImplementedError("Padé and exponential groups in one problem")
    n_k = nk.pop() if nk else (2, 1)
    if n_k not in SUPPORTED_NK:
        raise NotImplementedError(f"(n, K)={n_k} not in {sorted(SUPPORTED_NK)}")
    flat = np.concatenate([np.asarray(x, dtype=np.float64).ravel() for x in fspec])
    return np.asarray(ispec, dtype=np.int32), flat, n_k, kinds.pop() if kinds else "pade"


def _device_spec(analytic, device):
    key = ("assembly_spec", device)
    if key not in analytic._consts:
        ispec, fspec, nk, kind = pack_spec(analytic)
        analytic._consts[key] = (
            torch.as_tensor(ispec, device=device),
            torch.as_tensor(fspec, dtype=torch.float32, device=device),
            nk, kind,
        )
    return analytic._consts[key]


def dyn_assembly_cuda(analytic, Z, lam):
    """Launch csrc/dyn_assembly.cu on CUDA float32 tensors."""
    Bt, T, d = Z.shape
    s = analytic.s
    if not (Z.is_cuda and lam.is_cuda):
        raise ValueError("dyn_assembly_cuda needs CUDA tensors")
    if Z.dtype != torch.float32 or lam.dtype != torch.float32:
        raise TypeError("dyn_assembly_cuda takes float32")
    if (T, d) != (analytic.T, analytic.d) or tuple(lam.shape) != (Bt, T - 1, s):
        raise ValueError(f"shapes Z {tuple(Z.shape)} lam {tuple(lam.shape)} do not fit the problem")
    if not (Z.is_contiguous() and lam.is_contiguous()):
        raise ValueError("dyn_assembly_cuda needs contiguous tensors")
    ispec, fspec, (n, K), kind = _device_spec(analytic, Z.device)
    F = torch.empty(Bt, T - 1, s, dtype=Z.dtype, device=Z.device)
    A = torch.empty(Bt, T - 1, s, d, dtype=Z.dtype, device=Z.device)
    Bj = torch.empty_like(A)
    Hc = torch.empty(Bt, T, d, d, dtype=Z.dtype, device=Z.device)
    Cc = torch.empty(Bt, T - 1, d, d, dtype=Z.dtype, device=Z.device)
    fn = build.library("dyn_assembly").qct_dyn_assembly
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    err = fn(
        Z.data_ptr(), lam.data_ptr(), Bt, T, d, s,
        ispec.data_ptr(), fspec.data_ptr(),
        F.data_ptr(), A.data_ptr(), Bj.data_ptr(), Hc.data_ptr(), Cc.data_ptr(),
        n, K, int(kind == "exp"), torch.cuda.current_stream(Z.device).cuda_stream,
    )
    build.check(err, "dyn_assembly")
    build.launch_counts["dyn_assembly"] += 1
    return F, A, Bj, Hc, Cc


def dyn_assembly(analytic, Z, lam):
    """F/A/B/Hc/Cc: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if Z.is_cuda:
        return dyn_assembly_cuda(analytic, Z, lam)
    return dyn_assembly_reference(analytic, Z, lam)
