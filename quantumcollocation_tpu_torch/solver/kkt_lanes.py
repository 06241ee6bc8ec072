"""Batched KKT solve through the Riccati sweep kernels.

Replaces quantumcollocation_tpu/solver/kkt_lanes.py::solve_kkt_lanes and
resolve_kkt_lanes and their Pallas kernels _fwd_sweep_kernel,
_bwd_sweep_kernel and _rhs_fwd_sweep_kernel with the CUDA kernels of
csrc/kkt_sweeps.cu (one warp per instance, knot loop inside the kernel;
the terminal blocks are folded into the ends of the forward sweeps).
Single right-hand-side column; the multi-column form (L-BFGS) comes with
the slice that needs it.  With want_factors the solve also keeps its
factors (LanesFactors), and resolve_kkt_lanes re-solves a new
right-hand side against them with triangular work only: the rhs-only
forward sweep, then the backward sweep.

Everything keeps the JAX package's batch-first shapes: the kernels read
an instance's blocks as contiguous rows, so no transpose is needed.  The
plain versions (`fwd_sweep_reference`, `bwd_sweep_reference` and
`rhs_fwd_sweep_reference`: the batched factor_kkt / forward_rhs /
back_substitute of solver/kkt.py) take CPU tensors; CUDA tensors go to
the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..ops import build
from .kkt import KKTFactors, _chol_solve, back_substitute, factor_kkt, forward_rhs

__all__ = [
    "LanesFactors",
    "solve_kkt_lanes",
    "resolve_kkt_lanes",
    "fwd_sweep_reference",
    "bwd_sweep_reference",
    "rhs_fwd_sweep_reference",
    "fwd_sweep_cuda",
    "bwd_sweep_cuda",
    "rhs_fwd_sweep_cuda",
]

_P, _I = ctypes.c_void_p, ctypes.c_int


class LanesFactors(NamedTuple):
    """Kept factors of one solve, batch-first, with the constraint blocks
    they belong to (the counterpart of the JAX LanesFactors)."""

    L_P: Any  # (B, T-1, d, d)
    L_S: Any  # (B, T-1, s, s)
    X_A: Any  # (B, T-1, d, s)
    G: Any  # (B, T-1, s, d)
    L_Pf: Any  # (B, d, d) terminal factor
    C: Any
    A: Any
    B: Any


def fwd_sweep_reference(H, C, A, B, rz, rnu, delta_c, want_factors=False):
    """Plain forward sweep, batch-first: (L_P, L_S, X_A, q, dz_last, ok),
    with q the carried rhs (B, T-1, d) and dz_last (B, d); with
    want_factors, G (B, T-1, s, d) and L_Pf (B, d, d) follow."""
    fac = factor_kkt(H, C, A, B, delta_c)
    qs, q_final = forward_rhs(fac, rz, rnu)
    dz_last = _chol_solve(fac.L_final, q_final.unsqueeze(-1))[..., 0]
    out = (fac.L_P, fac.L_S, fac.X_A, qs, dz_last, fac.ok)
    return out + (fac.G, fac.L_final) if want_factors else out


def rhs_fwd_sweep_reference(L_P, L_S, G, C, A, rz, rnu, L_Pf):
    """Plain rhs-only forward sweep against kept factors: (q (B, T-1, d),
    dz_last (B, d))."""
    fac = KKTFactors(L_P, L_S, None, G, L_Pf, C, A, None, None)
    qs, q_final = forward_rhs(fac, rz, rnu)
    return qs, _chol_solve(L_Pf, q_final.unsqueeze(-1))[..., 0]


def bwd_sweep_reference(L_P, L_S, X_A, q, C, A, B, rnu, dz_last):
    """Plain backward sweep, batch-first: (dz (B, T, d), nu (B, T-1, s))."""
    fac = KKTFactors(L_P, L_S, X_A, None, None, C, A, B, None)
    return back_substitute(fac, q, dz_last, rnu)


def _lib():
    lib = build.library("kkt_sweeps")
    lib.qct_kkt_fwd_sweep.restype = _I
    lib.qct_kkt_fwd_sweep.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_P] * 8
    lib.qct_kkt_bwd_sweep.restype = _I
    lib.qct_kkt_bwd_sweep.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 3
    lib.qct_kkt_rhs_fwd_sweep.restype = _I
    lib.qct_kkt_rhs_fwd_sweep.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 3
    return lib


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"{name} is not a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} is {x.dtype}, not float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, not {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fwd_sweep_cuda(H, C, A, B, rz, rnu, delta_c, want_factors=False):
    """Kernel 2 on float32 CUDA tensors H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d), rnu (B, T-1, s).  Returns
    (L_P, L_S, X_A, q, dz); dz (B, T, d) holds only dz_{T-1} until the
    backward sweep fills the rest.  With want_factors, G (B, T-1, s, d)
    and L_Pf (B, d, d) follow."""
    Bt, T, d, _ = H.shape
    s = A.shape[2]
    for name, x, shape in (
        ("H", H, (Bt, T, d, d)), ("C", C, (Bt, T - 1, d, d)),
        ("A", A, (Bt, T - 1, s, d)), ("B", B, (Bt, T - 1, s, d)),
        ("rz", rz, (Bt, T, d)), ("rnu", rnu, (Bt, T - 1, s)),
    ):
        _check(name, x, shape)
    new = dict(dtype=torch.float32, device=H.device)
    LP = torch.empty(Bt, T - 1, d, d, **new)
    LS = torch.empty(Bt, T - 1, s, s, **new)
    XA = torch.empty(Bt, T - 1, d, s, **new)
    q = torch.empty(Bt, T - 1, d, **new)
    dz = torch.empty(Bt, T, d, **new)
    G = torch.empty(Bt, T - 1, s, d, **new) if want_factors else None
    LPf = torch.empty(Bt, d, d, **new) if want_factors else None
    err = _lib().qct_kkt_fwd_sweep(
        *[x.data_ptr() for x in (H, C, A, B, rz, rnu)], Bt, T, d, s, float(delta_c),
        LP.data_ptr(), LS.data_ptr(), XA.data_ptr(), q.data_ptr(), dz.data_ptr(),
        *[None if x is None else x.data_ptr() for x in (G, LPf)],
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    build.check(err, "kkt_fwd_sweep")
    build.launch_counts["kkt_fwd_sweep"] += 1
    return (LP, LS, XA, q, dz) + ((G, LPf) if want_factors else ())


def bwd_sweep_cuda(L_P, L_S, X_A, q, C, A, B, rnu, dz):
    """Kernel 3: fills dz[:, :T-1] in place from dz[:, T-1]; returns
    (dz (B, T, d), nu (B, T-1, s))."""
    Bt, Tm1, d, _ = L_P.shape
    s = L_S.shape[2]
    for name, x, shape in (
        ("L_P", L_P, (Bt, Tm1, d, d)), ("L_S", L_S, (Bt, Tm1, s, s)),
        ("X_A", X_A, (Bt, Tm1, d, s)), ("q", q, (Bt, Tm1, d)),
        ("C", C, (Bt, Tm1, d, d)), ("A", A, (Bt, Tm1, s, d)),
        ("B", B, (Bt, Tm1, s, d)), ("rnu", rnu, (Bt, Tm1, s)),
        ("dz", dz, (Bt, Tm1 + 1, d)),
    ):
        _check(name, x, shape)
    nu = torch.empty(Bt, Tm1, s, dtype=torch.float32, device=L_P.device)
    err = _lib().qct_kkt_bwd_sweep(
        *[x.data_ptr() for x in (L_P, L_S, X_A, q, C, A, B, rnu)], Bt, Tm1 + 1, d, s,
        dz.data_ptr(), nu.data_ptr(), torch.cuda.current_stream(L_P.device).cuda_stream,
    )
    build.check(err, "kkt_bwd_sweep")
    build.launch_counts["kkt_bwd_sweep"] += 1
    return dz, nu


def rhs_fwd_sweep_cuda(L_P, L_S, G, C, A, rz, rnu, L_Pf):
    """Kernel 4: the rhs-only forward sweep against kept factors, float32
    CUDA tensors.  Returns (q (B, T-1, d), dz (B, T, d)) with dz holding
    only dz_{T-1}, for bwd_sweep_cuda."""
    Bt, Tm1, d, _ = L_P.shape
    s = L_S.shape[2]
    for name, x, shape in (
        ("L_P", L_P, (Bt, Tm1, d, d)), ("L_S", L_S, (Bt, Tm1, s, s)),
        ("G", G, (Bt, Tm1, s, d)), ("C", C, (Bt, Tm1, d, d)), ("A", A, (Bt, Tm1, s, d)),
        ("rz", rz, (Bt, Tm1 + 1, d)), ("rnu", rnu, (Bt, Tm1, s)), ("L_Pf", L_Pf, (Bt, d, d)),
    ):
        _check(name, x, shape)
    new = dict(dtype=torch.float32, device=L_P.device)
    q = torch.empty(Bt, Tm1, d, **new)
    dz = torch.empty(Bt, Tm1 + 1, d, **new)
    err = _lib().qct_kkt_rhs_fwd_sweep(
        *[x.data_ptr() for x in (L_P, L_S, G, C, A, rz, rnu, L_Pf)], Bt, Tm1 + 1, d, s,
        q.data_ptr(), dz.data_ptr(), torch.cuda.current_stream(L_P.device).cuda_stream,
    )
    build.check(err, "kkt_rhs_fwd_sweep")
    build.launch_counts["kkt_rhs_fwd_sweep"] += 1
    return q, dz


def _ok(dz, nu):
    return torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)


def solve_kkt_lanes(H, C, A, B, rz, rnu, delta_c, *, want_factors=False):
    """Batched block-tridiagonal KKT solve: H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d), rnu (B, T-1, s) -> (dz, nu, ok), and
    the kept LanesFactors as a fourth entry with want_factors.  The sweep
    kernels for CUDA tensors, the plain versions for CPU ones."""
    if not H.is_cuda:
        # torch's Cholesky reports a failed pivot in `info` (kept in ok)
        # where the kernel's NaN pivot reaches dz and nu
        L_P, L_S, X_A, q, dz_last, ok, *fac = fwd_sweep_reference(
            H, C, A, B, rz, rnu, delta_c, want_factors
        )
        dz, nu = bwd_sweep_reference(L_P, L_S, X_A, q, C, A, B, rnu, dz_last)
    else:
        L_P, L_S, X_A, q, dz, *fac = fwd_sweep_cuda(H, C, A, B, rz, rnu, delta_c, want_factors)
        dz, nu = bwd_sweep_cuda(L_P, L_S, X_A, q, C, A, B, rnu, dz)
        ok = True
    out = (dz, nu, _ok(dz, nu) & ok)
    return out + (LanesFactors(L_P, L_S, X_A, *fac, C, A, B),) if want_factors else out


def resolve_kkt_lanes(fac: LanesFactors, rz, rnu):
    """Rhs-only re-solve against kept factors: rz (B, T, d), rnu
    (B, T-1, s) -> (dz, nu, ok), ok = finite.  Kernel 4 then kernel 3 for
    CUDA tensors, the plain versions for CPU ones."""
    if not rz.is_cuda:
        q, dz_last = rhs_fwd_sweep_reference(fac.L_P, fac.L_S, fac.G, fac.C, fac.A, rz, rnu,
                                             fac.L_Pf)
        dz, nu = bwd_sweep_reference(fac.L_P, fac.L_S, fac.X_A, q, fac.C, fac.A, fac.B, rnu,
                                     dz_last)
    else:
        q, dz = rhs_fwd_sweep_cuda(fac.L_P, fac.L_S, fac.G, fac.C, fac.A, rz, rnu, fac.L_Pf)
        dz, nu = bwd_sweep_cuda(fac.L_P, fac.L_S, fac.X_A, q, fac.C, fac.A, fac.B, rnu, dz)
    return dz, nu, _ok(dz, nu)
