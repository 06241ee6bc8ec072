"""Batched KKT solve through the two Riccati sweep kernels.

Replaces quantumcollocation_tpu/solver/kkt_lanes.py::solve_kkt_lanes and
its Pallas kernels _fwd_sweep_kernel and _bwd_sweep_kernel with the CUDA
kernels of csrc/kkt_sweeps.cu (one warp per instance, knot loop inside
the kernel; the terminal block is folded into the end of the forward
sweep).  Single right-hand-side column; the multi-column form and the
kept factors (`want_factors`) come with the slices that need them.

Everything keeps the JAX package's batch-first shapes: the kernels read
an instance's blocks as contiguous rows, so no transpose is needed.  The
plain versions (`kkt_sweeps_reference` = `fwd_sweep_reference` +
`bwd_sweep_reference`, the batched factor_kkt / solve_with_factors of
solver/kkt.py) take CPU tensors; CUDA tensors go to the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import build
from .kkt import KKTFactors, _chol_solve, back_substitute, factor_kkt, forward_rhs

__all__ = [
    "solve_kkt_lanes",
    "kkt_sweeps_reference",
    "fwd_sweep_reference",
    "bwd_sweep_reference",
    "fwd_sweep_cuda",
    "bwd_sweep_cuda",
]

_P, _I = ctypes.c_void_p, ctypes.c_int


def fwd_sweep_reference(H, C, A, B, rz, rnu, delta_c):
    """Plain forward sweep, batch-first: (L_P, L_S, X_A, q, dz_last, ok),
    with q the carried rhs (B, T-1, d) and dz_last (B, d)."""
    fac = factor_kkt(H, C, A, B, delta_c)
    qs, q_final = forward_rhs(fac, rz, rnu)
    dz_last = _chol_solve(fac.L_final, q_final.unsqueeze(-1))[..., 0]
    return fac.L_P, fac.L_S, fac.X_A, qs, dz_last, fac.ok


def bwd_sweep_reference(L_P, L_S, X_A, q, C, A, B, rnu, dz_last):
    """Plain backward sweep, batch-first: (dz (B, T, d), nu (B, T-1, s))."""
    fac = KKTFactors(L_P, L_S, X_A, None, None, C, A, B, None)
    return back_substitute(fac, q, dz_last, rnu)


def kkt_sweeps_reference(H, C, A, B, rz, rnu, delta_c):
    """Plain version of both sweeps: (dz, nu, ok), batch-first."""
    L_P, L_S, X_A, q, dz_last, ok = fwd_sweep_reference(H, C, A, B, rz, rnu, delta_c)
    dz, nu = bwd_sweep_reference(L_P, L_S, X_A, q, C, A, B, rnu, dz_last)
    return dz, nu, ok & _ok(dz, nu)


def _lib():
    lib = build.library("kkt_sweeps")
    lib.qct_kkt_fwd_sweep.restype = _I
    lib.qct_kkt_fwd_sweep.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_P] * 6
    lib.qct_kkt_bwd_sweep.restype = _I
    lib.qct_kkt_bwd_sweep.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 3
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


def fwd_sweep_cuda(H, C, A, B, rz, rnu, delta_c):
    """Kernel 2 on float32 CUDA tensors H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d), rnu (B, T-1, s).  Returns
    (L_P, L_S, X_A, q, dz); dz (B, T, d) holds only dz_{T-1} until the
    backward sweep fills the rest."""
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
    err = _lib().qct_kkt_fwd_sweep(
        *[x.data_ptr() for x in (H, C, A, B, rz, rnu)], Bt, T, d, s, float(delta_c),
        LP.data_ptr(), LS.data_ptr(), XA.data_ptr(), q.data_ptr(), dz.data_ptr(),
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    build.check(err, "kkt_fwd_sweep")
    build.launch_counts["kkt_fwd_sweep"] += 1
    return LP, LS, XA, q, dz


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


def _ok(dz, nu):
    return torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)


def solve_kkt_lanes(H, C, A, B, rz, rnu, delta_c):
    """Batched block-tridiagonal KKT solve: H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d), rnu (B, T-1, s) -> (dz, nu, ok).
    The sweep kernels for CUDA tensors, the plain versions for CPU ones."""
    if not H.is_cuda:
        return kkt_sweeps_reference(H, C, A, B, rz, rnu, delta_c)
    L_P, L_S, X_A, q, dz = fwd_sweep_cuda(H, C, A, B, rz, rnu, delta_c)
    dz, nu = bwd_sweep_cuda(L_P, L_S, X_A, q, C, A, B, rnu, dz)
    return dz, nu, _ok(dz, nu)
