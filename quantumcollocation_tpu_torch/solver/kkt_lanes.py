"""Batched KKT solve through the Riccati sweep kernels.

Replaces quantumcollocation_tpu/solver/kkt_lanes.py::solve_kkt_lanes,
resolve_kkt_lanes and solve_kkt_lanes_scan and their Pallas kernels
_fwd_sweep_kernel, _bwd_sweep_kernel, _rhs_fwd_sweep_kernel,
_fwd_step_kernel and _bwd_step_kernel with the CUDA kernels of
csrc/kkt_sweeps.cu (a group of warps per instance; the backward step,
one warp per instance).  The fused sweeps loop over the knots inside the
kernel, with the terminal blocks folded into the ends of the forward
sweeps; kernels 2 and 3 take a right-hand side of r columns, rz
(B, T, d, r) and rnu (B, T-1, s, r), as the L-BFGS [rz | U] system needs.
With want_factors the solve also keeps its factors (LanesFactors), and
resolve_kkt_lanes re-solves a new single-column right-hand side against
them with triangular work only: the rhs-only forward sweep, then the
backward sweep.  solve_kkt_lanes_scan is the lanes_scan backend: one
launch per knot forward (the full carry P, q in global memory), the
terminal Cholesky in plain torch, one launch per knot backward; 2(T-1)
launches per solve, single column.

Everything keeps the JAX package's batch-first shapes: the kernels read
an instance's blocks as contiguous rows, so no transpose is needed.  The
plain versions (`fwd_sweep_reference`, `bwd_sweep_reference` and
`rhs_fwd_sweep_reference`: the batched factor_kkt / forward_rhs /
back_substitute of solver/kkt.py; `fwd_step_reference` and
`bwd_step_reference`: one knot of the JAX step kernels) take CPU tensors;
CUDA tensors go to the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple

import torch

from ..ops import build
from .kkt import (
    KKTFactors,
    _chol_solve,
    back_substitute,
    factor_kkt,
    forward_rhs,
    terminal_solve,
)

__all__ = [
    "LanesFactors",
    "solve_kkt_lanes",
    "resolve_kkt_lanes",
    "solve_kkt_lanes_scan",
    "fwd_sweep_reference",
    "bwd_sweep_reference",
    "rhs_fwd_sweep_reference",
    "fwd_step_reference",
    "bwd_step_reference",
    "fwd_sweep_cuda",
    "bwd_sweep_cuda",
    "rhs_fwd_sweep_cuda",
    "fwd_step_cuda",
    "bwd_step_cuda",
    "sweep_config",
    "set_signatures",
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
    with q the carried rhs (B, T-1, d[, r]) and dz_last (B, d[, r]); with
    want_factors, G (B, T-1, s, d) and L_Pf (B, d, d) follow."""
    fac = factor_kkt(H, C, A, B, delta_c)
    qs, q_final = forward_rhs(fac, rz, rnu)
    out = (fac.L_P, fac.L_S, fac.X_A, qs, terminal_solve(fac.L_final, q_final), fac.ok)
    return out + (fac.G, fac.L_final) if want_factors else out


def rhs_fwd_sweep_reference(L_P, L_S, G, C, A, rz, rnu, L_Pf):
    """Plain rhs-only forward sweep against kept factors: (q (B, T-1, d),
    dz_last (B, d))."""
    fac = KKTFactors(L_P, L_S, None, G, L_Pf, C, A, None, None)
    qs, q_final = forward_rhs(fac, rz, rnu)
    return qs, terminal_solve(L_Pf, q_final)


def bwd_sweep_reference(L_P, L_S, X_A, q, C, A, B, rnu, dz_last):
    """Plain backward sweep, batch-first: (dz (B, T, d[, r]),
    nu (B, T-1, s[, r]))."""
    fac = KKTFactors(L_P, L_S, X_A, None, None, C, A, B, None)
    return back_substitute(fac, q, dz_last, rnu)


def fwd_step_reference(P, q, Hn, C, A, B, rzn, rnu, delta_c):
    """Plain version of one knot of the lanes_scan forward elimination
    (JAX _fwd_step_kernel), batch-first: P (B, d, d) and q (B, d) the
    carry, Hn = H_{t+1}, C/A/B the knot's blocks, rzn = rz_{t+1},
    rnu (B, s).  Returns (P', q', L_P, L_S, X_A, q, ok), ok (B,) where both
    Cholesky factorizations succeeded (torch reports a failed pivot in
    `info` where the kernel's NaN reaches the solution)."""
    eye_s = torch.eye(A.shape[-2], dtype=P.dtype, device=P.device)
    L_P, info_p = torch.linalg.cholesky_ex(P)
    X_A = _chol_solve(L_P, A.mT)
    X_C = _chol_solve(L_P, C)
    x = _chol_solve(L_P, q.unsqueeze(-1))
    L_S, info_s = torch.linalg.cholesky_ex(A @ X_A + delta_c * eye_s)
    G = A @ X_C - B
    y = _chol_solve(L_S, A @ x - rnu.unsqueeze(-1))
    Pn = Hn - C.mT @ X_C + G.mT @ _chol_solve(L_S, G)
    Pn = 0.5 * (Pn + Pn.mT)
    qn = rzn - (C.mT @ x)[..., 0] + (G.mT @ y)[..., 0]
    return Pn, qn, L_P, L_S, X_A, q, (info_p == 0) & (info_s == 0)


def bwd_step_reference(dz_next, L_P, L_S, X_A, q, C, A, B, rnu):
    """Plain version of one knot of the lanes_scan back substitution (JAX
    _bwd_step_kernel), batch-first: dz_{t+1} (B, d) and the knot's saved
    factors and blocks -> (dz_t (B, d), nu_t (B, s))."""
    u = (q - (C @ dz_next.unsqueeze(-1))[..., 0]).unsqueeze(-1)
    v = rnu.unsqueeze(-1) - B @ dz_next.unsqueeze(-1)
    x = _chol_solve(L_P, u)
    y = _chol_solve(L_S, A @ x - v)
    return (x - X_A @ y)[..., 0], y[..., 0]


def set_signatures(lib):
    """Sets the C signatures of a kkt_sweeps.cu library (this tree's, or
    another build of it); returns lib."""
    lib.qct_kkt_fwd_sweep.restype = _I
    lib.qct_kkt_fwd_sweep.argtypes = [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_P] * 8
    lib.qct_kkt_bwd_sweep.restype = _I
    lib.qct_kkt_bwd_sweep.argtypes = [_P] * 8 + [_I] * 5 + [_P] * 3
    lib.qct_kkt_rhs_fwd_sweep.restype = _I
    lib.qct_kkt_rhs_fwd_sweep.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 3
    lib.qct_kkt_fwd_step.restype = _I
    lib.qct_kkt_fwd_step.argtypes = [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_P] * 7
    lib.qct_kkt_bwd_step.restype = _I
    lib.qct_kkt_bwd_step.argtypes = [_P] * 8 + [_I] * 5 + [_P] * 3
    lib.qct_kkt_sweep_config.restype = _I
    lib.qct_kkt_sweep_config.argtypes = [_I] * 5 + [_P]
    return lib


@functools.cache
def _lib():
    """The kernels' library, its C signatures set once."""
    return set_signatures(build.library("kkt_sweeps"))


# kernel name -> `which` of qct_kkt_sweep_config
_CONFIG_KERNELS = {"kkt_fwd_sweep": 0, "kkt_bwd_sweep": 1, "kkt_rhs_fwd_sweep": 2,
                   "kkt_fwd_step": 3}


def sweep_config(kernel, Bn, d, s, r=1):
    """Launch configuration of kernel 2 ("kkt_fwd_sweep"), 3
    ("kkt_bwd_sweep"), 4 ("kkt_rhs_fwd_sweep", one column) or 6
    ("kkt_fwd_step", one column) on the current CUDA device for these
    shapes: threads per instance, instances per block, shared bytes per
    block."""
    out = (ctypes.c_int * 3)()
    err = _lib().qct_kkt_sweep_config(_CONFIG_KERNELS[kernel], Bn, d, s, r, out)
    build.check(err, kernel)
    return dict(threads_per_instance=out[0], instances_per_block=out[1],
                shared_bytes_per_block=out[2])


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"{name} is not a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} is {x.dtype}, not float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, not {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _checks(*items):
    for name, x, shape in items:
        _check(name, x, shape)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def fwd_sweep_cuda(H, C, A, B, rz, rnu, delta_c, want_factors=False):
    """Kernel 2 on float32 CUDA tensors H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d[, r]), rnu (B, T-1, s[, r]).  Returns
    (L_P, L_S, X_A, q, dz), q (B, T-1, d[, r]); dz (B, T, d[, r]) holds
    only dz_{T-1} until the backward sweep fills the rest.  With
    want_factors, G (B, T-1, s, d) and L_Pf (B, d, d) follow."""
    Bt, T, d, _ = H.shape
    s = A.shape[2]
    cols = tuple(rz.shape[3:])
    _checks(
        ("H", H, (Bt, T, d, d)), ("C", C, (Bt, T - 1, d, d)),
        ("A", A, (Bt, T - 1, s, d)), ("B", B, (Bt, T - 1, s, d)),
        ("rz", rz, (Bt, T, d, *cols)), ("rnu", rnu, (Bt, T - 1, s, *cols)),
    )
    new = dict(dtype=torch.float32, device=H.device)
    LP = torch.empty(Bt, T - 1, d, d, **new)
    LS = torch.empty(Bt, T - 1, s, s, **new)
    XA = torch.empty(Bt, T - 1, d, s, **new)
    q = torch.empty(Bt, T - 1, d, *cols, **new)
    dz = torch.empty(Bt, T, d, *cols, **new)
    G = torch.empty(Bt, T - 1, s, d, **new) if want_factors else None
    LPf = torch.empty(Bt, d, d, **new) if want_factors else None
    err = _lib().qct_kkt_fwd_sweep(
        *[x.data_ptr() for x in (H, C, A, B, rz, rnu)], Bt, T, d, s, cols[0] if cols else 1,
        float(delta_c), LP.data_ptr(), LS.data_ptr(), XA.data_ptr(), q.data_ptr(),
        dz.data_ptr(), *[None if x is None else x.data_ptr() for x in (G, LPf)], _stream(H),
    )
    build.check(err, "kkt_fwd_sweep")
    build.launch_counts["kkt_fwd_sweep"] += 1
    return (LP, LS, XA, q, dz) + ((G, LPf) if want_factors else ())


def bwd_sweep_cuda(L_P, L_S, X_A, q, C, A, B, rnu, dz):
    """Kernel 3: fills dz[:, :T-1] in place from dz[:, T-1]; returns
    (dz (B, T, d[, r]), nu (B, T-1, s[, r])), with as many columns as q."""
    Bt, Tm1, d, _ = L_P.shape
    s = L_S.shape[2]
    cols = tuple(q.shape[3:])
    _checks(
        ("L_P", L_P, (Bt, Tm1, d, d)), ("L_S", L_S, (Bt, Tm1, s, s)),
        ("X_A", X_A, (Bt, Tm1, d, s)), ("q", q, (Bt, Tm1, d, *cols)),
        ("C", C, (Bt, Tm1, d, d)), ("A", A, (Bt, Tm1, s, d)),
        ("B", B, (Bt, Tm1, s, d)), ("rnu", rnu, (Bt, Tm1, s, *cols)),
        ("dz", dz, (Bt, Tm1 + 1, d, *cols)),
    )
    nu = torch.empty(Bt, Tm1, s, *cols, dtype=torch.float32, device=L_P.device)
    err = _lib().qct_kkt_bwd_sweep(
        *[x.data_ptr() for x in (L_P, L_S, X_A, q, C, A, B, rnu)], Bt, Tm1 + 1, d, s,
        cols[0] if cols else 1, dz.data_ptr(), nu.data_ptr(), _stream(L_P),
    )
    build.check(err, "kkt_bwd_sweep")
    build.launch_counts["kkt_bwd_sweep"] += 1
    return dz, nu


def fwd_step_cuda(P, q, H, C, A, B, rz, rnu, t, delta_c, L_P, L_S, X_A, qs):
    """Kernel 6: knot t of the lanes_scan forward elimination on float32
    CUDA tensors, every instance.  The carry P (B, d, d), q (B, d); the
    whole problem's H (B, T, d, d), C (B, T-1, d, d), A/B (B, T-1, s, d),
    rz (B, T, d), rnu (B, T-1, s), of which it reads knot t (H_{t+1} and
    rz_{t+1} for the next carry).  Writes the knot's L_P, L_S, X_A and q
    at index t of L_P (B, T-1, d, d), L_S, X_A and qs (B, T-1, d), and
    returns the next carry (P', q')."""
    Bt, T, d, _ = H.shape
    s = A.shape[2]
    _checks(
        ("P", P, (Bt, d, d)), ("q", q, (Bt, d)), ("H", H, (Bt, T, d, d)),
        ("C", C, (Bt, T - 1, d, d)), ("A", A, (Bt, T - 1, s, d)), ("B", B, (Bt, T - 1, s, d)),
        ("rz", rz, (Bt, T, d)), ("rnu", rnu, (Bt, T - 1, s)),
        ("L_P", L_P, (Bt, T - 1, d, d)), ("L_S", L_S, (Bt, T - 1, s, s)),
        ("X_A", X_A, (Bt, T - 1, d, s)), ("qs", qs, (Bt, T - 1, d)),
    )
    if not 0 <= t < T - 1:
        raise ValueError(f"knot {t} is not in [0, {T - 1})")
    Pn, qn = torch.empty_like(P), torch.empty_like(q)
    err = _lib().qct_kkt_fwd_step(
        *[x.data_ptr() for x in (P, q, H, C, A, B, rz, rnu)], Bt, T, d, s, t, float(delta_c),
        *[x.data_ptr() for x in (Pn, qn, L_P, L_S, X_A, qs)], _stream(P),
    )
    build.check(err, "kkt_fwd_step")
    build.launch_counts["kkt_fwd_step"] += 1
    return Pn, qn


def bwd_step_cuda(L_P, L_S, X_A, qs, C, A, B, rnu, dz, nu, t):
    """Kernel 7: knot t of the lanes_scan back substitution on float32
    CUDA tensors, every instance: reads dz_{t+1} from dz (B, T, d) and
    writes dz_t there and nu_t at index t of nu (B, T-1, s)."""
    Bt, Tm1, d, _ = L_P.shape
    s = L_S.shape[2]
    _checks(
        ("L_P", L_P, (Bt, Tm1, d, d)), ("L_S", L_S, (Bt, Tm1, s, s)),
        ("X_A", X_A, (Bt, Tm1, d, s)), ("qs", qs, (Bt, Tm1, d)),
        ("C", C, (Bt, Tm1, d, d)), ("A", A, (Bt, Tm1, s, d)), ("B", B, (Bt, Tm1, s, d)),
        ("rnu", rnu, (Bt, Tm1, s)), ("dz", dz, (Bt, Tm1 + 1, d)), ("nu", nu, (Bt, Tm1, s)),
    )
    if not 0 <= t < Tm1:
        raise ValueError(f"knot {t} is not in [0, {Tm1})")
    err = _lib().qct_kkt_bwd_step(
        *[x.data_ptr() for x in (L_P, L_S, X_A, qs, C, A, B, rnu)], Bt, Tm1 + 1, d, s, t,
        dz.data_ptr(), nu.data_ptr(), _stream(L_P),
    )
    build.check(err, "kkt_bwd_step")
    build.launch_counts["kkt_bwd_step"] += 1


def rhs_fwd_sweep_cuda(L_P, L_S, G, C, A, rz, rnu, L_Pf):
    """Kernel 4: the rhs-only forward sweep against kept factors, float32
    CUDA tensors.  Returns (q (B, T-1, d), dz (B, T, d)) with dz holding
    only dz_{T-1}, for bwd_sweep_cuda."""
    Bt, Tm1, d, _ = L_P.shape
    s = L_S.shape[2]
    _checks(
        ("L_P", L_P, (Bt, Tm1, d, d)), ("L_S", L_S, (Bt, Tm1, s, s)),
        ("G", G, (Bt, Tm1, s, d)), ("C", C, (Bt, Tm1, d, d)), ("A", A, (Bt, Tm1, s, d)),
        ("rz", rz, (Bt, Tm1 + 1, d)), ("rnu", rnu, (Bt, Tm1, s)), ("L_Pf", L_Pf, (Bt, d, d)),
    )
    new = dict(dtype=torch.float32, device=L_P.device)
    q = torch.empty(Bt, Tm1, d, **new)
    dz = torch.empty(Bt, Tm1 + 1, d, **new)
    err = _lib().qct_kkt_rhs_fwd_sweep(
        *[x.data_ptr() for x in (L_P, L_S, G, C, A, rz, rnu, L_Pf)], Bt, Tm1 + 1, d, s,
        q.data_ptr(), dz.data_ptr(), _stream(L_P),
    )
    build.check(err, "kkt_rhs_fwd_sweep")
    build.launch_counts["kkt_rhs_fwd_sweep"] += 1
    return q, dz


def _ok(dz, nu):
    return torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)


def solve_kkt_lanes(H, C, A, B, rz, rnu, delta_c, *, want_factors=False):
    """Batched block-tridiagonal KKT solve: H (B, T, d, d), C (B, T-1, d, d),
    A/B (B, T-1, s, d), rz (B, T, d[, r]), rnu (B, T-1, s[, r]) ->
    (dz (B, T, d[, r]), nu (B, T-1, s[, r]), ok), and the kept LanesFactors
    as a fourth entry with want_factors.  The sweep kernels for CUDA
    tensors, the plain versions for CPU ones."""
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


def solve_kkt_lanes_scan(H, C, A, B, rz, rnu, delta_c):
    """The lanes_scan backend: the KKT solve of solve_kkt_lanes, single
    column, as T-1 forward steps (kernel 6), the terminal Cholesky in plain
    torch (as the JAX scan does it in jnp) and T-1 backward steps
    (kernel 7).  The step kernels for CUDA tensors, fwd_step_reference and
    bwd_step_reference for CPU ones.  Returns (dz, nu, ok); no factors are
    kept."""
    Bt, T, d, _ = H.shape
    s = A.shape[2]
    new = dict(dtype=H.dtype, device=H.device)
    if not H.is_cuda:
        P, q = H[:, 0], rz[:, 0]
        ok = torch.ones(Bt, dtype=torch.bool, device=H.device)
        saved = []
        for t in range(T - 1):
            P, q, *fac, okt = fwd_step_reference(P, q, H[:, t + 1], C[:, t], A[:, t], B[:, t],
                                                 rz[:, t + 1], rnu[:, t], delta_c)
            saved.append(fac)
            ok = ok & okt
    else:
        L_P = torch.empty(Bt, T - 1, d, d, **new)
        L_S = torch.empty(Bt, T - 1, s, s, **new)
        X_A = torch.empty(Bt, T - 1, d, s, **new)
        qs = torch.empty(Bt, T - 1, d, **new)
        P, q = H[:, 0].contiguous(), rz[:, 0].contiguous()
        for t in range(T - 1):
            P, q = fwd_step_cuda(P, q, H, C, A, B, rz, rnu, t, delta_c, L_P, L_S, X_A, qs)
        ok = True
    L_f, info = torch.linalg.cholesky_ex(P)
    dz = torch.empty(Bt, T, d, **new)
    nu = torch.empty(Bt, T - 1, s, **new)
    dz[:, -1] = terminal_solve(L_f, q)
    for t in reversed(range(T - 1)):
        if H.is_cuda:
            bwd_step_cuda(L_P, L_S, X_A, qs, C, A, B, rnu, dz, nu, t)
        else:
            dz[:, t], nu[:, t] = bwd_step_reference(dz[:, t + 1], *saved[t], C[:, t], A[:, t],
                                                    B[:, t], rnu[:, t])
    return dz, nu, _ok(dz, nu) & (info == 0) & ok
