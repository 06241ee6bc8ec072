"""Propagator-derivative bank over (instance, knot) pairs.

Replaces the Pallas kernel quantumcollocation_tpu/ops/pallas_prop_bank.py
::_bank_kernel (entry prop_bank_lanes) by a hand-written CUDA kernel,
csrc/prop_bank.cu, for every pair at once, X = G(a)Δt: for the Padé kind
N = q(X), D = q(-X) with first and second θ-derivatives; for the
exponential kind P = exp(X) with its derivatives, by the same Padé step on
X/2^s, a Gauss-Jordan inverse of D and s squarings.  The solver runs it
once per iteration when the fused assembly is off (the two-qubit sizes,
where the bank does not fit one thread's registers), and once per solve
for the multiplier initialisation's Jacobian.

`prop_bank_reference` is the plain PyTorch version (the batched
pade_poly_frechet / expm_frechet_bank of dynamics/expm.py).  `prop_bank`
takes it only for CPU tensors; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..dynamics.expm import expm_frechet_bank, frechet_pairs, pade_coefficients, pade_poly_frechet
from . import build

__all__ = ["prop_bank", "prop_bank_reference", "prop_bank_cuda", "run_library", "bank_config",
           "set_signatures"]

# what the library returns for an n it has no kernel for (csrc/prop_bank.cu,
# QCT_SIZES: n = 2, 4, 6, 8 and 18, any number of drives; n = 18, two
# coupled three-level transmons, takes the entry design only)
_NOT_SUPPORTED = 801  # cudaErrorNotSupported


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def prop_bank_reference(a, dt, G_drift, G_drives, *, kind, order, num_squarings=0,
                        free_dt, second_order):
    """Plain version.  a (M, na), dt (M,); G_drift (n, n), G_drives
    (na, n, n).  Returns, with leading axis M, (N, dN, d2N, D, dD, d2D) for
    kind "pade" and (P, dP, d2P) for "exp"; the second-order entries are
    None unless second_order."""
    Gd, Gs = _as(G_drift, a), _as(G_drives, a)
    na = Gs.shape[0]
    G = Gd + torch.tensordot(a, Gs, dims=1)
    X = G * dt[:, None, None]
    dX = Gs * dt[:, None, None, None]
    if free_dt:
        dX = torch.cat([dX, G.unsqueeze(-3)], dim=-3)
    d2X = None
    if second_order and free_dt:
        zero = torch.zeros_like(Gd)
        d2X = torch.stack([
            Gs[k] if (k < na and l == na) else zero for (k, l) in frechet_pairs(na + 1)
        ])
    if kind == "exp":
        return expm_frechet_bank(X, dX, d2X, order=order, num_squarings=num_squarings,
                                 second_order=second_order)
    return pade_poly_frechet(X, dX, d2X, order=order, second_order=second_order)


_COEFFS: dict = {}


def _coeffs(order, device):
    """The Padé coefficients as a float32 device tensor, made once."""
    key = (order, device)
    if key not in _COEFFS:
        _COEFFS[key] = torch.tensor(pade_coefficients(order), dtype=torch.float32, device=device)
    return _COEFFS[key]


def set_signatures(lib):
    """Sets the C signature of qct_prop_bank in a prop_bank.cu library
    (this tree's, or another build of it); returns lib."""
    lib.qct_prop_bank.restype = ctypes.c_int
    lib.qct_prop_bank.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p] * 7
    return lib


@functools.cache
def _lib():
    """This tree's library, its C signatures set once."""
    lib = set_signatures(build.library("prop_bank"))
    lib.qct_prop_bank_config.restype = ctypes.c_int
    lib.qct_prop_bank_config.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _check(err, n):
    if err == _NOT_SUPPORTED:
        raise NotImplementedError(f"prop_bank has no kernel for n={n}")
    build.check(err, "prop_bank")


def bank_config(n, na, free_dt, second_order, kind):
    """Launch configuration of the kernel for n x n generators, na drives
    and a free Δt or not: threads per pair, pairs per block, shared bytes
    per block, and the design ("strip" up to a few drives, "entry" past
    them and at n = 18; csrc/prop_bank.cu)."""
    out = (ctypes.c_int * 4)()
    _check(_lib().qct_prop_bank_config(n, na, int(free_dt), int(second_order),
                                       int(kind == "exp"), out), n)
    return dict(threads_per_pair=out[0], pairs_per_block=out[1], shared_bytes_per_block=out[2],
                design="strip" if out[3] else "entry")


def run_library(lib, a, dt, G_drift, G_drives, *, kind, order, num_squarings=0, free_dt,
                second_order):
    """Launch qct_prop_bank of `lib` (set_signatures done) on contiguous
    float32 CUDA tensors; outputs as prop_bank_reference, allocated here."""
    M, na = a.shape
    n = G_drift.shape[0]
    coeffs = _coeffs(order, a.device)
    K = na + int(free_dt)
    Kp = K * (K + 1) // 2 if second_order else 0
    shapes = [(M, n, n), (M, K, n, n), (M, Kp, n, n) if second_order else None]
    if kind == "pade":
        shapes *= 2
    new = dict(dtype=torch.float32, device=a.device)
    outs = [None if sh is None else torch.empty(sh, **new) for sh in shapes]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.qct_prop_bank(
        a.data_ptr(), dt.data_ptr(), G_drift.data_ptr(), G_drives.data_ptr(), coeffs.data_ptr(),
        coeffs.numel(), M, n, na, K, Kp, int(free_dt), int(kind == "exp"),
        int(num_squarings) if kind == "exp" else 0,
        *[ptr(x) for x in outs + [None] * (6 - len(outs))],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _check(err, n)
    return tuple(outs)


def prop_bank_cuda(a, dt, G_drift, G_drives, *, kind, order, num_squarings=0,
                   free_dt, second_order):
    """Launch csrc/prop_bank.cu on float32 CUDA tensors a (M, na), dt (M,);
    outputs as prop_bank_reference."""
    if kind not in ("pade", "exp"):
        raise ValueError(f"kind {kind!r} is not 'pade' or 'exp'")
    if order < 2:
        raise ValueError(f"Padé order {order} < 2")
    if not (a.is_cuda and dt.is_cuda):
        raise ValueError("prop_bank_cuda needs CUDA tensors")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError("prop_bank_cuda takes float32")
    M, na = a.shape
    n = G_drift.shape[0]
    if tuple(dt.shape) != (M,) or tuple(G_drives.shape) != (na, n, n):
        raise ValueError(f"shapes a {tuple(a.shape)} dt {tuple(dt.shape)} G_drives "
                         f"{tuple(G_drives.shape)} do not fit")
    Gd, Gs = _as(G_drift, a).contiguous(), _as(G_drives, a).contiguous()
    outs = run_library(_lib(), a.contiguous(), dt.contiguous(), Gd, Gs, kind=kind, order=order,
                       num_squarings=num_squarings, free_dt=free_dt, second_order=second_order)
    build.launch_counts["prop_bank"] += 1
    return outs


def prop_bank(a, dt, G_drift, G_drives, **kw):
    """The bank: the kernel for CUDA tensors, the plain version for CPU
    tensors (keywords as prop_bank_reference)."""
    if a.is_cuda:
        return prop_bank_cuda(a, dt, G_drift, G_drives, **kw)
    return prop_bank_reference(a, dt, G_drift, G_drives, **kw)
