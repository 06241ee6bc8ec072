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

import torch

from ..dynamics.expm import expm_frechet_bank, frechet_pairs, pade_coefficients, pade_poly_frechet
from . import build

__all__ = ["prop_bank", "prop_bank_reference", "prop_bank_cuda", "SUPPORTED_N"]

# matrix sizes the kernel is instantiated for (csrc/prop_bank.cu)
SUPPORTED_N = (2, 4, 6, 8)


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
    key = (order, str(device))
    if key not in _COEFFS:
        _COEFFS[key] = torch.tensor(pade_coefficients(order), dtype=torch.float32, device=device)
    return _COEFFS[key]


def prop_bank_cuda(a, dt, G_drift, G_drives, *, kind, order, num_squarings=0,
                   free_dt, second_order):
    """Launch csrc/prop_bank.cu on float32 CUDA tensors a (M, na), dt (M,);
    outputs as prop_bank_reference."""
    if kind not in ("pade", "exp"):
        raise ValueError(f"kind {kind!r} is not 'pade' or 'exp'")
    if not (a.is_cuda and dt.is_cuda):
        raise ValueError("prop_bank_cuda needs CUDA tensors")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError("prop_bank_cuda takes float32")
    M, na = a.shape
    n = G_drift.shape[0]
    if tuple(dt.shape) != (M,) or tuple(G_drives.shape) != (na, n, n):
        raise ValueError(f"shapes a {tuple(a.shape)} dt {tuple(dt.shape)} G_drives "
                         f"{tuple(G_drives.shape)} do not fit")
    if n not in SUPPORTED_N:
        raise NotImplementedError(f"n={n} not in {SUPPORTED_N}")
    a, dt = a.contiguous(), dt.contiguous()
    Gd, Gs = _as(G_drift, a).contiguous(), _as(G_drives, a).contiguous()
    coeffs = _coeffs(order, a.device)
    K = na + int(free_dt)
    Kp = len(frechet_pairs(K)) if second_order else 0
    new = dict(dtype=torch.float32, device=a.device)
    outs = [torch.empty(M, n, n, **new), torch.empty(M, K, n, n, **new),
            torch.empty(M, Kp, n, n, **new) if second_order else None]
    if kind == "pade":
        outs += [torch.empty_like(x) if x is not None else None for x in outs]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    fn = build.library("prop_bank").qct_prop_bank
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 7
    err = fn(
        a.data_ptr(), dt.data_ptr(), Gd.data_ptr(), Gs.data_ptr(), coeffs.data_ptr(),
        coeffs.numel(), M, n, na, K, Kp, int(free_dt), int(kind == "exp"),
        int(num_squarings) if kind == "exp" else 0,
        *[ptr(x) for x in outs + [None] * (6 - len(outs))],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "prop_bank")
    build.launch_counts["prop_bank"] += 1
    return tuple(outs)


def prop_bank(a, dt, G_drift, G_drives, **kw):
    """The bank: the kernel for CUDA tensors, the plain version for CPU
    tensors (keywords as prop_bank_reference)."""
    if a.is_cuda:
        return prop_bank_cuda(a, dt, G_drift, G_drives, **kw)
    return prop_bank_reference(a, dt, G_drift, G_drives, **kw)
