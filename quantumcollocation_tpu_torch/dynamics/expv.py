"""Krylov (Arnoldi) action of the matrix exponential: exp(t A) b.

Counterpart of quantumcollocation_tpu/dynamics/expv.py.  `expv_krylov`
projects onto a static m-dimensional Krylov basis (one DGKS
reorthogonalization per column; a happy breakdown zeroes the basis rows
after it instead of ending early), exponentiates the small (m, m)
Hessenberg matrix densely and maps back, in `substeps` time substeps.  A
may be a matrix or a matvec, so a Lindblad superoperator can act through
N x N matmuls (OpenQuantumSystem.lindblad_action) instead of a dense
(2N², 2N²) row.  Real arithmetic, with any leading batch axes on b (and
on t and A), each instance its own basis.
"""

from __future__ import annotations

import torch

from .expm import expm_taylor

__all__ = ["expv_krylov"]


def _arnoldi_expv_step(matvec, v, dt, m):
    """exp(dt A) v for v (..., n) by Arnoldi with a static m-row basis;
    dt a scalar or a (...) tensor."""
    n = v.shape[-1]
    finfo = torch.finfo(v.dtype)
    beta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    V = v.new_zeros(*v.shape[:-1], m, n)
    V[..., 0, :] = v / beta.clamp_min(finfo.tiny)
    H = v.new_zeros(*v.shape[:-1], m + 1, m)
    rows = torch.arange(m, device=v.device)
    for j in range(m):
        w = matvec(V[..., j, :])
        mask = (rows <= j).to(v.dtype)
        # Gram-Schmidt against the rows so far (rows past j are zero), then
        # one reorthogonalization pass
        h = (V @ w.unsqueeze(-1)).squeeze(-1) * mask
        w = w - (h.unsqueeze(-2) @ V).squeeze(-2)
        h2 = (V @ w.unsqueeze(-1)).squeeze(-1) * mask
        w = w - (h2.unsqueeze(-2) @ V).squeeze(-2)
        hnext = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        H[..., :m, j] = h + h2
        H[..., j + 1, j] = hnext[..., 0]
        w = torch.where(hnext > 1e3 * finfo.eps, w / hnext.clamp_min(finfo.tiny),
                        torch.zeros_like(w))
        if j + 1 < m:
            V[..., j + 1, :] = w
    dt = torch.as_tensor(dt, dtype=v.dtype, device=v.device)
    E = expm_taylor(dt[..., None, None] * H[..., :m, :])
    return beta * (E[..., :, 0].unsqueeze(-2) @ V).squeeze(-2)


def expv_krylov(t, A, b, *, m: int = 24, substeps: int = 1, matvec=None):
    """exp(t A) @ b without forming exp(t A).

    t: a scalar, or a (...) tensor of times, one per instance of b;
    A: (..., n, n) matrix, or None when matvec is given;
    b: (..., n) real vector;
    m: the static Krylov dimension (24 reaches ~1e-12 for ||t A|| up to
       ~10 a substep);
    substeps: the static number of time substeps;
    matvec: v -> A v on (..., n), for operators too large to materialize.
    The Hessenberg exponential is expm_taylor's (matmuls only, within
    float64 rounding of scipy's expm up to ||X|| = 60)."""
    mv = matvec if matvec is not None else (lambda x: (A @ x.unsqueeze(-1)).squeeze(-1))
    dt = torch.as_tensor(t, dtype=b.dtype, device=b.device) / int(substeps)
    y = b
    for _ in range(int(substeps)):
        y = _arnoldi_expv_step(mv, y, dt, int(m))
    return y
