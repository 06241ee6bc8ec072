"""Compact limited-memory BFGS for the quasi-Newton IPM mode.

Counterpart of quantumcollocation_tpu/solver/lbfgs.py (the reference's
`eval_hessian=false`, Ipopt's `hessian_approximation=limited-memory`): the
Lagrangian Hessian is approximated by the compact representation

    B = sigma*I - U M^{-1} U^T,      U = [Y, sigma*S]  (n, 2m)
    M = [[-D,  L^T       ],          D = diag(s_i^T y_i)
         [ L,  sigma*S^T S]]         L_ij = s_i^T y_j (i > j, chronological)

(Byrd, Nocedal & Schnabel 1994).  The KKT solve keeps the sigma*I + barrier
base (stage-diagonal, C = 0) and applies the low-rank part by
Sherman-Morrison-Woodbury: one solve of the multi-column right-hand side
[rz | U] through the sweep kernels (solver/ipm.py).

The JAX functions are single-instance and the JAX IPM vmaps them; the port
does not vmap its IPM, so both functions here carry a leading batch axis.
Memory is a chronological shift buffer (index m-1 = newest); invalid slots
(fewer than m accepted pairs) carry zero U columns and identity rows in M.
"""

from __future__ import annotations

import torch

__all__ = ["lbfgs_update", "lbfgs_compact", "lbfgs_rhs"]


def lbfgs_update(S, Y, sty, count, s, y, *, eps: float = 1e-8):
    """Insert the curvature pair (s, y) of each instance that passes the
    positivity skip rule s^T y > eps * ||s||^2.

    S, Y: (B, m, n);  sty: (B, m);  count: (B,) int32;  s, y: (B, n).
    Returns (S, Y, sty, count, sigma, accepted) with sigma = y^T y / s^T y
    of the newest pair where accepted (the standard B0 scaling), else 0.
    """
    sy = (s * y).sum(-1)
    ss = (s * s).sum(-1)
    accept = sy > eps * torch.clamp_min(ss, 1e-300)
    a3 = accept[:, None, None]
    S = torch.where(a3, torch.cat([S[:, 1:], s[:, None]], 1), S)
    Y = torch.where(a3, torch.cat([Y[:, 1:], y[:, None]], 1), Y)
    sty = torch.where(accept[:, None], torch.cat([sty[:, 1:], sy[:, None]], 1), sty)
    count = torch.where(accept, torch.clamp_max(count + 1, S.shape[1]), count).to(torch.int32)
    sigma = torch.where(
        accept, (y * y).sum(-1) / torch.clamp_min(sy, 1e-300), torch.zeros_like(sy)
    )
    return S, Y, sty, count, sigma, accept


def lbfgs_compact(S, Y, sty, count, sigma):
    """The compact-form pieces (U, M) of B = sigma*I - U M^{-1} U^T.

    S, Y: (B, m, n) chronological (newest last); sty: (B, m); count: (B,)
    valid pairs (the LAST count slots); sigma: (B,) > 0.  Returns
    U (B, n, 2m) and M (B, 2m, 2m), invalid slots zeroed in U and given
    identity rows and columns in M (so they contribute nothing).
    """
    m = S.shape[1]
    idx = torch.arange(m, device=S.device)
    valid = idx[None] >= (m - count)[:, None]  # (B, m)
    Sv = S * valid[..., None]
    Yv = Y * valid[..., None]
    SY = Sv @ Yv.mT  # SY[b, i, j] = s_i . y_j
    STS = Sv @ Sv.mT
    L = torch.tril(SY, diagonal=-1)
    D = torch.diag_embed(torch.where(valid, sty, torch.ones_like(sty)))
    sig = sigma[:, None, None]
    M = torch.cat([torch.cat([-D, L.mT], 2), torch.cat([L, sig * STS], 2)], 1)
    valid2 = torch.cat([valid, valid], 1)
    mask = valid2[:, :, None] & valid2[:, None, :]
    M = torch.where(mask, M, torch.eye(2 * m, dtype=M.dtype, device=M.device))
    U = torch.cat([Yv, sig * Sv], 1).mT  # (B, n, 2m)
    return U, M


def lbfgs_rhs(rz, rnu, U):
    """The SMW solve's right-hand side [rz | U], [rnu | 0]: rz (B, T, d),
    rnu (B, T-1, s), U (B, T*d, 2m) -> (B, T, d, 1+2m), (B, T-1, s, 1+2m)."""
    Bt, T, d = rz.shape
    k2 = U.shape[-1]
    RZ = torch.cat([rz[..., None], U.reshape(Bt, T, d, k2)], -1).contiguous()
    RNU = torch.cat([rnu[..., None], rnu.new_zeros(*rnu.shape, k2)], -1)
    return RZ, RNU
