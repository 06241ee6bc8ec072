"""Block-tridiagonal KKT factorization and solve (stage-wise Riccati),
batched over a leading instance axis.

Counterpart of quantumcollocation_tpu/solver/kkt.py.  Solves

    [[H̄, J^T], [J, -δ_c I]] [Δz; ν] = [rz; rnu]

for every instance, where H̄ is block-tridiagonal (H_t diagonal, C_t
coupling) and J block-bidiagonal (A_t, B_t).  Shapes with the batch first:
H (B, T, d, d), C (B, T-1, d, d), A/B (B, T-1, s, d), rz (B, T, d),
rnu (B, T-1, s).  Returns (Δz, ν, ok) with ok (B,) bool.  A right-hand
side of r columns, rz (B, T, d, r) and rnu (B, T-1, s, r), gives Δz
(B, T, d, r) and ν (B, T-1, s, r), as the JAX lanes solve does for the
L-BFGS [rz | U] system; one without the column axis comes back without it.

This is the plain version of the two sweep kernels (solver/kkt_lanes.py).
torch.linalg.cholesky raises on a matrix that is not positive definite
where jnp.linalg.cholesky returns NaN; cholesky_ex's `info` carries the
failure into `ok` instead, so the solver's δ_w retry loop sees the same
outcome as the JAX package's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = [
    "KKTFactors",
    "factor_kkt",
    "forward_rhs",
    "back_substitute",
    "terminal_solve",
    "solve_with_factors",
    "solve_kkt",
]


def _chol_solve(L, rhs):
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


class KKTFactors(NamedTuple):
    L_P: Any  # (B, T-1, d, d)
    L_S: Any  # (B, T-1, s, s)
    X_A: Any  # (B, T-1, d, s)
    G: Any  # (B, T-1, s, d)
    L_final: Any  # (B, d, d)
    C: Any
    A: Any
    B: Any
    ok: Any  # (B,) every Cholesky succeeded


def factor_kkt(H, C, A, B, delta_c) -> KKTFactors:
    """Forward elimination of the saddle matrix (no rhs)."""
    s = A.shape[-2]
    eye_s = torch.eye(s, dtype=H.dtype, device=H.device)
    P = H[:, 0]
    ok = torch.ones(H.shape[0], dtype=torch.bool, device=H.device)
    L_Ps, L_Ss, X_As, Gs = [], [], [], []
    for t in range(H.shape[1] - 1):
        C_t, A_t, B_t = C[:, t], A[:, t], B[:, t]
        L_P, info = torch.linalg.cholesky_ex(P)
        ok = ok & (info == 0)
        # P^-1 [A_t^T | C_t] in one pair of triangular solves
        X_A, X_C = _chol_solve(L_P, torch.cat([A_t.mT, C_t], -1)).split([s, C_t.shape[-1]], -1)
        L_S, info = torch.linalg.cholesky_ex(delta_c * eye_s + A_t @ X_A)
        ok = ok & (info == 0)
        G = A_t @ X_C - B_t
        P = H[:, t + 1] - C_t.mT @ X_C + G.mT @ _chol_solve(L_S, G)
        P = 0.5 * (P + P.mT)
        L_Ps.append(L_P)
        L_Ss.append(L_S)
        X_As.append(X_A)
        Gs.append(G)
    L_final, info = torch.linalg.cholesky_ex(P)
    ok = ok & (info == 0)
    return KKTFactors(
        torch.stack(L_Ps, 1), torch.stack(L_Ss, 1), torch.stack(X_As, 1),
        torch.stack(Gs, 1), L_final, C, A, B, ok,
    )


def _with_cols(rz, rnu):
    """(rz, rnu, single): the right-hand sides with a column axis, and
    whether the caller gave a single column without one."""
    single = rz.ndim == 3
    return (rz.unsqueeze(-1), rnu.unsqueeze(-1), True) if single else (rz, rnu, False)


def forward_rhs(fac: KKTFactors, rz, rnu):
    """Forward rhs elimination: the carried q_t for t < T-1, (B, T-1, d[, r]),
    and the terminal rhs q_{T-1}, (B, d[, r]); r columns where rz is
    (B, T, d, r) and rnu (B, T-1, s, r)."""
    rz, rnu, single = _with_cols(rz, rnu)
    q = rz[:, 0]
    qs = []
    for t in range(fac.L_P.shape[1]):
        x = _chol_solve(fac.L_P[:, t], q)
        y = _chol_solve(fac.L_S[:, t], fac.A[:, t] @ x - rnu[:, t])
        qs.append(q)
        q = rz[:, t + 1] - fac.C[:, t].mT @ x + fac.G[:, t].mT @ y
    qs = torch.stack(qs, 1)
    return (qs[..., 0], q[..., 0]) if single else (qs, q)


def back_substitute(fac: KKTFactors, qs, dz_last, rnu):
    """Reverse-time back substitution from dz_{T-1}: (dz (B, T, d[, r]),
    nu (B, T-1, s[, r])), with as many columns as qs."""
    single = qs.ndim == 3
    if single:
        qs, dz_last, rnu = qs.unsqueeze(-1), dz_last.unsqueeze(-1), rnu.unsqueeze(-1)
    dz_next = dz_last
    dzs, nus = [dz_next], []
    for t in reversed(range(fac.L_P.shape[1])):
        u = qs[:, t] - fac.C[:, t] @ dz_next
        v = rnu[:, t] - fac.B[:, t] @ dz_next
        x = _chol_solve(fac.L_P[:, t], u)
        y = _chol_solve(fac.L_S[:, t], fac.A[:, t] @ x - v)
        dz_next = x - fac.X_A[:, t] @ y
        dzs.append(dz_next)
        nus.append(y)
    dz, nu = torch.stack(dzs[::-1], 1), torch.stack(nus[::-1], 1)
    return (dz[..., 0], nu[..., 0]) if single else (dz, nu)


def terminal_solve(L_final, q_final):
    """dz_{T-1} = P_f^-1 q_{T-1} for q_final (B, d) or (B, d, r)."""
    if q_final.ndim == 2:
        return _chol_solve(L_final, q_final.unsqueeze(-1))[..., 0]
    return _chol_solve(L_final, q_final)


def solve_with_factors(fac: KKTFactors, rz, rnu):
    """Solve for a rhs against an existing factorization."""
    qs, q_final = forward_rhs(fac, rz, rnu)
    dz, nu = back_substitute(fac, qs, terminal_solve(fac.L_final, q_final), rnu)
    ok = (
        fac.ok
        & torch.isfinite(dz).flatten(1).all(1)
        & torch.isfinite(nu).flatten(1).all(1)
    )
    return dz, nu, ok


def solve_kkt(H, C, A, B, rz, rnu, delta_c):
    """Factor + solve the block-tridiagonal saddle system."""
    return solve_with_factors(factor_kkt(H, C, A, B, delta_c), rz, rnu)
