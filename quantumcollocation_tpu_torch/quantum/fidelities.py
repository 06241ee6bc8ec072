"""Ket and unitary fidelities in iso coordinates, in real arithmetic.

Counterpart of quantumcollocation_tpu/quantum/fidelities.py::fidelity,
iso_fidelity and iso_vec_unitary_fidelity.  The iso functions work on
torch tensors (the objective path, differentiable under torch.func) and on
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .isomorphisms import iso_vec_to_iso_operator

__all__ = ["fidelity", "iso_fidelity", "unitary_fidelity", "iso_vec_unitary_fidelity"]


def _safe_abs(re, im):
    """sqrt(re^2 + im^2) with a zero (sub)gradient at the origin, where a
    plain sqrt would give NaN derivatives (the identity start of a Hadamard
    synthesis has tr(H^† I) = 0)."""
    sq = re**2 + im**2
    if isinstance(sq, torch.Tensor):
        pos = sq > 0
        r = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
        return torch.where(pos, r, torch.zeros_like(r))
    return np.sqrt(sq)


def fidelity(psi, psi_goal):
    """|<psi_goal|psi>|^2 for complex numpy kets."""
    return np.abs(np.vdot(np.asarray(psi_goal), np.asarray(psi))) ** 2


def iso_fidelity(psi_iso, psi_goal_iso):
    """|<goal|psi>|^2 on iso kets (..., 2N): <goal|psi> = (gre - i gim) ·
    (pre + i pim)."""
    n = psi_iso.shape[-1] // 2
    pre, pim = psi_iso[..., :n], psi_iso[..., n:]
    gre, gim = psi_goal_iso[..., :n], psi_goal_iso[..., n:]
    re = (gre * pre + gim * pim).sum(-1)
    im = (gre * pim - gim * pre).sum(-1)
    return re**2 + im**2


def unitary_fidelity(U, U_goal):
    """|tr(U_goal^† U)| / n for complex numpy operators."""
    U = np.asarray(U)
    U_goal = np.asarray(U_goal)
    tr = np.trace(np.swapaxes(U_goal.conj(), -1, -2) @ U, axis1=-2, axis2=-1)
    return np.abs(tr) / U.shape[-1]


def iso_vec_unitary_fidelity(U_iso_vec, U_goal_iso_vec):
    """|tr(G^† U)| / n on iso vecs: tr(G^† U) = sum(Gre Ure + Gim Uim)
    + i sum(Gre Uim - Gim Ure)."""
    Uo = iso_vec_to_iso_operator(U_iso_vec)
    Go = iso_vec_to_iso_operator(U_goal_iso_vec)
    n = Uo.shape[-1]
    Ure, Uim = Uo[..., :n, :], Uo[..., n:, :]
    Gre, Gim = Go[..., :n, :], Go[..., n:, :]
    re = (Gre * Ure + Gim * Uim).sum((-2, -1))
    im = (Gre * Uim - Gim * Ure).sum((-2, -1))
    return _safe_abs(re, im) / n
