"""Unitary fidelity in iso coordinates, in real arithmetic.

Counterpart of quantumcollocation_tpu/quantum/fidelities.py::
iso_vec_unitary_fidelity.  Works on torch tensors (the objective path,
differentiable under torch.func) and on numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .isomorphisms import iso_vec_to_iso_operator

__all__ = ["unitary_fidelity", "iso_vec_unitary_fidelity"]


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
