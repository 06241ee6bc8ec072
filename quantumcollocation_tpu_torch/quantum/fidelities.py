"""Ket and unitary fidelities in iso coordinates, in real arithmetic.

Counterpart of quantumcollocation_tpu/quantum/fidelities.py::fidelity,
iso_fidelity and iso_vec_unitary_fidelity.  The iso functions work on
torch tensors (the objective path, differentiable under torch.func) and on
numpy arrays.  A `subspace` restricts the unitary fidelities to the block
U[idx, idx] and divides by len(idx); on tensors it is a gather by an index
tensor (pass one built once on the tensors' device on a hot path).
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


def unitary_fidelity(U, U_goal, subspace=None):
    """|tr(U_goal^† U)| / n for complex numpy operators, on the subspace
    block where one is given."""
    U = np.asarray(U)
    U_goal = np.asarray(U_goal)
    if subspace is not None:
        idx = np.asarray(subspace)
        U = U[..., idx[:, None], idx[None, :]]
        U_goal = U_goal[..., idx[:, None], idx[None, :]]
    tr = np.trace(np.swapaxes(U_goal.conj(), -1, -2) @ U, axis1=-2, axis2=-1)
    return np.abs(tr) / U.shape[-1]


def _iso_vec_reim(v, subspace=None):
    """iso vec (..., 2N^2) -> (Re U, Im U), restricted to the subspace
    block where one is given."""
    Uo = iso_vec_to_iso_operator(v)
    n = Uo.shape[-1]
    Ure, Uim = Uo[..., :n, :], Uo[..., n:, :]
    if subspace is None:
        return Ure, Uim
    if isinstance(Ure, torch.Tensor):
        idx = torch.as_tensor(subspace, dtype=torch.long, device=Ure.device)
        return tuple(x.index_select(-2, idx).index_select(-1, idx) for x in (Ure, Uim))
    idx = np.asarray(subspace)
    return Ure[..., idx[:, None], idx[None, :]], Uim[..., idx[:, None], idx[None, :]]


def iso_vec_unitary_fidelity(U_iso_vec, U_goal_iso_vec, subspace=None):
    """|tr(G^† U)| / n on iso vecs: tr(G^† U) = sum(Gre Ure + Gim Uim)
    + i sum(Gre Uim - Gim Ure), over the subspace block (n = its size)
    where one is given."""
    Ure, Uim = _iso_vec_reim(U_iso_vec, subspace)
    Gre, Gim = _iso_vec_reim(U_goal_iso_vec, subspace)
    n = Ure.shape[-1]
    re = (Gre * Ure + Gim * Uim).sum((-2, -1))
    im = (Gre * Uim - Gim * Ure).sum((-2, -1))
    return _safe_abs(re, im) / n
