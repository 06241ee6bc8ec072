"""Ket and unitary fidelities in iso coordinates, in real arithmetic.

Counterpart of quantumcollocation_tpu/quantum/fidelities.py::fidelity,
iso_fidelity, iso_vec_unitary_fidelity, free_phase_iso_rotation and
iso_vec_unitary_free_phase_fidelity.  The iso functions work on
torch tensors (the objective path, differentiable under torch.func) and on
numpy arrays.  A `subspace` restricts the unitary fidelities to the block
U[idx, idx] and divides by len(idx); on tensors it is a gather by an index
tensor (pass one built once on the tensors' device on a hot path).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..dynamics.expm import expm_taylor
from .isomorphisms import iso_vec_to_iso_operator

__all__ = [
    "fidelity",
    "iso_fidelity",
    "unitary_fidelity",
    "iso_vec_unitary_fidelity",
    "free_phase_iso_rotation",
    "iso_vec_unitary_free_phase_fidelity",
]


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
    return _iso_operator_reim(iso_vec_to_iso_operator(v), subspace)


def _iso_operator_reim(Uo, subspace=None):
    """iso operator (..., 2N, N) -> (Re U, Im U), restricted to the
    subspace block where one is given."""
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
    return _trace_fidelity(_iso_vec_reim(U_iso_vec, subspace),
                           _iso_vec_reim(U_goal_iso_vec, subspace))


def _trace_fidelity(U, G):
    """|tr(G^† U)| / n from (Re, Im) pairs of n x n blocks."""
    (Ure, Uim), (Gre, Gim) = U, G
    re = (Gre * Ure + Gim * Uim).sum((-2, -1))
    im = (Gre * Uim - Gim * Ure).sum((-2, -1))
    return _safe_abs(re, im) / Ure.shape[-1]


def free_phase_iso_rotation(phases, phase_operators):
    """The real iso form (..., 2N, 2N) of R(φ) = exp(i Σ_k φ_k G_k) for
    phases (..., k): with Ā + i B̄ = Σ_k φ_k G_k, i(Ā + i B̄) has the iso
    generator K = [[-B̄, -Ā], [Ā, -B̄]], and exp(K) acts on [Re; Im]
    stacked columns.  phase_operators: a list or (k, N, N) array of
    complex matrices, or a complex tensor of them on the phases' device
    (build it once on a hot path).  Tensors go through expm_taylor (a
    fixed chain of matmuls, twice differentiable under torch.func, within
    float64 rounding of scipy's and JAX's expm for ||K|| up to 60), numpy
    arrays through scipy's expm.  (torch.linalg.matrix_exp is off by up
    to ~1e-10 near ||K|| ~ 0.05 in float64: scripts/free_phase_expm_probe.py.)"""
    if isinstance(phases, torch.Tensor):
        ops = (phase_operators if isinstance(phase_operators, torch.Tensor)
               else torch.as_tensor(_stack_ops(phase_operators), device=phases.device))
        A = ops.real.to(phases.dtype)
        B = ops.imag.to(phases.dtype)
        Abar = torch.tensordot(phases, A, dims=1)
        Bbar = torch.tensordot(phases, B, dims=1)
        K = torch.cat([torch.cat([-Bbar, -Abar], -1), torch.cat([Abar, -Bbar], -1)], -2)
        return expm_taylor(K)
    ops = _stack_ops(phase_operators)
    phases = np.asarray(phases, dtype=float)
    Abar = np.tensordot(phases, ops.real, axes=1)
    Bbar = np.tensordot(phases, ops.imag, axes=1)
    K = np.concatenate([np.concatenate([-Bbar, -Abar], -1),
                        np.concatenate([Abar, -Bbar], -1)], -2)
    return sla.expm(K)


def _stack_ops(phase_operators):
    """(k, N, N) complex numpy array of a list or array of operators."""
    if isinstance(phase_operators, (list, tuple)):
        return np.stack([np.asarray(op, dtype=complex) for op in phase_operators])
    return np.asarray(phase_operators, dtype=complex)


def iso_vec_unitary_free_phase_fidelity(U_iso_vec, U_goal_iso_vec, phases, phase_operators,
                                        subspace=None):
    """Fidelity up to the global phases R(φ) = exp(i Σ_k φ_k G_k):
    |tr(G^† R(φ) U)| / n, on the subspace block (n its size) where one is
    given; U (..., 2N²) with phases (..., k).  Real arithmetic."""
    R = free_phase_iso_rotation(phases, phase_operators)
    RU = R @ iso_vec_to_iso_operator(U_iso_vec)
    return _trace_fidelity(_iso_operator_reim(RU, subspace),
                           _iso_vec_reim(U_goal_iso_vec, subspace))
