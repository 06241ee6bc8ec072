"""Convenience fidelity accessors.

Counterpart of quantumcollocation_tpu/utils/losses.py.  The package root
star-imports this module last, so `quantumcollocation_tpu_torch.fidelity`
is this problem-or-trajectory `fidelity`, as in the JAX package; the ket
overlap stays `quantumcollocation_tpu_torch.quantum.fidelity`.
"""

from __future__ import annotations

import torch

from ..dynamics.expv import expv_krylov
from ..dynamics.rollouts import rollout_fidelity, unitary_rollout_fidelity

__all__ = ["fidelity", "expv"]


def fidelity(prob_or_traj, system=None, **kwargs):
    """Float64 rollout fidelity of a problem or a trajectory.

    fidelity(prob)          -> prob.trajectory under prob.system
    fidelity(traj, system)  -> the given system
    Dispatches on the trajectory's first state component: a unitary (Ũ⃗*)
    through unitary_rollout_fidelity, else a ket (ψ̃*) through
    rollout_fidelity; kwargs go to that function."""
    if hasattr(prob_or_traj, "trajectory"):
        traj = prob_or_traj.trajectory
        system = system or prob_or_traj.system
    else:
        traj = prob_or_traj
    if system is None:
        raise ValueError("a system is required")
    unitary_names = [n for n in traj.names if n.startswith("Ũ⃗")]
    if unitary_names:
        return unitary_rollout_fidelity(traj, system, state_name=unitary_names[0], **kwargs)
    ket_names = [n for n in traj.names if n.startswith("ψ̃")]
    if ket_names:
        return rollout_fidelity(traj, system, state_name=ket_names[0], **kwargs)
    raise ValueError("no unitary or ket state component found")


def expv(t, A, b, *, m: int = 24, substeps: int = 2, matvec=None):
    """exp(t A) @ b by the Krylov action (dynamics/expv.py::expv_krylov),
    never forming exp(t A); A a matrix, or None with matvec (v -> A v) for
    an operator too large to materialize, such as
    OpenQuantumSystem.lindblad_action.  Numpy inputs run in float64 on the
    CPU."""
    b = torch.as_tensor(b, dtype=b.dtype if torch.is_tensor(b) else torch.float64)
    if A is not None:
        A = torch.as_tensor(A, dtype=b.dtype, device=b.device)
    return expv_krylov(t, A, b, m=m, substeps=substeps, matvec=matvec)
