"""Ket and unitary rollouts: the ground-truth check of a solved trajectory.

Counterpart of quantumcollocation_tpu/dynamics/rollouts.py (ket and
unitary parts, the "expm" rollout integrator).  A rollout always runs in
float64: it validates the solver, and the solver's own float32 must not
leak into the check.  Batched over a leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quantum.fidelities import (
    iso_fidelity,
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
)
from .expm import expm_squaring

__all__ = [
    "rollout",
    "rollout_fidelity",
    "batched_ket_rollout_fidelity",
    "unitary_rollout",
    "unitary_rollout_fidelity",
    "batched_rollout_fidelity",
]


def _propagate(x0, controls, dts, system, order, num_squarings, device):
    """States x_t (..., T, 2N, c) from x0 (2N, c): knot t propagates
    t -> t+1 with exp(G(a_t) dt_t), float64."""
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.as_tensor(np.array(controls), **f64)
    dt = torch.as_tensor(np.array(dts), **f64)
    x = x0.to(**f64).expand(*a.shape[:-2], *x0.shape)
    X = system.generator(a[..., :-1, :]) * dt[..., :-1, None, None]
    Ps = expm_squaring(X, order=order, num_squarings=num_squarings)
    xs = [x]
    for t in range(Ps.shape[-3]):
        x = Ps[..., t, :, :] @ x
        xs.append(x)
    return torch.stack(xs, dim=-3)


def rollout(psi_iso_init, controls, dts, system, *, order=12, num_squarings=8, device="cpu"):
    """Ket rollout on iso kets.  controls (..., T, n_drives), dts (..., T);
    knot t propagates t -> t+1.  Returns (..., T, 2N) float64."""
    psi0 = torch.as_tensor(np.array(psi_iso_init), dtype=torch.float64)
    return _propagate(psi0[:, None], controls, dts, system, order, num_squarings,
                      device)[..., 0]


def unitary_rollout(
    U_iso_vec_init, controls, dts, system, *, order=12, num_squarings=8,
    device="cpu",
):
    """Unitary rollout on iso vecs.  controls (..., T, n_drives), dts
    (..., T); knot t propagates t -> t+1.  Returns (..., T, 2N^2) float64."""
    v0 = torch.as_tensor(np.array(U_iso_vec_init), dtype=torch.float64)
    N = int(round((v0.shape[-1] / 2) ** 0.5))
    Us = _propagate(v0.reshape(N, 2 * N).T, controls, dts, system, order, num_squarings,
                    device)
    return Us.transpose(-1, -2).reshape(*Us.shape[:-2], -1)


def batched_ket_rollout_fidelity(
    controls, dts, system, psi_goal_iso, psi_init_iso, *, device="cpu"
):
    """Ket rollout fidelity |<goal|psi_T>|^2 for a batch: controls
    (B, T, n_drives), dts (B, T).  Returns a (B,) float64 numpy array."""
    psis = rollout(psi_init_iso, controls, dts, system, device=device)
    goal = torch.as_tensor(np.asarray(psi_goal_iso), dtype=torch.float64, device=device)
    return iso_fidelity(psis[..., -1, :], goal).cpu().numpy()


def batched_rollout_fidelity(
    controls, dts, system, U_goal_iso_vec, U_init_iso_vec, *, subspace=None, phases=None,
    phase_operators=None, device="cpu"
):
    """Rollout fidelity for a batch: controls (B, T, n_drives), dts (B, T),
    on the subspace block where one is given; with phases (B, k) and
    phase_operators, up to each instance's global phases
    exp(i Σ_k φ_k G_k).  Returns a (B,) float64 numpy array."""
    Us = unitary_rollout(U_init_iso_vec, controls, dts, system, device=device)
    goal = torch.as_tensor(np.asarray(U_goal_iso_vec), dtype=torch.float64, device=device)
    if phases is None:
        fid = iso_vec_unitary_fidelity(Us[..., -1, :], goal, subspace=subspace)
    else:
        fid = iso_vec_unitary_free_phase_fidelity(
            Us[..., -1, :], goal,
            torch.as_tensor(np.array(phases), dtype=torch.float64, device=device),
            phase_operators, subspace=subspace)
    return fid.cpu().numpy()


def rollout_fidelity(traj, system, *, state_name="ψ̃", drive_name="a"):
    """Ground-truth ket fidelity of a trajectory by rollout (float)."""
    return float(
        batched_ket_rollout_fidelity(
            traj[drive_name], traj.get_timesteps(), system,
            traj.goal[state_name], traj.initial[state_name],
        )
    )


def unitary_rollout_fidelity(traj, system, *, state_name="Ũ⃗", drive_name="a", subspace=None,
                             phases=None, phase_operators=None):
    """Ground-truth unitary fidelity of a trajectory by rollout (float), on
    the subspace block where one is given; with phases (k,) and
    phase_operators, up to the global phases exp(i Σ_k φ_k G_k)."""
    return float(
        batched_rollout_fidelity(
            traj[drive_name], traj.get_timesteps(), system,
            traj.goal[state_name], traj.initial[state_name], subspace=subspace,
            phases=phases, phase_operators=phase_operators,
        )
    )
