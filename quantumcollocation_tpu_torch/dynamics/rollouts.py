"""Unitary rollouts: the ground-truth check of a solved trajectory.

Counterpart of quantumcollocation_tpu/dynamics/rollouts.py (unitary part).
A rollout always runs in float64: it validates the solver, and the solver's
own float32 must not leak into the check.  Batched over a leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quantum.fidelities import iso_vec_unitary_fidelity
from .expm import expm_squaring

__all__ = ["unitary_rollout", "unitary_rollout_fidelity", "batched_rollout_fidelity"]


def unitary_rollout(
    U_iso_vec_init, controls, dts, system, *, order=12, num_squarings=8,
    device="cpu",
):
    """Unitary rollout on iso vecs.  controls (..., T, n_drives), dts
    (..., T); knot t propagates t -> t+1.  Returns (..., T, 2N^2) float64."""
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.as_tensor(np.array(controls), **f64)
    dt = torch.as_tensor(np.array(dts), **f64)
    v0 = torch.as_tensor(np.array(U_iso_vec_init), **f64)
    N = int(round((v0.shape[-1] / 2) ** 0.5))
    U = v0.reshape(N, 2 * N).T.expand(*a.shape[:-2], 2 * N, N)
    X = system.generator(a[..., :-1, :]) * dt[..., :-1, None, None]
    Ps = expm_squaring(X, order=order, num_squarings=num_squarings)
    Us = [U]
    for t in range(Ps.shape[-3]):
        U = Ps[..., t, :, :] @ U
        Us.append(U)
    Us = torch.stack(Us, dim=-3)
    return Us.transpose(-1, -2).reshape(*Us.shape[:-2], -1)


def batched_rollout_fidelity(
    controls, dts, system, U_goal_iso_vec, U_init_iso_vec, *, device="cpu"
):
    """Rollout fidelity for a batch: controls (B, T, n_drives), dts (B, T).
    Returns a (B,) float64 numpy array."""
    Us = unitary_rollout(U_init_iso_vec, controls, dts, system, device=device)
    goal = torch.as_tensor(np.asarray(U_goal_iso_vec), dtype=torch.float64, device=device)
    return iso_vec_unitary_fidelity(Us[..., -1, :], goal).cpu().numpy()


def unitary_rollout_fidelity(traj, system, *, state_name="Ũ⃗", drive_name="a"):
    """Ground-truth unitary fidelity of a trajectory by rollout (float)."""
    return float(
        batched_rollout_fidelity(
            traj[drive_name], traj.get_timesteps(), system,
            traj.goal[state_name], traj.initial[state_name],
        )
    )
