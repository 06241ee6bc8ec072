"""Multi-goal batched unitary synthesis: many different target gates solved
in lockstep by one solver.

Counterpart of quantumcollocation_tpu/problems/multigoal.py.  For a
full-space goal G the change of variables W_t = U_t G† leaves the dynamics
as they are (W_{t+1} = Φ_t W_t), turns the objective into the infidelity
against the identity (|tr(G† U_T)| = |tr(W_T)|), and moves the goal into
the pinned initial condition W_0 = G†.  Pinned coordinates (free_mask
False) keep each batch row's own value through the solve
(solver/ipm.py init_state and the step's masking), so one solver, with its
NLP scaling computed once at the identity goal, advances instances with
distinct goals.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..dynamics.rollouts import unitary_rollout
from ..quantum.isomorphisms import operator_to_iso_vec
from .unitary_smooth_pulse import UnitarySmoothPulseProblem

__all__ = [
    "UnitaryMultiGoalProblem",
    "multigoal_initial_decisions",
    "multigoal_rollout_fidelities",
    "random_su",
]


def random_su(n: int, rng) -> np.ndarray:
    """Haar-distributed SU(n) sample (QR of a complex Ginibre matrix with
    phase fixing); the JAX package's draws, in its order."""
    z = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, r = np.linalg.qr(z)
    q = q * (np.diagonal(r) / np.abs(np.diagonal(r))).conj()[None, :]
    det = np.linalg.det(q)
    return q * det ** (-1.0 / n)


def UnitaryMultiGoalProblem(system, T, dt, **kwargs):
    """Identity-goal UnitarySmoothPulseProblem whose batch rows carry their
    own goals through multigoal_initial_decisions; takes the
    UnitarySmoothPulseProblem keywords (device among them)."""
    N = system.levels
    return UnitarySmoothPulseProblem(system, np.eye(N, dtype=complex), T, dt, **kwargs)


def multigoal_initial_decisions(
    prob, goals, *, n_seeds_per_goal: int = 1, sigma: float = 0.1, rng=None,
    unitary_name: str = "Ũ⃗", control_name: str = "a",
):
    """(len(goals) * n_seeds_per_goal, T, d) numpy initial decisions;
    instance b = goal_index * n_seeds_per_goal + seed_index.

    Seed 0 of each goal follows the geodesic W_t = expm(s_t logm(G)) G†
    from W_0 = G† to the identity; the other seeds get sigma-perturbed
    controls (clipped to their bounds) and the float64 rollout of those
    controls from W_0 = G†, so every seed starts feasible.  The draws are
    the JAX package's, in its order."""
    rng = rng or np.random.default_rng(0)
    traj = prob.trajectory
    T = traj.T
    z0 = prob.initial_decision(1)[0]
    u_sl = traj.comp_slice(unitary_name)
    a_sl = traj.comp_slice(control_name)

    B = len(goals) * n_seeds_per_goal
    rows = np.broadcast_to(z0, (B, *z0.shape)).copy()
    ts = np.linspace(0.0, 1.0, T)
    W0_iso = np.zeros((len(goals), u_sl.stop - u_sl.start))
    for gi, G in enumerate(goals):
        G = np.asarray(G, dtype=complex)
        W0 = G.conj().T
        W0_iso[gi] = operator_to_iso_vec(W0)
        H = sla.logm(G)
        path = np.stack([operator_to_iso_vec(sla.expm(s * H) @ W0) for s in ts])
        lo = gi * n_seeds_per_goal
        rows[lo:lo + n_seeds_per_goal, :, u_sl] = path[None]
    a = rows[:, :, a_sl]
    pert = sigma * rng.standard_normal(a[:, 1:-1].shape)
    mask = np.ones(B, dtype=bool)
    mask[::n_seeds_per_goal] = False
    a[mask, 1:-1] += pert[mask]
    if control_name in traj.bounds:
        lo_b, hi_b = traj.bounds[control_name]
        a = np.clip(a, lo_b[None, None, :], hi_b[None, None, :])
    rows[:, :, a_sl] = a

    if n_seeds_per_goal > 1:
        dts = np.asarray(traj.get_timesteps(), dtype=np.float64)
        for gi in range(len(goals)):
            lo = gi * n_seeds_per_goal
            seeds = slice(lo + 1, lo + n_seeds_per_goal)
            rows[seeds, :, u_sl] = unitary_rollout(
                W0_iso[gi], a[seeds], np.broadcast_to(dts, (n_seeds_per_goal - 1, T)),
                prob.system,
            ).numpy()
    return rows


def multigoal_rollout_fidelities(
    prob, Z, goals, *, n_seeds_per_goal: int = 1, unitary_name: str = "Ũ⃗",
    control_name: str = "a",
):
    """Host float64 check: per instance, the controls rolled forward under
    the true dynamics (expm by eigh of each knot's Hamiltonian) and scored
    |tr(G† U_T)| / N against the instance's own goal.  Returns (B,)."""
    traj = prob.trajectory
    sysq = prob.system
    a_sl = traj.comp_slice(control_name)
    Z = np.asarray(Z, dtype=np.float64)
    B, T, _ = Z.shape
    a = Z[:, :, a_sl]
    if isinstance(traj.timestep, str):
        dts = Z[:, :, traj.comp_slice(traj.timestep)][:, :, 0]
    else:
        dts = np.full((B, T), float(traj.timestep))

    H_drift = np.asarray(sysq.H_drift, dtype=complex)
    H_drives = np.stack([np.asarray(h, dtype=complex) for h in sysq.H_drives])
    N = H_drift.shape[0]
    H = H_drift[None, None] + np.einsum("btj,jkl->btkl", a[:, :-1], H_drives)
    w, V = np.linalg.eigh(H)
    phase = np.exp(-1j * w * dts[:, :-1, None])
    P = np.einsum("btij,btj,btkj->btik", V, phase, V.conj())

    U = np.broadcast_to(np.eye(N, dtype=complex), (B, N, N)).copy()
    for t in range(T - 1):
        U = P[:, t] @ U
    goals = np.asarray(goals, dtype=complex)
    Gd = np.repeat(goals.conj().transpose(0, 2, 1), n_seeds_per_goal, axis=0)
    return np.abs(np.einsum("bij,bji->b", Gd, U)) / N
