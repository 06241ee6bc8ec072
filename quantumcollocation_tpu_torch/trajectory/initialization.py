"""Initial guesses for unitary trajectories (host numpy, build time only).

Counterpart of quantumcollocation_tpu/trajectory/initialization.py:
unitary geodesic (or linear) state guess plus random bounded controls.
Randomness comes from a numpy Generator, drawn in the same order as the
JAX package, so both packages build the same trajectory from one seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.linalg as sla

from ..quantum.isomorphisms import operator_to_iso_vec
from .named_trajectory import NamedTrajectory

__all__ = [
    "unitary_geodesic",
    "linear_interpolation",
    "initialize_control_trajectory",
    "initialize_trajectory",
    "initialize_unitary_trajectory",
]


def linear_interpolation(x, y, samples: int):
    """(samples, k) linear interpolation between two vectors."""
    ts = np.linspace(0.0, 1.0, samples)[:, None]
    return (1 - ts) * np.asarray(x)[None, :] + ts * np.asarray(y)[None, :]


def unitary_geodesic(U_init, U_goal, *, samples: int):
    """(samples, 2N^2) iso-vec rows of exp(-i H t) U_init with
    H = i log(U_goal U_init^†), t in [0, 1]."""
    times = np.linspace(0.0, 1.0, samples)
    U_init = np.asarray(U_init, dtype=complex)
    U_goal = np.asarray(U_goal, dtype=complex)
    H = 1j * sla.logm(U_goal @ U_init.conj().T) / (times[-1] - times[0])
    H = (H + H.conj().T) / 2
    return np.stack(
        [operator_to_iso_vec(sla.expm(-1j * H * t) @ U_init) for t in times]
    )


def initialize_control_trajectory(
    n_drives: int, n_derivatives: int, T: int, bounds,
    drive_derivative_sigma: float = 0.1, *, rng=None,
):
    """[a, da, ..., d^n a], each (T, n_drives): a zero at the endpoints and
    uniform inside its bounds, derivatives Gaussian with sigma."""
    rng = rng or np.random.default_rng(0)
    if isinstance(bounds, tuple) and len(bounds) == 2 and not np.isscalar(bounds[0]):
        lo = np.asarray(bounds[0], dtype=float)
        hi = np.asarray(bounds[1], dtype=float)
    else:
        hi = np.broadcast_to(np.asarray(bounds, dtype=float), (n_drives,))
        lo = -hi
    a = np.zeros((T, n_drives))
    a[1:-1] = rng.uniform(
        np.where(np.isfinite(lo), lo, -1.0),
        np.where(np.isfinite(hi), hi, 1.0),
        size=(T - 2, n_drives),
    )
    controls = [a]
    for _ in range(n_derivatives):
        controls.append(rng.normal(size=(T, n_drives)) * drive_derivative_sigma)
    return controls


def initialize_trajectory(
    state_data: Sequence[np.ndarray],
    state_inits: Sequence[np.ndarray],
    state_goals: Sequence[np.ndarray],
    state_names: Sequence[str],
    T: int,
    dt,
    n_drives: int,
    control_bounds,
    *,
    bound_state: bool = False,
    free_time: bool = False,
    control_name: str = "a",
    zero_initial_and_final_derivative: bool = False,
    timestep_name: str = "Δt",
    dt_bounds=None,
    drive_derivative_sigma: float = 0.1,
    rng=None,
) -> NamedTrajectory:
    """States first, then the control chain, then the timestep (free
    time); pins a = 0 at both ends and the states at t = 0."""
    n_der = len(control_bounds) - 1
    control_names = [control_name] + [
        "d" * i + control_name for i in range(1, n_der + 1)
    ]
    dts = (
        np.full((T,), float(dt)) if np.isscalar(dt)
        else np.asarray(dt, dtype=float).reshape(-1)
    )
    if dt_bounds is None:
        dt_bounds = (0.5 * float(np.mean(dts)), 1.5 * float(np.mean(dts)))
    a_values = initialize_control_trajectory(
        n_drives, n_der, T, control_bounds[0], drive_derivative_sigma, rng=rng
    )
    components = dict(zip(state_names, state_data))
    components.update(zip(control_names, a_values))
    bounds = dict(zip(control_names, control_bounds))
    if bound_state:
        bounds.update({name: 1.0 for name in state_names})
    initial = dict(zip(state_names, state_inits))
    initial[control_name] = np.zeros(n_drives)
    final = {control_name: np.zeros(n_drives)}
    if zero_initial_and_final_derivative and n_der:
        initial[control_names[1]] = np.zeros(n_drives)
        final[control_names[1]] = np.zeros(n_drives)
    goal = dict(zip(state_names, state_goals))
    if free_time:
        components[timestep_name] = dts[:, None]
        bounds[timestep_name] = dt_bounds
        controls = (control_names[-1], timestep_name)
        timestep = timestep_name
    else:
        controls = (control_names[-1],)
        timestep = float(dts[0])
    return NamedTrajectory(
        components, controls=controls, timestep=timestep, bounds=bounds,
        initial=initial, final=final, goal=goal,
    )


def initialize_unitary_trajectory(
    U_goal, T: int, dt, n_drives: int, control_bounds, *,
    state_name: str = "Ũ⃗", U_init=None, geodesic: bool = True, rng=None,
    **kwargs,
) -> NamedTrajectory:
    """Geodesic (or linear) unitary state guess with random controls."""
    U_goal = np.asarray(U_goal, dtype=complex)
    if U_init is None:
        U_init = np.eye(U_goal.shape[0], dtype=complex)
    v_init = operator_to_iso_vec(np.asarray(U_init))
    v_goal = operator_to_iso_vec(U_goal)
    if geodesic:
        U_traj = unitary_geodesic(U_init, U_goal, samples=T)
    else:
        U_traj = linear_interpolation(v_init, v_goal, T)
    return initialize_trajectory(
        [U_traj], [v_init], [v_goal], [state_name], T, dt, n_drives,
        control_bounds, rng=rng, **kwargs,
    )
