"""Initial guesses for unitary and ket trajectories (host numpy, build
time only).

Counterpart of quantumcollocation_tpu/trajectory/initialization.py:
unitary geodesic (or linear) state guess, ket linear interpolation (or a
rollout under a given control guess), plus random bounded controls or the
derivative chain of a given guess.  Randomness comes from a numpy
Generator, drawn in the same order as the JAX package, so both packages
build the same trajectory from one seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.linalg as sla

from ..dynamics.rollouts import rollout
from ..quantum.isomorphisms import ket_to_iso, operator_to_iso_vec
from .named_trajectory import NamedTrajectory, derivative

__all__ = [
    "unitary_geodesic",
    "linear_interpolation",
    "initialize_control_trajectory",
    "initialize_trajectory",
    "initialize_unitary_trajectory",
    "initialize_state_trajectory",
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


def _control_chain(a_guess, dts, n_derivatives: int):
    """[a, da, ...] from a guess a (T, n_drives): forward differences, each
    but the last with its end row fixed so the last derivative-chain
    defect holds at the start."""
    controls = [np.array(a_guess, dtype=float)]
    for n in range(1, n_derivatives + 1):
        controls.append(derivative(controls[-1], dts))
        if n > 1:
            controls[-2][-1] = controls[-2][-2] + dts[-2] * controls[-1][-2]
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
    a_guess=None,
    rng=None,
) -> NamedTrajectory:
    """States first, then the control chain (random, or that of a_guess),
    then the timestep (free time); pins a = 0 at both ends and the states
    at t = 0."""
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
    if a_guess is None:
        a_values = initialize_control_trajectory(
            n_drives, n_der, T, control_bounds[0], drive_derivative_sigma, rng=rng
        )
    else:
        a_values = _control_chain(a_guess, dts, n_der)
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


def initialize_state_trajectory(
    psi_goals, psi_inits, T: int, dt, n_drives: int, control_bounds, *,
    state_name: str = "ψ̃", state_names=None, a_guess=None, system=None,
    rollout_integrator: str = "expm", rng=None, **kwargs,
) -> NamedTrajectory:
    """Ket trajectory: one state per (init, goal) pair, named state_name
    alone or auto-numbered ψ̃1, ψ̃2, ... for several; the linear
    interpolation of each pair, or its rollout under a_guess."""
    if state_names is None:
        state_names = (
            [state_name] if len(psi_goals) == 1
            else [f"{state_name}{i + 1}" for i in range(len(psi_goals))]
        )
    iso_inits = [ket_to_iso(np.asarray(p, dtype=complex)) for p in psi_inits]
    iso_goals = [ket_to_iso(np.asarray(p, dtype=complex)) for p in psi_goals]
    dts = np.full((T,), float(dt)) if np.isscalar(dt) else np.asarray(dt).reshape(-1)
    if a_guess is not None:
        if system is None:
            raise ValueError("a system is needed to roll out a_guess")
        if rollout_integrator != "expm":
            raise NotImplementedError(
                f"rollout integrator {rollout_integrator!r}: the port rolls out with expm"
            )
        states = [rollout(i0, np.asarray(a_guess), dts, system).numpy() for i0 in iso_inits]
    else:
        states = [linear_interpolation(i0, g0, T) for i0, g0 in zip(iso_inits, iso_goals)]
    return initialize_trajectory(
        states, iso_inits, iso_goals, state_names, T, dt, n_drives, control_bounds,
        a_guess=a_guess, rng=rng, **kwargs,
    )
