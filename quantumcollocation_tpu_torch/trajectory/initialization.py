"""Initial guesses for unitary, ket and density trajectories (host numpy,
build time only).

Counterpart of quantumcollocation_tpu/trajectory/initialization.py:
unitary geodesic (or linear) state guess, ket or density linear
interpolation, or any of these states' rollout under a given control
guess, plus random bounded
controls or the derivative chain of a given guess.  An EmbeddedOperator
goal takes its geodesic in the subspace, embedded back with the identity
on the leakage levels.  With phase_operators, the trajectory carries the
global variable phase_name, π·N(0, 1) for each operator.  Randomness comes
from a numpy Generator, drawn in the same order as the JAX package (the
phases before the controls), so both packages build the same trajectory
from one seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.linalg as sla

from ..dynamics.rollouts import open_rollout, rollout, unitary_rollout
from ..quantum.embedded import EmbeddedOperator, embed, unembed
from ..quantum.isomorphisms import density_to_iso_vec, ket_to_iso, operator_to_iso_vec
from .named_trajectory import NamedTrajectory, derivative

__all__ = [
    "unitary_geodesic",
    "linear_interpolation",
    "initialize_control_trajectory",
    "initialize_trajectory",
    "initialize_unitary_trajectory",
    "initialize_state_trajectory",
    "initialize_density_trajectory",
]


def linear_interpolation(x, y, samples: int):
    """(samples, k) linear interpolation between two vectors."""
    ts = np.linspace(0.0, 1.0, samples)[:, None]
    return (1 - ts) * np.asarray(x)[None, :] + ts * np.asarray(y)[None, :]


def _geodesic_unitaries(U_init, U_goal, samples):
    times = np.linspace(0.0, 1.0, samples)
    U_init = np.asarray(U_init, dtype=complex)
    U_goal = np.asarray(U_goal, dtype=complex)
    H = 1j * sla.logm(U_goal @ U_init.conj().T) / (times[-1] - times[0])
    H = (H + H.conj().T) / 2
    return [sla.expm(-1j * H * t) @ U_init for t in times]


def unitary_geodesic(U_init, U_goal, *, samples: int):
    """(samples, 2N^2) iso-vec rows of exp(-i H t) U_init with
    H = i log(U_goal U_init^†), t in [0, 1]; for an EmbeddedOperator goal,
    the subspace blocks' geodesic embedded back."""
    if isinstance(U_goal, EmbeddedOperator):
        Us = _geodesic_unitaries(unembed(U_init, U_goal), unembed(U_goal.operator, U_goal),
                                 samples)
        Us = [embed(U, U_goal) for U in Us]
    else:
        Us = _geodesic_unitaries(U_init, U_goal, samples)
    return np.stack([operator_to_iso_vec(U) for U in Us])


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
    phase_name: str = "ϕ",
    phase_data=None,
    rng=None,
) -> NamedTrajectory:
    """States first, then the control chain (random, or that of a_guess),
    then the timestep (free time); pins a = 0 at both ends and the states
    at t = 0; phase_data, where given, is the global variable
    phase_name."""
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
        global_data={} if phase_data is None else {phase_name: np.asarray(phase_data)},
    )


def initialize_unitary_trajectory(
    U_goal, T: int, dt, n_drives: int, control_bounds, *,
    state_name: str = "Ũ⃗", U_init=None, a_guess=None, system=None,
    geodesic: bool = True, phase_name: str = "ϕ", phase_operators=None,
    rollout_integrator: str = "expm", rng=None, **kwargs,
) -> NamedTrajectory:
    """Geodesic (or linear) unitary state guess with random controls, or
    the rollout of a_guess (T, n_drives) under system's dynamics with
    a_guess's control chain.  An EmbeddedOperator goal starts from the
    identity of all its levels and has its full operator as the goal.
    With phase_operators, the global variable phase_name holds π·N(0, 1)
    for each, drawn from rng (else default_rng(0)) before the controls."""
    goal_op = np.asarray(
        U_goal.operator if isinstance(U_goal, EmbeddedOperator) else U_goal, dtype=complex)
    if U_init is None:
        U_init = np.eye(goal_op.shape[0], dtype=complex)
    v_init = operator_to_iso_vec(np.asarray(U_init))
    v_goal = operator_to_iso_vec(goal_op)
    if a_guess is not None:
        if system is None:
            raise ValueError("a system is needed to roll out a_guess")
        if rollout_integrator != "expm":
            raise NotImplementedError(
                f"rollout integrator {rollout_integrator!r}: the port rolls out with expm"
            )
        dts = np.full((T,), float(dt)) if np.isscalar(dt) else np.asarray(dt).reshape(-1)
        U_traj = unitary_rollout(v_init, np.asarray(a_guess), dts, system).numpy()
    elif geodesic:
        U_traj = unitary_geodesic(U_init, U_goal, samples=T)
    else:
        U_traj = linear_interpolation(v_init, v_goal, T)
    phase_data = None
    if phase_operators is not None:
        phase_data = np.pi * (rng or np.random.default_rng(0)).standard_normal(
            len(phase_operators))
    return initialize_trajectory(
        [U_traj], [v_init], [v_goal], [state_name], T, dt, n_drives,
        control_bounds, a_guess=a_guess, phase_name=phase_name, phase_data=phase_data,
        rng=rng, **kwargs,
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


def initialize_density_trajectory(
    rho_init, rho_goal, T: int, dt, n_drives: int, control_bounds, *,
    state_name: str = "ρ⃗̃", a_guess=None, system=None, rollout_integrator: str = "expm",
    rng=None, **kwargs,
) -> NamedTrajectory:
    """Density trajectory: the linear interpolation between the iso vecs of
    rho_init and rho_goal, or the open rollout of a_guess (T, n_drives)
    under system's dynamics ("expm" or "expv"), with random controls drawn
    from rng (else default_rng(0)) or a_guess's control chain."""
    v_init = density_to_iso_vec(np.asarray(rho_init, dtype=complex))
    v_goal = density_to_iso_vec(np.asarray(rho_goal, dtype=complex))
    if a_guess is None:
        data = linear_interpolation(v_init, v_goal, T)
    else:
        if system is None:
            raise ValueError("a system is needed to roll out a_guess")
        dts = np.full((T,), float(dt)) if np.isscalar(dt) else np.asarray(dt).reshape(-1)
        data = open_rollout(v_init, np.asarray(a_guess), dts, system,
                            integrator=rollout_integrator).numpy()
    return initialize_trajectory(
        [data], [v_init], [v_goal], [state_name], T, dt, n_drives, control_bounds,
        a_guess=a_guess, rng=rng, **kwargs,
    )
