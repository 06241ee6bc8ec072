"""QuantumStateSmoothPulseProblem: the ket state-transfer template.

Counterpart of quantumcollocation_tpu/problems/quantum_state_smooth_pulse.py.
One or more (init, goal) ket pairs share one control pulse: one
QuantumStateObjective and one ket integrator per pair, the states named
ψ̃ alone or ψ̃1, ψ̃2, ... for several.  Decision variables (ψ̃…, a, da, dda,
Δt); minimize Q Σ (1 - |<goal|ψ_T>|²) + (1/2) Σ (R_a a² + R_da da² +
R_dda dda²) subject to Padé (or exponential) ket dynamics, the derivative
chain, equal timesteps and box bounds.
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import (
    DerivativeIntegrator,
    QuantumStateExponentialIntegrator,
    QuantumStatePadeIntegrator,
)
from ..objectives.objectives import QuadraticRegularizer, QuantumStateObjective
from ..quantum.systems import QuantumSystem
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.initialization import initialize_state_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem

__all__ = ["QuantumStateSmoothPulseProblem"]


def _fan_out(value, n):
    return np.broadcast_to(np.asarray(value, dtype=float), (n,)).copy()


def _as_list(x):
    x = np.asarray(x)
    return [x] if x.ndim == 1 else [np.asarray(v) for v in x]


def QuantumStateSmoothPulseProblem(
    system,
    psi_inits=None,
    psi_goals=None,
    T=None,
    dt=None,
    *args,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "ψ̃",
    control_name: str = "a",
    timestep_name: str = "Δt",
    init_trajectory=None,
    a_bound: float = 1.0,
    a_bounds=None,
    a_guess=None,
    da_bound: float = np.inf,
    da_bounds=None,
    dda_bound: float = 1.0,
    dda_bounds=None,
    dt_min: float | None = None,
    dt_max: float | None = None,
    drive_derivative_sigma: float = 0.01,
    Q: float = 100.0,
    R: float = 1e-2,
    R_a=None,
    R_da=None,
    R_dda=None,
    constraints=None,
    state_leakage_indices=None,
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Build the ket state-transfer problem on `device` (None = CUDA; see
    problems/problem.py).  Takes (system, psi_init, psi_goal, T, dt) with
    single kets or lists of kets, or the matrix-pair overload (H_drift,
    H_drives, psi_init, psi_goal, T, dt)."""
    if not isinstance(system, QuantumSystem):
        system = QuantumSystem(system, list(psi_inits))
        psi_inits, psi_goals, T, dt = psi_goals, T, dt, args[0]
        args = args[1:]
    if args:
        raise TypeError(f"unexpected positional arguments {args}")
    if state_leakage_indices is not None:
        raise NotImplementedError("leakage suppression is not ported yet")
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])
    psi_inits, psi_goals = _as_list(psi_inits), _as_list(psi_goals)
    if len(psi_inits) != len(psi_goals):
        raise ValueError(f"{len(psi_inits)} initial kets for {len(psi_goals)} goals")

    n_drives = system.n_drives
    a_bounds = _fan_out(a_bound if a_bounds is None else a_bounds, n_drives)
    da_bounds = _fan_out(da_bound if da_bounds is None else da_bounds, n_drives)
    dda_bounds = _fan_out(dda_bound if dda_bounds is None else dda_bounds, n_drives)
    dt_mean = float(np.mean(dt))
    dt_min = 0.5 * dt_mean if dt_min is None else dt_min
    dt_max = 1.5 * dt_mean if dt_max is None else dt_max
    R_a = R if R_a is None else R_a
    R_da = R if R_da is None else R_da
    R_dda = R if R_dda is None else R_dda

    traj = init_trajectory
    if traj is None:
        traj = initialize_state_trajectory(
            psi_goals, psi_inits, T, dt, n_drives, (a_bounds, da_bounds, dda_bounds),
            state_name=state_name, free_time=piccolo_options.free_time,
            rollout_integrator=piccolo_options.rollout_integrator,
            dt_bounds=(dt_min, dt_max), bound_state=piccolo_options.bound_state,
            drive_derivative_sigma=drive_derivative_sigma, a_guess=a_guess, system=system,
            control_name=control_name, timestep_name=timestep_name, rng=rng,
        )
    state_names = [n for n in traj.names if n.startswith(state_name)]

    J = None
    for name in state_names:
        term = QuantumStateObjective(name, traj, Q)
        J = term if J is None else J + term
    control_names = [name for name in traj.names if name.endswith(control_name)]
    J = J + QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J = J + QuadraticRegularizer(control_names[2], traj, R_dda)
    J, traj = apply_piccolo_options(J, constraints, piccolo_options, traj, timestep_name)

    integrators = []
    for name in state_names:
        if piccolo_options.integrator == "pade":
            integrators.append(QuantumStatePadeIntegrator(
                name, control_name, system, order=piccolo_options.pade_order,
                timestep_name=timestep_name,
            ))
        elif piccolo_options.integrator == "exponential":
            integrators.append(QuantumStateExponentialIntegrator(
                name, control_name, system, drive_bounds=a_bounds,
                dt_max=dt_max if piccolo_options.free_time else dt_mean,
                timestep_name=timestep_name,
            ))
        else:
            raise ValueError("integrator must be 'pade' or 'exponential'")
    integrators += [
        DerivativeIntegrator(control_names[0], control_names[1], timestep_name=timestep_name),
        DerivativeIntegrator(control_names[1], control_names[2], timestep_name=timestep_name),
    ]
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=system,
        device=device,
    )
