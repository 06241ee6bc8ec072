"""QuantumStateSamplingProblem: one pulse for kets of several systems.

Counterpart of quantumcollocation_tpu/problems/quantum_state_sampling.py.
The cross product of systems and (init, goal) ket pairs: the state of
pair i under system j is the component ψ̃i_system_j (ψ̃_system_j for one
pair), with its own weighted QuantumStateObjective and its own Padé or
exponential ket integrator; the controls, their derivatives and the
timestep are shared, by merging the per-system trajectories.  The defect
dimension grows with the pairs; each system is one propagator group of
the analytic assembly.
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import (
    DerivativeIntegrator,
    QuantumStateExponentialIntegrator,
    QuantumStatePadeIntegrator,
)
from ..objectives.objectives import QuadraticRegularizer, QuantumStateObjective
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.directsums import merge as merge_trajs
from ..trajectory.initialization import initialize_state_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem

__all__ = ["QuantumStateSamplingProblem"]


def _fan_out(value, n):
    return np.broadcast_to(np.asarray(value, dtype=float), (n,)).copy()


def _as_list(x):
    x = np.asarray(x)
    return [x] if x.ndim == 1 else [np.asarray(v) for v in x]


def QuantumStateSamplingProblem(
    systems,
    psi_inits,
    psi_goals,
    T,
    dt,
    *,
    system_weights=None,
    init_trajectory=None,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "ψ̃",
    control_name: str = "a",
    timestep_name: str = "Δt",
    constraints=None,
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
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Build the problem on `device` (None = CUDA; see problems/problem.py).
    psi_inits and psi_goals are one ket or a list of kets, shared by every
    system.  The per-system trajectories draw from one numpy Generator
    (`rng`, default_rng(0)) in system order, as the JAX package's do, so
    both build the same trajectory."""
    systems = list(systems)
    n_sys = len(systems)
    system_weights = [1.0] * n_sys if system_weights is None else list(system_weights)
    psi_inits, psi_goals = _as_list(psi_inits), _as_list(psi_goals)
    if len(psi_inits) != len(psi_goals):
        raise ValueError(f"{len(psi_inits)} initial kets for {len(psi_goals)} goals")
    n_states = len(psi_inits)
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])

    n_drives = systems[0].n_drives
    a_bounds = _fan_out(a_bound if a_bounds is None else a_bounds, n_drives)
    da_bounds = _fan_out(da_bound if da_bounds is None else da_bounds, n_drives)
    dda_bounds = _fan_out(dda_bound if dda_bounds is None else dda_bounds, n_drives)
    dt_mean = float(np.mean(dt))
    dt_min = 0.5 * dt_mean if dt_min is None else dt_min
    dt_max = 1.5 * dt_mean if dt_max is None else dt_max
    R_a = R if R_a is None else R_a
    R_da = R if R_da is None else R_da
    R_dda = R if R_dda is None else R_dda

    def sname(i, j):
        base = state_name if n_states == 1 else f"{state_name}{i + 1}"
        return f"{base}_system_{j + 1}"

    if init_trajectory is not None:
        traj = init_trajectory
    else:
        rng = rng or np.random.default_rng(0)
        trajs = [
            initialize_state_trajectory(
                psi_goals, psi_inits, T, dt, sys.n_drives, (a_bounds, da_bounds, dda_bounds),
                state_names=[sname(i, j) for i in range(n_states)],
                free_time=piccolo_options.free_time,
                rollout_integrator=piccolo_options.rollout_integrator,
                dt_bounds=(dt_min, dt_max), bound_state=piccolo_options.bound_state,
                drive_derivative_sigma=drive_derivative_sigma, a_guess=a_guess, system=sys,
                control_name=control_name, timestep_name=timestep_name, rng=rng,
            )
            for j, sys in enumerate(systems)
        ]
        merge_names = {control_name: 1, "d" + control_name: 1, "dd" + control_name: 1}
        if piccolo_options.free_time:
            merge_names[timestep_name] = 1
        traj = merge_trajs(trajs, merge_names=merge_names)

    control_names = [n for n in traj.names if n.endswith(control_name)]
    all_state_names = [sname(i, j) for j in range(n_sys) for i in range(n_states)]
    J = QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J = J + QuadraticRegularizer(control_names[2], traj, R_dda)
    for j, weight in enumerate(system_weights):
        for i in range(n_states):
            J = J + weight * QuantumStateObjective(sname(i, j), traj, Q)
    J, traj = apply_piccolo_options(J, constraints, piccolo_options, traj, all_state_names,
                                    timestep_name)

    integrators = []
    for j, sys in enumerate(systems):
        for i in range(n_states):
            if piccolo_options.integrator == "pade":
                integrators.append(QuantumStatePadeIntegrator(
                    sname(i, j), control_name, sys, order=piccolo_options.pade_order,
                    timestep_name=timestep_name))
            elif piccolo_options.integrator == "exponential":
                integrators.append(QuantumStateExponentialIntegrator(
                    sname(i, j), control_name, sys, drive_bounds=a_bounds,
                    dt_max=dt_max if piccolo_options.free_time else dt_mean,
                    timestep_name=timestep_name))
            else:
                raise ValueError("integrator must be 'pade' or 'exponential'")
    integrators.append(DerivativeIntegrator(control_names[0], control_names[1],
                                            timestep_name=timestep_name))
    integrators.append(DerivativeIntegrator(control_names[1], control_names[2],
                                            timestep_name=timestep_name))
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=systems[0],
        device=device,
    )
