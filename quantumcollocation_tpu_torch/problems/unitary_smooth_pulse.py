"""UnitarySmoothPulseProblem: the gate-synthesis template.

Counterpart of quantumcollocation_tpu/problems/unitary_smooth_pulse.py.
Decision variables (U_iso_vec, a, da, dda, Δt); minimize Q·infidelity +
(1/2) Σ (R_a a² + R_da da² + R_dda dda²) subject to Padé (or exponential)
unitary dynamics, the derivative chain, equal timesteps and box bounds.
An EmbeddedOperator goal measures the infidelity on its subspace, and with
PiccoloOptions(leakage_suppression=True) adds R_leakage Σ |leakage
entries| through L1 slack rows (problems/_options.py).
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import (
    DerivativeIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from ..objectives.objectives import QuadraticRegularizer, UnitaryInfidelityObjective
from ..quantum.embedded import EmbeddedOperator, get_iso_vec_leakage_indices
from ..quantum.systems import QuantumSystem
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.initialization import initialize_unitary_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem

__all__ = ["UnitarySmoothPulseProblem"]


def _fan_out(value, n):
    return np.broadcast_to(np.asarray(value, dtype=float), (n,)).copy()


def UnitarySmoothPulseProblem(
    system,
    operator=None,
    T=None,
    dt=None,
    *,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "Ũ⃗",
    control_name: str = "a",
    timestep_name: str = "Δt",
    init_trajectory=None,
    a_bound: float = 1.0,
    a_bounds=None,
    a_guess=None,
    da_bound: float = np.inf,
    da_bounds=None,
    zero_initial_and_final_derivative: bool = False,
    dda_bound: float = 1.0,
    dda_bounds=None,
    dt_min: float | None = None,
    dt_max: float | None = None,
    Q: float = 100.0,
    R: float = 1e-2,
    R_a=None,
    R_da=None,
    R_dda=None,
    constraints=None,
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Build the smooth-pulse unitary gate-synthesis problem on `device`
    (None = CUDA; see problems/problem.py for the device and dtype rule).
    With a_guess (T, n_drives) the state starts as its rollout and the
    control chain as its differences."""
    if not isinstance(system, QuantumSystem):
        raise TypeError("system must be a QuantumSystem")
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])
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
        traj = initialize_unitary_trajectory(
            operator, T, dt, n_drives, (a_bounds, da_bounds, dda_bounds),
            state_name=state_name, control_name=control_name,
            timestep_name=timestep_name, free_time=piccolo_options.free_time,
            dt_bounds=(dt_min, dt_max),
            zero_initial_and_final_derivative=zero_initial_and_final_derivative,
            geodesic=piccolo_options.geodesic,
            rollout_integrator=piccolo_options.rollout_integrator,
            bound_state=piccolo_options.bound_state, a_guess=a_guess, system=system, rng=rng,
        )
    embedded = isinstance(operator, EmbeddedOperator)
    J = UnitaryInfidelityObjective(state_name, traj, Q,
                                   subspace=operator.subspace if embedded else None)
    control_names = [name for name in traj.names if name.endswith(control_name)]
    J = J + QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J = J + QuadraticRegularizer(control_names[2], traj, R_dda)
    J, traj = apply_piccolo_options(
        J, constraints, piccolo_options, traj, state_name, timestep_name,
        state_leakage_indices=get_iso_vec_leakage_indices(operator) if embedded else None,
    )

    if piccolo_options.integrator == "pade":
        unitary_integrator = UnitaryPadeIntegrator(
            state_name, control_name, system, order=piccolo_options.pade_order,
            timestep_name=timestep_name,
        )
    elif piccolo_options.integrator == "exponential":
        unitary_integrator = UnitaryExponentialIntegrator(
            state_name, control_name, system, drive_bounds=a_bounds,
            dt_max=dt_max if piccolo_options.free_time else dt_mean,
            timestep_name=timestep_name,
        )
    else:
        raise ValueError("integrator must be 'pade' or 'exponential'")
    integrators = [
        unitary_integrator,
        DerivativeIntegrator(control_names[0], control_names[1], timestep_name=timestep_name),
        DerivativeIntegrator(control_names[1], control_names[2], timestep_name=timestep_name),
    ]
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=system,
        device=device,
    )
