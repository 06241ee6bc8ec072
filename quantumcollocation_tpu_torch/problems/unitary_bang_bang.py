"""UnitaryBangBangProblem: an L1 penalty on the control derivative drives
the pulse towards bang-bang (piecewise-constant) shapes.

Counterpart of quantumcollocation_tpu/problems/unitary_bang_bang.py.
Decision variables (U_iso_vec, a, da, Δt) with one derivative level; the
objective is Q·infidelity + (1/2) Σ (R_a a² + R_da da²) + Σ_t Σ_i
R_bang_bang_i |da_i(t)|, the last through L1 slack rows (an
`L1Regularizer` on da, per-drive weights); R_da defaults to 0, since the
L1 term takes the place of the quadratic smoothing.  Padé (or
exponential) dynamics on a, DerivativeIntegrator(a, da), equal timesteps
and box bounds.  With phase_operators the infidelity is taken up to the
global phases exp(i Σ_k φ_k G_k), as in the smooth-pulse template.
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import (
    DerivativeIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from ..objectives.objectives import (
    L1Regularizer,
    QuadraticRegularizer,
    UnitaryFreePhaseInfidelityObjective,
    UnitaryInfidelityObjective,
)
from ..quantum.embedded import EmbeddedOperator, get_iso_vec_leakage_indices
from ..quantum.systems import QuantumSystem
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.initialization import initialize_unitary_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem
from .unitary_smooth_pulse import _fan_out

__all__ = ["UnitaryBangBangProblem"]


def UnitaryBangBangProblem(
    system,
    operator=None,
    T=None,
    dt=None,
    *args,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "Ũ⃗",
    control_name: str = "a",
    timestep_name: str = "Δt",
    init_trajectory=None,
    a_bound: float = 1.0,
    a_bounds=None,
    a_guess=None,
    da_bound: float = 1.0,
    da_bounds=None,
    dt_min: float | None = None,
    dt_max: float | None = None,
    Q: float = 100.0,
    R: float = 1e-2,
    R_a=None,
    R_da=0.0,
    R_bang_bang=1e-1,
    phase_name: str = "ϕ",
    phase_operators=None,
    constraints=None,
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Two call forms, as the JAX package's:

    UnitaryBangBangProblem(system, operator, T, dt; ...)
    UnitaryBangBangProblem(H_drift, H_drives, operator, T, dt; ...)

    on `device` (None = CUDA; see problems/problem.py)."""
    if not isinstance(system, QuantumSystem):
        H_drift, H_drives = system, operator
        system = QuantumSystem(H_drift, list(H_drives))
        operator, T, dt = T, dt, args[0]
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])
    n_drives = system.n_drives
    a_bounds = _fan_out(a_bound if a_bounds is None else a_bounds, n_drives)
    da_bounds = _fan_out(da_bound if da_bounds is None else da_bounds, n_drives)
    dt_mean = float(np.mean(dt))
    dt_min = 0.5 * dt_mean if dt_min is None else dt_min
    dt_max = 1.5 * dt_mean if dt_max is None else dt_max
    R_a = R if R_a is None else R_a

    traj = init_trajectory
    if traj is None:
        traj = initialize_unitary_trajectory(
            operator, T, dt, n_drives, (a_bounds, da_bounds),
            state_name=state_name, control_name=control_name,
            timestep_name=timestep_name, free_time=piccolo_options.free_time,
            dt_bounds=(dt_min, dt_max), geodesic=piccolo_options.geodesic,
            rollout_integrator=piccolo_options.rollout_integrator,
            bound_state=piccolo_options.bound_state, a_guess=a_guess, system=system,
            phase_name=phase_name, phase_operators=phase_operators, rng=rng,
        )
    embedded = isinstance(operator, EmbeddedOperator)
    subspace = operator.subspace if embedded else None
    if phase_operators is None:
        J = UnitaryInfidelityObjective(state_name, traj, Q, subspace=subspace)
    else:
        J = UnitaryFreePhaseInfidelityObjective(
            state_name, phase_name, phase_operators, traj, Q, subspace=subspace,
            eval_hessian=piccolo_options.eval_hessian)
    control_names = [name for name in traj.names if name.endswith(control_name)]
    J = J + QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J_l1, traj = L1Regularizer(constraints, control_names[1], traj,
                               R=_fan_out(R_bang_bang, n_drives))
    J = J + J_l1
    J, traj = apply_piccolo_options(
        J, constraints, piccolo_options, traj, state_name, timestep_name,
        state_leakage_indices=get_iso_vec_leakage_indices(operator) if embedded else None,
    )

    if piccolo_options.integrator == "pade":
        unitary_integrator = UnitaryPadeIntegrator(
            state_name, control_names[0], system, order=piccolo_options.pade_order,
            timestep_name=timestep_name,
        )
    elif piccolo_options.integrator == "exponential":
        unitary_integrator = UnitaryExponentialIntegrator(
            state_name, control_names[0], system, drive_bounds=a_bounds,
            dt_max=dt_max if piccolo_options.free_time else dt_mean,
            timestep_name=timestep_name,
        )
    else:
        raise ValueError("integrator must be 'pade' or 'exponential'")
    integrators = [
        unitary_integrator,
        DerivativeIntegrator(control_names[0], control_names[1], timestep_name=timestep_name),
    ]
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=system,
        device=device,
    )
