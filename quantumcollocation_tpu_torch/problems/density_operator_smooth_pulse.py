"""DensityOperatorSmoothPulseProblem: open-system (Lindblad) pulse design.

Counterpart of
quantumcollocation_tpu/problems/density_operator_smooth_pulse.py.  The
state ρ⃗̃ is the iso vec of a density matrix on an OpenQuantumSystem; the
goal is |ψ⟩⟨ψ| of a goal ket.  Decision variables (ρ⃗̃, a, da, dda, Δt);
minimize Q (1 - ⟨ψ|ρ_T|ψ⟩) + (1/2) Σ (R_a a² + R_da da² + R_dda dda²)
subject to the Lindblad exponential dynamics, the derivative chain, equal
timesteps and box bounds.  The density integrator has no analytic
assembly, so the solver takes the AD route (solver/stage_nlp.py).  The
JAX package leaves out the leakage branch of the template it follows (it
reads an undefined variable there), and so does the port.
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import DensityOperatorExponentialIntegrator, DerivativeIntegrator
from ..objectives.objectives import (
    DensityOperatorPureStateInfidelityObjective,
    QuadraticRegularizer,
)
from ..quantum.systems import OpenQuantumSystem
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.initialization import initialize_density_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem

__all__ = ["DensityOperatorSmoothPulseProblem"]


def _fan_out(value, n):
    return np.broadcast_to(np.asarray(value, dtype=float), (n,)).copy()


def DensityOperatorSmoothPulseProblem(
    system: OpenQuantumSystem,
    rho_init,
    psi_goal,
    T,
    dt,
    *,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "ρ⃗̃",
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
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Build the open-system transfer problem on `device` (None = CUDA; see
    problems/problem.py).  rho_init is a density matrix, or a ket, which
    becomes |ψ⟩⟨ψ|; psi_goal is normalized."""
    if not isinstance(system, OpenQuantumSystem):
        raise TypeError("DensityOperatorSmoothPulseProblem requires an OpenQuantumSystem")
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])

    psi_goal = np.asarray(psi_goal, dtype=complex)
    psi_goal = psi_goal / np.linalg.norm(psi_goal)
    rho_init = np.asarray(rho_init, dtype=complex)
    if rho_init.ndim == 1:
        rho_init = np.outer(rho_init, rho_init.conj())
    rho_goal = np.outer(psi_goal, psi_goal.conj())

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
        traj = initialize_density_trajectory(
            rho_init, rho_goal, T, dt, n_drives, (a_bounds, da_bounds, dda_bounds),
            state_name=state_name, free_time=piccolo_options.free_time,
            rollout_integrator=piccolo_options.rollout_integrator,
            dt_bounds=(dt_min, dt_max), drive_derivative_sigma=drive_derivative_sigma,
            a_guess=a_guess, system=system, control_name=control_name,
            timestep_name=timestep_name, rng=rng,
        )

    J = DensityOperatorPureStateInfidelityObjective(state_name, psi_goal, Q=Q, traj=traj)
    control_names = [name for name in traj.names if name.endswith(control_name)]
    J = J + QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J = J + QuadraticRegularizer(control_names[2], traj, R_dda)
    J, traj = apply_piccolo_options(J, constraints, piccolo_options, traj, [state_name],
                                    timestep_name)

    integrators = [
        DensityOperatorExponentialIntegrator(state_name, control_name, system,
                                             timestep_name=timestep_name),
        DerivativeIntegrator(control_names[0], control_names[1], timestep_name=timestep_name),
        DerivativeIntegrator(control_names[1], control_names[2], timestep_name=timestep_name),
    ]
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=system,
        device=device,
    )
