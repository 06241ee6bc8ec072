"""UnitaryRobustnessProblem: first-order robustness against an error
Hamiltonian under a final-fidelity floor.

Counterpart of quantumcollocation_tpu/problems/unitary_robustness.py.  The
first-order Magnus cost ||Σ_t dt_t U_t† H_e U_t||² / (N T_total)² does not
separate over knots, so an accumulator state M (`m_rob`, an iso-vec, M_0 =
0) carries the sum through a RobustnessAccumulatorIntegrator's defect rows
and the cost is a terminal cost on M_T; T_total is the duration of the
trajectory the problem is built from, fixed at build time.  A
FinalUnitaryFidelityConstraint keeps the fidelity at `final_fidelity`
(by default the trajectory's current one; with phase_operators the
free-phase floor on the global phases, as the minimum-time template's).
The accumulator has no analytic assembly, so the NLP takes the AD route
(solver/stage_nlp.py).
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import RobustnessAccumulatorIntegrator
from ..objectives.objectives import Objective, ObjectiveTerm
from ..quantum.embedded import EmbeddedOperator
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.named_trajectory import NamedTrajectory
from .problem import QuantumControlProblem
from .unitary_minimum_time import fidelity_floor, warm_start_parts

__all__ = ["UnitaryRobustnessProblem"]


def UnitaryRobustnessProblem(
    H_error,
    trajectory,
    system=None,
    objective=None,
    integrators=None,
    constraints=None,
    *,
    unitary_name: str = "Ũ⃗",
    control_name: str = "a",
    final_fidelity: float | None = None,
    phase_name: str = "ϕ",
    phase_operators=None,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    subspace=None,
    accumulator_name: str = "m_rob",
    device=None,
) -> QuantumControlProblem:
    """Two call forms, as the JAX package's:

    UnitaryRobustnessProblem(H_error, traj, system, objective, integrators,
                             constraints; ...)
    UnitaryRobustnessProblem(H_error, prob[, system]; ...)   # warm start,
                                                             # on prob's device
    """
    if isinstance(trajectory, QuantumControlProblem):
        (system, objective, integrators, constraints, ipopt_options, piccolo_options,
         trajectory, warm_device) = warm_start_parts(
            trajectory, system, objective, integrators, constraints, ipopt_options,
            piccolo_options)
        device = warm_device if device is None else device
    if not isinstance(trajectory, NamedTrajectory) or unitary_name not in trajectory.names:
        raise ValueError(f"a NamedTrajectory with a {unitary_name!r} component is needed")
    constraints = list(constraints or [])
    integrators = list(integrators or [])
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    H_e = np.asarray(H_error.operator if isinstance(H_error, EmbeddedOperator) else H_error)

    # the trajectory with the accumulator M appended, zero and pinned at t = 0
    n2 = trajectory.comp_size(unitary_name)
    comps = {n: np.asarray(trajectory[n]) for n in trajectory.names}
    comps[accumulator_name] = np.zeros((trajectory.T, n2))
    initial = dict(trajectory.initial)
    initial[accumulator_name] = np.zeros(n2)
    traj = NamedTrajectory(
        comps, controls=trajectory.controls, timestep=trajectory.timestep,
        bounds=dict(trajectory.bounds), initial=initial, final=dict(trajectory.final),
        goal=dict(trajectory.goal), global_data=dict(trajectory.global_data),
    )
    integrators.append(RobustnessAccumulatorIntegrator(
        state_name=unitary_name, accumulator_name=accumulator_name,
        control_name=control_name, H_error=H_e,
    ))

    # terminal robustness cost ||M_T||² / (N T_total)²
    N = int(round((n2 / 2) ** 0.5))
    scale = 1.0 / (N * max(float(trajectory.duration()), 1e-12)) ** 2
    start, stop = traj.components[accumulator_name]

    def make(dtype, device):
        def fn(zT, globals_=None):
            m = zT[start:stop]
            return scale * (m * m).sum()

        return fn

    objective = objective + Objective((ObjectiveTerm("terminal", make, 1.0,
                                                     "unitary_robustness"),))
    constraints.append(fidelity_floor(trajectory, unitary_name, final_fidelity, subspace,
                                      phase_name, phase_operators))
    return QuantumControlProblem(
        traj, objective, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=system,
        device=device,
    )
