"""UnitaryMinimumTimeProblem: minimize the duration under a fidelity floor.

Counterpart of quantumcollocation_tpu/problems/unitary_minimum_time.py:
adds D Σ Δt to the objective and a FinalUnitaryFidelityConstraint at
`final_fidelity` (by default the trajectory's current fidelity; both on
the `subspace` block where one is given), with a
warm-start form from a solved problem.  Bounds and pins are trajectory
metadata, so a warm start keeps them.  The free-phase form
(phase_operators) needs global variables, which are not ported.
"""

from __future__ import annotations

import copy

import numpy as np

from ..objectives.constraints import FinalUnitaryFidelityConstraint
from ..objectives.objectives import MinimumTimeObjective
from ..quantum.fidelities import iso_vec_unitary_fidelity
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.named_trajectory import NamedTrajectory
from .problem import QuantumControlProblem

__all__ = ["UnitaryMinimumTimeProblem"]


def warm_start_parts(prob, system, objective, integrators, constraints, ipopt_options,
                     piccolo_options):
    """The arguments of a minimum-time template taken from a solved
    problem where the caller gave none."""
    return (
        system or prob.system,
        objective if objective is not None else prob.get_objective(),
        integrators if integrators is not None else prob.integrators,
        list(constraints) if constraints is not None else prob.get_constraints(),
        ipopt_options or copy.deepcopy(prob.ipopt_options),
        piccolo_options or copy.deepcopy(prob.piccolo_options),
        prob.trajectory.copy(),
        prob.device,
    )


def UnitaryMinimumTimeProblem(
    trajectory,
    system=None,
    objective=None,
    integrators=None,
    constraints=None,
    *,
    unitary_name: str = "Ũ⃗",
    control_name: str = "a",
    final_fidelity: float | None = None,
    D: float = 1.0,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    phase_name: str = "ϕ",
    phase_operators=None,
    subspace=None,
    device=None,
) -> QuantumControlProblem:
    """Two call forms, as the JAX package's:

    UnitaryMinimumTimeProblem(traj, system, objective, integrators, constraints; ...)
    UnitaryMinimumTimeProblem(prob[, system]; ...)   # warm start, on prob's device
    """
    if phase_operators is not None:
        raise NotImplementedError(
            "phase_operators (the free-phase fidelity floor) need global variables, "
            "which are not ported yet"
        )
    if isinstance(trajectory, QuantumControlProblem):
        (system, objective, integrators, constraints, ipopt_options, piccolo_options,
         trajectory, warm_device) = warm_start_parts(
            trajectory, system, objective, integrators, constraints, ipopt_options,
            piccolo_options)
        device = warm_device if device is None else device
    if not isinstance(trajectory, NamedTrajectory) or unitary_name not in trajectory.names:
        raise ValueError(f"a NamedTrajectory with a {unitary_name!r} component is needed")
    constraints = list(constraints or [])
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()

    objective = objective + MinimumTimeObjective(
        trajectory, D=D, eval_hessian=piccolo_options.eval_hessian
    )
    if final_fidelity is None:
        final_fidelity = float(iso_vec_unitary_fidelity(
            trajectory[unitary_name][-1], np.asarray(trajectory.goal[unitary_name]),
            subspace=subspace))
    constraints.append(
        FinalUnitaryFidelityConstraint(unitary_name, final_fidelity, subspace=subspace)
    )
    return QuantumControlProblem(
        trajectory, objective, integrators, constraints=constraints,
        ipopt_options=ipopt_options, piccolo_options=piccolo_options,
        control_name=control_name, system=system, device=device,
    )
