"""UnitaryMinimumTimeProblem: minimize the duration under a fidelity floor.

Counterpart of quantumcollocation_tpu/problems/unitary_minimum_time.py:
adds D Σ Δt to the objective and a FinalUnitaryFidelityConstraint at
`final_fidelity` (by default the trajectory's current fidelity; both on
the `subspace` block where one is given), with a
warm-start form from a solved problem.  Bounds and pins are trajectory
metadata, so a warm start keeps them.  With phase_operators the floor is
a FinalUnitaryFreePhaseFidelityConstraint on the global phases
phase_name, by default at the free-phase fidelity of the trajectory's
last knot with its stored phases; a warm start carries the phases in the
trajectory's global data.
"""

from __future__ import annotations

import copy

import numpy as np

from ..objectives.constraints import (
    FinalUnitaryFidelityConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
)
from ..objectives.objectives import MinimumTimeObjective
from ..quantum.fidelities import iso_vec_unitary_fidelity, iso_vec_unitary_free_phase_fidelity
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.named_trajectory import NamedTrajectory
from .problem import QuantumControlProblem

__all__ = ["UnitaryMinimumTimeProblem"]


def fidelity_floor(trajectory, unitary_name, final_fidelity, subspace, phase_name,
                   phase_operators):
    """The final-fidelity constraint of the minimum-time and robustness
    templates: at final_fidelity, by default the fidelity of the
    trajectory's last knot (up to its stored global phases with
    phase_operators)."""
    U_T = trajectory[unitary_name][-1]
    U_G = np.asarray(trajectory.goal[unitary_name])
    if phase_operators is None:
        if final_fidelity is None:
            final_fidelity = float(iso_vec_unitary_fidelity(U_T, U_G, subspace=subspace))
        return FinalUnitaryFidelityConstraint(unitary_name, final_fidelity, subspace=subspace)
    if final_fidelity is None:
        final_fidelity = float(iso_vec_unitary_free_phase_fidelity(
            U_T, U_G, trajectory.global_data[phase_name], phase_operators, subspace=subspace))
    return FinalUnitaryFreePhaseFidelityConstraint(unitary_name, phase_name, phase_operators,
                                                   final_fidelity, subspace=subspace)


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
    constraints.append(fidelity_floor(trajectory, unitary_name, final_fidelity, subspace,
                                      phase_name, phase_operators))
    return QuantumControlProblem(
        trajectory, objective, integrators, constraints=constraints,
        ipopt_options=ipopt_options, piccolo_options=piccolo_options,
        control_name=control_name, system=system, device=device,
    )
