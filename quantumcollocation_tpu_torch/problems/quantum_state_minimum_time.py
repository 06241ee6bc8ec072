"""QuantumStateMinimumTimeProblem: minimize the duration under a fidelity
floor on every ket.

Counterpart of quantumcollocation_tpu/problems/quantum_state_minimum_time.py:
the MinimumTimeObjective plus one FinalQuantumStateFidelityConstraint per
state component (names starting with state_name); the default floor is the
mean of the current state fidelities; a warm-start form from a solved
problem.
"""

from __future__ import annotations

import numpy as np

from ..objectives.constraints import FinalQuantumStateFidelityConstraint
from ..objectives.objectives import MinimumTimeObjective
from ..quantum.fidelities import iso_fidelity
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.named_trajectory import NamedTrajectory
from .problem import QuantumControlProblem
from .unitary_minimum_time import warm_start_parts

__all__ = ["QuantumStateMinimumTimeProblem"]


def QuantumStateMinimumTimeProblem(
    trajectory,
    system=None,
    objective=None,
    integrators=None,
    constraints=None,
    *,
    state_name: str = "ψ̃",
    control_name: str = "a",
    final_fidelity: float | None = None,
    D: float = 1.0,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    device=None,
) -> QuantumControlProblem:
    """Two call forms, as UnitaryMinimumTimeProblem."""
    if isinstance(trajectory, QuantumControlProblem):
        (system, objective, integrators, constraints, ipopt_options, piccolo_options,
         trajectory, warm_device) = warm_start_parts(
            trajectory, system, objective, integrators, constraints, ipopt_options,
            piccolo_options)
        device = warm_device if device is None else device
    if not isinstance(trajectory, NamedTrajectory):
        raise TypeError("trajectory must be a NamedTrajectory or a solved problem")
    constraints = list(constraints or [])
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    state_names = [n for n in trajectory.names if n.startswith(state_name)]
    if not state_names:
        raise ValueError(f"no components starting with {state_name!r}")

    objective = objective + MinimumTimeObjective(
        trajectory, D=D, eval_hessian=piccolo_options.eval_hessian
    )
    if final_fidelity is None:
        final_fidelity = float(np.mean([
            float(iso_fidelity(trajectory[n][-1], np.asarray(trajectory.goal[n])))
            for n in state_names
        ]))
    for name in state_names:
        constraints.append(FinalQuantumStateFidelityConstraint(name, final_fidelity))
    return QuantumControlProblem(
        trajectory, objective, integrators, constraints=constraints,
        ipopt_options=ipopt_options, piccolo_options=piccolo_options,
        control_name=control_name, system=system, device=device,
    )
