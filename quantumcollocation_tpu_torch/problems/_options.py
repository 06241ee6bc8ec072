"""Shared option application for problem templates.

Counterpart of quantumcollocation_tpu/problems/_options.py: leakage
suppression (an L1 penalty on each state's leakage entries through slack
rows), the equal-timestep constraint under free time, and the
complex-control modulus constraint.  Returns the (possibly augmented)
objective and trajectory; constraints are appended in place.
"""

from __future__ import annotations

from ..objectives.constraints import ComplexModulusConstraint, TimeStepsAllEqualConstraint
from ..objectives.objectives import L1Regularizer

__all__ = ["apply_piccolo_options"]


def apply_piccolo_options(J, constraints: list, piccolo_options, traj, state_names,
                          timestep_name: str, *, state_leakage_indices=None):
    """state_names is a list of state components, each with its own list of
    leakage indices, or one name: then every component whose name starts
    with it, all sharing the one list of indices."""
    if isinstance(state_names, str):
        prefix = state_names
        state_names = [n for n in traj.names if n.startswith(prefix)]
        if state_leakage_indices is not None:
            state_leakage_indices = [state_leakage_indices] * len(state_names)

    if piccolo_options.leakage_suppression:
        if state_leakage_indices is None:
            raise ValueError("You must provide leakage indices for leakage suppression.")
        for name, indices in zip(state_names, state_leakage_indices):
            J_leak, traj = L1Regularizer(constraints, name, traj,
                                         R_value=piccolo_options.R_leakage, indices=indices)
            J = J + J_leak

    if piccolo_options.free_time and piccolo_options.timesteps_all_equal:
        constraints.append(TimeStepsAllEqualConstraint(timestep_name))

    if piccolo_options.complex_control_norm_constraint_name is not None:
        constraints.append(ComplexModulusConstraint(
            piccolo_options.complex_control_norm_constraint_name,
            piccolo_options.complex_control_norm_constraint_radius,
        ))
    return J, traj
