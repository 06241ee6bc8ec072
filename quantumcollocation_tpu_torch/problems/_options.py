"""Shared option application for problem templates.

Counterpart of quantumcollocation_tpu/problems/_options.py: under free time
with equal timesteps, add the TimeStepsAllEqualConstraint.  Leakage
suppression (embedded operators, L1 slack rows) and the complex-modulus
constraint are not ported yet.
"""

from __future__ import annotations

from ..objectives.constraints import TimeStepsAllEqualConstraint

__all__ = ["apply_piccolo_options"]


def apply_piccolo_options(J, constraints: list, piccolo_options, traj, timestep_name: str):
    if piccolo_options.leakage_suppression:
        raise NotImplementedError("leakage suppression is not ported yet")
    if piccolo_options.complex_control_norm_constraint_name is not None:
        raise NotImplementedError("the complex-modulus constraint is not ported yet")
    if piccolo_options.free_time and piccolo_options.timesteps_all_equal:
        constraints.append(TimeStepsAllEqualConstraint(timestep_name))
    return J, traj
