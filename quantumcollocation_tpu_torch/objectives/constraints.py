"""Constraint objects (bounds and the equal-timestep constraint).

Counterpart of quantumcollocation_tpu/objectives/constraints.py, main-path
subset.  Box bounds come from trajectory metadata and are enforced by the
interior-point barrier; equal timesteps lower to defect rows so the KKT
system stays block-tridiagonal.
"""

from __future__ import annotations

import dataclasses

__all__ = ["AbstractConstraint", "TimeStepsAllEqualConstraint", "BoundsConstraint"]


class AbstractConstraint:
    """Base class; stage inequality rows are not part of this port yet."""

    def ineq_dim(self, traj) -> int:
        return 0


@dataclasses.dataclass
class TimeStepsAllEqualConstraint(AbstractConstraint):
    """dt_t = dt_{t+1} for all t, lowered to TimeStepEqualityIntegrator."""

    timestep_name: str = "Δt"

    def as_integrator(self):
        from ..dynamics.integrators import TimeStepEqualityIntegrator

        return TimeStepEqualityIntegrator(self.timestep_name)


@dataclasses.dataclass
class BoundsConstraint(AbstractConstraint):
    """Marker: box bounds come from the trajectory's bounds."""

    name: str = ""
