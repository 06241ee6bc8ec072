"""Constraint objects: bounds, the equal-timestep constraint and the final
fidelity floors.

Counterpart of quantumcollocation_tpu/objectives/constraints.py, subset.
Box bounds come from trajectory metadata and are enforced by the
interior-point barrier; equal timesteps lower to defect rows so the KKT
system stays block-tridiagonal.  An inequality constraint has
`ineq_dim(traj)` rows g >= 0 per knot; `make(traj, dtype, device)` gives
its row function fn(z, t) -> (ineq_dim,) with its constants on the solver's
device, and `ineq(z, t, traj)` evaluates it once.  Rows inactive at knot t
return +1 through a tensor `where` (zero derivative there), so the
function vectorizes over t under torch.func.vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..quantum.fidelities import iso_fidelity, iso_vec_unitary_fidelity

__all__ = [
    "AbstractConstraint",
    "TimeStepsAllEqualConstraint",
    "BoundsConstraint",
    "FinalUnitaryFidelityConstraint",
    "FinalUnitaryFreePhaseFidelityConstraint",
    "FinalQuantumStateFidelityConstraint",
]


class AbstractConstraint:
    """Base class: no inequality rows."""

    def ineq_dim(self, traj) -> int:
        return 0

    def make(self, traj, dtype, device):
        return lambda z, t: z.new_zeros(0)

    def ineq(self, z, t, traj):
        return self.make(traj, z.dtype, z.device)(z, t)


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


class _FinalFidelityFloor(AbstractConstraint):
    """One row: fidelity(z_T) - final_fidelity at t = T-1, +1 elsewhere."""

    def ineq_dim(self, traj) -> int:
        return 1

    def make(self, traj, dtype, device):
        start, stop = traj.components[self.state_name]
        goal = torch.as_tensor(np.asarray(traj.goal[self.state_name]), dtype=dtype, device=device)
        floor, last = float(self.final_fidelity), traj.T - 1
        fid = self._fidelity

        def fn(z, t):
            val = fid(z[start:stop], goal) - floor
            return torch.where(t == last, val, torch.ones_like(val))[None]

        return fn


@dataclasses.dataclass
class FinalUnitaryFidelityConstraint(_FinalFidelityFloor):
    """|tr(G^† U_T)| / N >= final_fidelity; the modulus has the port's
    zero subgradient at the origin (quantum/fidelities.py::_safe_abs)."""

    state_name: str
    final_fidelity: float
    subspace: Any = None

    def __post_init__(self):
        if self.subspace is not None:
            raise NotImplementedError("subspace fidelities are not ported yet")

    @staticmethod
    def _fidelity(u, goal):
        return iso_vec_unitary_fidelity(u, goal)


@dataclasses.dataclass
class FinalQuantumStateFidelityConstraint(_FinalFidelityFloor):
    """|<goal|psi_T>|^2 >= final_fidelity."""

    state_name: str
    final_fidelity: float

    @staticmethod
    def _fidelity(psi, goal):
        return iso_fidelity(psi, goal)


class FinalUnitaryFreePhaseFidelityConstraint(AbstractConstraint):
    """The free-phase floor needs global (free-phase) variables, which the
    port does not carry yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FinalUnitaryFreePhaseFidelityConstraint needs global (free-phase) "
            "variables, which are not ported yet"
        )
