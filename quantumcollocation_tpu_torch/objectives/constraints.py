"""Constraint objects: bounds, the equal-timestep constraint, the final
fidelity floors, the L1 slack rows and the complex-modulus disk.

Counterpart of quantumcollocation_tpu/objectives/constraints.py.
Box bounds come from trajectory metadata and are enforced by the
interior-point barrier; equal timesteps lower to defect rows so the KKT
system stays block-tridiagonal.  An inequality constraint has
`ineq_dim(traj)` rows g >= 0 per knot; `make(traj, dtype, device)` gives
its row function fn(z, t) -> (ineq_dim,) with its constants on the solver's
device, and `ineq(z, t, traj)` evaluates it once.  Rows inactive at knot t
return +1 through a tensor `where` (zero derivative there), so the
function vectorizes over t under torch.func.vmap.  Row functions gather
their entries of z by index tensors built once in `make`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..quantum.fidelities import (
    _stack_ops,
    iso_fidelity,
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
)

__all__ = [
    "AbstractConstraint",
    "TimeStepsAllEqualConstraint",
    "BoundsConstraint",
    "FinalUnitaryFidelityConstraint",
    "FinalUnitaryFreePhaseFidelityConstraint",
    "FinalQuantumStateFidelityConstraint",
    "L1SlackConstraint",
    "ComplexModulusConstraint",
    "ComplexModulusContraint",
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

    subspace = None

    def ineq_dim(self, traj) -> int:
        return 1

    def make(self, traj, dtype, device):
        start, stop = traj.components[self.state_name]
        goal = torch.as_tensor(np.asarray(traj.goal[self.state_name]), dtype=dtype, device=device)
        floor, last = float(self.final_fidelity), traj.T - 1
        fid = self._fidelity
        sub = (None if self.subspace is None
               else torch.as_tensor([int(i) for i in self.subspace], dtype=torch.long,
                                    device=device))

        def fn(z, t):
            val = fid(z[start:stop], goal, sub) - floor
            return torch.where(t == last, val, torch.ones_like(val))[None]

        return fn


@dataclasses.dataclass
class FinalUnitaryFidelityConstraint(_FinalFidelityFloor):
    """|tr(G^† U_T)| / N >= final_fidelity, on the subspace block where one
    is given; the modulus has the port's zero subgradient at the origin
    (quantum/fidelities.py::_safe_abs)."""

    state_name: str
    final_fidelity: float
    subspace: Any = None

    @staticmethod
    def _fidelity(u, goal, subspace):
        return iso_vec_unitary_fidelity(u, goal, subspace=subspace)


@dataclasses.dataclass
class FinalQuantumStateFidelityConstraint(_FinalFidelityFloor):
    """|<goal|psi_T>|^2 >= final_fidelity."""

    state_name: str
    final_fidelity: float

    @staticmethod
    def _fidelity(psi, goal, subspace):
        return iso_fidelity(psi, goal)


@dataclasses.dataclass
class L1SlackConstraint(AbstractConstraint):
    """The slack rows of an L1 penalty, at every knot: s - v >= 0 and
    s + v >= 0 for v = z[name][indices], s = z[slack_name]."""

    name: str
    slack_name: str
    indices: Sequence[int]

    def ineq_dim(self, traj) -> int:
        return 2 * len(self.indices)

    def make(self, traj, dtype, device):
        start, _ = traj.components[self.name]
        s_start, _ = traj.components[self.slack_name]
        k = len(self.indices)
        iv = torch.as_tensor([start + int(i) for i in self.indices], device=device)
        i_s = torch.arange(s_start, s_start + k, device=device)

        def fn(z, t):
            v, s = z.index_select(0, iv), z.index_select(0, i_s)
            return torch.cat([s - v, s + v])

        return fn


@dataclasses.dataclass
class ComplexModulusConstraint(AbstractConstraint):
    """|v_re + i v_im| <= radius at every knot: rows radius² - v_re² -
    v_im² >= 0, the pairs (i, i + k/2) of the component (first half real,
    second half imaginary) or the given `pairs`."""

    name: str
    radius: float
    pairs: Any = None

    def _pairs(self, traj):
        start, stop = traj.components[self.name]
        k = stop - start
        if self.pairs is not None:
            return [(start + i, start + j) for i, j in self.pairs]
        if k % 2:
            raise ValueError("the complex modulus needs a component of even size")
        return [(start + i, start + k // 2 + i) for i in range(k // 2)]

    def ineq_dim(self, traj) -> int:
        return len(self._pairs(traj))

    def make(self, traj, dtype, device):
        ii, jj = zip(*self._pairs(traj))
        ire, iim = (torch.as_tensor(x, device=device) for x in (ii, jj))
        r2 = float(self.radius) ** 2

        def fn(z, t):
            return r2 - z.index_select(0, ire) ** 2 - z.index_select(0, iim) ** 2

        return fn


# the JAX package exports the upstream spelling too
ComplexModulusContraint = ComplexModulusConstraint


@dataclasses.dataclass
class FinalUnitaryFreePhaseFidelityConstraint(AbstractConstraint):
    """|tr(G^† R(φ) U_T)| / N >= final_fidelity, the fidelity up to the
    global phases R(φ) = exp(i Σ_k φ_k G_k) (on the subspace block where
    one is given).  The phases φ are the global variable `phase_name`,
    which the problem compiler appends to every knot row: it injects
    `global_slices` {name: (start, stop)}, and the row reads z[start:stop]
    at the last knot."""

    state_name: str
    phase_name: str
    phase_operators: Any
    final_fidelity: float
    subspace: Any = None
    global_slices: Any = None

    def ineq_dim(self, traj) -> int:
        return 1

    def make(self, traj, dtype, device):
        if self.global_slices is None or self.phase_name not in self.global_slices:
            raise ValueError(f"no global variable {self.phase_name!r}: the problem compiler "
                             "injects global_slices")
        start, stop = traj.components[self.state_name]
        gs, ge = self.global_slices[self.phase_name]
        goal = torch.as_tensor(np.asarray(traj.goal[self.state_name]), dtype=dtype, device=device)
        ops = torch.as_tensor(_stack_ops(self.phase_operators), device=device)
        floor, last = float(self.final_fidelity), traj.T - 1
        sub = (None if self.subspace is None
               else torch.as_tensor([int(i) for i in self.subspace], dtype=torch.long,
                                    device=device))

        def fn(z, t):
            val = iso_vec_unitary_free_phase_fidelity(
                z[start:stop], goal, z[gs:ge], ops, subspace=sub) - floor
            return torch.where(t == last, val, torch.ones_like(val))[None]

        return fn
