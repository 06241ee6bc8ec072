"""Objective terms and their algebra.

Counterpart of quantumcollocation_tpu/objectives/objectives.py
(UnitaryInfidelityObjective, QuantumStateObjective, QuadraticRegularizer).  A term is classified
by its stage structure so the problem compiler keeps the KKT system
block-tridiagonal:
  - "stage":    fn(z_t, t) -> scalar, summed over all knots
  - "terminal": fn(z_T) -> scalar

Each term carries `make(dtype, device) -> fn`: its constants (goal,
weights) are materialized once on the solver's device, never per call.
The functions are pure torch, so torch.func derives their gradients and
Hessians.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..quantum.fidelities import iso_fidelity, iso_vec_unitary_fidelity

__all__ = [
    "Objective",
    "ObjectiveTerm",
    "UnitaryInfidelityObjective",
    "QuantumStateObjective",
    "QuadraticRegularizer",
]


@dataclasses.dataclass(frozen=True)
class ObjectiveTerm:
    kind: str  # "stage" | "terminal"
    make: Callable  # (dtype, device) -> fn
    weight: float = 1.0
    label: str = ""

    def scaled(self, factor):
        return dataclasses.replace(self, weight=self.weight * float(factor))


@dataclasses.dataclass(frozen=True)
class Objective:
    terms: tuple = ()

    def __add__(self, other):
        if other is None or other == 0:
            return self
        return Objective(self.terms + other.terms)

    __radd__ = __add__

    def __mul__(self, factor):
        return Objective(tuple(t.scaled(factor) for t in self.terms))

    __rmul__ = __mul__


def UnitaryInfidelityObjective(name, traj, Q=100.0):
    """Q |1 - F(U_T, U_goal)|, F = |tr(U_goal^† U_T)| / N."""
    start, stop = traj.components[name]
    goal = np.asarray(traj.goal[name])

    def make(dtype, device):
        g = torch.as_tensor(goal, dtype=dtype, device=device)

        def fn(zT):
            x = 1.0 - iso_vec_unitary_fidelity(zT[start:stop], g)
            # |x| with derivative +1 at x = 0, as jnp.abs defines it: the
            # geodesic guess ends exactly on the goal, where x = 0
            return torch.where(x >= 0, x, -x)

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"unitary_infidelity[{name}]"),)
    )


def QuantumStateObjective(name, traj, Q=100.0):
    """Q (1 - |<goal|psi_T>|^2).  No |x| here: the ket fidelity is smooth,
    so its derivative at the goal needs no convention."""
    start, stop = traj.components[name]
    goal = np.asarray(traj.goal[name])

    def make(dtype, device):
        g = torch.as_tensor(goal, dtype=dtype, device=device)

        def fn(zT):
            return 1.0 - iso_fidelity(zT[start:stop], g)

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"state_infidelity[{name}]"),)
    )


def QuadraticRegularizer(name, traj, R=1.0):
    """(1/2) sum_t R ||v_t||^2."""
    start, stop = traj.components[name]
    Rvec = np.broadcast_to(np.asarray(R, dtype=float), (stop - start,)).copy()

    def make(dtype, device):
        r = torch.as_tensor(Rvec, dtype=dtype, device=device)

        def fn(z, t):
            return 0.5 * torch.sum(r * z[start:stop] ** 2)

        return fn

    return Objective((ObjectiveTerm("stage", make, 1.0, f"quad_reg[{name}]"),))
