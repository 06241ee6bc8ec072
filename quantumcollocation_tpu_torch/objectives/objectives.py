"""Objective terms and their algebra.

Counterpart of quantumcollocation_tpu/objectives/objectives.py
(UnitaryInfidelityObjective, UnitaryFreePhaseInfidelityObjective,
QuantumStateObjective, DensityOperatorPureStateInfidelityObjective,
QuadraticRegularizer,
QuadraticSmoothnessRegularizer, L1Regularizer, MinimumTimeObjective,
UnitaryRobustnessObjective).  A term is classified by its stage structure
so the problem compiler keeps the KKT system block-tridiagonal:
  - "stage":    fn(z_t, t) -> scalar, summed over all knots
  - "pair":     fn(z_t, z_{t+1}, t) -> scalar, summed over t = 0..T-2
  - "terminal": fn(z_T, globals) -> scalar, globals the trajectory's
                global variables {name: (k,) tensor} cut from z_T's tail
                by the problem compiler (terms that read none may be
                called as fn(z_T))

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

from ..quantum.fidelities import (
    _stack_ops,
    density_fidelity_coefficients,
    iso_fidelity,
    iso_vec_density_pure_state_fidelity,
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
)

__all__ = [
    "Objective",
    "ObjectiveTerm",
    "UnitaryInfidelityObjective",
    "UnitaryFreePhaseInfidelityObjective",
    "QuantumStateObjective",
    "DensityOperatorPureStateInfidelityObjective",
    "QuadraticRegularizer",
    "QuadraticSmoothnessRegularizer",
    "L1Regularizer",
    "MinimumTimeObjective",
    "UnitaryRobustnessObjective",
]


@dataclasses.dataclass(frozen=True)
class ObjectiveTerm:
    kind: str  # "stage" | "pair" | "terminal"
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


def UnitaryInfidelityObjective(name, traj, Q=100.0, *, subspace=None):
    """Q |1 - F(U_T, U_goal)|, F = |tr(U_goal^† U_T)| / N, on the subspace
    block (N its size) where one is given."""
    start, stop = traj.components[name]
    goal = np.asarray(traj.goal[name])
    sub = None if subspace is None else [int(i) for i in subspace]

    def make(dtype, device):
        g = torch.as_tensor(goal, dtype=dtype, device=device)
        idx = None if sub is None else torch.as_tensor(sub, dtype=torch.long, device=device)

        def fn(zT, globals_=None):
            return _abs(1.0 - iso_vec_unitary_fidelity(zT[start:stop], g, subspace=idx))

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"unitary_infidelity[{name}]"),)
    )


def _abs(x):
    """|x| with derivative +1 at x = 0, as jnp.abs defines it: the
    geodesic guess ends exactly on the goal, where x = 0."""
    return torch.where(x >= 0, x, -x)


def UnitaryFreePhaseInfidelityObjective(name, phase_name, phase_operators, traj, Q=100.0, *,
                                        subspace=None, eval_hessian=True):
    """Q |1 - F|, F = |tr(U_goal^† R(φ) U_T)| / N the fidelity up to the
    global phases R(φ) = exp(i Σ_k φ_k G_k), φ the global variable
    `phase_name` (on the subspace block, N its size, where one is given)."""
    start, stop = traj.components[name]
    goal = np.asarray(traj.goal[name])
    ops = _stack_ops(phase_operators)
    sub = None if subspace is None else [int(i) for i in subspace]

    def make(dtype, device):
        g = torch.as_tensor(goal, dtype=dtype, device=device)
        ops_t = torch.as_tensor(ops, device=device)
        idx = None if sub is None else torch.as_tensor(sub, dtype=torch.long, device=device)

        def fn(zT, globals_=None):
            return _abs(1.0 - iso_vec_unitary_free_phase_fidelity(
                zT[start:stop], g, globals_[phase_name], ops_t, subspace=idx))

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"free_phase_infidelity[{name}]"),)
    )


def QuantumStateObjective(name, traj, Q=100.0):
    """Q (1 - |<goal|psi_T>|^2).  No |x| here: the ket fidelity is smooth,
    so its derivative at the goal needs no convention."""
    start, stop = traj.components[name]
    goal = np.asarray(traj.goal[name])

    def make(dtype, device):
        g = torch.as_tensor(goal, dtype=dtype, device=device)

        def fn(zT, globals_=None):
            return 1.0 - iso_fidelity(zT[start:stop], g)

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"state_infidelity[{name}]"),)
    )


def DensityOperatorPureStateInfidelityObjective(name, psi_goal, *, Q=100.0, traj=None):
    """Q (1 - <psi|rho_T|psi>) on the density iso vec, in real arithmetic."""
    if traj is None:
        raise ValueError("traj is needed to find the density component")
    start, stop = traj.components[name]
    coeffs = density_fidelity_coefficients(psi_goal)

    def make(dtype, device):
        c = tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in coeffs)

        def fn(zT, globals_=None):
            return 1.0 - iso_vec_density_pure_state_fidelity(zT[start:stop], None, c)

        return fn

    return Objective(
        (ObjectiveTerm("terminal", make, float(Q), f"density_infidelity[{name}]"),)
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


def QuadraticSmoothnessRegularizer(name, traj, R=1.0, *, eval_hessian=True):
    """(1/2) Σ_t R ||v_{t+1} - v_t||², a pair term."""
    start, stop = traj.components[name]
    Rvec = np.broadcast_to(np.asarray(R, dtype=float), (stop - start,)).copy()

    def make(dtype, device):
        r = torch.as_tensor(Rvec, dtype=dtype, device=device)

        def fn(zt, ztp1, t):
            return 0.5 * torch.sum(r * (ztp1[start:stop] - zt[start:stop]) ** 2)

        return fn

    return Objective((ObjectiveTerm("pair", make, 1.0, f"smooth_reg[{name}]"),))


def UnitaryRobustnessObjective(*, H_error=None, accumulator_name="m_rob", traj=None,
                               eval_hessian=True):
    """||M_T||², the first-order Magnus robustness cost as a terminal cost
    on the accumulator component M (RobustnessAccumulatorIntegrator's
    state); the robustness template adds its own normalized form."""
    if traj is None:
        raise ValueError("traj is needed to find the accumulator component")
    start, stop = traj.components[accumulator_name]

    def make(dtype, device):
        def fn(zT, globals_=None):
            return torch.sum(zT[start:stop] ** 2)

        return fn

    return Objective((ObjectiveTerm("terminal", make, 1.0, "unitary_robustness"),))


def L1Regularizer(constraints: list, name: str, traj, *, R=1.0, R_value=None, indices=None,
                  slack_name=None):
    """R Σ_t Σ_i |v_i(t)| through slack variables: returns (J, new_traj).
    new_traj is traj with the component `<name>_l1_slack` (one column per
    index, initialised at |v| + 1e-3, unbounded) appended after the others;
    an L1SlackConstraint (s - v >= 0, s + v >= 0) is appended to
    `constraints`; J = R Σ s is a stage term, so the KKT system stays
    block-tridiagonal."""
    from .constraints import L1SlackConstraint

    if R_value is not None:
        R = R_value
    start, stop = traj.components[name]
    indices = list(range(stop - start)) if indices is None else [int(i) for i in indices]
    slack_name = slack_name or f"{name}_l1_slack"
    comps = {n: np.asarray(traj[n]) for n in traj.names}
    comps[slack_name] = np.abs(np.asarray(traj[name]))[:, indices] + 1e-3
    new_traj = type(traj)(
        comps, controls=traj.controls, timestep=traj.timestep, bounds=dict(traj.bounds),
        initial=dict(traj.initial), final=dict(traj.final), goal=dict(traj.goal),
        global_data=dict(traj.global_data),
    )
    constraints.append(L1SlackConstraint(name, slack_name, tuple(indices)))
    s_start, s_stop = new_traj.components[slack_name]
    Rvec = np.broadcast_to(np.asarray(R, dtype=float), (len(indices),)).copy()

    def make(dtype, device):
        r = torch.as_tensor(Rvec, dtype=dtype, device=device)

        def fn(z, t):
            return torch.sum(r * z[s_start:s_stop])

        return fn

    return Objective((ObjectiveTerm("stage", make, 1.0, f"l1_reg[{name}]"),)), new_traj


def MinimumTimeObjective(traj, *, D=1.0, timestep_name="Δt", eval_hessian=True):
    """D Σ_{t<T-1} Δt_t, a stage term (the last knot's Δt moves nothing)."""
    if not isinstance(traj.timestep, str):
        raise ValueError("MinimumTimeObjective needs a free-time trajectory")
    start, stop = traj.components[traj.timestep]
    last = traj.T - 1

    def make(dtype, device):
        def fn(z, t):
            dt = z[start:stop].sum()
            return torch.where(t < last, dt, torch.zeros_like(dt))

        return fn

    return Objective((ObjectiveTerm("stage", make, float(D), "minimum_time"),))
