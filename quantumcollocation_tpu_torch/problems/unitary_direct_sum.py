"""UnitaryDirectSumProblem: solved problems merged into one coupled problem.

Counterpart of quantumcollocation_tpu/problems/unitary_direct_sum.py.  The
trajectories of N smooth-pulse problems are suffixed with their labels
(Ũ⃗1, a1, ..., Δt1; Ũ⃗2, ...) and merged; each problem keeps its own
integrators (suffixed, so each propagator reads its own controls and its
own timestep column) and gets a FinalUnitaryFidelityConstraint.  A
PairwiseQuadraticRegularizer couples the problems over a graph of edges
(by default the chain over the Q_symb components), boundary edges pull a
component toward a given value, and each problem keeps its control
regularizers (and, with fidelity_cost, its infidelity).  drive_reset_ratio
mixes fresh random controls into the solved ones, so the coupled solve
does not start at the subproblems' optimum.
"""

from __future__ import annotations

import copy

import numpy as np

from ..objectives.constraints import FinalUnitaryFidelityConstraint
from ..objectives.objectives import (
    PairwiseQuadraticRegularizer,
    QuadraticRegularizer,
    UnitaryInfidelityObjective,
)
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.directsums import add_suffix, merge as merge_trajs
from ..trajectory.initialization import initialize_control_trajectory
from .problem import QuantumControlProblem

__all__ = ["UnitaryDirectSumProblem", "reset_drives"]


def reset_drives(traj, labels, ratio, sigma, rng):
    """A copy of traj.data with each label's a, da and dda mixed with fresh
    controls: (1 - ratio)·old + ratio·new, new drawn by
    initialize_control_trajectory(n_drives, 2, T, bounds, sigma) from rng,
    one label after another."""
    data = traj.data.copy()
    for label in labels:
        a_name = "a" + label
        fresh = initialize_control_trajectory(
            traj.comp_size(a_name), 2, traj.T, traj.bounds[a_name], sigma, rng=rng)
        for name, new in zip((a_name, "da" + label, "dda" + label), fresh):
            sl = traj.comp_slice(name)
            data[:, sl] = (1 - ratio) * data[:, sl] + ratio * new
    return data


def UnitaryDirectSumProblem(
    probs,
    final_fidelity: float,
    *,
    prob_labels=None,
    graph=None,
    boundary_values=None,
    control_name: str = "a",
    Q=100.0,
    Q_symb: str = "dda",
    R: float = 1e-2,
    R_a=None,
    R_da=None,
    R_dda=None,
    R_b=None,
    drive_derivative_sigma: float = 0.01,
    drive_reset_ratio: float = 0.50,
    fidelity_cost: bool = False,
    subspace=None,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Build the problem on `device` (default the first problem's).  graph
    holds (label, label) edges, or (label, boundary key) edges whose
    component is pulled toward boundary_values[key] with weight R_b.  The
    reset draws each problem's fresh controls from one numpy Generator
    (`rng`, default_rng(0)) in label order, as the JAX package's does."""
    N = len(probs)
    if N < 2:
        raise ValueError("at least two problems are required")
    prob_labels = list(prob_labels or [str(i + 1) for i in range(N)])
    if len(prob_labels) != N:
        raise ValueError(f"{len(prob_labels)} labels for {N} problems")
    if not 0 <= drive_reset_ratio <= 1:
        raise ValueError(f"drive_reset_ratio {drive_reset_ratio} is not in [0, 1]")
    boundary_values = dict(boundary_values or {})
    if set(boundary_values) & set(prob_labels):
        raise ValueError("boundary keys and problem labels overlap")
    if any("dda" not in p.trajectory.names for p in probs):
        raise ValueError("only smooth pulse problems are supported")
    R_a = R if R_a is None else R_a
    R_da = R if R_da is None else R_da
    R_dda = R if R_dda is None else R_dda
    R_b = R if R_b is None else R_b
    ipopt_options = ipopt_options or copy.deepcopy(probs[0].ipopt_options)
    piccolo_options = piccolo_options or copy.deepcopy(probs[0].piccolo_options)
    rng = rng or np.random.default_rng(0)

    boundary = []
    if graph is None:
        graph = [(Q_symb + prob_labels[i], Q_symb + prob_labels[i + 1]) for i in range(N - 1)]
    else:
        resolved = []
        for e1, e2 in graph:
            if e1 in prob_labels and e2 in prob_labels:
                resolved.append((Q_symb + e1, Q_symb + e2))
            elif e1 in boundary_values and e2 in prob_labels:
                boundary.append((Q_symb + e2, boundary_values[e1]))
            elif e1 in prob_labels and e2 in boundary_values:
                boundary.append((Q_symb + e1, boundary_values[e2]))
            else:
                raise ValueError("edge labels must be in prob_labels or boundary_values")
        graph = resolved

    traj = merge_trajs([add_suffix(p.trajectory, label)
                        for p, label in zip(probs, prob_labels)])
    if drive_reset_ratio > 0:
        traj = traj.with_data(
            reset_drives(traj, prob_labels, drive_reset_ratio, drive_derivative_sigma, rng))

    integrators = [add_suffix(ig, label) for p, label in zip(probs, prob_labels)
                   for ig in p.integrators]
    constraints = [
        FinalUnitaryFidelityConstraint(next(iter(p.trajectory.goal)) + label, final_fidelity,
                                       subspace=subspace)
        for p, label in zip(probs, prob_labels)
    ]

    J = PairwiseQuadraticRegularizer(traj, Q, graph)
    for name, value in boundary:
        J = J + QuadraticRegularizer(name, traj, R_b, baseline=value)
    for label in prob_labels:
        J = J + QuadraticRegularizer("a" + label, traj, R_a)
        J = J + QuadraticRegularizer("da" + label, traj, R_da)
        J = J + QuadraticRegularizer("dda" + label, traj, R_dda)
    if fidelity_cost:
        Q_fid = Q if np.isscalar(Q) else Q[0]
        for label in prob_labels:
            J = J + UnitaryInfidelityObjective("Ũ⃗" + label, traj, Q_fid, subspace=subspace)

    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=probs[0].system,
        device=probs[0].device if device is None else device,
    )
