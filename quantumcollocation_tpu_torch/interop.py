"""Carry a problem's data from the JAX package into the port.

This system has no weights: its parameters are the problem data.
`problem_arrays` reads a JAX-package problem as plain numpy (the system's
Hamiltonians and generators, the trajectory with its bounds and pins, the
initial decision Z0, the solver's variable, defect, inequality-row and
objective scales, each integrator's class, Padé order and squaring count,
the Hamiltonians of every propagator integrator's system (one per sampled
system), an open system's dissipators and a robustness accumulator's
error Hamiltonian, the inequality
constraints (fidelity floors: class, state name, floor, subspace; L1 slack
rows: class, names, indices) with m, the MinimumTimeObjective's weight,
the goals of a multigoal batch, an embedded goal's subspace, levels and
subsystem levels, a composite system's subsystem levels,
the global variables (the free phases: their values, name, operators and
slices of the knot row; each instance's phases sit in Z0's global columns
at the last knot), the component names each integrator reads, the
objective's terms (kind, label, weight), and the NLP's (d, s, m), bounds,
free mask and z0).  It
only reads attributes, calls the problem's own methods and calls numpy, so
it imports nothing of JAX.  The `*_from_arrays` functions build the port's
problem from those arrays and check that the port derives the same
integrators, constraints, trajectory and NLP scaling: an exponential
integrator's squaring count comes from a host-side norm bound, and a port
that derived another count would build another NLP.  The check also
holds the port's NLP dimensions, bounds, free mask and z0 (the global
columns included) against the source's.  A leakage problem's
slack components are left out of the port's starting trajectory: its
L1Regularizer adds them again, and the check holds their initial values
and place in the layout against the source's.
"""

from __future__ import annotations

import numpy as np
import torch

from .dynamics.integrators import _Suffixable
from .problems.density_operator_smooth_pulse import DensityOperatorSmoothPulseProblem
from .problems.multigoal import UnitaryMultiGoalProblem
from .problems.quantum_state_minimum_time import QuantumStateMinimumTimeProblem
from .problems.quantum_state_sampling import QuantumStateSamplingProblem
from .problems.quantum_state_smooth_pulse import QuantumStateSmoothPulseProblem
from .problems.unitary_bang_bang import UnitaryBangBangProblem
from .problems.unitary_direct_sum import UnitaryDirectSumProblem
from .problems.unitary_minimum_time import UnitaryMinimumTimeProblem
from .problems.unitary_robustness import UnitaryRobustnessProblem
from .problems.unitary_sampling import UnitarySamplingProblem
from .problems.unitary_smooth_pulse import UnitarySmoothPulseProblem
from .quantum.embedded import EmbeddedOperator, unembed
from .quantum.isomorphisms import iso_to_ket, iso_vec_to_density, iso_vec_to_operator
from .quantum.systems import OpenQuantumSystem, QuantumSystem
from .solver.options import PiccoloOptions
from .trajectory.directsums import remove_suffix
from .trajectory.named_trajectory import NamedTrajectory

__all__ = [
    "problem_arrays",
    "system_from_arrays",
    "trajectory_from_arrays",
    "unitary_smooth_pulse_from_arrays",
    "quantum_state_smooth_pulse_from_arrays",
    "unitary_minimum_time_from_arrays",
    "quantum_state_minimum_time_from_arrays",
    "unitary_multigoal_from_arrays",
    "unitary_sampling_from_arrays",
    "unitary_robustness_from_arrays",
    "unitary_bang_bang_from_arrays",
    "density_operator_smooth_pulse_from_arrays",
    "quantum_state_sampling_from_arrays",
    "unitary_direct_sum_from_arrays",
]


def _integrator_specs(integrators):
    """(class name, order, num_squarings) of each integrator; None where
    the class has no such field."""
    return [
        (type(ig).__name__, getattr(ig, "order", None), getattr(ig, "num_squarings", None))
        for ig in integrators
    ]


def _integrator_names(integrators):
    """The component names each integrator reads (None where it has no
    such field): a direct sum's suffixed integrators each read their own
    timestep column."""
    return [tuple(getattr(ig, f, None) for f in _Suffixable._NAME_FIELDS) for ig in integrators]


def _objective_specs(objective):
    """(kind, label, weight) of each objective term."""
    return [(t.kind, t.label, float(t.weight)) for t in objective.terms]


def _constraint_specs(constraints):
    """One tuple for each inequality constraint: (class name, state name,
    floor, subspace) of a fidelity floor, (class name, name, slack name,
    indices) of L1 slack rows."""
    specs = []
    for c in constraints:
        if hasattr(c, "final_fidelity"):
            sub = getattr(c, "subspace", None)
            specs.append((type(c).__name__, c.state_name, float(c.final_fidelity),
                          None if sub is None else tuple(int(i) for i in sub)))
        elif hasattr(c, "slack_name"):
            specs.append((type(c).__name__, c.name, c.slack_name,
                          tuple(int(i) for i in c.indices)))
    return specs


def _defect_scale(prob):
    """The solver's defect-row scales r of a problem without an analytic
    assembly, as the ratio of its scaled defect rows to the problem's
    unscaled ones at a seeded point off the dynamics (z0 + N(0, 1) at
    knot 0, where every row is nonzero)."""
    solver = prob.solver
    v = np.asarray(solver.var_scale, dtype=np.float64)
    z0 = np.asarray(prob.nlp.z0, dtype=np.float64)
    zt = z0[0] + np.random.default_rng(0).standard_normal(z0.shape[1])
    scaled = np.asarray(solver.nlp.defect(zt / v, z0[1] / v, 0), dtype=np.float64)
    return scaled / np.asarray(prob.nlp.defect(zt, z0[1], 0), dtype=np.float64)


def problem_arrays(prob, batch: int = 1, *, Z0=None, goals=None, operator=None,
                   phase_operators=None) -> dict:
    """numpy snapshot of a JAX-package QuantumControlProblem; Z0 (B, T,
    d_aug) replaces the trajectory's broadcast initial decision, goals are
    those of a multigoal batch, operator is the problem's EmbeddedOperator
    goal, if it has one, and phase_operators those of its free-phase
    objective (a free-phase floor carries its own).  The inequality-row
    scales q are read at knot 0
    as the ratio of the solver's scaled rows to the problem's unscaled
    ones: a final-fidelity row is inactive there (q·1 over 1), an L1 slack
    row is s ∓ v with s = |v| + 1e-3 > 0."""
    traj = prob.trajectory
    solver = prob.solver
    nlp = solver.nlp
    analytic = nlp.analytic
    ineq_scale = (
        np.asarray(nlp.ineq(np.asarray(nlp.z0)[0], 0), dtype=np.float64)
        / np.asarray(prob.nlp.ineq(np.asarray(prob.nlp.z0)[0], 0), dtype=np.float64)
        if nlp.m > 0 else np.ones(0))
    min_time = [t.weight for t in prob.objective.terms if t.label == "minimum_time"]
    floors = [c for c in prob.constraints if hasattr(c, "phase_operators")]
    if phase_operators is None and floors:
        phase_operators = floors[0].phase_operators
    raw = prob.nlp
    return {
        "H_drift": np.asarray(prob.system.H_drift),
        "H_drives": np.asarray(prob.system.H_drives),
        "L_dissipators": (None if getattr(prob.system, "L_dissipators", None) is None
                          else np.asarray(prob.system.L_dissipators)),
        "G_drift": np.asarray(prob.system.G_drift),
        "G_drives": np.asarray(prob.system.G_drives),
        "data": np.asarray(traj.data, dtype=np.float64),
        "components": dict(traj.components),
        "controls": tuple(traj.controls),
        "timestep": traj.timestep if isinstance(traj.timestep, str) else float(traj.timestep),
        "bounds": {k: (np.asarray(lo), np.asarray(hi)) for k, (lo, hi) in traj.bounds.items()},
        "initial": {k: np.asarray(v) for k, v in traj.initial.items()},
        "final": {k: np.asarray(v) for k, v in traj.final.items()},
        "goal": {k: np.asarray(v) for k, v in traj.goal.items()},
        "Z0": np.asarray(prob.initial_decision(batch) if Z0 is None else Z0, dtype=np.float64),
        "var_scale": np.asarray(solver.var_scale, dtype=np.float64),
        "obj_scale": float(solver.obj_scale),
        "defect_scale": (
            _defect_scale(prob) if analytic is None
            else np.asarray(analytic.defect_scale, dtype=np.float64)
            if analytic.defect_scale is not None else None
        ),
        "integrators": _integrator_specs(prob.integrators),
        "integrator_names": _integrator_names(prob.integrators),
        "objective_terms": _objective_specs(prob.objective),
        "systems": [(np.asarray(ig.system.H_drift), np.asarray(ig.system.H_drives))
                    for ig in prob.integrators if getattr(ig, "system", None) is not None],
        "H_errors": [np.asarray(ig.H_error) for ig in prob.integrators
                     if getattr(ig, "H_error", None) is not None],
        "constraints": _constraint_specs(prob.constraints),
        "m": int(nlp.m),
        "ineq_scale": ineq_scale,
        "min_time_D": float(min_time[0]) if min_time else None,
        "goals": None if goals is None else np.asarray(goals, dtype=complex),
        "subspace": None if operator is None else tuple(int(i) for i in operator.subspace),
        "levels": None if operator is None else int(operator.levels),
        "operator_subsystem_levels": (None if operator is None
                                      else tuple(int(n) for n in operator.subsystem_levels)),
        "subsystem_levels": (None if "subsystem_levels" not in prob.system.params
                             else tuple(int(n) for n in prob.system.params["subsystem_levels"])),
        "global_data": {k: np.asarray(v, dtype=np.float64) for k, v in traj.global_data.items()},
        "phase_name": next(iter(traj.global_data), None),
        "phase_operators": (None if phase_operators is None
                            else np.stack([np.asarray(op, dtype=complex)
                                           for op in phase_operators])),
        "global_slices": dict(prob.global_slices),
        "nlp": {"d": int(raw.d), "s": int(raw.s), "m": int(raw.m),
                "lb": np.asarray(raw.lb, dtype=np.float64),
                "ub": np.asarray(raw.ub, dtype=np.float64),
                "free_mask": np.asarray(raw.free_mask, dtype=bool),
                "z0": np.asarray(raw.z0, dtype=np.float64)},
    }


def system_from_arrays(arrays) -> QuantumSystem:
    """The port's QuantumSystem, with a composite source's subsystem
    levels in its params; its generators must equal the source's."""
    levels = arrays.get("subsystem_levels")
    system = QuantumSystem(arrays["H_drift"], list(arrays["H_drives"]),
                           params=None if levels is None else {"subsystem_levels": levels})
    if not (np.allclose(system.G_drift, arrays["G_drift"])
            and np.allclose(system.G_drives, arrays["G_drives"])):
        raise ValueError("iso generators differ from the source problem's")
    return system


def trajectory_from_arrays(arrays) -> NamedTrajectory:
    """The source's trajectory, its global variables included, without its
    L1 slack components."""
    data = arrays["data"]
    slacks = [spec[2] for spec in arrays["constraints"] if spec[0] == "L1SlackConstraint"]
    comps = {name: data[:, a:b] for name, (a, b) in arrays["components"].items()
             if name not in slacks}
    return NamedTrajectory(
        comps, controls=arrays["controls"], timestep=arrays["timestep"],
        bounds=arrays["bounds"], initial=arrays["initial"], final=arrays["final"],
        goal=arrays["goal"], global_data=arrays["global_data"],
    )


def _phases(arrays):
    """The template keywords of the source's free phases (none without)."""
    if arrays["phase_operators"] is None:
        return {}
    return {"phase_name": arrays["phase_name"], "phase_operators": list(arrays["phase_operators"])}


def _checked(prob, arrays, rtol):
    """(problem, Z0 tensor) once the port's integrators, constraints, the
    components each integrator reads, objective terms and NLP scaling match
    the source's; raises ValueError where they differ."""
    mine, theirs = _integrator_specs(prob.integrators), list(arrays["integrators"])
    if mine != theirs:
        raise ValueError(f"integrators {mine} differ from the source problem's {theirs}")
    mine, theirs = _constraint_specs(prob.constraints), list(arrays["constraints"])
    if mine != theirs or prob.solver.nlp.m != arrays["m"]:
        raise ValueError(f"constraints {mine} differ from the source problem's {theirs}")
    mine, theirs = _integrator_names(prob.integrators), [tuple(x) for x in
                                                          arrays["integrator_names"]]
    if mine != theirs:
        raise ValueError(f"integrator components {mine} differ from the source's {theirs}")
    mine, theirs = _objective_specs(prob.objective), [tuple(x) for x in arrays["objective_terms"]]
    if mine != theirs:
        raise ValueError(f"objective terms {mine} differ from the source's {theirs}")
    traj = prob.trajectory
    if (dict(traj.components) != dict(arrays["components"])
            or not np.allclose(traj.data, arrays["data"], rtol=rtol, atol=0.0)):
        raise ValueError("the trajectory's layout or data differ from the source problem's")
    nlp, src = prob.nlp, arrays["nlp"]
    if ((nlp.d, nlp.s, nlp.m) != (src["d"], src["s"], src["m"])
            or dict(prob.global_slices) != dict(arrays["global_slices"])
            or not np.array_equal(nlp.free_mask, src["free_mask"])):
        raise ValueError(f"the NLP (d, s, m) = {(nlp.d, nlp.s, nlp.m)}, its global slices or "
                         f"its free mask differ from the source's {(src['d'], src['s'], src['m'])}")
    for name in ("lb", "ub", "z0"):
        if not np.allclose(getattr(nlp, name), src[name], rtol=rtol, atol=0.0):
            raise ValueError(f"the NLP's {name} differs from the source problem's")
    solver = prob.solver
    checks = {
        "var_scale": (solver.var_scale, arrays["var_scale"]),
        "obj_scale": (solver.obj_scale, arrays["obj_scale"]),
        "ineq_scale": (solver.ineq_scale, arrays["ineq_scale"]),
    }
    if arrays["defect_scale"] is not None:
        checks["defect_scale"] = (solver.defect_scale, arrays["defect_scale"])
    for name, (m, t) in checks.items():
        if not np.allclose(m, t, rtol=rtol, atol=0.0):
            raise ValueError(f"{name} differs from the source problem's")
    Z0 = torch.as_tensor(np.array(arrays["Z0"]), dtype=prob.dtype, device=prob.device)
    return prob, Z0


def _free_time(traj, piccolo_options):
    """The options with free_time as the trajectory has it (a named or a
    float timestep), whatever the caller's options say."""
    return (piccolo_options or PiccoloOptions()).replace(
        free_time=isinstance(traj.timestep, str)
    )


def _operator(arrays, traj, system):
    """The source's EmbeddedOperator goal (None without one): the goal's
    subspace block embedded at the source's subspace and levels.  On a
    composite system the port derives the subspace from the system's
    subsystem levels, as the source did, and raises where it differs."""
    if arrays["subspace"] is None:
        return None
    goal = unembed(iso_vec_to_operator(traj.goal["Ũ⃗"]), arrays["subspace"])
    sub_levels = arrays.get("operator_subsystem_levels")
    if sub_levels is None or len(sub_levels) == 1:
        return EmbeddedOperator(goal, arrays["subspace"], arrays["levels"])
    op = EmbeddedOperator(goal, system)
    if (op.subspace, op.subsystem_levels) != (tuple(arrays["subspace"]), tuple(sub_levels)):
        raise ValueError(f"the embedded goal's subspace {op.subspace} on subsystem levels "
                         f"{op.subsystem_levels} differs from the source's "
                         f"{tuple(arrays['subspace'])} on {tuple(sub_levels)}")
    return op


def unitary_smooth_pulse_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitarySmoothPulseProblem built with the same Q, R, integrator and
    leakage options (piccolo_options' leakage_suppression and R_leakage).
    Raises if the port's integrators, objective terms, constraints,
    trajectory or NLP scaling differ from the source's (scales by more than
    rtol)."""
    traj = trajectory_from_arrays(arrays)
    system = system_from_arrays(arrays)
    prob = UnitarySmoothPulseProblem(
        system, _operator(arrays, traj, system), traj.T,
        float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device, **_phases(arrays),
    )
    return _checked(prob, arrays, rtol)


def quantum_state_smooth_pulse_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    QuantumStateSmoothPulseProblem built with the same Q, R and integrator
    (and the default state name ψ̃); raises as
    unitary_smooth_pulse_from_arrays."""
    return _checked(_state_problem(arrays, Q, R, ipopt_options, piccolo_options, device),
                    arrays, rtol)


def _state_problem(arrays, Q, R, ipopt_options, piccolo_options, device):
    traj = trajectory_from_arrays(arrays)
    names = [n for n in traj.names if n.startswith("ψ̃")]
    leakage = [list(spec[3]) for spec in arrays["constraints"] if spec[0] == "L1SlackConstraint"]
    return QuantumStateSmoothPulseProblem(
        system_from_arrays(arrays),
        [iso_to_ket(traj.initial[n]) for n in names], [iso_to_ket(traj.goal[n]) for n in names],
        traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), state_leakage_indices=leakage or None,
        device=device,
    )


def _floor(arrays):
    """(floor, subspace) that all of the source's fidelity constraints
    share."""
    floors = {(spec[2], spec[3]) for spec in arrays["constraints"]
              if spec[0].startswith("Final")}
    if len(floors) != 1:
        raise ValueError(f"expected one fidelity floor, got {sorted(floors)}")
    return floors.pop()


def unitary_minimum_time_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitaryMinimumTimeProblem warm-started from a UnitarySmoothPulseProblem
    with the same Q, R and integrator: the port builds that smooth-pulse
    problem on the source's trajectory, then the minimum-time problem with
    the source's floor and D.  Raises as unitary_smooth_pulse_from_arrays,
    also where the constraints or the inequality-row scales differ."""
    traj = trajectory_from_arrays(arrays)
    base = UnitarySmoothPulseProblem(
        system_from_arrays(arrays), None, traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device, **_phases(arrays),
    )
    floor, subspace = _floor(arrays)
    prob = UnitaryMinimumTimeProblem(base, final_fidelity=floor, D=arrays["min_time_D"],
                                     subspace=subspace, **_phases(arrays))
    return _checked(prob, arrays, rtol)


def quantum_state_minimum_time_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """The ket counterpart of unitary_minimum_time_from_arrays, from a JAX
    QuantumStateMinimumTimeProblem warm-started from a
    QuantumStateSmoothPulseProblem (default state name ψ̃)."""
    base = _state_problem(arrays, Q, R, ipopt_options, piccolo_options, device)
    prob = QuantumStateMinimumTimeProblem(
        base, final_fidelity=_floor(arrays)[0], D=arrays["min_time_D"]
    )
    return _checked(prob, arrays, rtol)


def unitary_multigoal_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor, goals) for the port, from `problem_arrays` of a
    JAX UnitaryMultiGoalProblem (with Z0 its multigoal_initial_decisions
    and goals theirs) built with the same Q and R.  The NLP scaling is the
    one computed at the identity goal's z0, in both packages."""
    traj = trajectory_from_arrays(arrays)
    prob = UnitaryMultiGoalProblem(
        system_from_arrays(arrays), traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device,
    )
    prob, Z0 = _checked(prob, arrays, rtol)
    return prob, Z0, arrays["goals"]


def unitary_sampling_from_arrays(
    arrays, *, Q, R, system_weights=None, ipopt_options=None, piccolo_options=None, device=None,
    rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitarySamplingProblem built with the same Q, R, system weights and
    integrator: one system per source propagator integrator, each the goal
    of its Ũ⃗_system_i component; raises as
    unitary_smooth_pulse_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    systems = [QuantumSystem(Hd, list(Hs)) for Hd, Hs in arrays["systems"]]
    operators = [iso_vec_to_operator(traj.goal[f"Ũ⃗_system_{i + 1}"])
                 for i in range(len(systems))]
    prob = UnitarySamplingProblem(
        systems, operators, traj.T, float(np.mean(traj.get_timesteps())),
        system_weights=system_weights, init_trajectory=traj, Q=Q, R=R,
        ipopt_options=ipopt_options, piccolo_options=_free_time(traj, piccolo_options),
        device=device,
    )
    return _checked(prob, arrays, rtol)


def unitary_robustness_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
    accumulator_name="m_rob",
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitaryRobustnessProblem warm-started from a UnitarySmoothPulseProblem
    with the same Q, R and integrator: the port builds that smooth-pulse
    problem on the source's trajectory without its accumulator, then the
    robustness problem with the source's error Hamiltonian and floor.
    Raises as unitary_minimum_time_from_arrays."""
    full = trajectory_from_arrays(arrays)
    comps = {n: full[n] for n in full.names if n != accumulator_name}
    initial = {k: v for k, v in full.initial.items() if k != accumulator_name}
    traj = NamedTrajectory(comps, controls=full.controls, timestep=full.timestep,
                           bounds=full.bounds, initial=initial, final=full.final,
                           goal=full.goal, global_data=full.global_data)
    base = UnitarySmoothPulseProblem(
        system_from_arrays(arrays), None, traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device, **_phases(arrays),
    )
    (H_error,) = arrays["H_errors"]
    floor, subspace = _floor(arrays)
    prob = UnitaryRobustnessProblem(H_error, base, final_fidelity=floor, subspace=subspace,
                                    accumulator_name=accumulator_name, **_phases(arrays))
    return _checked(prob, arrays, rtol)


def unitary_bang_bang_from_arrays(
    arrays, *, Q, R, R_bang_bang, ipopt_options=None, piccolo_options=None, device=None,
    rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitaryBangBangProblem built with the same Q, R, R_bang_bang and Padé
    integrator (and phase operators, if any); the port's
    L1Regularizer adds the da slack component again.  Raises as
    unitary_minimum_time_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    prob = UnitaryBangBangProblem(
        system_from_arrays(arrays), None, traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, R_bang_bang=R_bang_bang, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options),
        device=device, **_phases(arrays),
    )
    return _checked(prob, arrays, rtol)


def density_operator_smooth_pulse_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    DensityOperatorSmoothPulseProblem built with the same Q and R (and the
    default state name ρ⃗̃): the open
    system from the source's Hamiltonians and dissipators, rho_init from
    the trajectory's initial density and the goal ket from its (pure)
    goal density, |ψ⟩ its leading eigenvector (the objective reads only
    |ψ⟩⟨ψ|).  Raises as unitary_smooth_pulse_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    system = OpenQuantumSystem(arrays["H_drift"], list(arrays["H_drives"]),
                               list(arrays["L_dissipators"]))
    if not (np.allclose(system.G_drift, arrays["G_drift"])
            and np.allclose(system.G_drives, arrays["G_drives"])):
        raise ValueError("iso generators differ from the source problem's")
    rho_goal = iso_vec_to_density(np.asarray(traj.goal["ρ⃗̃"]))
    psi_goal = np.linalg.eigh(rho_goal)[1][:, -1]
    prob = DensityOperatorSmoothPulseProblem(
        system, iso_vec_to_density(np.asarray(traj.initial["ρ⃗̃"])), psi_goal, traj.T,
        float(np.mean(traj.get_timesteps())), init_trajectory=traj, Q=Q, R=R,
        ipopt_options=ipopt_options, piccolo_options=_free_time(traj, piccolo_options),
        device=device,
    )
    return _checked(prob, arrays, rtol)


def quantum_state_sampling_from_arrays(
    arrays, *, Q, R, system_weights=None, ipopt_options=None, piccolo_options=None,
    device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    QuantumStateSamplingProblem built with the same Q, R, system weights
    and integrator (and the default state name ψ̃): the kets of the
    ψ̃…_system_1 components, one system for each system_j of the source's
    integrators.  Raises as unitary_smooth_pulse_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    names = [n for n in traj.names if n.startswith("ψ̃") and n.endswith("_system_1")]
    # one integrator per (system, ket), system-major: every len(names)-th
    systems = [QuantumSystem(Hd, list(Hs)) for Hd, Hs in arrays["systems"][::len(names)]]
    prob = QuantumStateSamplingProblem(
        systems, [iso_to_ket(traj.initial[n]) for n in names],
        [iso_to_ket(traj.goal[n]) for n in names], traj.T,
        float(np.mean(traj.get_timesteps())), system_weights=system_weights,
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device,
    )
    return _checked(prob, arrays, rtol)


def _unsuffixed(traj, label):
    """The components of a merged trajectory that end with label, the
    suffix removed, with their bounds, pins, goals and timestep."""
    keep = [n for n in traj.names if n.endswith(label)]

    def cut(d):
        return {remove_suffix(k, label): v for k, v in d.items() if k in keep}

    return NamedTrajectory(
        {remove_suffix(n, label): traj[n] for n in keep},
        controls=tuple(remove_suffix(c, label) for c in traj.controls if c in keep),
        timestep="Δt" if isinstance(traj.timestep, str) else traj.timestep,
        bounds=cut(traj.bounds), initial=cut(traj.initial), final=cut(traj.final),
        goal=cut(traj.goal),
    )


def unitary_direct_sum_from_arrays(
    arrays, *, Q, R, graph=None, boundary_values=None, R_b=None, fidelity_cost=False,
    ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitaryDirectSumProblem over UnitarySmoothPulseProblems built with the
    same Q, R and integrator (labels "1", "2", ...), coupled with the same
    Q, R, graph, boundary values, R_b and fidelity_cost: the port rebuilds
    each subproblem on its suffixed components of the source's (already
    reset) trajectory, each with its own system and timestep column, then
    the direct sum with drive_reset_ratio 0 and the source's floor and
    subspace.  Raises as unitary_smooth_pulse_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    floor, subspace = _floor(arrays)
    labels = [spec[1][len("Ũ⃗"):] for spec in arrays["constraints"]]
    opts = _free_time(traj, piccolo_options)
    subs = []
    for label, (Hd, Hs) in zip(labels, arrays["systems"]):
        sub = _unsuffixed(traj, label)
        subs.append(UnitarySmoothPulseProblem(
            QuantumSystem(Hd, list(Hs)), None, sub.T, float(np.mean(sub.get_timesteps())),
            init_trajectory=sub, Q=Q, R=R, ipopt_options=ipopt_options, piccolo_options=opts,
            device=device))
    prob = UnitaryDirectSumProblem(
        subs, floor, prob_labels=labels, graph=graph, boundary_values=boundary_values, Q=Q,
        R=R, R_b=R_b, drive_reset_ratio=0.0, fidelity_cost=fidelity_cost, subspace=subspace,
        ipopt_options=ipopt_options, piccolo_options=opts, device=device,
    )
    return _checked(prob, arrays, rtol)
