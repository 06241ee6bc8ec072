"""Carry a problem's data from the JAX package into the port.

This system has no weights: its parameters are the problem data.
`problem_arrays` reads a JAX-package problem as plain numpy (the system's
Hamiltonians and generators, the trajectory with its bounds and pins, the
initial decision Z0, the solver's variable, defect and objective scales,
and each integrator's class, Padé order and squaring count).  It only
reads attributes and calls numpy, so it imports nothing of JAX.
`unitary_smooth_pulse_from_arrays` and
`quantum_state_smooth_pulse_from_arrays` build the port's problem from
those arrays and check that the port derives the same integrators and the
same NLP scaling: an exponential integrator's squaring count comes from a
host-side norm bound, and a port that derived another count would build
another NLP.
"""

from __future__ import annotations

import numpy as np
import torch

from .problems.quantum_state_smooth_pulse import QuantumStateSmoothPulseProblem
from .problems.unitary_smooth_pulse import UnitarySmoothPulseProblem
from .quantum.isomorphisms import iso_to_ket
from .quantum.systems import QuantumSystem
from .solver.options import PiccoloOptions
from .trajectory.named_trajectory import NamedTrajectory

__all__ = [
    "problem_arrays",
    "system_from_arrays",
    "trajectory_from_arrays",
    "unitary_smooth_pulse_from_arrays",
    "quantum_state_smooth_pulse_from_arrays",
]


def _integrator_specs(integrators):
    """(class name, order, num_squarings) of each integrator; None where
    the class has no such field."""
    return [
        (type(ig).__name__, getattr(ig, "order", None), getattr(ig, "num_squarings", None))
        for ig in integrators
    ]


def problem_arrays(prob, batch: int = 1) -> dict:
    """numpy snapshot of a JAX-package QuantumControlProblem."""
    traj = prob.trajectory
    solver = prob.solver
    analytic = solver.nlp.analytic
    return {
        "H_drift": np.asarray(prob.system.H_drift),
        "H_drives": np.asarray(prob.system.H_drives),
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
        "Z0": np.asarray(prob.initial_decision(batch), dtype=np.float64),
        "var_scale": np.asarray(solver.var_scale, dtype=np.float64),
        "obj_scale": float(solver.obj_scale),
        "defect_scale": (
            np.asarray(analytic.defect_scale, dtype=np.float64)
            if analytic is not None and analytic.defect_scale is not None
            else None
        ),
        "integrators": _integrator_specs(prob.integrators),
    }


def system_from_arrays(arrays) -> QuantumSystem:
    """The port's QuantumSystem; its generators must equal the source's."""
    system = QuantumSystem(arrays["H_drift"], list(arrays["H_drives"]))
    if not (np.allclose(system.G_drift, arrays["G_drift"])
            and np.allclose(system.G_drives, arrays["G_drives"])):
        raise ValueError("iso generators differ from the source problem's")
    return system


def trajectory_from_arrays(arrays) -> NamedTrajectory:
    data = arrays["data"]
    comps = {name: data[:, a:b] for name, (a, b) in arrays["components"].items()}
    return NamedTrajectory(
        comps, controls=arrays["controls"], timestep=arrays["timestep"],
        bounds=arrays["bounds"], initial=arrays["initial"], final=arrays["final"],
        goal=arrays["goal"],
    )


def _checked(prob, arrays, rtol):
    """(problem, Z0 tensor) once the port's integrators and NLP scaling
    match the source's; raises ValueError where they differ."""
    mine, theirs = _integrator_specs(prob.integrators), list(arrays["integrators"])
    if mine != theirs:
        raise ValueError(f"integrators {mine} differ from the source problem's {theirs}")
    solver = prob.solver
    checks = {
        "var_scale": (solver.var_scale, arrays["var_scale"]),
        "obj_scale": (solver.obj_scale, arrays["obj_scale"]),
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


def unitary_smooth_pulse_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    UnitarySmoothPulseProblem built with the same Q, R and integrator.
    Raises if the port's integrators or NLP scaling differ from the
    source's (scales by more than rtol)."""
    traj = trajectory_from_arrays(arrays)
    prob = UnitarySmoothPulseProblem(
        system_from_arrays(arrays), None, traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device,
    )
    return _checked(prob, arrays, rtol)


def quantum_state_smooth_pulse_from_arrays(
    arrays, *, Q, R, ipopt_options=None, piccolo_options=None, device=None, rtol=1e-5,
):
    """(problem, Z0 tensor) for the port, from `problem_arrays` of a JAX
    QuantumStateSmoothPulseProblem built with the same Q, R and integrator
    (and the default state name ψ̃); raises as
    unitary_smooth_pulse_from_arrays."""
    traj = trajectory_from_arrays(arrays)
    names = [n for n in traj.names if n.startswith("ψ̃")]
    prob = QuantumStateSmoothPulseProblem(
        system_from_arrays(arrays),
        [iso_to_ket(traj.initial[n]) for n in names], [iso_to_ket(traj.goal[n]) for n in names],
        traj.T, float(np.mean(traj.get_timesteps())),
        init_trajectory=traj, Q=Q, R=R, ipopt_options=ipopt_options,
        piccolo_options=_free_time(traj, piccolo_options), device=device,
    )
    return _checked(prob, arrays, rtol)
