"""UnitarySamplingProblem: one pulse for several sampled systems.

Counterpart of quantumcollocation_tpu/problems/unitary_sampling.py.  Each
sampled system gets its own unitary state component (Ũ⃗_system_i) and its
own propagator integrator; the controls, their derivatives and the
timestep are shared, by merging the per-system trajectories
(trajectory/directsums.py).  The objective sums each system's weighted
infidelity with the control regularizers.  The defect dimension grows with
the number of systems; the knot structure stays block-tridiagonal, and
each system is one propagator group of the analytic assembly.
"""

from __future__ import annotations

import numpy as np

from ..dynamics.integrators import (
    DerivativeIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from ..objectives.objectives import QuadraticRegularizer, UnitaryInfidelityObjective
from ..quantum.embedded import EmbeddedOperator, get_iso_vec_leakage_indices
from ..quantum.systems import QuantumSystem
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.directsums import merge as merge_trajs
from ..trajectory.initialization import initialize_unitary_trajectory
from ._options import apply_piccolo_options
from .problem import QuantumControlProblem

__all__ = ["UnitarySamplingProblem", "UnitarySamplingProblemFromDistribution"]


def _fan_out(value, n):
    return np.broadcast_to(np.asarray(value, dtype=float), (n,)).copy()


def UnitarySamplingProblem(
    systems,
    operators=None,
    T=None,
    dt=None,
    *args,
    system_weights=None,
    init_trajectory=None,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    state_name: str = "Ũ⃗",
    control_name: str = "a",
    timestep_name: str = "Δt",
    constraints=None,
    a_bound: float = 1.0,
    a_bounds=None,
    a_guess=None,
    da_bound: float = np.inf,
    da_bounds=None,
    dda_bound: float = 1.0,
    dda_bounds=None,
    dt_min: float | None = None,
    dt_max: float | None = None,
    Q: float = 100.0,
    R: float = 1e-2,
    R_a=None,
    R_da=None,
    R_dda=None,
    rng=None,
    device=None,
) -> QuantumControlProblem:
    """Two call forms, as the JAX package's:

    UnitarySamplingProblem([sys1, sys2, ...], operator(s), T, dt; ...)
    UnitarySamplingProblem(system_fn, sampler, num_samples, operator, T, dt; ...)

    One operator is the goal of every system.  The per-system trajectories
    draw from one numpy Generator (`rng`, default_rng(0)) in system order,
    as the JAX package's do, so both build the same trajectory."""
    if callable(systems) and not isinstance(systems, QuantumSystem):
        return UnitarySamplingProblemFromDistribution(
            systems, operators, int(T), dt, args[0], args[1],
            system_weights=system_weights, init_trajectory=init_trajectory,
            ipopt_options=ipopt_options, piccolo_options=piccolo_options, rng=rng,
            device=device,
        )
    systems = list(systems)
    if not isinstance(operators, (list, tuple)):
        operators = [operators] * len(systems)
    operators = list(operators)
    if len(systems) != len(operators):
        raise ValueError(f"{len(systems)} systems but {len(operators)} operators")
    n_sys = len(systems)
    system_weights = [1.0] * n_sys if system_weights is None else list(system_weights)
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()
    constraints = list(constraints or [])

    n_drives = systems[0].n_drives
    a_bounds = _fan_out(a_bound if a_bounds is None else a_bounds, n_drives)
    da_bounds = _fan_out(da_bound if da_bounds is None else da_bounds, n_drives)
    dda_bounds = _fan_out(dda_bound if dda_bounds is None else dda_bounds, n_drives)
    dt_mean = float(np.mean(dt))
    dt_min = 0.5 * dt_mean if dt_min is None else dt_min
    dt_max = 1.5 * dt_mean if dt_max is None else dt_max
    R_a = R if R_a is None else R_a
    R_da = R if R_da is None else R_da
    R_dda = R if R_dda is None else R_dda

    state_names = [f"{state_name}_system_{i + 1}" for i in range(n_sys)]
    if init_trajectory is not None:
        traj = init_trajectory
    else:
        rng = rng or np.random.default_rng(0)
        trajs = [
            initialize_unitary_trajectory(
                op, T, dt, sys.n_drives, (a_bounds, da_bounds, dda_bounds),
                state_name=sname, control_name=control_name, timestep_name=timestep_name,
                free_time=piccolo_options.free_time, dt_bounds=(dt_min, dt_max),
                geodesic=piccolo_options.geodesic,
                rollout_integrator=piccolo_options.rollout_integrator,
                bound_state=piccolo_options.bound_state, a_guess=a_guess, system=sys, rng=rng,
            )
            for sys, op, sname in zip(systems, operators, state_names)
        ]
        merge_names = {control_name: 1, "d" + control_name: 1, "dd" + control_name: 1}
        if piccolo_options.free_time:
            merge_names[timestep_name] = 1
        traj = merge_trajs(trajs, merge_names=merge_names)

    control_names = [n for n in traj.names if n.endswith(control_name)]
    J = QuadraticRegularizer(control_names[0], traj, R_a)
    J = J + QuadraticRegularizer(control_names[1], traj, R_da)
    J = J + QuadraticRegularizer(control_names[2], traj, R_dda)
    for weight, op, sname in zip(system_weights, operators, state_names):
        subspace = op.subspace if isinstance(op, EmbeddedOperator) else None
        J = J + weight * UnitaryInfidelityObjective(sname, traj, Q, subspace=subspace)

    all_embedded = all(isinstance(op, EmbeddedOperator) for op in operators)
    J, traj = apply_piccolo_options(
        J, constraints, piccolo_options, traj, state_names, timestep_name,
        state_leakage_indices=(
            [get_iso_vec_leakage_indices(op) for op in operators] if all_embedded else None
        ),
    )

    integrators = []
    for sys, sname in zip(systems, state_names):
        if piccolo_options.integrator == "pade":
            integrators.append(UnitaryPadeIntegrator(
                sname, control_name, sys, order=piccolo_options.pade_order,
                timestep_name=timestep_name))
        elif piccolo_options.integrator == "exponential":
            integrators.append(UnitaryExponentialIntegrator(
                sname, control_name, sys, drive_bounds=a_bounds,
                dt_max=dt_max if piccolo_options.free_time else dt_mean,
                timestep_name=timestep_name))
        else:
            raise ValueError("integrator must be 'pade' or 'exponential'")
    integrators.append(DerivativeIntegrator(control_names[0], control_names[1],
                                            timestep_name=timestep_name))
    integrators.append(DerivativeIntegrator(control_names[1], control_names[2],
                                            timestep_name=timestep_name))
    return QuantumControlProblem(
        traj, J, integrators, constraints=constraints, ipopt_options=ipopt_options,
        piccolo_options=piccolo_options, control_name=control_name, system=systems[0],
        device=device,
    )


def UnitarySamplingProblemFromDistribution(
    system_fn, sampler, num_samples: int, operator, T: int, dt, *, rng=None, **kwargs,
) -> QuantumControlProblem:
    """num_samples parameters drawn from `sampler` (a callable rng ->
    sample, an object with .rvs(random_state=rng), or a (low, high)
    uniform tuple) in order from `rng` (default_rng(0)), each made a
    system by system_fn; the trajectories then draw from the same rng."""
    rng = rng or np.random.default_rng(0)
    samples = []
    for _ in range(num_samples):
        if callable(sampler):
            samples.append(sampler(rng))
        elif hasattr(sampler, "rvs"):
            samples.append(sampler.rvs(random_state=rng))
        elif isinstance(sampler, tuple) and len(sampler) == 2:
            samples.append(rng.uniform(sampler[0], sampler[1]))
        else:
            raise TypeError("unsupported sampler")
    return UnitarySamplingProblem([system_fn(x) for x in samples], operator, T, dt, rng=rng,
                                  **kwargs)
