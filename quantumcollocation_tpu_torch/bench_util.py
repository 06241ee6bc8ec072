"""Seeded KKT blocks, the propagator bank's inputs, CUDA timing, and the
hadamard, cnot, su4, min_time, leakage, sampling, robustness, free_phase,
free_phase_min_time, bang_bang, density, state_sampling and direct_sum
problems (the first two also in other solver modes) with their seeds and
float64 checks, shared by
chip_smoke.py, profile_step, the build comparison (sweep_builds) and the
GPU tests."""

from __future__ import annotations

import statistics

import numpy as np
import torch

__all__ = ["seeded_kkt", "bank_args", "seeded_bank", "time_ms", "graph_ms", "hadamard_problem",
           "hadamard_seeds", "cnot_problem", "su4_system",
           "su4_problem", "min_time_warm", "min_time_problem", "min_time_seeds",
           "leakage_problem", "leakage_seeds", "ZETAS", "zeta_system", "sampling_problem",
           "sampling_plain_problem", "sampling_seeds", "zeta_sweep_fidelity",
           "robustness_problem", "robustness_seeds", "magnus_cost", "free_phase_problem",
           "free_phase_seeds", "free_phase_min_time_problem", "free_phase_fidelity",
           "bang_bang_problem", "da_count", "DENSITY_GOAL", "density_system",
           "density_problem", "density_seeds", "density_fidelity", "KET_INIT", "KET_GOAL",
           "state_sampling_problem", "state_sampling_plain_problem", "MULTISTART_SIGMA",
           "multistart_seeds",
           "ket_fidelities", "ket_zeta_sweep_fidelity", "DS_FINAL_FIDELITY", "DS_RESET_RATIO",
           "DS_RESET_SIGMA", "DS_RESET_SEED", "direct_sum_parts", "direct_sum_problem",
           "direct_sum_seeds", "direct_sum_fidelities"]


def seeded_kkt(Bn, Tn, d, s, device, r=None, seed=0):
    """Seeded float32 blocks H, C, A, B, rz, rnu and a second right-hand
    side rz2, rnu2, shaped like dynamics defects (A ≈ -I, B ≈ I) and
    definite, so that float32 resolves them (their float32 error against
    float64 is ~1e-6 relative at d=15).  At the two-qubit size the noise
    shrinks with d, and B ≈ I/2 makes the chain contract: with B ≈ I the
    eliminated blocks sum H along the 40 knots, and the carried rhs reaches
    ~7e3, where float32 rounding alone is ~8e-5 of it (a CPU
    float32-vs-float64 probe).  With r, the right-hand sides have r
    columns."""
    rng = np.random.default_rng(seed)
    cols = () if r is None else (r,)
    small = d <= 16
    w = 0.3 if small else 1.0 / np.sqrt(d)
    Hs = np.eye(d) * 3 + w * rng.normal(size=(Bn, Tn, d, d))
    E = np.eye(s, d)
    out = [0.5 * (Hs + np.swapaxes(Hs, -1, -2)),
           (0.2 if small else 0.7 * w) * rng.normal(size=(Bn, Tn - 1, d, d)),
           -E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           (1.0 if small else 0.5) * E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols))]
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in out]


def bank_args(analytic, Z, var_scale, second_order=True, group=0):
    """The propagator bank's inputs on the (instance, knot) pairs of a
    problem's scaled Z (B, T, d), as the solver passes them for one of its
    propagator groups: (a (M, na), dt (M,), G_drift, G_drives, keywords of
    ops.prop_bank.prop_bank)."""
    g = analytic.groups[group]
    Zp = Z * torch.as_tensor(var_scale, dtype=Z.dtype, device=Z.device)
    na = g.G_drives.shape[0]
    a = Zp[:, :-1, g.a_slice[0]:g.a_slice[1]].reshape(-1, na).contiguous()
    free = g.dt_col is not None
    dt = (Zp[:, :-1, g.dt_col].reshape(-1).contiguous() if free
          else torch.full((a.shape[0],), g.dt_static, dtype=Z.dtype, device=Z.device))
    Gd = torch.as_tensor(g.G_drift, dtype=Z.dtype, device=Z.device)
    Gs = torch.as_tensor(g.G_drives, dtype=Z.dtype, device=Z.device)
    kw = dict(kind=g.kind, order=g.order, num_squarings=g.num_squarings, free_dt=free,
              second_order=second_order)
    return a, dt, Gd, Gs, kw


def seeded_bank(M, n, na, device, seed=0, a_scale=1.0, dt_range=(0.1, 0.4)):
    """Seeded float32 bank inputs a (M, na), dt (M,), G_drift (n, n),
    G_drives (na, n, n): controls uniform in ±a_scale, generators of
    entries ~0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(-a_scale, a_scale, size=(M, na)), rng.uniform(*dt_range, size=(M,)),
           0.5 * rng.normal(size=(n, n)), 0.5 * rng.normal(size=(na, n, n))]
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in out]


def time_ms(fn, n=20, warm=3):
    """Median of n calls of fn between two CUDA events, after warm calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n=20):
    """Median device time of one replay of a CUDA graph holding fn (its
    launches back to back, without the host between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture: the launchers' one-time set-up
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, n)


def _options(**kw):
    from . import SolverOptions

    return SolverOptions(**{**dict(print_level=1, kappa_mu=0.2, line_search="filter"), **kw})


def hadamard_problem(device=None, piccolo=None, **solver_options):
    """BASELINE #1's problem: Z drift, X and Y drives, the H gate, T=51,
    Δt=0.2 free, Q=1e4, R=1e-3, tol 1e-5, κ_μ 0.2, filter line search, with
    solver_options (e.g. kkt_backend, mu_strategy, watchdog_trials) and
    the PiccoloOptions fields in piccolo (e.g. eval_hessian=False)."""
    from . import GATES, PiccoloOptions, QuantumSystem, UnitarySmoothPulseProblem

    return UnitarySmoothPulseProblem(
        QuantumSystem(GATES["Z"], [GATES["X"], GATES["Y"]]), GATES["H"], 51, 0.2, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False, **(piccolo or {})),
        rng=np.random.default_rng(0), device=device,
    )


def hadamard_seeds(prob, B, seed):
    """(B, T, d) seeds: the initial decision with 0.1 N(0, 1) noise on the
    interior controls, drawn from default_rng(seed)."""
    return _control_noise(prob, B, seed, 0.1)


def cnot_problem(integrator="pade", **solver_options):
    """BASELINE #3's problem: su4_system's two qubits, the CX gate, T=40,
    Δt=0.3 fixed, Q=1e4, R=1e-3, tol 1e-5, κ_μ 0.2, filter line search,
    kkt_backend "lanes", the integrator ("pade" or "exponential"), with
    solver_options (e.g. soc=True).  Its seeds are
    multistart_initial_decisions(B, sigma=0.3)."""
    from . import GATES, PiccoloOptions, UnitarySmoothPulseProblem

    return UnitarySmoothPulseProblem(
        su4_system(), GATES["CX"], 40, 0.3, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, kkt_backend="lanes", **solver_options),
        piccolo_options=PiccoloOptions(verbose=False, free_time=False, integrator=integrator),
        rng=np.random.default_rng(7),
    )


def su4_system():
    """BASELINE #5's two qubits: drift 0.1 Z⊗Z, drives Z⊗X, X⊗I, Y⊗I,
    I⊗X, I⊗Y."""
    from . import PAULIS, QuantumSystem

    P, k = PAULIS, np.kron
    return QuantumSystem(0.1 * k(P["Z"], P["Z"]), [k(P["Z"], P["X"]), k(P["X"], P["I"]),
                                                  k(P["Y"], P["I"]), k(P["I"], P["X"]),
                                                  k(P["I"], P["Y"])])


def su4_problem(T=33, dt=0.3, device=None):
    """BASELINE #5's multigoal problem: Δt fixed, Q=1e4, R=1e-3, tol 1e-5,
    κ_μ 0.2, filter line search, kkt_backend "lanes"."""
    from . import PiccoloOptions, UnitaryMultiGoalProblem

    return UnitaryMultiGoalProblem(
        su4_system(), T, dt, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, kkt_backend="lanes"),
        piccolo_options=PiccoloOptions(verbose=False, free_time=False), device=device,
    )


def min_time_warm(T=51, dt=0.2, device=None):
    """BASELINE #2's warm stage: the fixed-time Hadamard smooth-pulse
    problem (Q=1e4, R=1e-3) at tol 1e-7 with recalc_y (feasibility
    tolerance 1e1) and kkt_backend "xla"."""
    from . import GATES, PiccoloOptions, QuantumSystem, UnitarySmoothPulseProblem

    return UnitarySmoothPulseProblem(
        QuantumSystem(GATES["Z"], [GATES["X"], GATES["Y"]]), GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-7, recalc_y="yes", recalc_y_feas_tol=1e1,
                               kkt_backend="xla"),
        piccolo_options=PiccoloOptions(verbose=False, free_time=False),
        rng=np.random.default_rng(0), device=device,
    )


def min_time_problem(warm, final_fidelity=0.99995, D=1000.0, **solver_options):
    """BASELINE #2's minimum-time stage on a solved warm stage: the
    free-time trajectory rolled out from the warm controls, the warm
    objective and integrators, the floor and D, tol 1e-6, kkt_backend
    "lanes", and solver_options (e.g. soc=True).  Returns (problem,
    duration before)."""
    from . import GATES, UnitaryMinimumTimeProblem, initialize_unitary_trajectory

    T = warm.trajectory.T
    traj = initialize_unitary_trajectory(
        GATES["H"], T, float(warm.trajectory.timestep), 2,
        [np.ones(2), np.full(2, np.inf), np.ones(2)],
        free_time=True, a_guess=np.asarray(warm.trajectory["a"]), system=warm.system,
    )
    prob = UnitaryMinimumTimeProblem(
        traj, warm.system, warm.get_objective(), warm.integrators, [],
        final_fidelity=final_fidelity, D=D,
        ipopt_options=_options(tol=1e-6, kkt_backend="lanes", **solver_options),
        device=warm.device,
    )
    return prob, float(traj.duration())


def min_time_seeds(prob, B, seed):
    """(B, T, d) seeds: the initial decision with 1e-4 N(0, 1) noise on
    the interior controls, inside the floor's basin."""
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    T = z0.shape[0]
    Z0[:, 1:-1, a_sl] += 1e-4 * np.random.default_rng(seed).standard_normal(
        (B, T - 2, a_sl.stop - a_sl.start))
    return Z0


def leakage_problem(T=40, dt=0.2, device=None):
    """BASELINE #4: a three-level transmon (omega 4.0, delta 0.2, rotating
    frame), the X gate embedded on its qubit subspace, a_bound 0.5, Q=1e4,
    R=1e-3, leakage suppression (R_leakage 0.1: L1 slack rows on the four
    leakage entries) at a fixed Δt, tol 1e-5, kkt_backend "lanes",
    rng default_rng(11).  Returns (problem, embedded goal)."""
    from . import EmbeddedOperator, GATES, PiccoloOptions, UnitarySmoothPulseProblem
    from .systems import TransmonSystem

    sysq = TransmonSystem(omega=4.0, delta=0.2, levels=3)
    goal = EmbeddedOperator(GATES["X"], sysq)
    prob = UnitarySmoothPulseProblem(
        sysq, goal, T, dt, a_bound=0.5, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, kkt_backend="lanes"),
        piccolo_options=PiccoloOptions(verbose=False, leakage_suppression=True, R_leakage=1e-1,
                                       free_time=False),
        rng=np.random.default_rng(11), device=device,
    )
    return prob, goal


def leakage_seeds(prob, B, seed):
    """(B, T, d) seeds: the initial decision with 0.05 N(0, 1) noise on the
    interior controls (the bench's)."""
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    T = z0.shape[0]
    Z0[:, 1:-1, a_sl] += 0.05 * np.random.default_rng(seed).standard_normal(
        (B, T - 2, a_sl.stop - a_sl.start))
    return Z0


ZETAS = (-0.05, 0.0, 0.05)  # example 04's drift samples


def zeta_system(zeta):
    """Example 04's system: drift ζ Z, drives X and Y."""
    from . import PAULIS, QuantumSystem

    return QuantumSystem(zeta * PAULIS["Z"], [PAULIS["X"], PAULIS["Y"]])


def sampling_problem(T=50, dt=0.2, zetas=ZETAS, device=None, dtype=None):
    """Example 04: UnitarySamplingProblem over the drift samples ζ, the H
    gate, Δt free, Q=1e4, R=1e-3, tol 1e-5, κ_μ 0.2, filter line search,
    kkt_backend "lanes", rng default_rng(0): one propagator group per ζ.
    dtype as SolverOptions.dtype (None: the device's)."""
    from . import GATES, PiccoloOptions, UnitarySamplingProblem

    return UnitarySamplingProblem(
        [zeta_system(z) for z in zetas], GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, kkt_backend="lanes", dtype=dtype),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
        device=device,
    )


def sampling_plain_problem(T=50, dt=0.2, device=None):
    """The non-robust counterpart: UnitarySmoothPulseProblem at ζ = 0 with
    sampling_problem's settings (its first system's controls and state)."""
    from . import GATES, PiccoloOptions, UnitarySmoothPulseProblem

    return UnitarySmoothPulseProblem(
        zeta_system(0.0), GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=_options(tol=1e-5, kkt_backend="lanes"),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
        device=device,
    )


def _control_noise(prob, B, seed, sigma):
    """(B, T, d) copies of the initial decision with sigma N(0, 1) noise on
    the interior controls, drawn from default_rng(seed)."""
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    T = z0.shape[0]
    Z0[:, 1:-1, a_sl] += sigma * np.random.default_rng(seed).standard_normal(
        (B, T - 2, a_sl.stop - a_sl.start))
    return Z0


def sampling_seeds(prob, B, seed):
    """(B, T, d) seeds: the initial decision with 0.1 N(0, 1) noise on the
    interior controls (the Hadamard path's); the same draws on the plain
    problem's controls."""
    return _control_noise(prob, B, seed, 0.1)


def zeta_sweep_fidelity(a, dts, goal, init, zetas=None, device="cpu"):
    """(B,) float64 rollout fidelities of the controls a (B, T, 2) and
    timesteps dts (B, T), summed over the drift sweep ζ ∈ -0.05:0.01:0.05
    (BASELINE.md's sampling comparison)."""
    from . import batched_rollout_fidelity

    zetas = np.arange(-0.05, 0.0501, 0.01) if zetas is None else zetas
    return sum(batched_rollout_fidelity(a, dts, zeta_system(z), goal, init, device=device)
               for z in zetas)


def robustness_problem(T=51, dt=0.2, final_fidelity=0.99, device=None, **solver_options):
    """The robustness warm start of the JAX package's template test: a
    drift-free qubit with X and Y drives, the X gate reached by a constant
    π pulse on X (T=51, Δt=0.2 free, tol 1e-7, kkt_backend "lanes", and
    solver_options, e.g. dtype), then UnitaryRobustnessProblem against
    H_error = Z with the fidelity floor final_fidelity.  Returns (problem,
    warm problem)."""
    from . import (GATES, PAULIS, PiccoloOptions, QuantumSystem, SolverOptions,
                   UnitaryRobustnessProblem, UnitarySmoothPulseProblem)

    sysq = QuantumSystem(None, [PAULIS["X"], PAULIS["Y"]])
    a_guess = np.zeros((T, 2))
    a_guess[:, 0] = (np.pi / 2) / ((T - 1) * dt)
    warm = UnitarySmoothPulseProblem(
        sysq, GATES["X"], T, dt, a_guess=a_guess,
        ipopt_options=SolverOptions(print_level=1, tol=1e-7, kkt_backend="lanes",
                                    **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), device=device,
    )
    return UnitaryRobustnessProblem(PAULIS["Z"], warm, sysq,
                                    final_fidelity=final_fidelity), warm


def robustness_seeds(prob, B, seed=5):
    """(B, T, d) seeds: the warm decision with 0.02 N(0, 1) noise on the
    interior controls, drawn from default_rng(seed)."""
    return _control_noise(prob, B, seed, 0.02)


def magnus_cost(a, dts, system, H_error, U_init, device="cpu"):
    """(B,) first-order Magnus sensitivities ||Σ_{t<T-1} dt_t U_t† H_e U_t||_F²
    / (N T_total)² of the float64 rollouts of the controls a (B, T, n_drives)
    with timesteps dts (B, T), T_total each instance's duration (the JAX
    package's test measure)."""
    from . import unitary_rollout

    Us = unitary_rollout(U_init, a, dts, system, device=device)  # (B, T, 2N²)
    N = int(round((Us.shape[-1] / 2) ** 0.5))
    V = Us.reshape(*Us.shape[:-1], N, 2 * N).transpose(-1, -2)
    U = torch.complex(V[..., :N, :], V[..., N:, :])[:, :-1]
    H = torch.as_tensor(np.asarray(H_error, dtype=np.complex128), device=U.device)
    dt = torch.as_tensor(np.asarray(dts, dtype=np.float64), device=U.device)[:, :-1]
    M = torch.einsum("bt,btji,jk,btkl->bil", dt.to(U.dtype), U.conj(), H, U)
    total = dt.sum(1)
    return ((M.abs() ** 2).sum((-1, -2)) / (N * total) ** 2).cpu().numpy()


def free_phase_problem(T=31, dt=0.2, device=None, **solver_options):
    """The JAX package's free-phase test (tests/test_free_phase_chaining.py):
    a drift-free qubit with an X drive alone, the Y gate up to a global Z
    phase (phase_operators [Z], the global variable ϕ), T=31, Δt=0.2
    free, Q=100, R=1e-2, tol 1e-6, rng default_rng(1234), with
    solver_options (e.g. dtype)."""
    from . import GATES, PAULIS, PiccoloOptions, QuantumSystem, SolverOptions
    from . import UnitarySmoothPulseProblem

    return UnitarySmoothPulseProblem(
        QuantumSystem([PAULIS["X"]]), GATES["Y"], T, dt, phase_operators=[PAULIS["Z"]],
        ipopt_options=SolverOptions(print_level=1, tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(1234),
        device=device,
    )


def free_phase_seeds(prob, B, seed):
    """(B, T, d_aug) seeds: the initial decision with 0.1 N(0, 1) noise on
    the interior controls, then each instance's phases π N(0, 1) at the
    last knot, both drawn from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    z0 = prob.initial_decision(1)[0]
    a_sl = prob.trajectory.comp_slice("a")
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    T = z0.shape[0]
    Z0[:, 1:-1, a_sl] += 0.1 * rng.standard_normal((B, T - 2, a_sl.stop - a_sl.start))
    for gs, ge in prob.global_slices.values():
        Z0[:, -1, gs:ge] = np.pi * rng.standard_normal((B, ge - gs))
    return Z0


def free_phase_min_time_problem(warm, final_fidelity=0.98, D=50.0):
    """The JAX free-phase test's chained stage: UnitaryMinimumTimeProblem
    warm-started from a solved free_phase_problem (its trajectory carries
    the solved phases), phase_operators [Z], the floor and D.  Returns
    (problem, duration before)."""
    from . import PAULIS, UnitaryMinimumTimeProblem

    prob = UnitaryMinimumTimeProblem(warm, phase_operators=[PAULIS["Z"]], D=D,
                                     final_fidelity=final_fidelity)
    return prob, float(warm.trajectory.duration())


def free_phase_fidelity(prob, Z, system, device="cpu"):
    """(up to the phases, plain): two (B,) float64 rollout fidelities of a
    free-phase problem's solutions Z (B, T, d_aug), the first up to each
    instance's phases (its last knot's global columns), the second
    without them."""
    from . import PAULIS, batched_rollout_fidelity

    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    (gs, ge), = prob.global_slices.values()
    out = {}
    for key, phases in (("phase", Z[:, -1, gs:ge]), ("plain", None)):
        out[key] = batched_rollout_fidelity(
            Z[:, :, traj.comp_slice("a")], Z[:, :, traj.comp_slice("Δt")][:, :, 0], system,
            traj.goal["Ũ⃗"], traj.initial["Ũ⃗"], phases=phases,
            phase_operators=None if phases is None else [PAULIS["Z"]], device=device)
    return out["phase"], out["plain"]


def bang_bang_problem(T=51, dt=0.2, phase=False, device=None, **solver_options):
    """The JAX package's bang-bang template test
    (tests/test_problem_templates.py): Z drift, X and Y drives, the H
    gate, T=51, Δt=0.2 free, R_bang_bang=0.5, da_bound 1.0, Q=100,
    R=1e-2, tol 1e-6, rng default_rng(1234); with phase, also the global
    Z phase of free_phase_problem."""
    from . import GATES, PAULIS, PiccoloOptions, QuantumSystem, SolverOptions
    from . import UnitaryBangBangProblem

    return UnitaryBangBangProblem(
        QuantumSystem(GATES["Z"], [GATES["X"], GATES["Y"]]), GATES["H"], T, dt,
        R_bang_bang=0.5, da_bound=1.0, phase_operators=[PAULIS["Z"]] if phase else None,
        ipopt_options=SolverOptions(print_level=1, tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(1234),
        device=device,
    )


def da_count(Z, da_slice, threshold=5e-2):
    """(B,) count of the entries |da| > threshold of each solution."""
    return (np.abs(np.asarray(Z)[:, :, da_slice]) > threshold).sum(axis=(1, 2))


DENSITY_GOAL = np.array([0.0, 1.0], dtype=complex)  # example 05's goal ket |1⟩


def density_system():
    """Example 05's open system: drift Z, drives X and Y, one dissipator
    0.05 a (a the two-level annihilation operator)."""
    from . import PAULIS, OpenQuantumSystem, annihilate

    return OpenQuantumSystem(PAULIS["Z"], [PAULIS["X"], PAULIS["Y"]], [0.05 * annihilate(2)])


def density_problem(T=30, dt=0.2, device=None, **solver_options):
    """Example 05's open-system problem: density_system, ρ0 = |0⟩⟨0|, the
    goal |1⟩, T=30, Δt=0.2 free, Q=100, R=1e-2 (the template's defaults),
    tol 1e-6, κ_μ 0.2, filter line search, rng default_rng(0), with
    solver_options (e.g. dtype).  The density integrator takes the AD
    route."""
    from . import DensityOperatorSmoothPulseProblem, PiccoloOptions

    return DensityOperatorSmoothPulseProblem(
        density_system(), np.array([[1, 0], [0, 0]], dtype=complex), DENSITY_GOAL, T, dt,
        ipopt_options=_options(tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
        device=device,
    )


def density_seeds(prob, B, seed):
    """(B, T, d) seeds: the initial decision with 0.1 N(0, 1) noise on the
    interior controls, drawn from default_rng(seed)."""
    return _control_noise(prob, B, seed, 0.1)


def density_fidelity(prob, Z, device="cpu"):
    """(B,) float64 open-rollout fidelities ⟨ψ|ρ_T|ψ⟩ of a density
    problem's solutions Z (B, T, d), ψ = DENSITY_GOAL."""
    from . import batched_open_rollout_fidelity

    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    return batched_open_rollout_fidelity(
        Z[:, :, traj.comp_slice("a")], Z[:, :, traj.comp_slice("Δt")][:, :, 0], prob.system,
        DENSITY_GOAL, traj.initial["ρ⃗̃"], device=device)


KET_INIT, KET_GOAL = np.array([1.0, 0.0], dtype=complex), np.array([0.0, 1.0], dtype=complex)


def state_sampling_problem(T=50, device=None, **solver_options):
    """QuantumStateSamplingProblem over the drift samples ζ Z (zeta_system),
    |0⟩ → |1⟩, T=50, Δt=0.2 free, Q=100, R=1e-2, tol 1e-6, κ_μ 0.2, filter
    line search, rng default_rng(0), with solver_options (e.g. dtype): one
    propagator group per ζ, the fused assembly at d=19."""
    from . import PiccoloOptions, QuantumStateSamplingProblem

    return QuantumStateSamplingProblem(
        [zeta_system(z) for z in ZETAS], KET_INIT, KET_GOAL, T, 0.2, Q=100.0, R=1e-2,
        ipopt_options=_options(tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
        device=device,
    )


def state_sampling_plain_problem(T=50, device=None, **solver_options):
    """The non-robust counterpart: QuantumStateSmoothPulseProblem at ζ = 0
    with state_sampling_problem's settings; the same rng draws its
    controls as the sampled problem's first system draws the shared ones."""
    from . import PiccoloOptions, QuantumStateSmoothPulseProblem

    return QuantumStateSmoothPulseProblem(
        zeta_system(0.0), KET_INIT, KET_GOAL, T, 0.2, Q=100.0, R=1e-2,
        ipopt_options=_options(tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
        device=device,
    )


MULTISTART_SIGMA = 0.1  # the state_sampling path's control perturbation


def multistart_seeds(prob, B, seed):
    """(B, T, d) seeds: multistart_initial_decisions(B, MULTISTART_SIGMA)
    from default_rng(seed): the first the clean decision, the others with
    perturbed controls and every state rolled out under them."""
    return prob.multistart_initial_decisions(B, sigma=MULTISTART_SIGMA,
                                             rng=np.random.default_rng(seed))


def ket_fidelities(prob, Z, device="cpu"):
    """(3, B) float64 ket rollout fidelities of a state_sampling problem's
    solutions Z (B, T, d): system j's ket ψ̃_system_j under ZETAS[j]."""
    from . import batched_ket_rollout_fidelity

    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    a, dts = Z[:, :, traj.comp_slice("a")], Z[:, :, traj.comp_slice("Δt")][:, :, 0]
    return np.stack([
        batched_ket_rollout_fidelity(a, dts, zeta_system(z), traj.goal[f"ψ̃_system_{j + 1}"],
                                     traj.initial[f"ψ̃_system_{j + 1}"], device=device)
        for j, z in enumerate(ZETAS)])


def ket_zeta_sweep_fidelity(a, dts, device="cpu"):
    """(B,) float64 ket rollout fidelities |⟨1|ψ_T⟩|² of the controls a (B,
    T, 2) and timesteps dts (B, T) from |0⟩, summed over the drift sweep
    ζ ∈ -0.05:0.01:0.05 (the sampling path's comparison, for kets)."""
    from . import batched_ket_rollout_fidelity, ket_to_iso

    return sum(batched_ket_rollout_fidelity(a, dts, zeta_system(z), ket_to_iso(KET_GOAL),
                                            ket_to_iso(KET_INIT), device=device)
               for z in np.arange(-0.05, 0.0501, 0.01))


# the direct_sum path's coupled problem: its floor, and the drive reset that
# both the template's one start and direct_sum_seeds' B starts draw
DS_FINAL_FIDELITY, DS_RESET_RATIO, DS_RESET_SIGMA, DS_RESET_SEED = 0.99, 0.25, 0.01, 2


def direct_sum_parts(T=31, device=None, **solver_options):
    """The JAX package's direct-sum test's subproblems
    (tests/test_problem_templates.py): hadamard's system, the H gate
    (rng default_rng(0)) and the X gate (default_rng(1)), T=31, Δt=0.2
    free, Q=100, R=1e-2, tol 1e-6, with solver_options (e.g. dtype)."""
    from . import GATES, PiccoloOptions, QuantumSystem, SolverOptions
    from . import UnitarySmoothPulseProblem

    return [UnitarySmoothPulseProblem(
        QuantumSystem(GATES["Z"], [GATES["X"], GATES["Y"]]), GATES[gate], T, 0.2,
        ipopt_options=SolverOptions(print_level=1, tol=1e-6, **solver_options),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(seed),
        device=device) for gate, seed in (("H", 0), ("X", 1))]


def direct_sum_problem(parts):
    """The test's UnitaryDirectSumProblem over (solved) parts: the chain
    graph on dda, Q=100, R=1e-2, the floor DS_FINAL_FIDELITY, the reset
    (DS_RESET_RATIO, DS_RESET_SIGMA) drawn from default_rng(DS_RESET_SEED)."""
    from . import UnitaryDirectSumProblem

    return UnitaryDirectSumProblem(
        parts, DS_FINAL_FIDELITY, drive_reset_ratio=DS_RESET_RATIO,
        drive_derivative_sigma=DS_RESET_SIGMA, rng=np.random.default_rng(DS_RESET_SEED))


def direct_sum_seeds(prob, parts, B, seed):
    """(B, T, d) seeds: B independent resets as the template makes its one
    (reset_drives with DS_RESET_RATIO and DS_RESET_SIGMA on the parts'
    merged solutions), all drawn from one default_rng(seed)."""
    from . import add_suffix, merge
    from .problems.unitary_direct_sum import reset_drives

    rng = np.random.default_rng(seed)
    labels = [str(i + 1) for i in range(len(parts))]
    merged = merge([add_suffix(p.trajectory, label) for p, label in zip(parts, labels)])
    Z0 = np.broadcast_to(prob.initial_decision(1)[0], (B, *prob.nlp.z0.shape)).copy()
    for b in range(B):
        Z0[b, :, :merged.dim] = reset_drives(merged, labels, DS_RESET_RATIO, DS_RESET_SIGMA, rng)
    return Z0


def direct_sum_fidelities(prob, Z, system, device="cpu"):
    """(2, B) float64 rollout fidelities of each part (Ũ⃗i under ai, Δti) of
    a direct sum's solutions Z (B, T, d)."""
    from . import batched_rollout_fidelity

    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    return np.stack([
        batched_rollout_fidelity(Z[:, :, traj.comp_slice(f"a{i}")],
                                 Z[:, :, traj.comp_slice(f"Δt{i}")][:, :, 0], system,
                                 traj.goal[f"Ũ⃗{i}"], traj.initial[f"Ũ⃗{i}"], device=device)
        for i in (1, 2)])


def cz_problem(T=75, dt=1.0, device=None, **solver_options):
    """BASELINE #5's canonical configuration (JAX
    tests/test_baseline_configs.py:54-80 at the upstream T=75): two
    three-level transmons (omegas 4.0, 4.5, deltas 0.2, dipole coupling
    0.01, rotating frame), CZ embedded on their qubit subspace, Δt=1.0
    free, a_bound 0.1, the template's Q=100, R=1e-2 and the default Padé-4,
    tol 1e-6, rng default_rng(5): d = 175, s = 171, the KKT route past 64
    and the bank at n = 18.  Returns (problem, embedded goal)."""
    from . import EmbeddedOperator, GATES, PiccoloOptions, SolverOptions, UnitarySmoothPulseProblem
    from .systems import MultiTransmonSystem

    sysq = MultiTransmonSystem(omegas=[4.0, 4.5], deltas=[0.2, 0.2],
                               gs=[[0.0, 0.01], [0.01, 0.0]], levels_per_transmon=3)
    goal = EmbeddedOperator(GATES["CZ"], sysq)
    prob = UnitarySmoothPulseProblem(
        sysq, goal, T, dt, a_bound=0.1,
        ipopt_options=SolverOptions(**{"print_level": 1, "tol": 1e-6, **solver_options}),
        piccolo_options=PiccoloOptions(verbose=False), rng=np.random.default_rng(5),
        device=device,
    )
    return prob, goal


CZ_SIGMA = 0.02  # the cz seeds' control perturbation (a fifth of a_bound)


def cz_seeds(prob, B, seed):
    """(B, T, d) dynamics-consistent seeds of the cz path:
    multistart_initial_decisions at σ = CZ_SIGMA from default_rng(seed)
    (seed 0 of the batch is the template's own controls); the JAX package
    draws the same rows from the same Generator."""
    return prob.multistart_initial_decisions(B, sigma=CZ_SIGMA, rng=np.random.default_rng(seed))


def cz_fidelities(prob, goal, Z, device="cpu"):
    """(B,) float64 subspace rollout fidelities of the cz solutions Z."""
    from . import batched_rollout_fidelity

    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    a = Z[:, :, traj.comp_slice("a")]
    dts = Z[:, :, traj.comp_slice("Δt")][..., 0]
    return batched_rollout_fidelity(a, dts, prob.system, traj.goal["Ũ⃗"], traj.initial["Ũ⃗"],
                                    subspace=goal.subspace, device=device)
