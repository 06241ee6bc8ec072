"""Port parity: the multigoal batch (BASELINE config #5's template).

random_su bit for bit; multigoal_initial_decisions (2 SU(4) goals × 2
seeds, T=7) within 1e-10 with each instance's pinned W₀ = G† rows equal;
multigoal_rollout_fidelities within 1e-12; and 6 IPM iterations of an
SU(2) multigoal batch (B=4, T=9) against the JAX package on the same numpy
seeds, float64 on the CPU (Z within 1e-6, the KKT error within 1e-4
relative, as tests/test_torch_solve.py), with the NLP scaling computed
once at the identity goal and the pinned rows kept through the solve.
The JAX side runs on its XLA KKT backend and starts from _init_state_jit."""

import functools

import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.problems import multigoal as jmg
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)


def _su4_system(pkg):
    P, k = pkg.PAULIS, np.kron
    return pkg.QuantumSystem(0.1 * k(P["Z"], P["Z"]),
                             [k(P["Z"], P["X"]), k(P["X"], P["I"]), k(P["Y"], P["I"]),
                              k(P["I"], P["X"]), k(P["I"], P["Y"])])


@functools.lru_cache(maxsize=None)
def _problem(pkg_name, qubits):
    pkg = {"jax": qct, "port": qt}[pkg_name]
    extra = {} if pkg is qct else {"device": "cpu"}
    if qubits == 2:
        sysq, T, dt, free = _su4_system(pkg), 7, 0.3, False
    else:
        sysq = pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]])
        T, dt, free = 9, 0.2, True
    return pkg.UnitaryMultiGoalProblem(
        sysq, T, dt, Q=100.0, R=1e-2,
        ipopt_options=pkg.SolverOptions(print_level=1, tol=1e-6, line_search="filter",
                                        kkt_backend="xla"),
        piccolo_options=pkg.PiccoloOptions(verbose=False, free_time=free),
        rng=np.random.default_rng(0), **extra,
    )


def test_random_su_matches_jax_bit_for_bit():
    for n in (2, 4, 8):
        rj, rt = np.random.default_rng(2024), np.random.default_rng(2024)
        for _ in range(3):
            np.testing.assert_array_equal(qt.random_su(n, rt), jmg.random_su(n, rj))


def test_initial_decisions_and_rollout_fidelities_match_jax():
    pj, pt = _problem("jax", 2), _problem("port", 2)
    goals = [qt.random_su(4, np.random.default_rng(s)) for s in (1, 2)]
    Zj = np.asarray(jmg.multigoal_initial_decisions(
        pj, goals, n_seeds_per_goal=2, sigma=0.2, rng=np.random.default_rng(100)))
    Zt = qt.multigoal_initial_decisions(pt, goals, n_seeds_per_goal=2, sigma=0.2,
                                        rng=np.random.default_rng(100))
    assert Zt.shape == Zj.shape == (4, 7, pt.solver.nlp.d)
    np.testing.assert_allclose(Zt, Zj, atol=1e-10)
    # the pinned coordinates of each instance are its own W₀ = G†
    free = np.asarray(pt.solver.nlp.free_mask)
    u_sl = pt.trajectory.comp_slice("Ũ⃗")
    for b, G in enumerate(np.repeat(goals, 2, axis=0)):
        W0 = qt.operator_to_iso_vec(G.conj().T)
        np.testing.assert_array_equal(Zt[b, 0, u_sl], Zj[b, 0, u_sl])
        np.testing.assert_allclose(Zt[b, 0, u_sl], W0, atol=1e-15)
    np.testing.assert_array_equal(Zt[:, ~free], Zj[:, ~free])
    # float64 rollout check, on the seeds and on perturbed controls
    Zp = Zt.copy()
    Zp[:, 1:-1, pt.trajectory.comp_slice("a")] += 0.05
    for Z in (Zt, Zp):
        np.testing.assert_allclose(
            qt.multigoal_rollout_fidelities(pt, Z, goals, n_seeds_per_goal=2),
            np.asarray(jmg.multigoal_rollout_fidelities(pj, Z, goals, n_seeds_per_goal=2)),
            atol=1e-12)


def test_six_multigoal_iterations_match_jax():
    pj = _problem("jax", 1)
    goals = [qt.random_su(2, np.random.default_rng(s)) for s in (3, 4)]
    Z0 = np.asarray(jmg.multigoal_initial_decisions(
        pj, goals, n_seeds_per_goal=2, sigma=0.2, rng=np.random.default_rng(9)))
    pt, Z0_t, goals_t = interop.unitary_multigoal_from_arrays(
        interop.problem_arrays(pj, batch=4, Z0=Z0, goals=goals), Q=100.0, R=1e-2,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search="filter"),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    np.testing.assert_array_equal(goals_t, np.asarray(goals))
    # one scaling for the batch, from the identity goal's z0
    ident = _problem("port", 1)
    np.testing.assert_array_equal(pt.solver.var_scale, ident.solver.var_scale)
    assert pt.solver.obj_scale == ident.solver.obj_scale
    sj = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 6)
    st = pt.solver.init_state(Z0_t)
    for _ in range(6):
        st = pt.solver.step(st)
    np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6)
    np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(sj.n_iter))
    # the pinned rows (W₀ = G† of each instance) came through the solve
    Zout = pt.solver.unscale(st.Z.numpy())
    free = np.asarray(pt.solver.nlp.free_mask)
    np.testing.assert_allclose(Zout[:, ~free], Z0[:, ~free], atol=1e-14)
    np.testing.assert_allclose(
        qt.multigoal_rollout_fidelities(pt, Zout, goals, n_seeds_per_goal=2),
        np.asarray(jmg.multigoal_rollout_fidelities(pj, Zout, goals, n_seeds_per_goal=2)),
        atol=1e-12)
