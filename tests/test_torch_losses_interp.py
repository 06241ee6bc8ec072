"""Port parity: the examples' calls, utils.losses, trajectory interpolation
and the multistart solve.

Float64 on the CPU, against the JAX package on the same numpy seeds:
(a) the package root's `fidelity` (utils.losses, imported last, as in
JAX) on a unitary problem and on a ket trajectory within 1e-12, the ket
overlap still under `quantum`, and `expv` against JAX's and scipy's;
(b) DataInterpolation on the same grid, resampled to another knot count
(linear and "previous") and at given times, resample_free_time from a
fixed-time and from a free-time trajectory, and
unitary_linear_interpolation with an EmbeddedOperator goal, each against
the JAX package's (1e-12); (c) solve_multistart on a Hadamard problem
(T=11, 4 seeds from default_rng(0), 4 iterations, the JAX side on its XLA
KKT backend): the same best seed as JAX, its written-back trajectory
within 1e-6, and the rollout fidelity of it within 1e-6.  One JAX
problem for the file; the checks are separate items, so that
`--dist loadfile` sends the file out before the long JAX files."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

T, DT = 11, 0.2


@functools.lru_cache(maxsize=None)  # one build per package for the whole file
def _hadamard(pkg):
    extra = {"kkt_backend": "xla"} if pkg is qct else {}
    dev = {} if pkg is qct else {"device": "cpu"}
    return pkg.UnitarySmoothPulseProblem(
        pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]]), pkg.GATES["H"], T,
        DT, ipopt_options=pkg.SolverOptions(print_level=1, tol=1e-6, **extra),
        piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(3), **dev)


def _same_traj(tt, tj, atol=1e-12):
    assert tt.names == tuple(tj.names) and tt.controls == tuple(tj.controls)
    assert tt.timestep == tj.timestep and tt.T == tj.T
    np.testing.assert_allclose(tt.data, np.asarray(tj.data), atol=atol)
    for field in ("bounds", "initial", "final", "goal"):
        a, b = getattr(tt, field), getattr(tj, field)
        assert list(a) == list(b), field
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=atol)


def test_root_fidelity_of_a_unitary_problem_matches_jax():
    # the root name is utils.losses' fidelity; the ket overlap stays in quantum
    assert qt.fidelity is qt.utils.losses.fidelity
    assert qt.quantum.fidelity is not qt.fidelity
    pj, pt = _hadamard(qct), _hadamard(qt)
    f_j = float(qct.fidelity(pj))
    np.testing.assert_allclose(qt.fidelity(pt), f_j, atol=1e-12)
    np.testing.assert_allclose(qt.fidelity(pt.trajectory, pt.system), f_j, atol=1e-12)
    np.testing.assert_allclose(qt.fidelity(pt), qt.unitary_rollout_fidelity(
        pt.trajectory, pt.system), atol=1e-12)


def test_root_fidelity_of_a_ket_trajectory_matches_jax():
    def ket(pkg):
        return pkg.initialize_state_trajectory(
            [np.array([0, 1])], [np.array([1, 0])], 8, DT, 1, [np.ones(1), np.ones(1), np.ones(1)])

    sys_j = qct.QuantumSystem(0.1 * qct.PAULIS["Z"], [qct.PAULIS["X"]])
    sys_t = qt.QuantumSystem(0.1 * qt.PAULIS["Z"], [qt.PAULIS["X"]])
    f_j = float(qct.fidelity(ket(qct), sys_j))
    assert 0.0 < f_j < 1.0
    np.testing.assert_allclose(qt.fidelity(ket(qt), sys_t), f_j, atol=1e-12)
    with pytest.raises(ValueError, match="system"):
        qt.fidelity(ket(qt))


def test_expv_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    A = 0.5 * rng.normal(size=(6, 6))
    b = rng.normal(size=6)
    e_j = np.asarray(qct.expv(0.7, jnp.asarray(A), jnp.asarray(b)))
    e_t = qt.expv(0.7, A, b).numpy()
    np.testing.assert_allclose(e_t, e_j, atol=1e-12)
    np.testing.assert_allclose(e_t, sla.expm(0.7 * A) @ b, atol=1e-10)
    mv = qt.expv(0.7, None, torch.as_tensor(b), matvec=lambda v: v @ torch.as_tensor(A).T)
    np.testing.assert_allclose(mv.numpy(), e_t, atol=1e-12)


def _free(pkg):
    """A free-time trajectory with timesteps of unequal length, so that the
    time grid is not uniform."""
    traj = pkg.initialize_unitary_trajectory(
        pkg.GATES["H"], T, DT, 2, [np.ones(2), np.full(2, np.inf), np.ones(2)],
        free_time=True, rng=np.random.default_rng(4))
    dts = 0.2 + 0.05 * np.sin(np.arange(T))
    if pkg is qct:
        return traj.update("Δt", dts)
    return traj.with_data(np.concatenate([traj.data[:, :-1], dts[:, None]], axis=1))


def _fixed(pkg):
    return pkg.initialize_unitary_trajectory(
        pkg.GATES["X"], T, DT, 2, [np.ones(2), np.full(2, np.inf), np.ones(2)],
        rng=np.random.default_rng(5))


@pytest.mark.parametrize("kind", ["linear", "previous"])
def test_data_interpolation_matches_jax(kind):
    tj, tt = _free(qct), _free(qt)
    np.testing.assert_allclose(tt.get_times(), np.asarray(tj.get_times()), atol=1e-15)
    ij, it = qct.DataInterpolation(tj, kind=kind), qt.DataInterpolation(tt, kind=kind)
    _same_traj(it(it.times), ij(ij.times))
    _same_traj(it(T=17), ij(T=17))
    times = np.sort(np.random.default_rng(1).uniform(0.0, float(tt.duration()), 9))
    _same_traj(it(times), ij(times))
    # on its own grid the data come back; Δt from the grid's differences
    same = it(tt.get_times())
    np.testing.assert_allclose(same.data[:, :-1], tt.data[:, :-1], atol=1e-12)
    np.testing.assert_allclose(same["Δt"][:-1, 0], tt["Δt"][:-1, 0], atol=1e-12)


@pytest.mark.parametrize("source", ["fixed", "free"])
def test_resample_free_time_matches_jax(source):
    make = _fixed if source == "fixed" else _free
    src_j, src_t = make(qct), make(qt)
    for n in (None, 21):
        rj, rt = qct.resample_free_time(src_j, T=n), qt.resample_free_time(src_t, T=n)
        _same_traj(rt, rj)
        assert rt.timestep == "Δt" and rt.T == (n or T)
    if source == "fixed":
        np.testing.assert_allclose(qt.resample_free_time(src_t).bounds["Δt"],
                                   [[0.5 * DT], [1.5 * DT]], rtol=1e-15)


def test_unitary_linear_interpolation_matches_jax():
    op_j = qct.EmbeddedOperator(qct.GATES["X"], [0, 1], 3)
    op_t = qt.EmbeddedOperator(qt.GATES["X"], [0, 1], 3)
    U0 = np.eye(3, dtype=complex)
    np.testing.assert_allclose(qt.unitary_linear_interpolation(U0, op_t, 7),
                               np.asarray(qct.unitary_linear_interpolation(U0, op_j, 7)),
                               atol=1e-15)
    np.testing.assert_allclose(
        qt.unitary_linear_interpolation(U0[:2, :2], qt.GATES["H"], 5),
        np.asarray(qct.unitary_linear_interpolation(U0[:2, :2], qct.GATES["H"], 5)), atol=1e-15)


def test_solve_multistart_keeps_the_same_seed_as_jax():
    pj, pt = _hadamard(qct), _hadamard(qt)
    saved = pj.trajectory, pt.trajectory
    try:
        pj.solve_multistart(4, sigma=0.3, rng=np.random.default_rng(0), max_iter=4)
        pt.solve_multistart(4, sigma=0.3, rng=np.random.default_rng(0), max_iter=4)

        def best(res):
            obj = np.asarray(res.objective, dtype=float)
            conv = np.asarray(res.converged, dtype=bool)
            score = np.where(conv, obj, obj + 1e10)
            return int(np.argmin(score)), score

        bj, sj = best(pj.result)
        bt, st = best(pt.result)
        assert bt == bj and len(set(np.round(sj, 6))) > 1  # the seeds differ
        np.testing.assert_allclose(st, sj, rtol=1e-6)
        np.testing.assert_allclose(pt.trajectory.data, np.asarray(pj.trajectory.data),
                                   atol=1e-6)
        np.testing.assert_allclose(qt.fidelity(pt), float(qct.fidelity(pj)), atol=1e-6)
    finally:  # the file's other checks read the unsolved problems
        pj.trajectory, pt.trajectory = saved
