"""Port parity: the sampling template (example 04: one pulse for several
drift samples) and the direct sums it merges its trajectories with.

The same problem from the same numpy seed in both packages, float64 on
the CPU: the merged trajectory's layout (component order, bounds, pins,
goals, controls, data) exactly; the distribution overload's draws; the
NLP's sizes, its three propagator groups, scales and resolved modes; and
4 IPM iterations of a B=2 batch (T=11, one refinement pass per KKT
attempt, the JAX side on its XLA backend) with Z within 1e-9 of the
largest entry, the KKT error within rtol 1e-6; and the EmbeddedOperator
branch with leakage suppression on two transmons (layout, m, scales and
the objective)."""

import functools

import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

T, DT, ZETAS = 11, 0.2, (-0.05, 0.0, 0.05)
Q, R = 1e4, 1e-3


def _system(pkg, zeta):
    return pkg.QuantumSystem(zeta * pkg.PAULIS["Z"], [pkg.PAULIS["X"], pkg.PAULIS["Y"]])


def _options(pkg, **kw):
    return pkg.SolverOptions(print_level=1, tol=1e-6, kappa_mu=0.2, line_search="filter", **kw)


@functools.lru_cache(maxsize=None)  # one build per package for the whole file
def _problem(pkg_name):
    pkg = {"jax": qct, "port": qt}[pkg_name]
    extra = {} if pkg is qct else {"device": "cpu"}
    return pkg.UnitarySamplingProblem(
        [_system(pkg, z) for z in ZETAS], pkg.GATES["H"], T, DT, Q=Q, R=R,
        ipopt_options=_options(pkg, kkt_backend="xla", kkt_refine=1),
        piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(1234),
        **extra,
    )


def _assert_same_layout(tt, tj):
    assert tt.names == tuple(tj.names)
    assert dict(tt.components) == dict(tj.components)
    assert tuple(tt.controls) == tuple(tj.controls) and tt.timestep == tj.timestep
    for field in ("initial", "final", "goal"):
        a, b = getattr(tt, field), getattr(tj, field)
        assert list(a) == list(b), field
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"{field}[{k}]")
    assert list(tt.bounds) == list(tj.bounds)
    for k, (lo, hi) in tt.bounds.items():
        np.testing.assert_array_equal(lo, np.asarray(tj.bounds[k][0]))
        np.testing.assert_array_equal(hi, np.asarray(tj.bounds[k][1]))
    np.testing.assert_array_equal(tt.data, np.asarray(tj.data))


def test_merged_layout_matches_jax():
    pj, pt = _problem("jax"), _problem("port")
    _assert_same_layout(pt.trajectory, pj.trajectory)
    assert pt.trajectory.names == ("Ũ⃗_system_1", "a", "da", "dda", "Δt", "Ũ⃗_system_2",
                                   "Ũ⃗_system_3")
    # the direct-sum helpers on their own: two trajectories merged with the
    # controls kept from the second, and a trajectory with its names suffixed
    merged, suffixed = {}, {}
    for pkg in (qct, qt):
        parts = [pkg.initialize_unitary_trajectory(
            pkg.GATES["X"], 5, 0.2, 2, [np.ones(2), np.full(2, np.inf), np.ones(2)],
            state_name=f"Ũ⃗_{i}", free_time=False, rng=np.random.default_rng(i))
            for i in range(2)]
        merged[pkg] = pkg.merge(parts, merge_names={"a": 2, "da": 2, "dda": 2})
        suffixed[pkg] = pkg.add_suffix(parts[0], "_s")
    _assert_same_layout(merged[qt], merged[qct])
    np.testing.assert_array_equal(merged[qt]["a"], np.asarray(qct.initialize_unitary_trajectory(
        qct.GATES["X"], 5, 0.2, 2, [np.ones(2), np.full(2, np.inf), np.ones(2)],
        free_time=False, rng=np.random.default_rng(1))["a"]))
    _assert_same_layout(suffixed[qt], suffixed[qct])
    assert suffixed[qt].names == ("Ũ⃗_0_s", "a_s", "da_s", "dda_s")
    assert qt.get_suffix("Ũ⃗_system_2", "Ũ⃗") == "_system_2"
    assert qct.get_suffix("Ũ⃗_system_2", "Ũ⃗") == "_system_2"
    assert qt.remove_suffix("a_0", "_0") == "a"
    ig = qt.UnitaryPadeIntegrator("Ũ⃗", "a", _system(qt, 0.0), timestep_name="Δt")
    ig2 = qt.add_suffix(ig, "_s")
    assert (ig2.state_name, ig2.control_name, ig2.timestep_name) == ("Ũ⃗_s", "a_s", "Δt_s")


@pytest.mark.parametrize("sampler", ["uniform", "callable"])
def test_distribution_overload_draws_match_jax(sampler):
    probs = {}
    for pkg in (qct, qt):
        extra = {} if pkg is qct else {"device": "cpu"}
        spec = (-0.05, 0.05) if sampler == "uniform" else (lambda rng: rng.normal(0.0, 0.03))
        probs[pkg] = pkg.UnitarySamplingProblem(
            lambda z, pkg=pkg: _system(pkg, z), spec, 3, pkg.GATES["H"], 7, 0.2,
            ipopt_options=_options(pkg), piccolo_options=pkg.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(5), **extra)
    pj, pt = probs[qct], probs[qt]
    drifts_j = [np.asarray(ig.system.H_drift) for ig in pj.integrators[:3]]
    drifts_t = [ig.system.H_drift for ig in pt.integrators[:3]]
    np.testing.assert_array_equal(np.stack(drifts_t), np.stack(drifts_j))
    assert len({float(d[0, 0].real) for d in drifts_t}) == 3
    _assert_same_layout(pt.trajectory, pj.trajectory)


def test_nlp_groups_and_modes_match_jax():
    pj, pt = _problem("jax"), _problem("port")
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (31, 29, 0)
    assert len(nt.analytic.groups) == len(nj.analytic.groups) == 3
    for gt, gj, zeta in zip(nt.analytic.groups, nj.analytic.groups, ZETAS):
        np.testing.assert_array_equal(gt.G_drift, np.asarray(gj.G_drift))
        np.testing.assert_array_equal(gt.G_drives, np.asarray(gj.G_drives))
        assert gt.G_drift.shape == (4, 4) and gt.G_drives.shape == (2, 4, 4)
        assert gt.dt_col == gj.dt_col == 14 and gt.a_slice == tuple(gj.a_slice) == (8, 10)
        assert np.abs(gt.G_drift).max() == pytest.approx(abs(zeta))
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.defect_scale, np.asarray(nj.analytic.defect_scale),
                               rtol=1e-12)
    got = (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n)
    assert got == (pj.solver.fused_assembly_on, pj.solver.kkt_refine_n) == (False, 1)
    # the card's setting: kkt_backend "lanes" refines once by "auto" at d=31
    lanes = qt.UnitarySamplingProblem(
        [_system(qt, z) for z in ZETAS], qt.GATES["H"], 5, DT,
        ipopt_options=_options(qt, kkt_backend="lanes"),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu")
    assert (lanes.solver.fused_assembly_on, lanes.solver.kkt_refine_n) == (False, 1)


def test_four_iterations_match_jax():
    pj = _problem("jax")
    Z0 = np.asarray(pj.initial_decision(2)).copy()
    a_sl = pj.trajectory.comp_slice("a")
    Z0[1, 1:-1, a_sl] += 0.1 * np.random.default_rng(3).standard_normal((T - 2, 2))
    pt, Z0_t = interop.unitary_sampling_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=Z0), Q=Q, R=R,
        ipopt_options=_options(qt, kkt_backend="xla", kkt_refine=1),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    sj = pj.solver._init_state_jit(Z0)
    st0 = st = pt.solver.init_state(Z0_t)
    for k in range(4):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        Zj = np.asarray(sj.Z)
        np.testing.assert_allclose(st.Z.numpy(), Zj, rtol=0, atol=1e-9 * np.abs(Zj).max(),
                                   err_msg=f"Z, it {k}")
        np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-6)
        np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(sj.n_iter))
    # the three systems share the controls: the iterate moved them
    assert (st.Z - st0.Z)[:, 1:-1, a_sl].abs().max() > 1e-3


def test_embedded_sampling_with_leakage_suppression_matches_jax():
    # the EmbeddedOperator branch: two three-level transmons of different
    # anharmonicity, the X gate on their qubit subspaces, an L1 leakage
    # penalty on each system's leakage entries (one slack component each)
    from quantumcollocation_tpu.systems import TransmonSystem as JaxTransmonSystem

    probs = {}
    for pkg in (qct, qt):
        transmon = JaxTransmonSystem if pkg is qct else qt.TransmonSystem
        systems = [transmon(omega=4.0, delta=d, levels=3) for d in (0.19, 0.21)]
        goal = pkg.EmbeddedOperator(pkg.GATES["X"], systems[0])
        extra = {} if pkg is qct else {"device": "cpu"}
        probs[pkg] = pkg.UnitarySamplingProblem(
            systems, goal, 7, 0.2, a_bound=0.5, Q=Q, R=R, ipopt_options=_options(pkg),
            piccolo_options=pkg.PiccoloOptions(verbose=False, leakage_suppression=True,
                                               R_leakage=0.1, free_time=False),
            rng=np.random.default_rng(2), **extra)
    pj, pt = probs[qct], probs[qt]
    _assert_same_layout(pt.trajectory, pj.trajectory)
    assert [n for n in pt.trajectory.names if n.endswith("l1_slack")] == [
        "Ũ⃗_system_1_l1_slack", "Ũ⃗_system_2_l1_slack"]
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) and nt.m == 16
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    # the objective at the initial point: both subspace infidelities, the
    # regularizers and the slack penalties
    z0 = torch.as_tensor(np.asarray(nt.z0))[None]
    np.testing.assert_allclose(pt.solver.funcs.total_cost(z0).numpy()[0],
                               float(pj.solver.funcs.total_cost(np.asarray(nj.z0))),
                               rtol=1e-12)
