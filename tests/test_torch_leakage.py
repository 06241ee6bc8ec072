"""Port parity: the transmon leakage configuration (BASELINE #4) and the
modules it needs.

The embedded-operator maps and the subspace and leakage indices, the
transmon system in its four frames, the subspace fidelity with its
gradient, the L1 slack and complex-modulus rows with their Jacobians, the
embedded geodesic trajectory, the subspace rollout fidelity and
minimum-time floor, the leakage problem's NLP (layout, scales, L1 rows,
the solver modes) and 8 lifted IPM iterations of its batched solve (T=9,
B=2) against the JAX package on the same numpy seeds, float64 on the CPU.
The JAX side of the solve runs on its XLA KKT backend from
_init_state_jit (its Pallas kernels in interpret mode take minutes at
d=28).  Z within 1e-6, σ and w within 1e-6 relative, the accepted δ_w
within 1e-12 relative, the KKT error 1e-4 relative, as
tests/test_torch_min_time.py; the rest within 1e-10 unless stated."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)
from torch.func import grad, hessian, jacrev

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.systems import TransmonSystem as JaxTransmonSystem
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
T_SMALL = 9


def _transmon(pkg, **kw):
    return (JaxTransmonSystem if pkg is qct else qt.TransmonSystem)(**kw)


def _options(pkg, **kw):
    return pkg.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter", **kw)


@functools.lru_cache(maxsize=None)
def _leakage(pkg_name, backend="xla", T=T_SMALL):
    """(goal, problem): the bench's leakage configuration at T knots."""
    pkg = {"jax": qct, "port": qt}[pkg_name]
    sysq = _transmon(pkg, omega=4.0, delta=0.2, levels=3)
    goal = pkg.EmbeddedOperator(pkg.GATES["X"], sysq)
    extra = {} if pkg is qct else {"device": "cpu"}
    return goal, pkg.UnitarySmoothPulseProblem(
        sysq, goal, T, 0.2, a_bound=0.5, Q=1e4, R=1e-3,
        ipopt_options=_options(pkg, kkt_backend=backend),
        piccolo_options=pkg.PiccoloOptions(verbose=False, leakage_suppression=True,
                                           R_leakage=1e-1, free_time=False),
        rng=np.random.default_rng(11), **extra,
    )


def _seeded_Z0(prob, B=2, sigma=0.05):
    Z0 = np.asarray(prob.initial_decision(B)).copy()
    a_sl = prob.trajectory.comp_slice("a")
    T = Z0.shape[1]
    Z0[1:, 1:-1, a_sl] += sigma * np.random.default_rng(5).standard_normal((B - 1, T - 2, 2))
    return Z0


def test_embedded_operators_and_indices_match_jax():
    rng = np.random.default_rng(0)
    sys3 = _transmon(qct, levels=3), _transmon(qt, levels=3)
    two = [pkg.QuantumSystem(np.zeros((9, 9)), [np.eye(9)],
                             params={"subsystem_levels": (3, 3)}) for pkg in (qct, qt)]
    forms = [
        lambda pkg, s, t: pkg.EmbeddedOperator(pkg.GATES["X"], s),
        lambda pkg, s, t: pkg.EmbeddedOperator(pkg.GATES["H"], [0, 2], 4),
        lambda pkg, s, t: pkg.EmbeddedOperator(pkg.GATES["CZ"], t),
        lambda pkg, s, t: pkg.EmbeddedOperator(pkg.GATES["CX"], [0, 1, 3, 4],
                                               subsystem_levels=[3, 3]),
    ]
    for form in forms:
        ej, et = form(qct, sys3[0], two[0]), form(qt, sys3[1], two[1])
        np.testing.assert_array_equal(et.operator, ej.operator)
        assert (et.subspace, et.levels, et.subsystem_levels, et.shape) == (
            ej.subspace, ej.levels, ej.subsystem_levels, ej.shape)
        np.testing.assert_array_equal(np.asarray(et), np.asarray(ej))
        for fn in ("get_leakage_indices", "get_iso_vec_leakage_indices",
                   "get_iso_vec_subspace_indices"):
            assert getattr(qt, fn)(et) == getattr(qct, fn)(ej), fn
        U = rng.standard_normal((2, ej.levels, ej.levels)) + 0j
        np.testing.assert_array_equal(qt.unembed(U, et), qct.unembed(U, ej))
        np.testing.assert_array_equal(qt.embed(qt.unembed(ej.operator, et), et), ej.operator)
    for subspaces, levels in (([0, 1], 3), ([[0, 1], [0, 1]], [3, 3]), ([[0, 2], [1]], [3, 2])):
        assert qt.get_subspace_indices(subspaces, levels) == qct.get_subspace_indices(
            subspaces, levels)
    assert qt.get_leakage_indices([0, 2], 4) == qct.get_leakage_indices([0, 2], 4) == [1, 3]
    assert qt.get_iso_vec_leakage_indices(qt.EmbeddedOperator(qt.GATES["X"], sys3[1])) == [
        2, 5, 8, 11]
    for op in ("annihilate", "create", "number_op", "quad_op"):
        np.testing.assert_array_equal(getattr(qt, op)(4), getattr(qct, op)(4))
    a = qt.annihilate(3)
    np.testing.assert_array_equal(qt.lift(a, 1, [3, 2, 3]), qct.lift(a, 1, [3, 2, 3]))
    np.testing.assert_array_equal(qt.lift(qt.GATES["X"], 0, 2), qct.lift(qct.GATES["X"], 0, 2))


@pytest.mark.parametrize("frame", [
    {}, dict(lab_frame=True), dict(lab_frame=True, lab_frame_type="quartic"),
    dict(lab_frame=True, lab_frame_type="cosine", levels=4),
    dict(frame_omega=3.9, multiply_by_2pi=False), dict(drives=False),
])
def test_transmon_system_matches_jax(frame):
    sj, st = _transmon(qct, **frame), _transmon(qt, **frame)
    for name in ("H_drift", "H_drives", "G_drift", "G_drives"):
        np.testing.assert_allclose(np.asarray(getattr(st, name)), np.asarray(getattr(sj, name)),
                                   atol=1e-12, err_msg=name)
    assert st.params == sj.params and st.levels == sj.levels


def test_subspace_fidelity_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    N, sub = 3, (0, 1)
    goal = qct.EmbeddedOperator(qct.GATES["X"], _transmon(qct, levels=N))
    g = np.asarray(qct.operator_to_iso_vec(goal.operator))
    U = np.linalg.qr(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))[0]
    u = np.asarray(qct.operator_to_iso_vec(U)) + 0.05 * rng.standard_normal(2 * N * N)
    for subspace in (None, sub):
        fj = float(qct.iso_vec_unitary_fidelity(u, g, subspace=subspace))
        ft = qt.iso_vec_unitary_fidelity(torch.as_tensor(u), torch.as_tensor(g),
                                         subspace=subspace)
        np.testing.assert_allclose(float(ft), fj, atol=ATOL)
        np.testing.assert_allclose(qt.iso_vec_unitary_fidelity(u, g, subspace=subspace), fj,
                                   atol=ATOL)
        np.testing.assert_allclose(qt.unitary_fidelity(U, goal.operator, subspace=subspace),
                                   qct.unitary_fidelity(U, goal.operator, subspace=subspace),
                                   atol=ATOL)
        gj = jax.jit(jax.grad(lambda x: qct.iso_vec_unitary_fidelity(x, jnp.asarray(g),
                                                                     subspace=subspace)))(u)
        gt = grad(lambda x: qt.iso_vec_unitary_fidelity(x, torch.as_tensor(g),
                                                         subspace=subspace))(torch.as_tensor(u))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL)
    # the objective on the subspace, with its derivatives
    traj = _leakage("jax")[1].trajectory
    Jj = qct.UnitaryInfidelityObjective("Ũ⃗", traj, 7.0, subspace=sub).terms[0]
    Jt = qt.UnitaryInfidelityObjective("Ũ⃗", traj, 7.0, subspace=sub).terms[0]
    fn = Jt.make(torch.float64, "cpu")
    z = np.asarray(traj.data)[-1] + 0.02 * rng.standard_normal(traj.dim)
    np.testing.assert_allclose(float(fn(torch.as_tensor(z))), float(Jj.fn(z, {})), atol=ATOL)
    np.testing.assert_allclose(hessian(fn)(torch.as_tensor(z)).numpy(),
                               np.asarray(jax.jit(jax.hessian(lambda x: Jj.fn(x, {})))(z)),
                               atol=1e-9)


def test_constraint_rows_match_jax():
    rng = np.random.default_rng(2)
    traj = _leakage("jax")[1].trajectory
    idx = (2, 5, 8, 11)
    cases = [
        (qct.L1SlackConstraint("Ũ⃗", "Ũ⃗_l1_slack", idx),
         qt.L1SlackConstraint("Ũ⃗", "Ũ⃗_l1_slack", idx)),
        (qct.ComplexModulusConstraint("a", 0.4), qt.ComplexModulusConstraint("a", 0.4)),
        (qct.ComplexModulusContraint("dda", 1.3, pairs=[(1, 0)]),
         qt.ComplexModulusContraint("dda", 1.3, pairs=[(1, 0)])),
    ]
    for con_j, con_t in cases:
        assert con_t.ineq_dim(traj) == con_j.ineq_dim(traj)
        fn = con_t.make(traj, torch.float64, "cpu")
        z = np.asarray(traj.data)[3] + 0.1 * rng.standard_normal(traj.dim)
        gj = lambda x: con_j.ineq(x, 3, traj)  # noqa: E731
        gt = lambda x: fn(x, torch.tensor(3))  # noqa: E731
        zt = torch.as_tensor(z)
        np.testing.assert_allclose(gt(zt).numpy(), np.asarray(gj(z)), atol=ATOL)
        np.testing.assert_allclose(jacrev(gt)(zt).numpy(),
                                   np.asarray(jax.jit(jax.jacfwd(gj))(z)), atol=ATOL)
        w = rng.uniform(0.5, 2.0, con_j.ineq_dim(traj))
        np.testing.assert_allclose(
            hessian(lambda x: (torch.as_tensor(w) * gt(x)).sum())(zt),
            np.asarray(jax.jit(jax.hessian(lambda x: jnp.asarray(w) @ gj(x)))(z)), atol=ATOL)
        # every knot is active, also vectorized over t
        rows = torch.vmap(fn)(torch.as_tensor(np.array(traj.data)), torch.arange(traj.T))
        np.testing.assert_allclose(rows.numpy(), np.stack(
            [np.asarray(con_j.ineq(np.asarray(traj.data)[t], t, traj)) for t in range(traj.T)]),
            atol=ATOL)


@pytest.mark.parametrize("geodesic", [True, False])
def test_embedded_trajectory_matches_jax(geodesic):
    bounds = [np.full(2, 0.5), np.full(2, np.inf), np.ones(2)]
    trajs = [
        pkg.initialize_unitary_trajectory(
            pkg.EmbeddedOperator(pkg.GATES["H"], _transmon(pkg, levels=4)), 7, 0.2, 2, bounds,
            geodesic=geodesic, rng=np.random.default_rng(3))
        for pkg in (qct, qt)
    ]
    np.testing.assert_allclose(trajs[1].data, trajs[0].data, atol=1e-12)
    for field in ("initial", "goal"):
        np.testing.assert_allclose(getattr(trajs[1], field)["Ũ⃗"], getattr(trajs[0], field)["Ũ⃗"],
                                   atol=1e-12)
    # the leakage levels stay on the identity along the geodesic
    U = np.stack([qt.iso_vec_to_operator(row) for row in trajs[1]["Ũ⃗"]])
    if geodesic:
        np.testing.assert_allclose(np.abs(U[:, 2:, 2:]), np.broadcast_to(np.eye(2), (7, 2, 2)),
                                   atol=1e-12)


def test_leakage_nlp_matches_jax():
    gj, pj = _leakage("jax", "lanes")
    _, pt = _leakage("port", "lanes")
    traj = pt.trajectory
    assert dict(traj.components) == dict(pj.trajectory.components)
    assert list(traj.components)[-1] == "Ũ⃗_l1_slack" and traj.components["Ũ⃗_l1_slack"] == (24, 28)
    np.testing.assert_array_equal(traj.data, pj.trajectory.data)
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (28, 22, 8)
    assert "Ũ⃗_l1_slack" not in traj.bounds and "Ũ⃗_l1_slack" not in traj.initial
    # the modes JAX resolves for this NLP: no fused assembly (d > 24), one
    # refinement pass, the lift, warm retries and restoration on
    modes = lambda s: (s.fused_assembly_on, s.kkt_refine_n, s.kkt_aug_on,  # noqa: E731
                       s.retry_warm_on, s.resto_on)
    assert modes(pt.solver) == modes(pj.solver) == (False, 1, True, True, True)
    assert pj.solver.options.kkt_backend == "lanes"
    # interop: the layout, scales and rows derived again from the arrays
    arrays = interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj), operator=gj)
    assert arrays["constraints"] == [("L1SlackConstraint", "Ũ⃗", "Ũ⃗_l1_slack", (2, 5, 8, 11))]
    assert (arrays["m"], arrays["subspace"], arrays["levels"]) == (8, (0, 1), 3)
    np.testing.assert_allclose(arrays["ineq_scale"], np.ones(8), rtol=1e-12)
    kw = dict(Q=1e4, R=1e-3, ipopt_options=_options(qt, kkt_backend="lanes"), device="cpu")
    pi, _ = interop.unitary_smooth_pulse_from_arrays(
        arrays, piccolo_options=qt.PiccoloOptions(verbose=False, leakage_suppression=True,
                                                  R_leakage=1e-1), **kw)
    np.testing.assert_allclose(pi.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pi.solver.defect_scale, np.asarray(nj.analytic.defect_scale),
                               rtol=1e-12)
    assert pi.solver.obj_scale == pytest.approx(pj.solver.obj_scale, rel=1e-12)
    with pytest.raises(ValueError, match="constraints"):
        interop.unitary_smooth_pulse_from_arrays(
            arrays, piccolo_options=qt.PiccoloOptions(verbose=False), **kw)
    # the stage functions at a scaled point with nonzero duals
    Zs = torch.as_tensor(arrays["Z0"]) / torch.as_tensor(pt.solver.var_scale)
    w = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (2, T_SMALL, 8)))
    fj, ft = pj.solver.funcs, pt.solver.funcs
    zj, wj = Zs[1].numpy(), w[1].numpy()
    Ht, Ct = ft.cost_hess(Zs, w)
    Hj, Cj = jax.jit(fj.cost_hess)(zj, wj)
    for mine, theirs, atol in ((ft.ineqs(Zs), jax.jit(fj.ineqs)(zj), ATOL),
                               (ft.jac_ineq(Zs), jax.jit(fj.jac_ineq)(zj), ATOL),
                               (Ht, Hj, 1e-9), (Ct, Cj, 1e-9)):
        np.testing.assert_allclose(mine[1].numpy(), np.asarray(theirs), atol=atol)


def test_eight_lifted_iterations_match_jax():
    gj, pj = _leakage("jax")
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj), operator=gj), Q=1e4, R=1e-3,
        ipopt_options=_options(qt, kkt_backend="xla"),
        piccolo_options=qt.PiccoloOptions(verbose=False, leakage_suppression=True,
                                          R_leakage=1e-1), device="cpu",
    )
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    lifted = 0
    for k in range(8):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6, err_msg=f"Z, {k}")
        for name in ("sig", "w", "lam"):
            a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(b).max()),
                                       err_msg=f"{name}, it {k}")
        np.testing.assert_allclose(st.reg_dw.numpy(), np.asarray(sj.reg_dw), rtol=1e-12,
                                   err_msg=f"dw, it {k}")
        np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4,
                                   atol=1e-8)
        lifted += int((st.reg_dw > 0).sum())
    # regularized (lifted, warm-started) attempts carried most iterations
    assert lifted >= 8, lifted


def test_subspace_rollout_and_minimum_time_floor_match_jax():
    def base(pkg):
        extra = {} if pkg is qct else {"device": "cpu"}
        sysq = _transmon(pkg, levels=3)
        goal = pkg.EmbeddedOperator(pkg.GATES["X"], sysq)
        return goal, sysq, pkg.UnitarySmoothPulseProblem(
            sysq, goal, 7, 0.2, a_bound=0.5, ipopt_options=_options(pkg),
            piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(4),
            **extra)

    (gj, sj, bj), (gt, st, bt) = base(qct), base(qt)
    np.testing.assert_array_equal(bt.trajectory.data, bj.trajectory.data)
    for sub in (None, gj.subspace):
        np.testing.assert_allclose(
            qt.unitary_rollout_fidelity(bt.trajectory, st, subspace=sub),
            float(qct.unitary_rollout_fidelity(bj.trajectory, sj, subspace=sub)), atol=1e-9)
    mj = qct.UnitaryMinimumTimeProblem(bj, D=10.0, subspace=gj.subspace)
    mt = qt.UnitaryMinimumTimeProblem(bt, D=10.0, subspace=gt.subspace)
    cj, ct = mj.constraints[-1], mt.constraints[-1]
    assert tuple(ct.subspace) == tuple(cj.subspace) == (0, 1)
    np.testing.assert_allclose(ct.final_fidelity, cj.final_fidelity, rtol=1e-12)
    fn = ct.make(mt.trajectory, torch.float64, "cpu")
    z = np.asarray(mt.trajectory.data)[-1]
    np.testing.assert_allclose(fn(torch.as_tensor(z), torch.tensor(6)).numpy(),
                               np.asarray(cj.ineq(z, 6, mj.trajectory)), atol=ATOL)
