"""Port parity: the two-ket state-transfer problem with the exponential
integrator, and the CNOT problem with the same integrator.

The ket layer (iso maps, fidelities, rollouts), the trajectory
initialisation, the state objective, the integrators' squaring counts, the
NLP scaling, the Padé ket integrator's assembly, the multistart seeds, and
8 IPM iterations of the batched
two-ket solve (B=4, T=11) against the JAX package on the same numpy seeds,
float64 on the CPU.  The JAX side of the solve runs on its XLA KKT backend
(its fused assembly is on at d=15, as the port's).  Z within 1e-6, as
tests/test_torch_solve.py; the rest within 1e-10 unless stated."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.quantum.fidelities import fidelity as jax_fidelity
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.ops.dyn_assembly import dyn_assembly

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
KETS0 = [np.array([1, 0]), np.array([0, 1])]
KETS1 = [np.array([0, 1]), np.array([1, 0])]


def _options(pkg, **kw):
    return pkg.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter", **kw)


def _problem(pkg_name, case="ket_exp", T=11):
    # the cache's key is positional, so _problem("jax") and
    # _problem("jax", "ket_exp") share one build
    return _build(pkg_name, case, T)


@functools.lru_cache(maxsize=None)  # one build per case for the whole file
def _build(pkg_name, case, T):
    pkg = {"jax": qct, "port": qt}[pkg_name]
    extra = {} if pkg is qct else {"device": "cpu"}
    if case == "cnot_exp":
        P, k = pkg.PAULIS, np.kron
        sysq = pkg.QuantumSystem(0.1 * k(P["Z"], P["Z"]),
                                 [k(P["Z"], P["X"]), k(P["X"], P["I"]), k(P["Y"], P["I"]),
                                  k(P["I"], P["X"]), k(P["I"], P["Y"])])
        return pkg.UnitarySmoothPulseProblem(
            sysq, pkg.GATES["CX"], 6, 0.3, Q=1e4, R=1e-3,
            ipopt_options=_options(pkg, kkt_backend="lanes"),
            piccolo_options=pkg.PiccoloOptions(verbose=False, integrator="exponential",
                                               free_time=False),
            rng=np.random.default_rng(7), **extra,
        )
    sysq = pkg.QuantumSystem(0.1 * pkg.PAULIS["Z"], [pkg.PAULIS["X"], pkg.PAULIS["Y"]])
    return pkg.QuantumStateSmoothPulseProblem(
        sysq, KETS0, KETS1, T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=_options(pkg, kkt_backend="xla"),
        piccolo_options=pkg.PiccoloOptions(
            verbose=False, integrator="pade" if case == "ket_pade" else "exponential"),
        rng=np.random.default_rng(0), **extra,
    )


def test_ket_maps_fidelities_and_rollouts_match_jax():
    rng = np.random.default_rng(2)
    psi = rng.standard_normal((6, 3)) + 1j * rng.standard_normal((6, 3))
    iso = qt.ket_to_iso(psi)
    np.testing.assert_array_equal(iso, np.asarray(qct.ket_to_iso(psi)))
    np.testing.assert_array_equal(qt.ket_to_iso(torch.as_tensor(psi)).numpy(), iso)
    np.testing.assert_array_equal(qt.iso_to_ket(iso), np.asarray(qct.iso_to_ket(iso)))
    goal = qt.ket_to_iso(psi[0])
    ref = np.array([float(qct.iso_fidelity(v, goal)) for v in iso])
    np.testing.assert_allclose(qt.iso_fidelity(iso, goal), ref, atol=1e-12)
    np.testing.assert_allclose(
        qt.iso_fidelity(torch.as_tensor(iso), torch.as_tensor(goal)).numpy(), ref, atol=1e-12)
    # the ket overlap is quantum.fidelity; the root name is utils.losses'
    # problem-or-trajectory fidelity, as in the JAX package
    np.testing.assert_allclose(qt.quantum.fidelity(psi[1], psi[0]),
                               jax_fidelity(psi[1], psi[0]), rtol=1e-12)
    # the ket rollout knot by knot, and the rollout fidelity of each ket
    pj, pt = _problem("jax"), _problem("port")
    a, dts = np.asarray(pj.trajectory["a"]), np.asarray(pj.trajectory.get_timesteps())
    roll_j = jax.jit(lambda v, x, t: qct.rollout(v, x, t, pj.system))
    for name in ("ψ̃1", "ψ̃2"):
        v0 = np.asarray(pj.trajectory.initial[name])
        np.testing.assert_allclose(qt.rollout(v0, a, dts, pt.system).numpy(),
                                   np.asarray(roll_j(v0, a, dts)), atol=ATOL)
        np.testing.assert_allclose(
            qt.rollout_fidelity(pt.trajectory, pt.system, state_name=name),
            float(qct.rollout_fidelity(pj.trajectory, pj.system, state_name=name)), atol=ATOL)


@pytest.mark.parametrize("kets, guess", [((KETS0, KETS1), False), ((KETS0[:1], KETS1[:1]), True)])
def test_initialize_state_trajectory_matches_jax(kets, guess):
    T = 7
    a_guess = 0.3 * np.random.default_rng(4).standard_normal((T, 2)) if guess else None
    trajs = []
    for pkg in (qct, qt):
        sysq = pkg.QuantumSystem(0.1 * pkg.PAULIS["Z"], [pkg.PAULIS["X"], pkg.PAULIS["Y"]])
        trajs.append(pkg.initialize_state_trajectory(
            kets[1], kets[0], T, 0.2, 2, (np.ones(2), np.full(2, np.inf), np.ones(2)),
            free_time=True, dt_bounds=(0.1, 0.3), drive_derivative_sigma=0.01,
            a_guess=a_guess, system=sysq, rng=np.random.default_rng(5),
        ))
    tj, tt = trajs
    assert tt.names == tuple(tj.names)
    assert tt.names[:2] == (("ψ̃1", "ψ̃2") if len(kets[0]) == 2 else ("ψ̃", "a"))
    np.testing.assert_allclose(tt.data, np.asarray(tj.data), atol=ATOL)
    for field in ("initial", "final", "goal"):
        for name, val in getattr(tj, field).items():
            np.testing.assert_array_equal(getattr(tt, field)[name], np.asarray(val))
    assert tt.timestep == tj.timestep


def test_state_objective_value_and_gradient_match_jax():
    pj, pt = _problem("jax"), _problem("port")
    (tj, *_), (tt, *_) = qct.QuantumStateObjective("ψ̃1", pj.trajectory, 1e4).terms, \
        qt.QuantumStateObjective("ψ̃1", pt.trajectory, 1e4).terms
    fn = tt.make(torch.float64, "cpu")
    rng = np.random.default_rng(6)
    d = pt.trajectory.dim
    rows = [rng.standard_normal(d), np.asarray(pt.trajectory.data[-1])]
    rows[1][pt.trajectory.comp_slice("ψ̃1")] = pt.trajectory.goal["ψ̃1"]  # infidelity 0
    for z in rows:
        zj = jnp.asarray(z)
        np.testing.assert_allclose(float(fn(torch.as_tensor(z))), float(tj.fn(zj, {})),
                                   atol=1e-12)
        g_t = torch.func.grad(fn)(torch.as_tensor(z)).numpy()
        g_j = np.asarray(jax.jit(jax.grad(lambda x: tj.fn(x, {})))(zj))
        np.testing.assert_allclose(g_t, g_j, atol=1e-12)
    assert tt.weight == tj.weight == 1e4


@pytest.mark.parametrize("case, nsq", [("ket_exp", 1), ("cnot_exp", 2)])
def test_integrators_and_scaling_match_jax(case, nsq):
    pj, pt = _problem("jax", case), _problem("port", case)
    arrays = interop.problem_arrays(pj)
    specs = [x for x in arrays["integrators"] if x[0].endswith("ExponentialIntegrator")]
    assert specs and all(x[1:] == (8, nsq) for x in specs)
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s) == (nj.d, nj.s) == ((15, 13) if case == "ket_exp" else (47, 42))
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.defect_scale, np.asarray(nj.analytic.defect_scale),
                               rtol=1e-12)
    (g,) = nt.analytic.groups
    assert (g.kind, g.order, g.num_squarings) == ("exp", 8, nsq)
    assert (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n) == \
        (pj.solver.fused_assembly_on, pj.solver.kkt_refine_n) == \
        ((True, 0) if case == "ket_exp" else (False, 1))
    # a different squaring count is a different NLP: interop refuses it
    arrays["integrators"] = [(c, o, n + 1 if n else n) for c, o, n in arrays["integrators"]]
    build = (interop.quantum_state_smooth_pulse_from_arrays if case == "ket_exp"
             else interop.unitary_smooth_pulse_from_arrays)
    with pytest.raises(ValueError, match="integrators"):
        build(arrays, Q=1e4, R=1e-3, piccolo_options=qt.PiccoloOptions(
            verbose=False, integrator="exponential"), device="cpu")


def test_pade_ket_assembly_and_scaling_match_jax():
    # the Padé ket integrator: its interop spec, the NLP scaling, and the
    # fused assembly's plain version (two ncols=1 members, Padé kind)
    # against JAX's per-instance dyn_eval + defect_curvature
    pj, pt = _problem("jax", "ket_pade", T=6), _problem("port", "ket_pade", T=6)
    specs = interop.problem_arrays(pj)["integrators"]
    assert [x for x in specs if "QuantumState" in x[0]] == [("QuantumStatePadeIntegrator", 4, None)] * 2
    an_j, an_t = pj.solver.nlp.analytic, pt.solver.nlp.analytic
    (g,) = an_t.groups
    assert g.kind == "pade" and [m[4] for m in g.members] == [1, 1]
    assert pt.solver.fused_assembly_on == pj.solver.fused_assembly_on
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.defect_scale, np.asarray(an_j.defect_scale),
                               rtol=1e-12)
    rng = np.random.default_rng(8)
    z0 = np.asarray(pj.solver.nlp.z0)
    Z = z0[None] + 0.05 * rng.standard_normal((3, *z0.shape))
    lam = rng.standard_normal((3, z0.shape[0] - 1, an_j.s))

    def one(z, l):
        F, A, Bj, aux = an_j.dyn_eval(z, second_order=True)
        return (F, A, Bj, *an_j.defect_curvature(l, aux))

    ref = jax.jit(jax.vmap(one))(jnp.asarray(Z), jnp.asarray(lam))
    out = dyn_assembly(an_t, torch.as_tensor(Z), torch.as_tensor(lam))
    for name, o, r in zip(("F", "A", "B", "Hc", "Cc"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, err_msg=name)
    assert float(np.abs(np.asarray(ref[4])).max()) > 0  # the Padé kind's Cc term


def test_multistart_ket_seeds_match_jax():
    pj, pt = _problem("jax"), _problem("port")
    rows_j = np.asarray(pj.multistart_initial_decisions(4, sigma=0.1, rng=np.random.default_rng(3)))
    rows_t = pt.multistart_initial_decisions(4, sigma=0.1, rng=np.random.default_rng(3))
    assert rows_t.shape == (4, 11, 15)
    np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=ATOL)
    # seeds start on the dynamics: an order-12 rollout against the order-8
    # exponential defect leaves ~1e-10
    F = pt.solver.funcs.defects(torch.as_tensor(rows_t / pt.solver.var_scale))
    assert float(F.abs().max()) < 1e-8
    assert np.abs(rows_t[1] - rows_t[0]).max() > 0.01


def test_eight_iterations_match_jax():
    pj = _problem("jax")
    Z0 = np.asarray(pj.multistart_initial_decisions(4, sigma=0.1, rng=np.random.default_rng(1)))
    arrays = interop.problem_arrays(pj)
    arrays["Z0"] = Z0
    pt, Z0_t = interop.quantum_state_smooth_pulse_from_arrays(
        arrays, Q=1e4, R=1e-3, ipopt_options=_options(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False, integrator="exponential"), device="cpu",
    )
    assert pt.solver.fused_assembly_on and pj.solver.fused_assembly_on
    st_j = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 8)
    st_t = pt.solver.init_state(Z0_t)
    for _ in range(8):
        st_t = pt.solver.step(st_t)
    np.testing.assert_allclose(st_t.Z.numpy(), np.asarray(st_j.Z), atol=1e-6)
    np.testing.assert_allclose(
        st_t.kkt_err.numpy(), np.asarray(st_j.kkt_err), rtol=1e-4, atol=1e-8
    )
    np.testing.assert_array_equal(st_t.n_iter.numpy(), np.asarray(st_j.n_iter))


def test_template_overloads():
    # the matrix-pair overload builds the same problem; a single ket pair
    # keeps the plain state name
    sysq = qt.QuantumSystem(0.1 * qt.PAULIS["Z"], [qt.PAULIS["X"], qt.PAULIS["Y"]])
    kw = dict(piccolo_options=qt.PiccoloOptions(verbose=False, integrator="exponential"),
              device="cpu")
    p1 = qt.QuantumStateSmoothPulseProblem(sysq, KETS0, KETS1, 6, 0.2,
                                           rng=np.random.default_rng(0), **kw)
    p2 = qt.QuantumStateSmoothPulseProblem(0.1 * qt.PAULIS["Z"], [qt.PAULIS["X"], qt.PAULIS["Y"]],
                                           KETS0, KETS1, 6, 0.2, rng=np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(p1.trajectory.data, p2.trajectory.data)
    p3 = qt.QuantumStateSmoothPulseProblem(sysq, KETS0[0], KETS1[0], 6, 0.2,
                                           rng=np.random.default_rng(0), **kw)
    assert p3.trajectory.names[0] == "ψ̃" and p3.solver.nlp.d == 11
    # leakage suppression on the kets: a slack component per ket and two
    # rows per index, as JAX's
    leak = [
        pkg.QuantumStateSmoothPulseProblem(
            pkg.QuantumSystem(0.1 * pkg.PAULIS["Z"], [pkg.PAULIS["X"], pkg.PAULIS["Y"]]),
            KETS0, KETS1, 6, 0.2, state_leakage_indices=[[1], [3]], rng=np.random.default_rng(0),
            piccolo_options=pkg.PiccoloOptions(verbose=False, integrator="exponential",
                                               leakage_suppression=True),
            **({"device": "cpu"} if pkg is qt else {}))
        for pkg in (qct, qt)
    ]
    assert leak[1].trajectory.names == leak[0].trajectory.names
    assert leak[1].trajectory.names[-2:] == ("ψ̃1_l1_slack", "ψ̃2_l1_slack")
    assert leak[1].solver.nlp.m == leak[0].solver.nlp.m == 4
    np.testing.assert_array_equal(leak[1].trajectory.data, leak[0].trajectory.data)
