"""Port parity: the robustness template and the AD dynamics route.

The robustness problem of the JAX package's template test (a drift-free
qubit, X and Y drives, the X gate by a constant π pulse, H_error = Z,
floor 0.99; T cut to 11 knots) in both packages, float64 on the CPU: the
accumulator defect (1e-12); the AD route's F, A, B, its pair Hessian and
the cost Hessians on seeded (Z, λ, w) against the JAX package's
make_nlp_functions, structured on the nonlinear coordinates and dense
(1e-10 of the largest entry); the AD route against the port's own analytic
route on a Hadamard problem built with jacobian_structure=False; a
QuadraticSmoothnessRegularizer pair term; 4 lifted IPM iterations of a
B=2 batch (m=1: the lift and its warm retries) with Z, σ, w, λ and δ_w as
tests/test_torch_leakage.py holds them; the template's explicit call
form; and the float64 Magnus cost and ζ-sweep fidelity the card's gates
use (bench_util).  The JAX functions are jitted once per problem."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.solver.stage_nlp import make_nlp_functions as jax_nlp_functions
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.solver.stage_nlp import make_nlp_functions

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

T, DT = 11, 0.2
Q, R = 100.0, 1e-2


def _warm(pkg):
    extra = {} if pkg is qct else {"device": "cpu"}
    a_guess = np.zeros((T, 2))
    a_guess[:, 0] = (np.pi / 2) / ((T - 1) * DT)
    return pkg.UnitarySmoothPulseProblem(
        pkg.QuantumSystem(None, [pkg.PAULIS["X"], pkg.PAULIS["Y"]]), pkg.GATES["X"], T, DT,
        a_guess=a_guess, Q=Q, R=R,
        ipopt_options=pkg.SolverOptions(print_level=1, tol=1e-7),
        piccolo_options=pkg.PiccoloOptions(verbose=False), **extra,
    )


@functools.lru_cache(maxsize=None)  # one JAX problem for the whole file
def _jax_robust():
    warm = _warm(qct)
    return qct.UnitaryRobustnessProblem(qct.PAULIS["Z"], warm, warm.system, final_fidelity=0.99)


def _seeded_Z0(prob, sigma=0.02):
    Z0 = np.asarray(prob.initial_decision(2)).copy()
    a_sl = prob.trajectory.comp_slice("a")
    Z0[1, 1:-1, a_sl] += sigma * np.random.default_rng(5).standard_normal((T - 2, 2))
    return Z0


@functools.lru_cache(maxsize=None)
def _pair():
    pj = _jax_robust()
    pt, Z0_t = interop.unitary_robustness_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj)), Q=Q, R=R,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-7),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    return pj, pt, Z0_t


def _close(mine, theirs, name, rel=1e-10):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(np.asarray(mine), theirs, rtol=0,
                               atol=rel * max(1.0, np.abs(theirs).max()), err_msg=name)


def test_accumulator_defect_matches_jax():
    traj = _jax_robust().trajectory
    rng = np.random.default_rng(0)
    # a Hermitian error with real and imaginary parts exercises both blocks
    H = np.array([[0.3, 0.2 - 0.7j], [0.2 + 0.7j, -0.5]])
    igj = qct.RobustnessAccumulatorIntegrator(H_error=H)
    igt = qt.RobustnessAccumulatorIntegrator(H_error=H)
    assert igt.defect_dim(traj) == igj.defect_dim(traj) == 8
    zs = np.asarray(traj.data)[:2] + 0.3 * rng.standard_normal((2, traj.dim))
    ref = np.asarray(jax.jit(lambda a, b: igj.defect(a, b, traj))(zs[0], zs[1]))
    out = igt.defect(torch.as_tensor(zs[0]), torch.as_tensor(zs[1]), traj).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-12)
    # batched over leading axes, as the analytic integrators
    outb = igt.defect(torch.as_tensor(zs[None, :1]), torch.as_tensor(zs[None, 1:]), traj)
    np.testing.assert_allclose(outb.numpy()[0, 0], ref, atol=1e-12)


def test_robustness_nlp_matches_jax():
    pj, pt, _ = _pair()
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (23, 21, 1)
    assert nt.analytic is None and nj.analytic is None
    assert tuple(nt.nl_coords) == tuple(nj.nl_coords) == tuple(range(15))
    assert pt.trajectory.names == ("Ũ⃗", "a", "da", "dda", "Δt", "m_rob")
    assert (pt.solver.fused_assembly_on, pt.solver.kkt_aug_on) == (False, True)
    assert (pj.solver.fused_assembly_on, pj.solver.kkt_aug_on) == (False, True)
    # the terminal cost's scale is fixed at build time from the duration
    zT = np.zeros(23)
    zT[15:] = 1.0
    term = [t for t in pt.objective.terms if t.label == "unitary_robustness"][0]
    np.testing.assert_allclose(float(term.make(torch.float64, "cpu")(torch.as_tensor(zT))),
                               8.0 / (2 * (T - 1) * DT) ** 2, rtol=1e-14)
    # the free-phase form (build only): the floor on the global phase
    # column, which is free at the last knot alone
    fp = []
    for pkg in (qct, qt):
        extra = {} if pkg is qct else {"device": "cpu"}
        a_guess = np.zeros((T, 2))
        a_guess[:, 0] = (np.pi / 2) / ((T - 1) * DT)
        warm_fp = pkg.UnitarySmoothPulseProblem(
            pkg.QuantumSystem(None, [pkg.PAULIS["X"], pkg.PAULIS["Y"]]), pkg.GATES["X"], T, DT,
            a_guess=a_guess, Q=Q, R=R, phase_operators=[pkg.PAULIS["Z"]],
            rng=np.random.default_rng(3), ipopt_options=pkg.SolverOptions(print_level=1),
            piccolo_options=pkg.PiccoloOptions(verbose=False), **extra)
        fp.append(pkg.UnitaryRobustnessProblem(pkg.PAULIS["Z"], warm_fp,
                                               phase_operators=[pkg.PAULIS["Z"]]))
    (nj_fp, nt_fp) = (p.solver.nlp for p in fp)
    assert (nt_fp.d, nt_fp.s, nt_fp.m) == (nj_fp.d, nj_fp.s, nj_fp.m) == (24, 21, 1)
    assert fp[1].global_slices == fp[0].global_slices == {"ϕ": (23, 24)}
    np.testing.assert_array_equal(nt_fp.free_mask[:, 23], np.asarray(nj_fp.free_mask)[:, 23])
    np.testing.assert_allclose(nt_fp.z0[:, 23], np.asarray(nj_fp.z0)[:, 23], rtol=1e-15)
    np.testing.assert_allclose(fp[1].constraints[-1].final_fidelity,
                               fp[0].constraints[-1].final_fidelity, rtol=1e-12)
    # the explicit call form builds the warm-start form's NLP
    warm = _warm(qt)
    explicit = qt.UnitaryRobustnessProblem(
        qt.PAULIS["Z"], warm.trajectory, warm.system, warm.objective, warm.integrators,
        warm.get_constraints(), final_fidelity=0.99, ipopt_options=warm.ipopt_options,
        piccolo_options=warm.piccolo_options, device="cpu")
    ref = qt.UnitaryRobustnessProblem(qt.PAULIS["Z"], warm, final_fidelity=0.99)
    assert explicit.trajectory.names == ref.trajectory.names
    np.testing.assert_array_equal(explicit.trajectory.data, ref.trajectory.data)
    assert [type(ig).__name__ for ig in explicit.integrators] == [
        type(ig).__name__ for ig in ref.integrators]
    np.testing.assert_array_equal(explicit.solver.var_scale, ref.solver.var_scale)


@pytest.mark.parametrize("structured", [True, False])
def test_ad_route_blocks_match_jax(structured):
    pj, pt, Z0_t = _pair()
    nj, nt = pj.solver.nlp, pt.solver.nlp
    if not structured:
        nj, nt = dataclasses.replace(nj, nl_coords=None), dataclasses.replace(nt, nl_coords=None)
    fj, ft = jax_nlp_functions(nj), make_nlp_functions(nt)
    rng = np.random.default_rng(7)
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    Zs = Zs + 0.05 * torch.as_tensor(rng.standard_normal(Zs.shape))
    lam = torch.as_tensor(rng.standard_normal((2, T - 1, nt.s)))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (2, T, 1)))
    F, A, B = ft.dyn_eval(Zs)
    Hc, Cc = ft.defect_curvature(Zs, lam)
    H0, C0 = ft.cost_hess(Zs, w)
    dyn_j, hess_j, cost_j = jax.jit(fj.dyn_eval), jax.jit(fj.hess_blocks), jax.jit(fj.cost_hess)
    for b in range(2):
        z, l_, w_ = Zs[b].numpy(), lam[b].numpy(), w[b].numpy()
        Fj, Aj, Bj, _, _ = dyn_j(z)
        Hj, Cj = hess_j(z, l_, w_)
        H0j, C0j = cost_j(z, w_)
        for name, mine, theirs in (("F", F, Fj), ("A", A, Aj), ("B", B, Bj),
                                   ("H", H0 + Hc, Hj), ("C", C0 + Cc, Cj),
                                   ("cost H", H0, H0j), ("cost C", C0, C0j)):
            _close(mine[b], theirs, name)
    np.testing.assert_array_equal(ft.defects(Zs).numpy(), F.numpy())
    assert float(Hc.abs().max()) > 1e-3 and float(Cc.abs().max()) > 1e-3


def test_ad_route_matches_analytic_route():
    # the Hadamard problem with jacobian_structure=False takes the AD route
    # (dense pair Hessian); with the analytic assembly dropped from the
    # structured NLP, the AD route's structured form
    def build(js):
        return qt.UnitarySmoothPulseProblem(
            qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]]), qt.GATES["H"], T,
            DT, ipopt_options=qt.SolverOptions(print_level=1, line_search="filter"),
            piccolo_options=qt.PiccoloOptions(verbose=False, jacobian_structure=js),
            rng=np.random.default_rng(0), device="cpu")

    pa, pd = build(True), build(False)
    assert pd.solver.nlp.analytic is None and pd.solver.nlp.nl_coords is None
    assert pa.solver.nlp.nl_coords == tuple(range(8, 15))
    np.testing.assert_allclose(pd.solver.var_scale, pa.solver.var_scale, rtol=1e-14)
    np.testing.assert_allclose(pd.solver.defect_scale, pa.solver.defect_scale, rtol=1e-14)
    an = pa.solver.nlp.analytic
    Z = torch.as_tensor(pa.initial_decision(2)) / torch.as_tensor(pa.solver.var_scale)
    Z = Z + 0.01 * torch.as_tensor(np.random.default_rng(1).standard_normal(Z.shape))
    lam = torch.as_tensor(np.random.default_rng(2).standard_normal((2, T - 1, pa.nlp.s)))
    F1, A1, B1, aux = an.dyn_eval(Z, an.banks_batched(Z, second_order=True))
    Hc1, Cc1 = an.defect_curvature(lam, aux)
    structured = make_nlp_functions(dataclasses.replace(pa.solver.nlp, analytic=None))
    for f in (pd.solver.funcs, structured):
        F2, A2, B2 = f.dyn_eval(Z)
        Hc2, Cc2 = f.defect_curvature(Z, lam)
        for name, x, y in (("F", F2, F1), ("A", A2, A1), ("B", B2, B1), ("Hc", Hc2, Hc1),
                           ("Cc", Cc2, Cc1)):
            _close(x, y, name, 1e-12)
    sa, sd = pa.solver.init_state(pa.initial_decision(2)), pd.solver.init_state(
        pd.initial_decision(2))
    for _ in range(3):
        sa, sd = pa.solver.step(sa), pd.solver.step(sd)
    _close(sd.Z, sa.Z, "Z after 3 iterations", 1e-9)


def test_quadratic_smoothness_pair_term_matches_jax():
    pj = _jax_robust()
    probs = {}
    for pkg, warm in ((qct, pj), (qt, _pair()[1])):
        extra = {} if pkg is qct else {"device": "cpu"}
        J = warm.objective + pkg.QuadraticSmoothnessRegularizer("a", warm.trajectory, [0.3, 0.7])
        probs[pkg] = pkg.QuantumControlProblem(
            warm.trajectory, J, warm.integrators, constraints=warm.get_constraints(),
            ipopt_options=pkg.SolverOptions(print_level=1),
            piccolo_options=pkg.PiccoloOptions(verbose=False), **extra)
    sj, st = probs[qct].solver, probs[qt].solver
    np.testing.assert_allclose(st.var_scale, sj.var_scale, rtol=1e-12)
    np.testing.assert_allclose(st.obj_scale, sj.obj_scale, rtol=1e-12)
    Z = torch.as_tensor(np.asarray(st.nlp.z0))[None] + 0.1 * torch.as_tensor(
        np.random.default_rng(4).standard_normal((1, T, st.nlp.d)))
    w = torch.ones(1, T, 1, dtype=torch.float64)
    z = Z[0].numpy()
    fj, ft = sj.funcs, st.funcs
    _close(ft.total_cost(Z)[0], jax.jit(fj.total_cost)(z), "cost", 1e-12)
    _close(ft.grad_cost(Z)[0], jax.jit(fj.grad_cost)(z), "grad", 1e-12)
    H, C = ft.cost_hess(Z, w)
    Hj, Cj = jax.jit(fj.cost_hess)(z, w[0].numpy())
    _close(H[0], Hj, "H")
    _close(C[0], Cj, "C")
    a0 = probs[qt].trajectory.components["a"][0]
    # the pair term couples a_t and a_{t+1}: -R v_a² on the C blocks
    np.testing.assert_allclose(C[0, :, a0, a0].numpy(), np.full(T - 1, -0.3 * st.obj_scale
                                                               * st.var_scale[a0] ** 2),
                               rtol=1e-12)


def test_four_lifted_iterations_match_jax():
    pj, pt, Z0_t = _pair()
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    lifted = 0
    for k in range(4):
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
    assert lifted >= 1, lifted


def test_magnus_cost_and_zeta_sweep_match_jax():
    # the float64 measures the card's gates use: the Magnus cost of a rollout
    # (the JAX package's template test's formula, on the JAX package's
    # rollout) and the rollout fidelity summed over the drift sweep
    from quantumcollocation_tpu_torch import bench_util as bu

    rng = np.random.default_rng(8)
    warm = _jax_robust().trajectory
    a = np.asarray(warm["a"])[None] + 0.05 * rng.standard_normal((2, T, 2))
    dts = np.broadcast_to(np.asarray(warm.get_timesteps()), (2, T)).copy()
    v0 = np.asarray(warm.initial["Ũ⃗"])
    sj = qct.QuantumSystem(None, [qct.PAULIS["X"], qct.PAULIS["Y"]])
    st = qt.QuantumSystem(None, [qt.PAULIS["X"], qt.PAULIS["Y"]])
    roll = jax.jit(lambda x, d: qct.unitary_rollout(v0, x, d, sj))
    ref = []
    for b in range(2):
        U = np.asarray(roll(a[b], dts[b]))
        M = sum(dts[b, t] * (lambda W: W.conj().T @ np.asarray(qct.PAULIS["Z"]) @ W)(
            np.asarray(qct.iso_vec_to_operator(U[t]))) for t in range(T - 1))
        ref.append(float(np.linalg.norm(M) ** 2) / (2 * dts[b, :-1].sum()) ** 2)
    np.testing.assert_allclose(bu.magnus_cost(a, dts, st, qt.PAULIS["Z"], v0), ref, rtol=1e-10)
    goal = np.asarray(qct.operator_to_iso_vec(qct.GATES["H"]))
    zetas = (-0.05, 0.02, 0.05)
    swept = np.zeros(2)
    for zeta in zetas:
        sz = qct.QuantumSystem(zeta * qct.PAULIS["Z"], [qct.PAULIS["X"], qct.PAULIS["Y"]])
        roll_z = jax.jit(jax.vmap(lambda x, d: qct.unitary_rollout(v0, x, d, sz)[-1]))
        swept += np.asarray(jax.vmap(lambda u: qct.iso_vec_unitary_fidelity(u, goal))(
            roll_z(a, dts)))
    np.testing.assert_allclose(bu.zeta_sweep_fidelity(a, dts, goal, v0, zetas=zetas), swept,
                               rtol=1e-10)
