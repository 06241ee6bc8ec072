"""Port parity: global free-phase variables and UnitaryBangBangProblem.

Float64 on the CPU, against the JAX package on the same numpy seeds:
(a) the primitives: the iso rotation R(φ) = exp(i Σ φ_k G_k) over |φ| up
to ~4π (1e-12), the free-phase fidelity with and without a subspace, the
free-phase objective's value, gradient and Hessian (its U–φ coupling comes
through the exponential) against jax.grad / jax.hessian, the free-phase
floor's row, Jacobian and the Hessian of w·g at the last knot and +1 off
it, and the rollout fidelity with phases, single and batched (1e-10);
(b) the free-phase smooth pulse (an X-only drive to the Y gate, T=5, B=2)
built through interop's _checked (the phase column in bounds, masks and
z0) and directly (the phase drawn before the controls, as JAX draws it),
its NLP cost and gradient with a phase per instance, write_back's
phases, then the chained free-phase minimum-time problem through
_checked with its scaled floor rows and their Jacobian against the JAX
package's NLP functions (1e-10); (c) UnitaryBangBangProblem with a phase
operator (d=16, s=11, m=4), built directly and through interop, for 5
lifted iterations, the phase column included, then write_back's phases.
Z within 1e-6, the duals within 1e-6 relative, the KKT error 1e-4
relative, as tests/test_torch_min_time.py.  The JAX solver starts from
_init_state_jit on the XLA KKT backend; each JAX function is jitted once
(the file's time is mostly the JAX compiles of one IPM step and of the
problems' scaling)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)
from torch.func import grad, hessian, jacrev

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
Q, R, T, DT = 100.0, 1e-2, 5, 0.2


def _opts(pkg, **kw):
    extra = {"kkt_backend": "xla"} if pkg is qct else {}
    return pkg.SolverOptions(print_level=1, tol=1e-6, **extra, **kw)


def _seeded_Z0(prob, sigma=0.05):
    Z0 = np.asarray(prob.initial_decision(2)).copy()
    a_sl = prob.trajectory.comp_slice("a")
    Z0[1, 1:-1, a_sl] += sigma * np.random.default_rng(5).standard_normal(
        (T - 2, a_sl.stop - a_sl.start))
    return Z0


def _assert_state(sj, st, k):
    np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6, err_msg=f"Z, it {k}")
    for name in ("sig", "w", "lam"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(b).max(initial=0)),
                                   err_msg=f"{name}, it {k}")
    np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(sj.n_iter))


def _lockstep(pj, pt, Z0_t, n):
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    for k in range(n):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        _assert_state(sj, st, k)
    return sj, st


def test_free_phase_primitives_match_jax():
    rng = np.random.default_rng(0)
    ops = [qct.PAULIS["Z"], qct.PAULIS["X"]]
    ph = np.array([0.01, 0.1, 1.0, np.pi, 4 * np.pi])[:, None] * rng.standard_normal((5, 2))
    Rj = np.asarray(qct.free_phase_iso_rotation(jnp.asarray(ph), ops))
    np.testing.assert_allclose(qt.free_phase_iso_rotation(torch.as_tensor(ph), ops).numpy(), Rj,
                               atol=1e-12)
    np.testing.assert_allclose(qt.free_phase_iso_rotation(ph, ops), Rj, atol=1e-12)
    # the fidelity on a three-level unitary, whole and on the subspace [0, 1]
    haar = [np.linalg.qr(rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3)))[0]
            for _ in range(2)]
    U, G = (qct.operator_to_iso_vec(x) for x in haar)
    ops3 = [np.diag([1.0, -1.0, 0.0]).astype(complex)]
    for sub in (None, [0, 1]):
        fj = float(qct.iso_vec_unitary_free_phase_fidelity(jnp.asarray(U), jnp.asarray(G),
                                                            jnp.asarray([1.3]), ops3,
                                                            subspace=sub))
        ft = qt.iso_vec_unitary_free_phase_fidelity(torch.as_tensor(U), torch.as_tensor(G),
                                                    torch.as_tensor(np.array([1.3])), ops3,
                                                    subspace=sub)
        np.testing.assert_allclose(float(ft), fj, atol=ATOL)
        np.testing.assert_allclose(qt.iso_vec_unitary_free_phase_fidelity(U, G, [1.3], ops3,
                                                                          subspace=sub),
                                   fj, atol=ATOL)

    # the objective and the floor on the knot row of a free-phase trajectory
    traj = qct.initialize_unitary_trajectory(
        qct.GATES["Y"], T, DT, 1, [np.ones(1), np.full(1, np.inf), np.ones(1)], free_time=True,
        phase_operators=[qct.PAULIS["Z"]], rng=np.random.default_rng(1234))
    gs = traj.dim
    z = np.append(np.asarray(traj.data)[-1] + 0.05 * rng.standard_normal(traj.dim), 0.7)
    zt = torch.as_tensor(z)
    Z1 = [qt.PAULIS["Z"]]
    Jj = qct.UnitaryFreePhaseInfidelityObjective("Ũ⃗", "ϕ", Z1, traj, 7.0).terms[0]
    Jt = qt.UnitaryFreePhaseInfidelityObjective("Ũ⃗", "ϕ", Z1, traj, 7.0).terms[0]
    fn = Jt.make(torch.float64, "cpu")

    def fj(x):
        return Jj.fn(x, {"ϕ": x[gs:]})

    def ft(x):
        return fn(x, {"ϕ": x[gs:]})

    g_j, h_j = (np.asarray(x) for x in jax.jit(lambda x: (jax.grad(fj)(x),
                                                          jax.hessian(fj)(x)))(z))
    np.testing.assert_allclose(float(ft(zt)), float(fj(z)), atol=ATOL)
    np.testing.assert_allclose(grad(ft)(zt).numpy(), g_j, atol=ATOL)
    np.testing.assert_allclose(hessian(ft)(zt).numpy(), h_j, atol=1e-9)
    assert np.abs(h_j[gs, :8]).max() > 1e-2  # the U–φ coupling is there
    con_j = qct.FinalUnitaryFreePhaseFidelityConstraint("Ũ⃗", "ϕ", Z1, 0.97,
                                                        global_slices={"ϕ": (gs, gs + 1)})
    con_t = qt.FinalUnitaryFreePhaseFidelityConstraint("Ũ⃗", "ϕ", Z1, 0.97,
                                                       global_slices={"ϕ": (gs, gs + 1)})
    row = con_t.make(traj, torch.float64, "cpu")
    w = np.array([1.7])

    def gj(x):
        return con_j.ineq(x, T - 1, traj)

    def gt(x):
        return row(x, torch.tensor(T - 1))

    r_j, jg_j, hg_j = (np.asarray(x) for x in jax.jit(lambda x: (
        gj(x), jax.jacfwd(gj)(x), jax.hessian(lambda y: jnp.asarray(w) @ gj(y))(x)))(z))
    np.testing.assert_allclose(gt(zt).numpy(), r_j, atol=ATOL)
    np.testing.assert_allclose(jacrev(gt)(zt).numpy(), jg_j, atol=ATOL)
    np.testing.assert_allclose(hessian(lambda x: torch.as_tensor(w) @ gt(x))(zt).numpy(), hg_j,
                               atol=1e-9)
    off = lambda x: row(x, torch.tensor(3))  # noqa: E731
    np.testing.assert_array_equal(off(zt).numpy(), [1.0])
    np.testing.assert_array_equal(jacrev(off)(zt).numpy(), 0.0)

    # the rollout fidelity with phases, one trajectory and a batch of two
    sysj, syst = qct.QuantumSystem([qct.PAULIS["X"]]), qt.QuantumSystem([qt.PAULIS["X"]])
    ph = np.array([-1.1])
    f_j = float(qct.unitary_rollout_fidelity(traj, sysj, phases=ph, phase_operators=Z1))
    f_t = qt.unitary_rollout_fidelity(traj, syst, phases=ph, phase_operators=Z1)
    np.testing.assert_allclose(f_t, f_j, atol=ATOL)
    a = np.stack([traj["a"], 0.5 * traj["a"]])
    dts = np.stack([traj.get_timesteps()] * 2)
    phs = np.array([[-1.1], [0.4]])
    batch = qt.batched_rollout_fidelity(a, dts, syst, traj.goal["Ũ⃗"], traj.initial["Ũ⃗"],
                                        phases=phs, phase_operators=Z1)
    for i in range(2):
        one = traj.with_data(np.concatenate([traj.data[:, :8], a[i], traj.data[:, 9:]], 1))
        np.testing.assert_allclose(batch[i], float(qct.unitary_rollout_fidelity(
            one, sysj, phases=phs[i], phase_operators=Z1)), atol=ATOL)


def test_free_phase_smooth_pulse_and_min_time_match_jax():
    def build(pkg):
        extra = {} if pkg is qct else {"device": "cpu"}
        return pkg.UnitarySmoothPulseProblem(
            pkg.QuantumSystem([pkg.PAULIS["X"]]), pkg.GATES["Y"], T, DT,
            phase_operators=[pkg.PAULIS["Z"]], Q=Q, R=R, ipopt_options=_opts(pkg),
            piccolo_options=pkg.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(1234), **extra)

    pj = build(qct)
    Z0 = _seeded_Z0(pj)
    arrays = interop.problem_arrays(pj, batch=2, Z0=Z0, phase_operators=[qct.PAULIS["Z"]])
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=Q, R=R, ipopt_options=_opts(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu")
    nt = pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (13, 11, 0) and pt.global_slices == {"ϕ": (12, 13)}
    assert pt.solver.fused_assembly_on and pj.solver.fused_assembly_on
    assert not nt.free_mask[:-1, 12].any() and nt.free_mask[-1, 12]
    # built directly, the template draws the phase before the controls
    direct = build(qt)
    np.testing.assert_array_equal(direct.nlp.z0, np.asarray(pj.nlp.z0))
    # the NLP's cost and its gradient, the phase column included, at a
    # scaled point with its own phase per instance
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    Zs[1, -1, 12] = -2.3
    fj, ft = pj.solver.funcs, pt.solver.funcs
    c_j, g_j = jax.jit(lambda z: (fj.total_cost(z), fj.grad_cost(z)))(Zs[1].numpy())
    np.testing.assert_allclose(ft.total_cost(Zs)[1].item(), float(c_j), rtol=1e-12)
    g_t = ft.grad_cost(Zs)[1]
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-10)
    assert g_t[-1, 12].abs() > 1e-3

    # write_back carries the phases of the last knot; chain into minimum time
    Zw = pt.solver.unscale(Zs.numpy())[1]
    wj, wt = pj.write_back(Zw), pt.write_back(Zw)
    np.testing.assert_array_equal(wt.global_data["ϕ"], [-2.3 * pt.solver.var_scale[12]])
    np.testing.assert_allclose(wt.global_data["ϕ"], np.asarray(wj.global_data["ϕ"]), rtol=1e-15)
    np.testing.assert_allclose(wt.data, np.asarray(wj.data), rtol=1e-15)
    pj.trajectory = wj
    mj = qct.UnitaryMinimumTimeProblem(pj, phase_operators=[qct.PAULIS["Z"]], D=50.0,
                                       final_fidelity=0.9)
    pt.trajectory = wt
    mt_default = qt.UnitaryMinimumTimeProblem(pt, phase_operators=[qt.PAULIS["Z"]], D=50.0)
    np.testing.assert_allclose(
        mt_default.constraints[-1].final_fidelity,
        float(qct.iso_vec_unitary_free_phase_fidelity(
            wj["Ũ⃗"][-1], wj.goal["Ũ⃗"], wj.global_data["ϕ"], [qct.PAULIS["Z"]])), atol=1e-6)
    mt, Zm_t = interop.unitary_minimum_time_from_arrays(
        interop.problem_arrays(mj, batch=2, Z0=_seeded_Z0(mj, 0.01)), Q=Q, R=R,
        ipopt_options=_opts(qt), piccolo_options=qt.PiccoloOptions(verbose=False),
        device="cpu")
    n = mt.solver.nlp
    assert (n.d, n.s, n.m) == (13, 11, 1) and mt.solver.kkt_aug_on
    assert type(mt.constraints[-1]).__name__ == "FinalUnitaryFreePhaseFidelityConstraint"
    # the scaled floor rows and their Jacobian at a seeded point (instance
    # 1, the perturbed one; the floor's curvature is held in the first
    # test, the free-phase objective's in a lifted solve by bang-bang's
    # iterates below)
    Zs = Zm_t / torch.as_tensor(mt.solver.var_scale)
    fj, ft = mj.solver.funcs, mt.solver.funcs
    g_j, Jg_j = jax.jit(lambda z: (fj.ineqs(z), fj.jac_ineq(z)))(Zs[1].numpy())
    Jg = ft.jac_ineq(Zs)[1]
    np.testing.assert_allclose(ft.ineqs(Zs)[1].numpy(), np.asarray(g_j), atol=1e-10)
    np.testing.assert_allclose(Jg.numpy(), np.asarray(Jg_j), atol=1e-10)
    assert Jg[-1, 0, 12].abs() > 1e-3 and (Jg[:-1] == 0).all()  # the phase column at T-1


def test_bang_bang_with_phase_matches_jax():
    def sys_(pkg):
        return pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]])

    Z1 = [qct.PAULIS["Z"]]
    pj = qct.UnitaryBangBangProblem(
        sys_(qct), qct.GATES["H"], T, DT, R_bang_bang=0.5, da_bound=1.0, phase_operators=Z1,
        ipopt_options=_opts(qct), piccolo_options=qct.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(1234))
    direct = qt.UnitaryBangBangProblem(
        sys_(qt).H_drift, sys_(qt).H_drives, qt.GATES["H"], T, DT, R_bang_bang=0.5,
        da_bound=1.0, phase_operators=Z1, ipopt_options=_opts(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False), rng=np.random.default_rng(1234),
        device="cpu")
    assert direct.trajectory.names == pj.trajectory.names == (
        "Ũ⃗", "a", "da", "Δt", "da_l1_slack")
    # built directly, the template draws the phase before the controls
    np.testing.assert_array_equal(direct.trajectory.global_data["ϕ"],
                                  np.asarray(pj.trajectory.global_data["ϕ"]))
    np.testing.assert_array_equal(direct.nlp.z0, np.asarray(pj.nlp.z0))
    pt, Z0_t = interop.unitary_bang_bang_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj), phase_operators=Z1),
        Q=100.0, R=1e-2, R_bang_bang=0.5, ipopt_options=_opts(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu")
    n = pt.solver.nlp
    assert (n.d, n.s, n.m) == (16, 11, 4) and pt.global_slices == {"ϕ": (15, 16)}
    assert pt.solver.kkt_aug_on and pt.solver.fused_assembly_on
    sj, st = _lockstep(pj, pt, Z0_t, 5)
    assert (st.Z[:, -1, 15] - Z0_t[:, -1, 15]).abs().max() > 1e-3  # the phase moved
    wj = pj.write_back(np.asarray(pj.solver.unscale(sj.Z))[1])
    wt = pt.write_back(pt.solver.unscale(st.Z.numpy())[1])
    np.testing.assert_allclose(wt.global_data["ϕ"], np.asarray(wj.global_data["ϕ"]), atol=1e-6)
