"""Port parity: stage inequality rows (m > 0), the ρJᵀJ lift with its retry
warm start, recalc_y, and the two minimum-time templates.

Both final-fidelity constraints (value, Jacobian, Hessian of wᵀg), the
m = 1 NLP (row scales q, inequality Jacobian, Hessian blocks), and the
iterates of the batched solves against the JAX package on the same numpy
seeds, float64 on the CPU: 8 minimum-time iterations (Hadamard, T=11,
B=2, the lift and the warm retries on by "auto", and recalc_y) with Z, σ,
w, the reset λ and the accepted δ_w of every iteration, one JAX solver
for both the lift and recalc_y; 6 iterations of the two-ket minimum-time
problem.  The JAX side runs on its XLA KKT
backend and starts from _init_state_jit.  Z within 1e-6, the duals within
1e-6 relative, the KKT error 1e-4 relative, as tests/test_torch_solve.py;
function values within 1e-10.  Also: the fused assembly's "auto" mode
follows the kernel's (n, K) coverage."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)
from torch.func import hessian, jacrev

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.ops.dyn_assembly import SUPPORTED_NK

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
Q, R = 100.0, 1e-2


def _had_system(pkg, n_drives=2):
    drives = [pkg.GATES["X"], pkg.GATES["Y"], pkg.GATES["X"], pkg.GATES["Y"]][:n_drives]
    return pkg.QuantumSystem(pkg.GATES["Z"], drives)


@functools.lru_cache(maxsize=None)
def _smooth_cached(pkg_name):
    return _smooth({"jax": qct, "port": qt}[pkg_name])


def _smooth(pkg):
    extra = {} if pkg is qct else {"device": "cpu"}
    return pkg.UnitarySmoothPulseProblem(
        _had_system(pkg), pkg.GATES["H"], 11, 0.2, Q=Q, R=R,
        ipopt_options=pkg.SolverOptions(print_level=1, tol=1e-6, line_search="filter",
                                        kkt_backend="xla"),
        piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(0), **extra,
    )


# the one JAX solver of the file: the minimum-time problem with the
# multiplier reset on, whose iterates hold the lift, the warm retries and
# recalc_y at once (each further JAX solver costs a compile of its step)
RECALC_Y = dict(recalc_y="yes", recalc_y_feas_tol=1e1)


def _opts(pkg, **kw):
    extra = {"kkt_backend": "xla"} if pkg is qct else {}
    return pkg.SolverOptions(print_level=1, tol=1e-6, line_search="filter", **extra, **kw)


@functools.lru_cache(maxsize=None)
def _jax_min_time():
    return qct.UnitaryMinimumTimeProblem(_smooth_cached("jax"), final_fidelity=0.99, D=10.0,
                                         ipopt_options=_opts(qct, **RECALC_Y))


def _port_min_time(**kw):
    pj = _jax_min_time()
    return interop.unitary_minimum_time_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj)), Q=Q, R=R,
        ipopt_options=_opts(qt, **kw), piccolo_options=qt.PiccoloOptions(verbose=False),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _min_time_lockstep():
    """The states of 8 lockstep iterations of the minimum-time problem
    (JAX's, the port's) and the port problem with its start."""
    pt, Z0_t = _port_min_time(**RECALC_Y)
    return _lockstep(_jax_min_time(), pt, Z0_t, 8), pt, Z0_t


def _seeded_Z0(prob, sigma=0.05):
    Z0 = np.asarray(prob.initial_decision(2)).copy()
    a_sl = prob.trajectory.comp_slice("a")
    T = Z0.shape[1]
    Z0[1, 1:-1, a_sl] += sigma * np.random.default_rng(5).standard_normal((T - 2, 2))
    return Z0


def _lockstep(pj, pt, Z0_t, n):
    """n iterations of both solvers from the same Z0; the states after
    each iteration."""
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    out = []
    for _ in range(n):
        sj = pj.solver.step(sj)
        st = pt.solver.step(st)
        out.append((sj, st))
    return out


def _assert_state(sj, st, k):
    np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6, err_msg=f"Z, it {k}")
    for name in ("sig", "w", "lam"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(b).max(initial=0)),
                                   err_msg=f"{name}, it {k}")
    np.testing.assert_allclose(st.reg_dw.numpy(), np.asarray(sj.reg_dw), rtol=1e-12,
                               err_msg=f"dw, it {k}")
    np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(sj.n_iter))


@pytest.mark.parametrize("kind", ["unitary", "ket"])
def test_fidelity_constraints_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "unitary":
        traj = _jax_min_time().trajectory
        con_j = qct.FinalUnitaryFidelityConstraint("Ũ⃗", 0.97)
        con_t = qt.FinalUnitaryFidelityConstraint("Ũ⃗", 0.97)
    else:
        traj = qct.initialize_state_trajectory(
            [np.array([0, 1])], [np.array([1, 0])], 11, 0.2, 2,
            [np.ones(2), np.full(2, np.inf), np.ones(2)], rng=np.random.default_rng(0))
        con_j = qct.FinalQuantumStateFidelityConstraint("ψ̃", 0.9)
        con_t = qt.FinalQuantumStateFidelityConstraint("ψ̃", 0.9)
    assert con_t.ineq_dim(traj) == con_j.ineq_dim(traj) == 1
    fn = con_t.make(traj, torch.float64, "cpu")
    z = np.asarray(traj.data)[-1] + 0.1 * rng.standard_normal(traj.dim)
    w = np.array([1.7])
    for t in (traj.T - 1, 3):
        gj = lambda x, t=t: con_j.ineq(x, t, traj)  # noqa: E731
        gt = lambda x, t=t: fn(x, torch.tensor(t))  # noqa: E731
        zt = torch.as_tensor(z)
        np.testing.assert_allclose(gt(zt).numpy(), np.asarray(gj(z)), atol=ATOL)
        np.testing.assert_allclose(con_t.ineq(zt, torch.tensor(t), traj).numpy(),
                                   np.asarray(gj(z)), atol=ATOL)
        np.testing.assert_allclose(jacrev(gt)(zt).numpy(),
                                   np.asarray(jax.jit(jax.jacfwd(gj))(z)), atol=ATOL)
        h_t = hessian(lambda x: torch.as_tensor(w) @ gt(x))(zt).numpy()
        h_j = np.asarray(jax.jit(jax.hessian(lambda x: jnp.asarray(w) @ gj(x)))(z))
        np.testing.assert_allclose(h_t, h_j, atol=ATOL)
    # inactive knots give +1 and no derivative, also vectorized over t
    ts = torch.arange(traj.T)
    zs = torch.as_tensor(np.array(traj.data))
    vals = torch.vmap(fn)(zs, ts).numpy()[:, 0]
    np.testing.assert_array_equal(vals[:-1], np.ones(traj.T - 1))


def test_m1_nlp_matches_jax():
    pj = _jax_min_time()
    pt, Z0_t = _port_min_time(**RECALC_Y)
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (15, 13, 1)
    np.testing.assert_allclose(pt.solver.ineq_scale, interop.problem_arrays(pj)["ineq_scale"],
                               rtol=1e-12)
    assert (pt.solver.kkt_aug_on, pt.solver.retry_warm_on) == (True, True)
    assert (pj.solver.kkt_aug_on, pj.solver.retry_warm_on) == (True, True)
    # the blocks at a scaled point with nonzero duals (instance 1, the
    # perturbed one; the JAX functions jitted once)
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    w = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (2, 11, 1)))
    lam = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 10, 13)))
    fj, ft = pj.solver.funcs, pt.solver.funcs
    zj, wj, lj = Zs[1].numpy(), w[1].numpy(), lam[1].numpy()
    Ht, Ct = ft.cost_hess(Zs, w)
    Hj, Cj = jax.jit(fj.cost_hess)(zj, wj)
    pairs = [
        (ft.ineqs(Zs), jax.jit(fj.ineqs)(zj), ATOL),
        (ft.jac_ineq(Zs), jax.jit(fj.jac_ineq)(zj), ATOL),
        (Ht, Hj, 1e-9), (Ct, Cj, 1e-9),
        (ft.grad_lagrangian(Zs, lam, w), jax.jit(fj.grad_lagrangian)(zj, lj, wj), 1e-9),
    ]
    for mine, theirs, atol in pairs:
        np.testing.assert_allclose(mine[1].numpy(), np.asarray(theirs), atol=atol)
    # the default floor is the trajectory's current fidelity, as JAX's
    dflt = qt.UnitaryMinimumTimeProblem(_smooth(qt), D=10.0)
    traj = _smooth_cached("jax").trajectory
    np.testing.assert_allclose(
        dflt.constraints[-1].final_fidelity,
        float(qct.iso_vec_unitary_fidelity(traj["Ũ⃗"][-1], traj.goal["Ũ⃗"])), rtol=1e-12)


def test_eight_min_time_iterations_match_jax():
    states, _, _ = _min_time_lockstep()
    lifted = 0
    for k, (sj, st) in enumerate(states):
        _assert_state(sj, st, k)
        lifted += int((st.reg_dw > 0).sum())
    # the regularized (lifted, warm-started) attempts carried the solve
    assert lifted >= 8, lifted


def test_recalc_y_iterations_match_jax():
    states, pt, Z0_t = _min_time_lockstep()
    assert not pt.solver.fused_assembly_on and not _jax_min_time().solver.fused_assembly_on
    for k, (sj, st) in enumerate(states):
        _assert_state(sj, st, k)
    # the reset ran: without it the multipliers of three steps differ
    plain, _ = _port_min_time()
    st_p, st_r = plain.solver.init_state(Z0_t), pt.solver.init_state(Z0_t)
    for _ in range(3):
        st_p, st_r = plain.solver.step(st_p), pt.solver.step(st_r)
    assert (st_p.lam - st_r.lam).abs().max() > 1e-6


def test_state_minimum_time_iterations_match_jax():
    kets0, kets1 = [np.array([1, 0]), np.array([0, 1])], [np.array([0, 1]), np.array([1, 0])]
    base = qct.QuantumStateSmoothPulseProblem(
        qct.QuantumSystem(0.1 * qct.PAULIS["Z"], [qct.PAULIS["X"], qct.PAULIS["Y"]]),
        kets0, kets1, 11, 0.2, Q=Q, R=R,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, line_search="filter",
                                        kkt_backend="xla"),
        piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
    )
    pj = qct.QuantumStateMinimumTimeProblem(base, final_fidelity=0.9, D=10.0)
    pt, Z0_t = interop.quantum_state_minimum_time_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded_Z0(pj)), Q=Q, R=R,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search="filter"),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    assert pt.solver.nlp.m == 2 and [c.state_name for c in pt.constraints] == ["ψ̃1", "ψ̃2"]
    for k, (sj, st) in enumerate(_lockstep(pj, pt, Z0_t, 6)):
        _assert_state(sj, st, k)


@pytest.mark.parametrize("n_drives,fused", [(2, True), (3, False), (4, False)])
def test_fused_assembly_auto_follows_kernel_coverage(n_drives, fused):
    def build(pkg, **kw):
        extra = {} if pkg is qct else {"device": "cpu"}
        return pkg.UnitarySmoothPulseProblem(
            _had_system(pkg, n_drives), pkg.GATES["H"], 5, 0.2,
            ipopt_options=pkg.SolverOptions(**kw),
            piccolo_options=pkg.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(0), **extra,
        )

    pt = build(qt)
    assert ((2, n_drives + 1) in SUPPORTED_NK) == fused
    assert pt.solver.fused_assembly_on == fused
    if fused:  # where the kernel covers (n, K), JAX's route
        assert build(qct).solver.fused_assembly_on
    else:
        with pytest.raises(NotImplementedError, match="SUPPORTED_NK"):
            build(qt, fused_assembly=True)
        res = pt.solve_batched(pt.initial_decision(2), max_iter=2)
        assert torch.isfinite(res.Z).all()
