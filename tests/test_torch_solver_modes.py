"""Port parity: Gauss-Newton Hessians, adaptive μ and the watchdog.

The iterates of the T=11, B=2 Hadamard solve (instance 1's controls
perturbed) in each mode against the JAX package's, float64 on the CPU:
the JAX side on its XLA KKT backend from _init_state_jit.  Z within 1e-6,
the accepted δ_w within 1e-12 relative and the KKT error within 1e-4
relative after every iteration, as tests/test_torch_solve.py; μ within
1e-6 relative, as tests/test_torch_min_time.py holds the duals.

  - Gauss-Newton (eval_hessian=False, quasi_newton="gauss-newton"): no
    defect curvature, exact cost Hessians; the bank runs first order, and
    on the AD route (jacobian_structure=False) the -λ·∇²F passes never
    run;
  - adaptive μ (the LOQO oracle), μ itself included; one solve serves
    this mode and the one above (Gauss-Newton with adaptive μ: a JAX
    solver costs a compile of its step);
  - the watchdog, where the filter rejects every trial (theta_max_fact =
    1e-6 caps the violation a trial may have): the same activations, steps
    under the watchdog, rewinds and cool-downs (wd_count, wd_cool) as JAX.
"""

import functools

import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

Q, R = 100.0, 1e-2


def _pair(solver_kw, piccolo_kw=None):
    """(JAX problem, port problem, Z0 tensor, the JAX problem's arrays) of
    the seeded Hadamard solve."""
    opts = dict(print_level=1, tol=1e-6, line_search="filter", **solver_kw)
    pj = qct.UnitarySmoothPulseProblem(
        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]), qct.GATES["H"], 11,
        0.2, Q=Q, R=R, ipopt_options=qct.SolverOptions(kkt_backend="xla", **opts),
        piccolo_options=qct.PiccoloOptions(verbose=False, **(piccolo_kw or {})),
        rng=np.random.default_rng(0),
    )
    Z0 = np.asarray(pj.initial_decision(2)).copy()
    Z0[1, 1:-1, pj.trajectory.comp_slice("a")] += 0.3 * np.random.default_rng(5).standard_normal(
        (9, 2))
    arrays = interop.problem_arrays(pj, batch=2, Z0=Z0)
    pt, Z0_t = _port(arrays, solver_kw, piccolo_kw)
    return pj, pt, Z0_t, arrays


def _port(arrays, solver_kw, piccolo_kw=None, port_piccolo_kw=None):
    """(port problem, Z0 tensor) from the JAX problem's arrays."""
    return interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=Q, R=R,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search="filter",
                                       **solver_kw),
        piccolo_options=qt.PiccoloOptions(verbose=False, **(piccolo_kw or {}),
                                          **(port_piccolo_kw or {})),
        device="cpu",
    )


def _lockstep(pj, pt, Z0_t, n, check=None):
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    for k in range(n):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6,
                                   err_msg=f"Z, it {k}")
        np.testing.assert_allclose(st.reg_dw.numpy(), np.asarray(sj.reg_dw), rtol=1e-12,
                                   err_msg=f"dw, it {k}")
        np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4,
                                   atol=1e-8, err_msg=f"kkt_err, it {k}")
        np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(sj.n_iter))
        if check is not None:
            check(sj, st, k)
    return st


GN = dict(quasi_newton="gauss-newton")
GN_ADAPTIVE_MU = dict(GN, mu_strategy="adaptive")


@functools.lru_cache(maxsize=None)
def _gn_adaptive_mu():
    """The 10-iteration lockstep of Gauss-Newton with adaptive μ: the JAX
    and port problems, the port's start, the JAX problem's arrays, the
    port's last state, the bank's orders, μ of each iteration and the
    filter resets."""
    pj, pt, Z0_t, arrays = _pair(GN_ADAPTIVE_MU, dict(eval_hessian=False))
    an = pt.solver.nlp.analytic
    orders, mus = [], []
    banks = an.banks_batched
    an.banks_batched = lambda Z, second_order=True: orders.append(second_order) or banks(
        Z, second_order=second_order)

    def check(sj, st, k):
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(sj.mu), rtol=1e-6,
                                   err_msg=f"mu, it {k}")
        mus.append(st.mu.numpy())

    st = _lockstep(pj, pt, Z0_t, 10, check)
    an.banks_batched = banks
    return (pj, pt, Z0_t, arrays, st, orders, np.array(mus),
            pt.solver.mode_events("filter_reset"))


def test_gauss_newton_iterates_match_jax():
    pj, pt, Z0_t, arrays, st, orders, _, _ = _gn_adaptive_mu()
    s = pt.solver
    modes = (s.exact_hessian, s.qn_lbfgs, s.fused_assembly_on, s.resto_on)
    assert modes == (False, False, False, True) == (
        pj.solver.exact_hessian, pj.solver.qn_lbfgs, pj.solver.fused_assembly_on,
        pj.solver.resto_on)
    # kernel 5 first order: the multiplier initialisation's Jacobian, then
    # once an iteration
    assert orders == [False] * 11
    # the AD route: the same steps without its curvature passes
    ad, _ = _port(arrays, GN_ADAPTIVE_MU, dict(eval_hessian=False),
                  dict(jacobian_structure=False))
    assert ad.solver.nlp.analytic is None

    def no_curvature(*args):
        raise AssertionError("Gauss-Newton ran the defect curvature")

    ad.solver.funcs.defect_curvature = no_curvature
    st_ad = ad.solver.init_state(Z0_t)
    for _ in range(3):
        st_ad = ad.solver.step(st_ad)
    st3 = s.init_state(Z0_t)
    for _ in range(3):
        st3 = s.step(st3)
    np.testing.assert_allclose(st_ad.Z.numpy(), st3.Z.numpy(), atol=1e-9)
    assert torch.isfinite(st.Z).all()


def test_adaptive_mu_iterates_match_jax():
    _, _, _, _, _, _, mus, resets = _gn_adaptive_mu()
    # the oracle moved μ off the monotone schedule's 0.1, and reset the
    # filter where it fell tenfold in one iteration
    assert mus.min() < 1e-2 and len(np.unique(mus[:, 1])) > 3
    prev = np.vstack([np.full((1, 2), 0.1), mus[:-1]])
    np.testing.assert_array_equal(resets, mus < 0.1 * prev)


def test_watchdog_activates_and_rewinds_as_jax():
    pj, pt, Z0_t, _ = _pair(dict(watchdog_trials=2, theta_max_fact=1e-6))
    counts = []

    def check(sj, st, k):
        for name in ("wd_count", "wd_cool"):
            np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                          err_msg=f"{name}, it {k}")
        counts.append(st.wd_count.numpy())
        rw = pt.solver.mode_log["wd_rewind"][-1]
        # a rewind restores the snapshot as it was
        assert torch.equal(st.Z[rw], st.wd_Z[rw]) and torch.equal(st.lam[rw], st.wd_lam[rw])

    st = _lockstep(pj, pt, Z0_t, 10, check)
    s = pt.solver
    act, rew = s.mode_events("wd_activate"), s.mode_events("wd_rewind")
    # each instance activated, stepped on (count 2) and was rewound
    assert act.sum(0).min() >= 1 and rew.sum(0).min() >= 1, (act, rew)
    assert (np.array(counts) == 2).any(0).all()
    assert st.wd_Z is not st.Z and st.wd_Z.data_ptr() != st.Z.data_ptr()
