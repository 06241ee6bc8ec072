"""Port parity: the second-order correction (soc=True, Ipopt A-5.1).

The port's iterates against the JAX package's, float64 on the CPU, with
soc on: the JAX side on its XLA KKT backend (solve_with_factors on the
kept factors; its lanes kernels in interpret mode take minutes to
trace), starting from _init_state_jit; the port on "lanes", where the
plain versions of kernels 2, 3 and 4 stand in for the kernels.  Z within
1e-6 after every iteration, the accepted δ_w within 1e-12 relative and
the KKT error within 1e-4 relative, as tests/test_torch_solve.py and
tests/test_torch_min_time.py hold them.

  - a Hadamard solve with Δt = 0.6 and the merit line search, where full
    steps are cut and the corrected step is taken;
  - a minimum-time solve (m = 1, the ρJᵀJ lift and its warm retries), where
    instances accept different δ_w attempts, so an instance's correction
    must re-solve on the factors of its own accepted attempt, not on the
    last attempt's; it takes the corrected step on such an instance;
  - the one-time note where soc is inert (lanes_scan, L-BFGS), as the JAX
    package prints it.
"""

import functools

import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.solver import ipm

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

Q, R = 100.0, 1e-2


def _smooth(pkg, dt, **solver_kw):
    extra = {} if pkg is qct else {"device": "cpu"}
    return pkg.UnitarySmoothPulseProblem(
        pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]]), pkg.GATES["H"], 11,
        dt, Q=Q, R=R, ipopt_options=pkg.SolverOptions(print_level=1, tol=1e-6, **solver_kw),
        piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(0), **extra,
    )


def _seeded(prob, B, sigma):
    Z0 = np.asarray(prob.initial_decision(B)).copy()
    a_sl = prob.trajectory.comp_slice("a")
    Z0[1:, 1:-1, a_sl] += sigma * np.random.default_rng(5).standard_normal((B - 1, 9, 2))
    return Z0


def _lockstep(pj, pt, Z0_t, n):
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
    return pt.solver


@functools.lru_cache(maxsize=None)
def _jax_hadamard():
    return _smooth(qct, 0.6, line_search="merit", kkt_backend="xla", soc=True)


def test_soc_iterates_match_jax_and_take_the_correction():
    pj = _jax_hadamard()
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=_seeded(pj, 2, 0.3)), Q=Q, R=R,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search="merit",
                                       kkt_backend="lanes", soc=True),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    assert pt.solver.soc_on and pt.solver.kkt_refine_n == 0
    s = _lockstep(pj, pt, Z0_t, 8)
    taken = s.mode_events("soc_taken")
    assert taken.shape == (8, 2) and taken.sum() >= 2, taken
    # every iteration re-solves, and the correction replaces only where
    # it was tried
    assert not (taken & ~s.mode_events("soc_trigger")).any()


def test_soc_on_the_lifted_min_time_solve_uses_each_instances_factors(monkeypatch):
    kw = dict(line_search="filter", soc=True)
    pj = qct.UnitaryMinimumTimeProblem(_smooth(qct, 0.2, kkt_backend="xla", **kw),
                                       final_fidelity=0.99, D=10.0)
    pt, Z0_t = interop.unitary_minimum_time_from_arrays(
        interop.problem_arrays(pj, batch=4, Z0=_seeded(pj, 4, 0.3)), Q=Q, R=R,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, kkt_backend="lanes", **kw),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    assert pt.solver.soc_on and pt.solver.kkt_aug_on and pt.solver.nlp.m == 1
    # each iteration's KKT attempts, by the instances each one factored
    oks = []
    batched, lanes = pt.solver._solve_kkt_batched, ipm.solve_kkt_lanes

    def record_batched(*a, **kw_):
        oks.append([])
        return batched(*a, **kw_)

    def record_lanes(*a, **kw_):
        out = lanes(*a, **kw_)
        if oks:
            oks[-1].append(out[2].numpy())
        return out

    monkeypatch.setattr(pt.solver, "_solve_kkt_batched", record_batched)
    monkeypatch.setattr(ipm, "solve_kkt_lanes", record_lanes)
    s = _lockstep(pj, pt, Z0_t, 17)
    taken = s.mode_events("soc_taken")
    # an instance accepts the first attempt that factored it
    before_last = np.array([np.any(it, 0) & (np.argmax(it, 0) < len(it) - 1) for it in oks])
    # the corrected step was taken on factors of an attempt before the last
    assert (taken & before_last).any(), (taken.sum(0), before_last.sum(0))


def test_inert_soc_prints_the_jax_note(capsys):
    for case in ("lanes_scan", "lbfgs"):
        solver_kw = dict(soc=True, kkt_backend="lanes_scan" if case == "lanes_scan" else "lanes")
        piccolo_kw = dict(eval_hessian=False) if case == "lbfgs" else {}

        def build(pkg):
            extra = {} if pkg is qct else {"device": "cpu"}
            return pkg.UnitarySmoothPulseProblem(
                pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"]]), pkg.GATES["H"], 5, 0.2,
                ipopt_options=pkg.SolverOptions(**solver_kw),
                piccolo_options=pkg.PiccoloOptions(verbose=False, **piccolo_kw), **extra)

        capsys.readouterr()
        build(qct)
        jax_out = capsys.readouterr().out
        pt = build(qt)
        port_out = capsys.readouterr().out
        note = [line for line in jax_out.splitlines() if "soc=True is inert" in line]
        assert len(note) == 1 and port_out.splitlines() == note, (case, jax_out, port_out)
        assert not pt.solver.soc_on
        res = pt.solve_batched(pt.initial_decision(1), max_iter=2)
        assert torch.isfinite(res.Z).all() and pt.solver.mode_events("soc_taken").size == 0
