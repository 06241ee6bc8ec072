"""Port parity: the quasi-Newton (L-BFGS, eval_hessian=False) mode.

The batched lbfgs_update / lbfgs_compact against the JAX package's
single-instance functions (rtol 1e-12), and ten iterations of the T=11,
B=2 Hadamard solve with PiccoloOptions(eval_hessian=False) from the same
seed through interop, against the JAX solver on its XLA backend (its
lanes L-BFGS agrees with the XLA one within 1e-8,
tests/test_kkt_lanes.py::test_lbfgs_lanes_matches_xla; interpret-mode
lanes compile far slower): Z within 1e-6, the objective within rtol 1e-8.
float64 on the CPU."""

import jax
import numpy as np
import torch

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.solver.lbfgs import lbfgs_compact as jax_compact
from quantumcollocation_tpu.solver.lbfgs import lbfgs_update as jax_update
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.solver.lbfgs import lbfgs_compact, lbfgs_update

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)


def test_lbfgs_update_and_compact_match_jax():
    # three instances that end with 0, 3 and 6 valid pairs (m = 6): each
    # step offers every instance a pair, rejected (y = -s) where the
    # instance has its pairs already; step 2 is rejected by all
    rng = np.random.default_rng(11)
    m, n, want = 6, 20, np.array([0, 3, 6])
    S, Y = np.zeros((3, m, n)), np.zeros((3, m, n))
    sty, count, sigma = np.zeros((3, m)), np.zeros(3, np.int32), np.ones(3)
    state_t = [torch.as_tensor(x) for x in (S, Y, sty, count)]
    jupd, jcomp = jax.vmap(jax_update), jax.vmap(jax_compact)
    seen_reject = False
    for step in range(8):
        s = rng.normal(size=(3, n))
        y = s + 0.3 * rng.normal(size=(3, n))
        bad = (count >= want) | (step == 2)
        y[bad] = -s[bad]
        out_j = [np.asarray(x) for x in jupd(S, Y, sty, count, s, y)]
        out_t = lbfgs_update(*state_t, torch.as_tensor(s), torch.as_tensor(y))
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=0)
        seen_reject |= bool((~out_j[5]).any() & out_j[5].any())
        S, Y, sty, count = out_j[:4]
        state_t = list(out_t[:4])
        sigma = np.where(out_j[5], np.clip(out_j[4], 1e-8, 1e8), sigma)
        U_j, M_j = (np.asarray(x) for x in jcomp(S, Y, sty, count, sigma))
        U_t, M_t = lbfgs_compact(*state_t, torch.as_tensor(sigma))
        np.testing.assert_allclose(U_t.numpy(), U_j, rtol=1e-12, atol=0)
        np.testing.assert_allclose(M_t.numpy(), M_j, rtol=1e-12, atol=0)
    assert count.tolist() == [0, 3, 6] and seen_reject


def test_ten_lbfgs_iterations_match_jax():
    opts = dict(print_level=1, tol=1e-6, line_search="filter")
    pj = qct.UnitarySmoothPulseProblem(
        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]),
        qct.GATES["H"], 11, 0.2, Q=100.0, R=1e-2,
        ipopt_options=qct.SolverOptions(kkt_backend="xla", **opts),
        piccolo_options=qct.PiccoloOptions(verbose=False, eval_hessian=False),
        rng=np.random.default_rng(0),
    )
    arrays = interop.problem_arrays(pj, batch=2)
    Z0 = arrays["Z0"].copy()
    Z0[1, 1:-1, pj.trajectory.comp_slice("a")] += 0.1 * np.random.default_rng(5).standard_normal((9, 2))
    arrays["Z0"] = Z0
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=100.0, R=1e-2, ipopt_options=qt.SolverOptions(**opts),
        piccolo_options=qt.PiccoloOptions(verbose=False, eval_hessian=False), device="cpu",
    )
    solver = pt.solver
    assert solver.qn_lbfgs and not solver.fused_assembly_on and not solver.resto_on
    st_j = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 10)
    st_t = solver.init_state(Z0_t)
    for _ in range(10):
        st_t = solver.step(st_t)
    np.testing.assert_allclose(st_t.Z.numpy(), np.asarray(st_j.Z), atol=1e-6)
    np.testing.assert_array_equal(st_t.qn_count.numpy(), np.asarray(st_j.qn_count))
    np.testing.assert_array_equal(st_t.n_iter.numpy(), np.asarray(st_j.n_iter))
    obj_t = solver.funcs.total_cost(st_t.Z).numpy()
    obj_j = np.asarray(jax.vmap(pj.solver.funcs.total_cost)(st_j.Z))
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-8)
