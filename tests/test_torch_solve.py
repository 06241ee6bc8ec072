"""Port parity: the batched Hadamard smooth-pulse solve, end to end.

The same problem from the same numpy seed in both packages, the initial
decision carried through quantumcollocation_tpu_torch.interop; the port's
iterates against the JAX solver's (the model is
tests/test_analytic.py::TestFusedAssemblyKernel::test_full_solve_fused_matches_unfused:
Z within 1e-6 after 12 iterations), float64 on the CPU.  Also: the device
rule.  That the port runs without JAX is tests/test_torch_standalone.py."""

import functools

import numpy as np
import pytest
import torch

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)  # one build per line search for the whole file
def _jax_problem(line_search="filter", T=11):
    return qct.UnitarySmoothPulseProblem(
        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]),
        qct.GATES["H"], T, 0.2, Q=100.0, R=1e-2,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, line_search=line_search),
        piccolo_options=qct.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )


def _port_problem(line_search="filter", T=11, device="cpu"):
    return qt.UnitarySmoothPulseProblem(
        qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]]),
        qt.GATES["H"], T, 0.2, Q=100.0, R=1e-2,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search=line_search),
        piccolo_options=qt.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0), device=device,
    )


def test_nlp_matches_jax():
    pj, pt = _jax_problem(), _port_problem()
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (15, 13, 0)
    np.testing.assert_array_equal(pt.trajectory.data, np.asarray(pj.trajectory.data))
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(nt.lb), np.asarray(nj.lb))
    np.testing.assert_array_equal(np.asarray(nt.ub), np.asarray(nj.ub))
    np.testing.assert_array_equal(np.asarray(nt.free_mask), np.asarray(nj.free_mask))
    np.testing.assert_array_equal(np.asarray(nt.z0), np.asarray(nj.z0))


@pytest.mark.parametrize("line_search", ["filter", "merit"])
def test_twelve_iterations_match_jax(line_search):
    pj = _jax_problem(line_search)
    arrays = interop.problem_arrays(pj, batch=2)
    Z0 = arrays["Z0"].copy()
    Z0[1, 1:-1, pj.trajectory.comp_slice("a")] += 0.1 * np.random.default_rng(5).standard_normal((9, 2))
    arrays["Z0"] = Z0
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=100.0, R=1e-2,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search=line_search),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    st_j = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 12)
    st_t = pt.solver.init_state(Z0_t)
    for _ in range(12):
        st_t = pt.solver.step(st_t)
    np.testing.assert_allclose(st_t.Z.numpy(), np.asarray(st_j.Z), atol=1e-6)
    np.testing.assert_allclose(
        st_t.kkt_err.numpy(), np.asarray(st_j.kkt_err), rtol=1e-4, atol=1e-8
    )
    np.testing.assert_array_equal(st_t.n_iter.numpy(), np.asarray(st_j.n_iter))


def test_solve_improves_rollout_fidelity():
    pt = _port_problem()
    sysq = pt.system
    f0 = qt.unitary_rollout_fidelity(pt.trajectory, sysq)
    pt.solve(max_iter=20)
    f1 = qt.unitary_rollout_fidelity(pt.trajectory, sysq)
    assert f1 > f0 + 0.1, (f0, f1)
    res = pt.solve_batched(pt.initial_decision(3), max_iter=3)
    assert res.Z.shape == (3, 11, 15) and torch.isfinite(res.Z).all()


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_problem(device=None)


def test_unported_options_raise():
    # the cr backend is not ported
    with pytest.raises(NotImplementedError, match="kkt_backend='cr'"):
        qt.UnitarySmoothPulseProblem(
            qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"]]), qt.GATES["H"], 5, 0.2,
            ipopt_options=qt.SolverOptions(kkt_backend="cr"),
            piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
        )
