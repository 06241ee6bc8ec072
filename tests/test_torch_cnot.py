"""Port parity: the two-qubit CNOT smooth-pulse solve (fixed time, d=47).

The same problem from the same numpy seed in both packages (BASELINE #3's
system and weights, T cut to 6 knots): the NLP sizes and scaling, the
resolved solver modes, the multistart seeds, and 12 IPM iterations with one
refinement pass per KKT attempt (the JAX side on its XLA backend, which
runs the same refinement arithmetic; its Pallas kernels in interpret mode
take minutes at d=47).  float64 on the CPU; Z within 1e-6 and the KKT error
within rtol 1e-4 after 12 iterations, as tests/test_torch_solve.py."""

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

T = 6


def _system(pkg):
    P, k = pkg.PAULIS, np.kron
    return pkg.QuantumSystem(
        0.1 * k(P["Z"], P["Z"]),
        [k(P["Z"], P["X"]), k(P["X"], P["I"]), k(P["Y"], P["I"]), k(P["I"], P["X"]),
         k(P["I"], P["Y"])],
    )


def _options(pkg, **kw):
    return pkg.SolverOptions(print_level=1, tol=1e-5, kappa_mu=0.2, line_search="filter", **kw)


@functools.lru_cache(maxsize=None)  # one build per case for the whole file
def _problem(pkg_name, gate="CX", **kw):
    pkg = {"jax": qct, "port": qt}[pkg_name]
    cnot = gate == "CX"
    extra = {} if pkg is qct else {"device": "cpu"}
    one_qubit = pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]])
    return pkg.UnitarySmoothPulseProblem(
        _system(pkg) if cnot else one_qubit,
        pkg.GATES[gate], T, 0.3 if cnot else 0.2, Q=1e4, R=1e-3,
        ipopt_options=_options(pkg, **kw),
        piccolo_options=pkg.PiccoloOptions(verbose=False, free_time=not cnot),
        rng=np.random.default_rng(7), **extra,
    )


def test_nlp_matches_jax():
    pj, pt = _problem("jax", kkt_backend="lanes"), _problem("port", kkt_backend="lanes")
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (47, 42, 0)
    np.testing.assert_array_equal(pt.trajectory.data, np.asarray(pj.trajectory.data))
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.defect_scale, np.asarray(nj.analytic.defect_scale),
                               rtol=1e-12)
    (g,) = nt.analytic.groups
    assert g.G_drift.shape == (8, 8) and g.G_drives.shape == (5, 8, 8) and g.dt_col is None


@pytest.mark.parametrize("gate, backend, expected", [
    ("CX", "lanes", (False, 1)), ("CX", "xla", (False, 0)), ("H", "lanes", (True, 0)),
])
def test_modes_resolve_as_in_jax(gate, backend, expected):
    pj = _problem("jax", gate, kkt_backend=backend)
    pt = _problem("port", gate, kkt_backend=backend)
    got = (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n)
    assert got == (pj.solver.fused_assembly_on, pj.solver.kkt_refine_n) == expected


def test_multistart_rows_match_jax():
    pj, pt = _problem("jax", kkt_backend="lanes"), _problem("port", kkt_backend="lanes")
    rows_j = np.asarray(pj.multistart_initial_decisions(4, sigma=0.3, rng=np.random.default_rng(3)))
    rows_t = pt.multistart_initial_decisions(4, sigma=0.3, rng=np.random.default_rng(3))
    assert rows_t.shape == (4, T, 47)
    np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=1e-10)
    # seeds start on the dynamics (an exact rollout leaves only the Padé-4
    # defect's own error) with distinct controls
    F = pt.solver.funcs.defects(torch.as_tensor(rows_t / pt.solver.var_scale))
    assert float(F.abs().max()) < 1e-3
    assert np.abs(rows_t[1] - rows_t[0]).max() > 0.01


def test_twelve_iterations_match_jax():
    pj = _problem("jax", kkt_backend="xla", kkt_refine=1)
    Z0 = np.asarray(pj.multistart_initial_decisions(2, sigma=0.3, rng=np.random.default_rng(1)))
    arrays = interop.problem_arrays(pj)
    arrays["Z0"] = Z0
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=1e4, R=1e-3, ipopt_options=_options(qt, kkt_refine=1),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    assert (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n) == (False, 1)
    st_j = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 12)
    st_t = pt.solver.init_state(Z0_t)
    for _ in range(12):
        st_t = pt.solver.step(st_t)
    np.testing.assert_allclose(st_t.Z.numpy(), np.asarray(st_j.Z), atol=1e-6)
    np.testing.assert_allclose(
        st_t.kkt_err.numpy(), np.asarray(st_j.kkt_err), rtol=1e-4, atol=1e-8
    )
    np.testing.assert_array_equal(st_t.n_iter.numpy(), np.asarray(st_j.n_iter))


def test_bank_route_matches_fused_route():
    # the two dynamics routes of the solver give the same iterates
    runs = []
    for fused in (True, False):
        pt = _problem("port", "H", fused_assembly=fused)
        assert pt.solver.fused_assembly_on is fused
        st = pt.solver.init_state(pt.initial_decision(2))
        for _ in range(3):
            st = pt.solver.step(st)
        runs.append(st.Z)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=1e-12)
