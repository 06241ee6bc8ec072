"""Port parity: the multi-column sweeps and the lanes_scan backend.

The plain sweeps with an r-column right-hand side (the L-BFGS [rz | U]
system) against the JAX lanes solve in interpret mode; the plain per-knot
steps (fwd_step_reference, bwd_step_reference: kernels 6 and 7's plain
versions) against one call of the JAX step kernels, and the port's
solve_kkt_lanes_scan against the JAX one, both in interpret mode; atol
1e-10 in float64 on the CPU.  Through the solver, the lanes_scan
iterates against the fused lanes ones (Z within 1e-10), with and without
a refinement pass.  The CUDA kernels are held against these plain
versions on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.solver import kkt_lanes as jkl
from quantumcollocation_tpu_torch.solver import kkt_lanes as kl

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

DC = 1e-8
ATOL = 1e-10


def _random_kkt(Bt, T, d=5, s=3, r=None, seed=0):
    """A definite KKT system (tests/test_kkt_lanes.py's shapes) with an
    r-column right-hand side, or a single column for r=None."""
    rng = np.random.default_rng(seed)
    H = np.eye(d) * 2 + 0.1 * rng.normal(size=(Bt, T, d, d))
    cols = () if r is None else (r,)
    return (
        0.5 * (H + np.swapaxes(H, -1, -2)),
        0.1 * rng.normal(size=(Bt, T - 1, d, d)),
        rng.normal(size=(Bt, T - 1, s, d)),
        rng.normal(size=(Bt, T - 1, s, d)),
        rng.normal(size=(Bt, T, d, *cols)),
        rng.normal(size=(Bt, T - 1, s, *cols)),
    )


def test_multi_column_sweeps_match_jax_lanes():
    args = _random_kkt(3, 5, r=3, seed=7)
    dz, nu, ok = kl.solve_kkt_lanes(*[torch.as_tensor(x) for x in args], DC)
    dz_j, nu_j, ok_j = jkl.solve_kkt_lanes(*[jnp.asarray(x) for x in args], DC, interpret=True)
    assert dz.shape == (3, 5, 5, 3) and nu.shape == (3, 4, 3, 3)
    assert bool(ok.all()) and bool(np.asarray(ok_j).all())
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), atol=ATOL)
    np.testing.assert_allclose(nu.numpy(), np.asarray(nu_j), atol=ATOL)
    # each column as its own single-column solve
    for k in range(3):
        dzk, nuk, _ = kl.solve_kkt_lanes(*[torch.as_tensor(x) for x in args[:4]],
                                         torch.as_tensor(args[4][..., k]),
                                         torch.as_tensor(args[5][..., k]), DC)
        np.testing.assert_allclose(dz[..., k].numpy(), dzk.numpy(), atol=1e-12)
        np.testing.assert_allclose(nu[..., k].numpy(), nuk.numpy(), atol=1e-12)


def _lanes(x):
    """Batch-first (128, ...) -> the JAX lanes layout (..., 128)."""
    return jnp.moveaxis(jnp.asarray(x), 0, -1)


def test_step_references_match_jax_step_kernels():
    # one knot of each step, all 128 lanes of a JAX tile filled
    d, s = 5, 3
    H, C, A, B, rz, rnu = _random_kkt(128, 3, seed=5)
    P, q = H[:, 0], rz[:, 0]
    out = kl.fwd_step_reference(*[torch.as_tensor(x) for x in (
        P, q, H[:, 1], C[:, 0], A[:, 0], B[:, 0], rz[:, 1], rnu[:, 0])], DC)
    assert bool(out[-1].all())
    fwd = jkl._make_fwd_step(d, s, DC, True)
    out_j = fwd(_lanes(P), _lanes(q[..., None]), _lanes(H[:, 1]), _lanes(C[:, 0]),
                _lanes(A[:, 0]), _lanes(B[:, 0]), _lanes(rz[:, 1][..., None]),
                _lanes(rnu[:, 0][..., None]))
    for o, oj in zip(out[:6], out_j):
        oj = np.moveaxis(np.asarray(oj), -1, 0)
        np.testing.assert_allclose(o.numpy(), oj.reshape(o.shape), atol=ATOL)
    L_P, L_S, X_A, qs = (x.numpy() for x in out[2:6])
    dz_next = np.random.default_rng(6).normal(size=(128, d))
    dz_t, nu_t = kl.bwd_step_reference(*[torch.as_tensor(x) for x in (
        dz_next, L_P, L_S, X_A, qs, C[:, 0], A[:, 0], B[:, 0], rnu[:, 0])])
    bwd = jkl._make_bwd_step(d, s, True)
    dz_j, nu_j = bwd(_lanes(dz_next[..., None]), _lanes(L_P), _lanes(L_S), _lanes(X_A),
                     _lanes(qs[..., None]), _lanes(C[:, 0]), _lanes(A[:, 0]), _lanes(B[:, 0]),
                     _lanes(rnu[:, 0][..., None]))
    np.testing.assert_allclose(dz_t.numpy(), np.moveaxis(np.asarray(dz_j), -1, 0)[:, :, 0],
                               atol=ATOL)
    np.testing.assert_allclose(nu_t.numpy(), np.moveaxis(np.asarray(nu_j), -1, 0)[:, :, 0],
                               atol=ATOL)


def test_scan_solve_matches_jax_scan():
    args = _random_kkt(4, 7, seed=3)
    dz, nu, ok = kl.solve_kkt_lanes_scan(*[torch.as_tensor(x) for x in args], DC)
    dz_j, nu_j, ok_j = jkl.solve_kkt_lanes_scan(*[jnp.asarray(x) for x in args], DC,
                                                interpret=True)
    assert bool(ok.all()) and np.asarray(ok_j).tolist() == ok.tolist()
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), atol=ATOL)
    np.testing.assert_allclose(nu.numpy(), np.asarray(nu_j), atol=ATOL)
    # a failed stage factorization is reported, as by the fused solve
    bad = [x.copy() for x in args]
    bad[0][1, 3] -= 10 * np.eye(5)
    _, _, ok = kl.solve_kkt_lanes_scan(*[torch.as_tensor(x) for x in bad], DC)
    _, _, ok_f = kl.solve_kkt_lanes(*[torch.as_tensor(x) for x in bad], DC)
    assert ok.tolist() == ok_f.tolist() == [True, False, True, True]


def _problem(backend, refine, eval_hessian=True):
    return qt.UnitarySmoothPulseProblem(
        qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]]),
        qt.GATES["H"], 11, 0.2, Q=100.0, R=1e-2,
        ipopt_options=qt.SolverOptions(print_level=1, tol=1e-6, line_search="filter",
                                       kkt_backend=backend, kkt_refine=refine),
        piccolo_options=qt.PiccoloOptions(verbose=False, eval_hessian=eval_hessian),
        rng=np.random.default_rng(0), device="cpu",
    )


@pytest.mark.parametrize("refine", ["auto", 1])
def test_scan_backend_iterates_match_lanes(refine):
    ps, pl = _problem("lanes_scan", refine), _problem("lanes", refine)
    assert ps.solver.scan and ps.solver.fused_assembly_on
    assert ps.solver.kkt_refine_n == pl.solver.kkt_refine_n == (0 if refine == "auto" else 1)
    Z0 = ps.initial_decision(2)
    Z0[1, 1:-1, ps.trajectory.comp_slice("a")] += 0.1 * np.random.default_rng(5).standard_normal(
        (9, 2))
    st_s, st_l = ps.solver.init_state(Z0), pl.solver.init_state(Z0)
    for _ in range(6):
        st_s, st_l = ps.solver.step(st_s), pl.solver.step(st_l)
    np.testing.assert_allclose(st_s.Z.numpy(), st_l.Z.numpy(), atol=1e-10)
    np.testing.assert_array_equal(st_s.n_iter.numpy(), st_l.n_iter.numpy())
    with pytest.raises(ValueError, match="lanes_scan"):
        _problem("lanes_scan", refine, eval_hessian=False)
