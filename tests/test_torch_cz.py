"""Port parity: the two-transmon embedded CZ (BASELINE #5's canonical
configuration, JAX tests/test_baseline_configs.py:54-80), cut to T=4.

Two three-level transmons with a dipole coupling: the unitary iso vec has
2·9² = 162 rows, so with four drives and a free Δt the NLP has d = 175,
s = 171, past the sweep kernels' 64, and every KKT solve takes the batched
Riccati of solver/kkt.py; the fused assembly is off (d > 24), so the bank
(kernel 5's plain version) runs at n = 18.  Against the JAX package on the
same numpy seeds, float64 on the CPU: the resolved modes and route, the
interop arrays (the composite system's subsystem levels and the embedded
goal's subspace), the bank route's A, B and curvature at n = 18 against
JAX's, and 3 IPM iterations in lockstep (B=1): the iterates Z within
1e-8 relative (to the largest entry), the multipliers λ and bound duals
within 1e-6 relative and the KKT error 1e-6 relative.  The duals carry the
least-squares multiplier initialisation, a solve of Jᵀν = g at δ_c = 1e-8
whose two float64 factorizations (JAX's vmapped scan, the port's batched
Riccati) already differ by 3e-7 relative at this point.  One JAX problem
for the file."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.solver.options import kkt_route

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

T = 4
ITERS = 3


def _options(pkg):
    return pkg.SolverOptions(print_level=1, tol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_cz():
    """(goal, problem): the JAX package's CZ at T knots (the JAX test's
    system, goal, a_bound and options)."""
    sysq = qct.MultiTransmonSystem(omegas=[4.0, 4.5], deltas=[0.2, 0.2],
                                   gs=[[0.0, 0.01], [0.01, 0.0]], levels_per_transmon=3)
    goal = qct.EmbeddedOperator(qct.GATES["CZ"], sysq)
    return goal, qct.UnitarySmoothPulseProblem(
        sysq, goal, T, 1.0, a_bound=0.1, ipopt_options=_options(qct),
        piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(5))


@functools.lru_cache(maxsize=None)
def _port_cz():
    """(arrays, problem, Z0) of the port, rebuilt from the JAX problem's
    arrays, B=1 at a seeded point off the geodesic."""
    goal, pj = _jax_cz()
    Z0 = np.asarray(pj.initial_decision(1)).copy()
    a_sl = pj.trajectory.comp_slice("a")
    Z0[0, 1:-1, a_sl] += 0.02 * np.random.default_rng(3).standard_normal((T - 2, 4))
    arrays = interop.problem_arrays(pj, batch=1, Z0=Z0, operator=goal)
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=100.0, R=1e-2, ipopt_options=_options(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu")
    return arrays, pt, Z0_t


def test_cz_nlp_modes_and_route():
    goal, pj = _jax_cz()
    arrays, pt, _ = _port_cz()
    nj, nt = pj.solver.nlp, pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (175, 171, 0)
    (g,) = nt.analytic.groups
    assert g.G_drift.shape == (18, 18) and g.G_drives.shape == (4, 18, 18)
    assert g.dt_col is not None and g.kind == "pade"
    assert (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n) == \
        (pj.solver.fused_assembly_on, pj.solver.kkt_refine_n) == (False, 0)
    assert pt.solver.kkt_route == "riccati_torch" and pj.solver.options.kkt_backend == "xla"
    # the rule: max(d, s) past max(lanes_max_dim, lanes_vec_max_dim), whatever
    # the backend; at or below it the kernels' routes
    for backend in ("xla", "lanes", "lanes_scan"):
        o = qt.SolverOptions(kkt_backend=backend)
        assert kkt_route(o, 175, 171) == kkt_route(o, 65, 60) == "riccati_torch"
        assert kkt_route(o, 64, 64) == ("lanes_scan" if backend == "lanes_scan" else "lanes")
    assert kkt_route(qt.SolverOptions(lanes_vec_max_dim=None), 25, 20) == "riccati_torch"
    assert kkt_route(qt.SolverOptions(lanes_vec_max_dim=200), 175, 171) == "lanes"
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.defect_scale, np.asarray(nj.analytic.defect_scale),
                               rtol=1e-12)


def test_cz_interop_carries_the_composite_system():
    goal, pj = _jax_cz()
    arrays, pt, _ = _port_cz()
    assert arrays["subsystem_levels"] == (3, 3) and arrays["operator_subsystem_levels"] == (3, 3)
    assert arrays["subspace"] == tuple(goal.subspace) == (0, 1, 3, 4) and arrays["levels"] == 9
    assert pt.system.params["subsystem_levels"] == (3, 3)
    # the port's own composite system and goal build the same problem
    sysq = qt.MultiTransmonSystem(omegas=[4.0, 4.5], deltas=[0.2, 0.2],
                                  gs=[[0.0, 0.01], [0.01, 0.0]], levels_per_transmon=3)
    own = qt.EmbeddedOperator(qt.GATES["CZ"], sysq)
    assert own.subspace == (0, 1, 3, 4) and own.subsystem_levels == (3, 3)
    np.testing.assert_allclose(sysq.G_drift, arrays["G_drift"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(sysq.G_drives, arrays["G_drives"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(own.operator, np.asarray(goal.operator))
    kw = dict(Q=100.0, R=1e-2, ipopt_options=_options(qt),
              piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu")
    for key, value in (("subspace", (0, 1, 3, 5)), ("subsystem_levels", (9,))):
        with pytest.raises(ValueError, match="differs"):
            interop.unitary_smooth_pulse_from_arrays({**arrays, key: value}, **kw)


def test_cz_bank_route_blocks_match_jax():
    # A, B, the cost Hessians and the defect curvature at n = 18, four
    # drives and a free Δt, at the seeded point with nonzero multipliers
    _, pj = _jax_cz()
    _, pt, Z0_t = _port_cz()
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    lam = torch.as_tensor(np.random.default_rng(1).standard_normal((1, T - 1, 171)))
    an, ft, fj = pt.solver.nlp.analytic, pt.solver.funcs, pj.solver.funcs
    _, At, Bt, aux = an.dyn_eval(Zs)
    # JAX's blocks in one compile
    (Aj, Bj, _), (Hj, Cj) = jax.jit(lambda z, l: (fj.jac_blocks(z), fj.hess_blocks(
        z, l, np.zeros((T, 0)))))(Zs[0].numpy(), lam[0].numpy())
    Hc, Cc = an.defect_curvature(lam, aux)
    Hq, Cq = ft.cost_hess(Zs)
    for name, mine, theirs in (("A", At, Aj), ("B", Bt, Bj), ("H", Hq + Hc, Hj),
                               ("C", Cq + Cc, Cj)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine[0].numpy(), theirs, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(theirs).max()), err_msg=name)
    assert float(Hc.abs().max()) > 1e-3  # the curvature is there


def test_cz_three_iterations_match_jax():
    _, pj = _jax_cz()
    _, pt, Z0_t = _port_cz()
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    for k in range(ITERS):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        for name, rtol in (("Z", 1e-8), ("lam", 1e-6), ("zl", 1e-6), ("zu", 1e-6)):
            a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
            scale = max(1.0, np.abs(b).max())
            assert np.abs(a - b).max() <= rtol * scale, (name, k, np.abs(a - b).max() / scale)
        np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-6)
    assert float(np.abs(st.Z.numpy() - Z0_t.numpy()).max()) > 1e-6  # the iterate moved
