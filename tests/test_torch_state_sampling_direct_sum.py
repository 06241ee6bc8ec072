"""Port parity: QuantumStateSamplingProblem and UnitaryDirectSumProblem.

Float64 on the CPU, against the JAX package on the same numpy seeds (T=11,
B=2, the JAX side on its XLA KKT backend, started from _init_state_jit):
(a) state sampling over three drift samples ζ Z (ζ ∈ {-0.05, 0, 0.05})
with one ket |0⟩ → |1⟩, built directly: the merged layout (ψ̃_system_j,
bounds, pins, goals, data) exactly; through
interop.quantum_state_sampling_from_arrays: (d, s, m) = (19, 17, 0), three
propagator groups, the fused assembly's route, the scales, the weighted
objective and its gradient (1e-12), then 3 IPM iterations in lockstep;
(b) the direct sum of an H and an X smooth-pulse problem with the JAX
test's drive_reset_ratio 0.25 (the reset drawn from one Generator) and a
boundary edge (a QuadraticRegularizer with a baseline) and fidelity_cost:
the suffixed layout exactly; through interop.unitary_direct_sum_from_arrays:
(d, s, m) = (30, 26, 2), two propagator groups each on its own Δt column,
the objective and its gradient with the pairwise and baseline terms
(1e-12), F, A, B and the curvature against the JAX package's
make_nlp_functions on a seeded (Z, λ, w) (1e-10 of the largest entry),
then 3 lifted IPM iterations in lockstep.  Iterates: Z within 1e-6, σ, w
and λ within 1e-6 relative, the KKT error 1e-4 relative, as
tests/test_torch_min_time.py holds them.  One JAX problem for each
template; the checks are separate items, so that `--dist loadfile` sends
the file out before the long JAX files."""

import functools

import jax
import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.solver.stage_nlp import make_nlp_functions as jax_nlp_functions
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

T, DT, ZETAS = 11, 0.2, (-0.05, 0.0, 0.05)
Q, R = 100.0, 1e-2


def _opts(pkg):
    extra = {"kkt_backend": "xla"} if pkg is qct else {}
    return pkg.SolverOptions(print_level=1, tol=1e-6, **extra)


def _dev(pkg):
    return {} if pkg is qct else {"device": "cpu"}


def _same_layout(tt, tj):
    assert tt.names == tuple(tj.names) and tt.controls == tuple(tj.controls)
    assert tt.timestep == tj.timestep
    for field in ("initial", "final", "goal"):
        a, b = getattr(tt, field), getattr(tj, field)
        assert list(a) == list(b), field
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"{field}[{k}]")
    assert list(tt.bounds) == list(tj.bounds)
    for k, (lo, hi) in tt.bounds.items():
        np.testing.assert_array_equal(lo, np.asarray(tj.bounds[k][0]))
        np.testing.assert_array_equal(hi, np.asarray(tj.bounds[k][1]))
    np.testing.assert_array_equal(tt.data, np.asarray(tj.data))


def _seeded_Z0(prob, names, sigma=0.05):
    Z0 = np.asarray(prob.initial_decision(2)).copy()
    rng = np.random.default_rng(5)
    for name in names:
        sl = prob.trajectory.comp_slice(name)
        Z0[1, 1:-1, sl] += sigma * rng.standard_normal((T - 2, sl.stop - sl.start))
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
    return st


def _cost_and_gradient(pj, pt, Z0_t):
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    fj, ft = pj.solver.funcs, pt.solver.funcs
    c_j, g_j = jax.jit(lambda z: (fj.total_cost(z), fj.grad_cost(z)))(Zs[1].numpy())
    np.testing.assert_allclose(ft.total_cost(Zs)[1].item(), float(c_j), rtol=1e-12)
    np.testing.assert_allclose(ft.grad_cost(Zs)[1].numpy(), np.asarray(g_j),
                               atol=1e-12 * max(1.0, float(np.abs(g_j).max())))
    return Zs


def _zeta_systems(pkg):
    return [pkg.QuantumSystem(z * pkg.PAULIS["Z"], [pkg.PAULIS["X"], pkg.PAULIS["Y"]])
            for z in ZETAS]


@functools.lru_cache(maxsize=None)  # one build per package for the whole file
def _state_sampling(pkg):
    return pkg.QuantumStateSamplingProblem(
        _zeta_systems(pkg), np.array([1, 0]), np.array([0, 1]), T, DT,
        system_weights=[1.0, 2.0, 0.5], Q=Q, R=R, ipopt_options=_opts(pkg),
        piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(3),
        **_dev(pkg))


@functools.lru_cache(maxsize=None)
def _state_sampling_interop():
    pj = _state_sampling(qct)
    Z0 = _seeded_Z0(pj, ["a"])
    return interop.quantum_state_sampling_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=Z0), Q=Q, R=R, system_weights=[1.0, 2.0, 0.5],
        ipopt_options=_opts(qt), piccolo_options=qt.PiccoloOptions(verbose=False),
        device="cpu")


EDGES = dict(graph=[("1", "2"), ("2", "b")], boundary_values={"b": np.array([0.1, -0.2])},
             R_b=0.3, fidelity_cost=True)


@functools.lru_cache(maxsize=None)
def _direct_sum(pkg):
    def sub(gate, seed):
        return pkg.UnitarySmoothPulseProblem(
            pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]]),
            pkg.GATES[gate], T, DT, ipopt_options=_opts(pkg),
            piccolo_options=pkg.PiccoloOptions(verbose=False), rng=np.random.default_rng(seed),
            **_dev(pkg))

    return pkg.UnitaryDirectSumProblem([sub("H", 0), sub("X", 1)], 0.99,
                                       drive_reset_ratio=0.25, rng=np.random.default_rng(2),
                                       **EDGES)


@functools.lru_cache(maxsize=None)
def _direct_sum_interop():
    pj = _direct_sum(qct)
    Z0 = _seeded_Z0(pj, ["a1", "a2"])
    return interop.unitary_direct_sum_from_arrays(
        interop.problem_arrays(pj, batch=2, Z0=Z0), Q=100.0, R=1e-2, ipopt_options=_opts(qt),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu", **EDGES)


def test_state_sampling_layout_matches_jax():
    direct = _state_sampling(qt)
    _same_layout(direct.trajectory, _state_sampling(qct).trajectory)
    assert direct.trajectory.names == ("ψ̃_system_1", "a", "da", "dda", "Δt", "ψ̃_system_2",
                                       "ψ̃_system_3")
    assert [ig.system.H_drift[0, 0] for ig in direct.integrators[:3]] == list(ZETAS)


def test_state_sampling_nlp_and_objective_match_jax():
    pj = _state_sampling(qct)
    pt, Z0_t = _state_sampling_interop()
    nt = pt.solver.nlp
    assert (nt.d, nt.s, nt.m) == (19, 17, 0)
    assert [g.members[0][:2] for g in nt.analytic.groups] == [(0, 4), (11, 15), (15, 19)]
    assert all((g.a_slice, g.dt_col) == ((4, 6), 10) for g in nt.analytic.groups)
    assert pt.solver.fused_assembly_on and pj.solver.fused_assembly_on
    np.testing.assert_allclose(pt.solver.var_scale, pj.solver.var_scale, rtol=1e-12)
    np.testing.assert_allclose(pt.solver.obj_scale, pj.solver.obj_scale, rtol=1e-12)
    assert [t.weight for t in pt.objective.terms][3:] == [Q, 2 * Q, 0.5 * Q]
    _cost_and_gradient(pj, pt, Z0_t)


def test_state_sampling_iterations_match_jax():
    pt, Z0_t = _state_sampling_interop()
    st = _lockstep(_state_sampling(qct), pt, Z0_t, 3)
    assert (st.Z - Z0_t / torch.as_tensor(pt.solver.var_scale))[:, 1:-1, 4:6].abs().max() > 1e-3


def test_direct_sum_layout_matches_jax():
    pj = _direct_sum(qct)
    _same_layout(_direct_sum(qt).trajectory, pj.trajectory)
    assert pj.trajectory.names == ("Ũ⃗1", "a1", "da1", "dda1", "Δt1", "Ũ⃗2", "a2", "da2", "dda2",
                                   "Δt2")
    assert pj.trajectory.timestep == "Δt1"


def test_direct_sum_nlp_and_objective_match_jax():
    pj = _direct_sum(qct)
    pt, Z0_t = _direct_sum_interop()
    nt, nj = pt.solver.nlp, pj.solver.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (30, 26, 2)
    assert [(g.a_slice, g.dt_col) for g in nt.analytic.groups] == [((8, 10), 14), ((23, 25), 29)]
    assert [r.dt_col for r in nt.analytic.deriv_rows] == [14, 14, 29, 29]
    assert not pt.solver.fused_assembly_on and pt.solver.kkt_aug_on
    labels = [t.label for t in pt.objective.terms]
    assert labels[:2] == ["pairwise_quad_reg", "quad_reg[dda2]"] and labels[-1] == (
        "unitary_infidelity[Ũ⃗2]")
    _cost_and_gradient(pj, pt, Z0_t)


def test_direct_sum_dynamics_blocks_match_jax():
    # F, A, B and the curvature on a seeded (Z, λ, w): each group reads its
    # own Δt column, each derivative chain its own
    pj = _direct_sum(qct)
    pt, Z0_t = _direct_sum_interop()
    nt = pt.solver.nlp
    fj = jax_nlp_functions(pj.solver.nlp)
    rng = np.random.default_rng(7)
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    Zs = Zs + 0.05 * torch.as_tensor(rng.standard_normal(Zs.shape))
    lam = torch.as_tensor(rng.standard_normal((2, T - 1, nt.s)))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (2, T, 2)))
    F, A, B, aux = nt.analytic.dyn_eval(Zs)
    Hc, Cc = nt.analytic.defect_curvature(lam, aux)
    H0, C0 = pt.solver.funcs.cost_hess(Zs, w)
    dyn_j, hess_j = jax.jit(fj.dyn_eval), jax.jit(fj.hess_blocks)
    for b in range(2):
        Fj, Aj, Bj, _, _ = dyn_j(Zs[b].numpy())
        Hj, Cj = hess_j(Zs[b].numpy(), lam[b].numpy(), w[b].numpy())
        for name, mine, theirs in (("F", F, Fj), ("A", A, Aj), ("B", B, Bj),
                                   ("H", H0 + Hc, Hj), ("C", C0 + Cc, Cj)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine[b].numpy(), theirs,
                                       atol=1e-10 * max(1.0, np.abs(theirs).max()),
                                       err_msg=f"{name}, instance {b}")
    assert float(A[..., 14].abs().max()) > 1e-3 and float(A[..., 29].abs().max()) > 1e-3
    # the two Δt columns are separate: a part's rows do not read the other's
    assert float(A[:, :, :13, 29].abs().max()) == 0.0
    assert float(A[:, :, 13:, 14].abs().max()) == 0.0


def test_direct_sum_iterations_match_jax():
    pt, Z0_t = _direct_sum_interop()
    _lockstep(_direct_sum(qct), pt, Z0_t, 3)
