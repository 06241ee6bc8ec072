"""Port parity: open-system (Lindblad) pulse design.

Float64 on the CPU, against the JAX package on the same numpy seeds, in
three items (so that `--dist loadfile` sends this file out beside the
long JAX files):
(a) the quantum objects and rollouts: the density iso maps, mat_to_iso
and iso_D (a random Hermitian H and two random dissipators at n=3), the
open system's superoperators and lindblad_action against JAX and against
the dense generator, expv_krylov in its matrix and matvec forms with
substeps (rtol 1e-9, atol 1e-10: the JAX package's tests/test_expv.py),
open_rollout "expm" and "expv" and the reroute's warning, the density
initializer's rollout of a control guess, both density fidelities (atol
1e-10 elsewhere);
(b) example 05's open-system problem at T=11 (rng default_rng(0)) carried
across by interop (the template refuses a closed system, and without
CUDA a build on the default device): z0, bounds, (d, s, m), nl_coords, the density defect
against JAX's Padé-8 defect (1e-13), and on a B=4 batch the AD route's F,
A, B and the curvature -λ·∇²F of every instance against JAX's
per-instance jax.hessian (atol 1e-9; the recipe through a linear solve
fails past instance 0: scripts/vmap_solve_hessian_probe.py);
(c) four IPM iterations of that batch from the same seeds (the JAX side
from _init_state_jit): Z within 1e-6, the duals 1e-6 relative, the KKT
error 1e-4 relative, as tests/test_torch_free_phase.py, and the final
open-rollout fidelities within 1e-6."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.dynamics.expv import expv_krylov as jax_expv
from quantumcollocation_tpu.solver.stage_nlp import make_nlp_functions as jax_nlp_functions
from quantumcollocation_tpu_torch import bench_util as bu
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.dynamics.expv import expv_krylov
from quantumcollocation_tpu_torch.solver.stage_nlp import make_nlp_functions

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
EXPV = dict(rtol=1e-9, atol=1e-10)
Q, R, T, DT, B = 100.0, 1e-2, 11, 0.2, 4
RHO0 = np.array([[1, 0], [0, 0]], dtype=complex)


def _random_open(pkg, rng, n=3, **kw):
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Hd = rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))
    Ls = [0.3 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
          for _ in range(2)]
    herm = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2).conj())  # noqa: E731
    return pkg.OpenQuantumSystem(herm(H), list(herm(Hd)), Ls, **kw), (herm(H), Ls)


def test_density_objects_and_rollouts_match_jax():
    rng = np.random.default_rng(0)
    sj, (H, Ls) = _random_open(qct, np.random.default_rng(1))
    st, _ = _random_open(qt, np.random.default_rng(1))
    # iso maps, numpy and torch, and their inverses
    rho = rng.standard_normal((2, 3, 3)) + 1j * rng.standard_normal((2, 3, 3))
    v_j = np.asarray(qct.density_to_iso_vec(rho))
    np.testing.assert_array_equal(qt.density_to_iso_vec(rho), v_j)
    np.testing.assert_array_equal(qt.density_to_iso_vec(torch.as_tensor(rho)).numpy(), v_j)
    np.testing.assert_array_equal(qt.iso_vec_to_density(v_j), rho)
    np.testing.assert_array_equal(qt.iso_vec_to_density(torch.as_tensor(v_j)).numpy(), rho)
    np.testing.assert_array_equal(qt.mat_to_iso(rho), np.asarray(qct.mat_to_iso(rho)))
    np.testing.assert_allclose(qt.iso_D(H, Ls), np.asarray(qct.iso_D(H, Ls)), atol=ATOL)
    np.testing.assert_allclose(st.D_drift, np.asarray(sj.D_drift), atol=ATOL)
    np.testing.assert_allclose(st.D_drives, np.asarray(sj.D_drives), atol=ATOL)
    # lindblad_action: against JAX, the dense generator, and batched
    a = rng.uniform(-1, 1, (3, 2))
    v = rng.standard_normal((3, 18))
    act_j = np.asarray(jax.vmap(sj.lindblad_action)(jnp.asarray(a), jnp.asarray(v)))
    act_t = st.lindblad_action(torch.as_tensor(a), torch.as_tensor(v))
    np.testing.assert_allclose(act_t.numpy(), act_j, atol=ATOL)
    dense = st.lindblad_generator(torch.as_tensor(a)) @ torch.as_tensor(v)[..., None]
    np.testing.assert_allclose(act_t.numpy(), dense[..., 0].numpy(), atol=ATOL)
    assert st.lindblad_action(torch.as_tensor(a, dtype=torch.float32),
                              torch.as_tensor(v, dtype=torch.float32)).dtype == torch.float32
    # expv_krylov: a matrix with substeps; the Lindblad matvec past the
    # space's dimension (m = 24 > 18: the happy breakdown)
    A = 0.5 * rng.standard_normal((12, 12))
    b = rng.standard_normal(12)
    got = expv_krylov(0.7, torch.as_tensor(A), torch.as_tensor(b), m=10, substeps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_expv(0.7, A, b, m=10, substeps=3)),
                               **EXPV)
    # batched: each instance its own time, controls and basis
    mv_t = expv_krylov(torch.tensor([1.3, 0.4], dtype=torch.float64), None,
                       torch.as_tensor(v[:2]), substeps=2,
                       matvec=lambda x: st.lindblad_action(torch.as_tensor(a[:2]), x))
    mv_j = jax.vmap(lambda t, a_, v_: jax_expv(
        t, None, v_, substeps=2, matvec=lambda x: sj.lindblad_action(a_, x)))(
        jnp.array([1.3, 0.4]), jnp.asarray(a[:2]), jnp.asarray(v[:2]))
    np.testing.assert_allclose(mv_t.numpy(), np.asarray(mv_j), **EXPV)
    # open rollouts (T=6) and the reroute's warning without superoperators
    r0 = np.asarray(qct.density_to_iso_vec(np.diag([1.0, 0.0, 0.0]).astype(complex)))
    ctl = rng.uniform(-1, 1, (6, 2))
    dts = rng.uniform(0.1, 0.3, 6)
    refs = {}
    for integ, tol in (("expm", dict(atol=ATOL)), ("expv", EXPV)):
        refs[integ] = np.asarray(qct.open_rollout(r0, ctl, dts, sj, integrator=integ))
        np.testing.assert_allclose(qt.open_rollout(r0, ctl, dts, st, integrator=integ).numpy(),
                                   refs[integ], **tol)
    s_free, _ = _random_open(qt, np.random.default_rng(1), materialize_superops=False)
    assert s_free.D_drift is None
    small = dict(num_squarings=1, krylov_dim=8)
    with pytest.warns(UserWarning, match="rerouted"):
        rer = qt.open_rollout(r0, ctl, dts, s_free, **small)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(
            rer.numpy(), qt.open_rollout(r0, ctl, dts, s_free, integrator="expv", **small).numpy())
    # the density initializer from a control guess (its state the JAX
    # package's rollout above), and both fidelities
    bounds = [np.ones(2), np.full(2, np.inf), np.ones(2)]
    tt = qt.initialize_density_trajectory(np.diag([1.0, 0.0, 0.0]), np.diag([0.0, 0.0, 1.0]),
                                          6, dts, 2, bounds, a_guess=ctl, system=st,
                                          free_time=True)
    assert tt.names == ("ρ⃗̃", "a", "da", "dda", "Δt")
    np.testing.assert_allclose(tt["ρ⃗̃"], refs["expm"], atol=ATOL)
    np.testing.assert_array_equal(tt["a"], ctl)
    psi = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    rho_h = rho[0] @ rho[0].conj().T
    np.testing.assert_allclose(qt.density_pure_state_fidelity(rho_h, psi),
                               qct.density_pure_state_fidelity(rho_h, psi), atol=ATOL)
    vv = qt.density_to_iso_vec(np.stack([rho_h, rho[1]]))
    ref = np.asarray(qct.iso_vec_density_pure_state_fidelity(jnp.asarray(vv), psi))
    np.testing.assert_allclose(qt.iso_vec_density_pure_state_fidelity(vv, psi), ref, atol=ATOL)
    np.testing.assert_allclose(
        qt.iso_vec_density_pure_state_fidelity(torch.as_tensor(vv), psi).numpy(), ref, atol=ATOL)


def _jax_problem():
    sys_o = qct.OpenQuantumSystem(qct.PAULIS["Z"], [qct.PAULIS["X"], qct.PAULIS["Y"]],
                                  [0.05 * qct.annihilate(2)])
    return qct.DensityOperatorSmoothPulseProblem(
        sys_o, RHO0, np.array([0, 1], dtype=complex), T, DT, Q=Q, R=R,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6, line_search="filter"),
        piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(0))


@functools.lru_cache(maxsize=None)  # one JAX problem for the file
def _pair():
    pj = _jax_problem()
    pt0 = bu.density_problem(T=T, dt=DT, device="cpu")
    Z0 = bu.density_seeds(pt0, B, 3)
    pt, Z0_t = interop.density_operator_smooth_pulse_from_arrays(
        interop.problem_arrays(pj, batch=B, Z0=Z0), Q=Q, R=R,
        ipopt_options=pt0.ipopt_options, piccolo_options=qt.PiccoloOptions(verbose=False),
        device="cpu")
    return pj, pt0, pt, Z0_t


def _close(mine, theirs, name, atol):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(theirs), rtol=0, atol=atol,
                               err_msg=name)


def test_density_nlp_and_ad_route_match_jax(monkeypatch):
    pj, pt0, pt, Z0_t = _pair()
    # the template takes an open system only, and device=None means CUDA
    with pytest.raises(TypeError, match="OpenQuantumSystem"):
        qt.DensityOperatorSmoothPulseProblem(qt.QuantumSystem(qt.PAULIS["Z"], [qt.PAULIS["X"]]),
                                             RHO0, [0, 1], T, DT, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bu.density_problem(T=T)
    nj, nt = pj.nlp, pt.nlp
    assert (nt.d, nt.s, nt.m) == (nj.d, nj.s, nj.m) == (15, 13, 0)
    assert nt.analytic is None and pt.solver.nlp.analytic is None
    assert tuple(nt.nl_coords) == tuple(nj.nl_coords) == tuple(range(8, 15))
    assert pt.trajectory.names == pt0.trajectory.names == ("ρ⃗̃", "a", "da", "dda", "Δt")
    # the template built directly draws as JAX draws (default_rng(0))
    for name in ("z0", "lb", "ub"):
        np.testing.assert_array_equal(getattr(pt0.nlp, name), np.asarray(getattr(nj, name)))
    np.testing.assert_array_equal(pt0.nlp.free_mask, np.asarray(nj.free_mask))
    # the density defect against JAX's Padé-8 defect, unscaled
    igj, igt = pj.integrators[0], pt.integrators[0]
    traj = pj.trajectory
    rng = np.random.default_rng(2)
    zs = np.asarray(traj.data)[:2] + 0.3 * rng.standard_normal((2, traj.dim))
    ref = np.asarray(jax.jit(lambda a, b: igj.defect(a, b, traj))(zs[0], zs[1]))
    out = igt.defect(torch.as_tensor(zs[:1]), torch.as_tensor(zs[1:]), traj)[0]
    _close(out, ref, "density defect", 1e-13)
    # the AD route on a B=4 batch, every instance against JAX
    sj_nlp, st_nlp = pj.solver.nlp, pt.solver.nlp
    fj, ft = jax_nlp_functions(sj_nlp), make_nlp_functions(st_nlp)
    d = st_nlp.d
    Zs = Z0_t / torch.as_tensor(pt.solver.var_scale)
    Zs = Zs + 0.05 * torch.as_tensor(rng.standard_normal(Zs.shape))
    lam = torch.as_tensor(rng.standard_normal((B, T - 1, st_nlp.s)))
    F, A, Bm = ft.dyn_eval(Zs)
    Hc, Cc = ft.defect_curvature(Zs, lam)

    def lam_F(zz, l_t, t):
        return -jnp.sum(l_t * sj_nlp.defect(zz[:d], zz[d:], t))

    dyn_j = jax.jit(fj.dyn_eval)
    pair_hess = jax.jit(jax.vmap(jax.hessian(lam_F)))
    for b in range(B):
        z, l_ = Zs[b].numpy(), lam[b].numpy()
        Fj, Aj, Bj = dyn_j(z)[:3]
        for name, mine, theirs in (("F", F, Fj), ("A", A, Aj), ("B", Bm, Bj)):
            _close(mine[b], theirs, f"{name}, instance {b}", 1e-12)
        Hp = np.asarray(pair_hess(np.concatenate([z[:-1], z[1:]], -1), l_, np.arange(T - 1)))
        Hj = np.zeros((T, d, d))
        Hj[:-1] += Hp[:, :d, :d]
        Hj[1:] += Hp[:, d:, d:]
        _close(Hc[b], Hj, f"Hc, instance {b}", 1e-9)
        _close(Cc[b], Hp[:, :d, d:], f"Cc, instance {b}", 1e-9)
    # the defect is linear in z_{t+1}: -λ·∇²F has no coupling block
    assert float(Hc.abs().max()) > 1e-2 and float(Cc.abs().max()) == 0.0


def test_four_density_iterations_match_jax():
    pj, _, pt, Z0_t = _pair()
    sj = pj.solver._init_state_jit(Z0_t.numpy())
    st = pt.solver.init_state(Z0_t)
    for k in range(4):
        sj, st = pj.solver.step(sj), pt.solver.step(st)
        np.testing.assert_allclose(st.Z.numpy(), np.asarray(sj.Z), atol=1e-6, err_msg=f"Z, {k}")
        a, b = st.lam.numpy(), np.asarray(sj.lam)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(b).max()),
                                   err_msg=f"lam, it {k}")
        np.testing.assert_allclose(st.kkt_err.numpy(), np.asarray(sj.kkt_err), rtol=1e-4,
                                   atol=1e-8)
    v = np.asarray(pt.solver.var_scale)
    Zt, Zj = st.Z.numpy() * v, np.asarray(sj.Z) * v
    traj = pj.trajectory
    a_sl, dt_sl = traj.comp_slice("a"), traj.comp_slice("Δt")
    roll = jax.jit(lambda a_, d_: qct.iso_vec_density_pure_state_fidelity(
        qct.open_rollout(traj.initial["ρ⃗̃"], a_, d_, pj.system)[-1], bu.DENSITY_GOAL))
    fid_j = np.array([float(roll(Zj[b, :, a_sl], Zj[b, :, dt_sl][:, 0])) for b in range(B)])
    fid_t = bu.density_fidelity(pt, Zt)
    np.testing.assert_allclose(fid_t, fid_j, atol=1e-6)
    assert np.all((fid_t > 0) & (fid_t <= 1))
