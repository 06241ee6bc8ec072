"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports nothing of JAX, so it runs on the GPU
machine:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch.ops import build
from quantumcollocation_tpu_torch.ops import dyn_assembly as da
from quantumcollocation_tpu_torch.ops import prop_bank as pb
from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
from quantumcollocation_tpu_torch.solver.kkt import solve_kkt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(T=11):
    sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    return qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["H"], T, 0.2, piccolo_options=qt.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0), device="cpu",
    )


def test_assembly_kernel_matches_plain_version(cuda):
    prob = _problem()
    an = prob.solver.nlp.analytic
    rng = np.random.default_rng(3)
    z0 = np.asarray(prob.solver.nlp.z0)
    Z = torch.as_tensor(z0 + 0.05 * rng.standard_normal((64, *z0.shape)),
                        dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.standard_normal((64, an.T - 1, an.s)),
                          dtype=torch.float32, device=cuda)
    before = build.launch_counts["dyn_assembly"]
    out = da.dyn_assembly(an, Z, lam)
    assert build.launch_counts["dyn_assembly"] == before + 1
    for o, r in zip(out, da.dyn_assembly_reference(an, Z, lam)):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


def test_sweep_kernels_match_plain_version(cuda):
    rng = np.random.default_rng(0)
    Bt, T, d, s = 64, 11, 15, 13
    H = np.eye(d) * 3 + 0.3 * rng.normal(size=(Bt, T, d, d))
    E = np.eye(s, d)  # defect-shaped constraint blocks: float32 resolves them
    args = [0.5 * (H + np.swapaxes(H, -1, -2)), 0.2 * rng.normal(size=(Bt, T - 1, d, d)),
            -E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            rng.normal(size=(Bt, T, d)), rng.normal(size=(Bt, T - 1, s))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    dz, nu, ok = kl.solve_kkt_lanes(*args, 1e-8)
    dz_r, nu_r, ok_r = solve_kkt(*args, 1e-8)
    assert bool(ok.all()) and bool(ok_r.all())
    # float32: both round differently; the error is measured against the
    # largest entry (these blocks' float32 error vs float64 is ~3e-6 of it)
    for out, ref in ((dz, dz_r), (nu, nu_r)):
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_sweep_kernel_reports_a_failed_factorization(cuda):
    rng = np.random.default_rng(1)
    Bt, T, d, s = 4, 6, 15, 13
    H = np.broadcast_to(3 * np.eye(d), (Bt, T, d, d)).copy()
    H[2, 3] = -np.eye(d)  # instance 2: a negative pivot, never clamped
    args = [H, np.zeros((Bt, T - 1, d, d)), rng.normal(size=(Bt, T - 1, s, d)),
            rng.normal(size=(Bt, T - 1, s, d)), rng.normal(size=(Bt, T, d)),
            rng.normal(size=(Bt, T - 1, s))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    _, _, ok = kl.solve_kkt_lanes(*args, 1e-8)
    assert ok.tolist() == [True, True, False, True]


def test_wrappers_refuse_float64(cuda):
    Bt, T, d, s = 2, 3, 15, 13
    shapes = [(Bt, T, d, d), (Bt, T - 1, d, d), (Bt, T - 1, s, d), (Bt, T - 1, s, d),
              (Bt, T, d), (Bt, T - 1, s)]
    args = [torch.zeros(sh, dtype=torch.float64, device=cuda) for sh in shapes]
    with pytest.raises(TypeError):
        kl.solve_kkt_lanes(*args, 1e-8)


def _close_rel(out, ref, tol=1e-4):
    """float32 kernel against its plain version: max error relative to the
    largest entry (the two round in different orders)."""
    assert (out.double() - ref.double()).abs().max() <= tol * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("n, na, free_dt", [(8, 5, False), (4, 2, True)])
def test_bank_kernel_matches_plain_version(cuda, n, na, free_dt):
    rng = np.random.default_rng(n)
    M = 300
    args = [rng.uniform(-1, 1, size=(M, na)), rng.uniform(0.1, 0.4, size=(M,)),
            0.5 * rng.normal(size=(n, n)), 0.5 * rng.normal(size=(na, n, n))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    kw = dict(kind="pade", order=4, free_dt=free_dt, second_order=True)
    before = build.launch_counts["prop_bank"]
    out = pb.prop_bank(*args, **kw)
    assert build.launch_counts["prop_bank"] == before + 1
    for o, r in zip(out, pb.prop_bank_reference(*args, **kw)):
        assert o.shape == r.shape
        _close_rel(o, r)
    first = pb.prop_bank(*args, **{**kw, "second_order": False})
    assert first[2] is None and first[5] is None
    _close_rel(first[4], out[4])


@pytest.mark.parametrize("n, na, free_dt, second_order, nsq", [
    (8, 5, False, True, 2),  # the CNOT path's iterations
    (4, 2, True, False, 1),  # the ket path's multiplier initialisation
    (4, 2, True, True, 3),
])
def test_bank_kernel_exp_branch_matches_plain_version(cuda, n, na, free_dt, second_order, nsq):
    rng = np.random.default_rng(n + nsq)
    M = 300
    args = [rng.uniform(-1, 1, size=(M, na)), rng.uniform(0.1, 0.4, size=(M,)),
            0.5 * rng.normal(size=(n, n)), 0.5 * rng.normal(size=(na, n, n))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    kw = dict(kind="exp", order=8, num_squarings=nsq, free_dt=free_dt, second_order=second_order)
    before = build.launch_counts["prop_bank"]
    out = pb.prop_bank(*args, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts["prop_bank"] == before + 1 and len(out) == 3
    for o, r in zip(out, pb.prop_bank_reference(*args, **kw)):
        if r is None:
            assert o is None
            continue
        assert o.shape == r.shape
        _close_rel(o, r)


def _ket_problem(T=11, **kw):
    sysq = qt.QuantumSystem(0.1 * qt.PAULIS["Z"], [qt.PAULIS["X"], qt.PAULIS["Y"]])
    return qt.QuantumStateSmoothPulseProblem(
        sysq, [[1, 0], [0, 1]], [[0, 1], [1, 0]], T, 0.2, Q=1e4, R=1e-3,
        ipopt_options=qt.SolverOptions(line_search="filter", kappa_mu=0.2, tol=1e-5),
        piccolo_options=qt.PiccoloOptions(verbose=False, integrator="exponential"),
        rng=np.random.default_rng(0), **kw,
    )


def test_assembly_kernel_exp_branch_matches_plain_version(cuda):
    prob = _ket_problem(device="cpu")
    an = prob.solver.nlp.analytic
    assert an.groups[0].kind == "exp" and an.groups[0].num_squarings == 1
    rng = np.random.default_rng(5)
    z0 = np.asarray(prob.solver.nlp.z0)
    Z = torch.as_tensor(z0 + 0.05 * rng.standard_normal((64, *z0.shape)),
                        dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.standard_normal((64, an.T - 1, an.s)),
                          dtype=torch.float32, device=cuda)
    before = build.launch_counts["dyn_assembly"]
    out = da.dyn_assembly(an, Z, lam)
    torch.cuda.synchronize()
    assert build.launch_counts["dyn_assembly"] == before + 1
    for o, r in zip(out, da.dyn_assembly_reference(an, Z, lam)):
        _close_rel(o, r)
    assert float(out[4].abs().max()) == 0.0  # no Cc term


def test_sweeps_with_kept_factors_at_two_qubit_size(cuda):
    rng = np.random.default_rng(4)
    Bt, T, d, s = 8, 6, 47, 42
    w = 1.0 / np.sqrt(d)
    H = np.eye(d) * 3 + w * rng.normal(size=(Bt, T, d, d))
    E = np.eye(s, d)
    args = [0.5 * (H + np.swapaxes(H, -1, -2)), 0.7 * w * rng.normal(size=(Bt, T - 1, d, d)),
            -E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            rng.normal(size=(Bt, T, d)), rng.normal(size=(Bt, T - 1, s))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    rhs2 = [torch.as_tensor(rng.normal(size=x.shape), dtype=torch.float32, device=cuda)
            for x in args[4:]]
    k = kl.fwd_sweep_cuda(*args, 1e-8, want_factors=True)
    r = kl.fwd_sweep_reference(*args, 1e-8, want_factors=True)
    for name, o, ref in zip(("L_P", "L_S", "X_A", "q", "dz", "G", "L_Pf"), k, r[:5] + r[6:]):
        _close_rel(o[:, -1] if name == "dz" else o, ref)
    dz, nu, ok, fac = kl.solve_kkt_lanes(*args, 1e-8, want_factors=True)
    dz_r, nu_r, ok_r = solve_kkt(*args, 1e-8)
    assert bool(ok.all()) and bool(ok_r.all())
    _close_rel(dz, dz_r)
    _close_rel(nu, nu_r)
    before = build.launch_counts["kkt_rhs_fwd_sweep"]
    ez, enu, okr = kl.resolve_kkt_lanes(fac, *rhs2)
    assert build.launch_counts["kkt_rhs_fwd_sweep"] == before + 1 and bool(okr.all())
    q_r, dzl_r = kl.rhs_fwd_sweep_reference(fac.L_P, fac.L_S, fac.G, fac.C, fac.A, *rhs2,
                                            fac.L_Pf)
    q_k, dz_k = kl.rhs_fwd_sweep_cuda(fac.L_P, fac.L_S, fac.G, fac.C, fac.A, *rhs2, fac.L_Pf)
    _close_rel(q_k, q_r)
    _close_rel(dz_k[:, -1], dzl_r)
    ez_r, enu_r, _ = solve_kkt(*args[:4], *rhs2, 1e-8)
    _close_rel(ez, ez_r)
    _close_rel(enu, enu_r)


def test_main_path_launches_every_kernel(cuda):
    # the Hadamard path: fused assembly and the two sweeps in the iterations,
    # the bank only for the multiplier initialisation's Jacobian, no re-solve
    sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["H"], 21, 0.2, piccolo_options=qt.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    build.reset_launch_counts()
    f0 = qt.unitary_rollout_fidelity(prob.trajectory, sysq)
    prob.solve(max_iter=20)
    c = build.launch_counts
    assert min(c["dyn_assembly"], c["kkt_fwd_sweep"], c["kkt_bwd_sweep"]) > 0, c
    assert c["prop_bank"] == 1 and c["kkt_rhs_fwd_sweep"] == 0, c
    assert qt.unitary_rollout_fidelity(prob.trajectory, sysq) > f0


def test_cnot_path_launches_its_kernels(cuda):
    P, k = qt.PAULIS, np.kron
    sysq = qt.QuantumSystem(0.1 * k(P["Z"], P["Z"]), [k(P["Z"], P["X"]), k(P["X"], P["I"]),
                                                      k(P["Y"], P["I"]), k(P["I"], P["X"]),
                                                      k(P["I"], P["Y"])])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["CX"], 11, 0.3, Q=1e4, R=1e-3,
        ipopt_options=qt.SolverOptions(kkt_backend="lanes", line_search="filter"),
        piccolo_options=qt.PiccoloOptions(verbose=False, free_time=False),
        rng=np.random.default_rng(7),
    )
    Z0 = prob.multistart_initial_decisions(4, sigma=0.3, rng=np.random.default_rng(0))
    build.reset_launch_counts()
    res = prob.solve_batched(Z0, max_iter=5)
    c = build.launch_counts
    assert torch.isfinite(res.Z).all()
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= prob.solver.last_steps > 0, c
    # every IPM attempt re-solves once; the multiplier solve at start does not
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c
    assert c["kkt_bwd_sweep"] == c["kkt_fwd_sweep"] + c["kkt_rhs_fwd_sweep"], c


def test_ket_exp_path_launches_its_kernels(cuda):
    # the exponential ket path: fused assembly (exponential branch) and the
    # two sweeps in the iterations, the exponential bank once per solve
    prob = _ket_problem()
    Z0 = prob.multistart_initial_decisions(8, sigma=0.1, rng=np.random.default_rng(0))
    build.reset_launch_counts()
    res = prob.solve_batched(Z0, max_iter=10)
    c = build.launch_counts
    assert torch.isfinite(res.Z).all()
    assert c["dyn_assembly"] == prob.solver.last_steps > 0, c
    assert c["prop_bank"] == 1 and c["kkt_rhs_fwd_sweep"] == 0, c
    assert c["kkt_fwd_sweep"] == c["kkt_bwd_sweep"] > 0, c


def test_cnot_exp_path_launches_its_kernels(cuda):
    P, k = qt.PAULIS, np.kron
    sysq = qt.QuantumSystem(0.1 * k(P["Z"], P["Z"]), [k(P["Z"], P["X"]), k(P["X"], P["I"]),
                                                      k(P["Y"], P["I"]), k(P["I"], P["X"]),
                                                      k(P["I"], P["Y"])])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["CX"], 11, 0.3, Q=1e4, R=1e-3,
        ipopt_options=qt.SolverOptions(kkt_backend="lanes", line_search="filter"),
        piccolo_options=qt.PiccoloOptions(verbose=False, free_time=False,
                                          integrator="exponential"),
        rng=np.random.default_rng(7),
    )
    (g,) = prob.solver.nlp.analytic.groups
    assert (g.kind, g.num_squarings) == ("exp", 2)
    Z0 = prob.multistart_initial_decisions(4, sigma=0.3, rng=np.random.default_rng(0))
    build.reset_launch_counts()
    res = prob.solve_batched(Z0, max_iter=5)
    c = build.launch_counts
    assert torch.isfinite(res.Z).all()
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= prob.solver.last_steps > 0, c
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c


def _seeded_kkt(Bt, T, d, s, r, device, seed=0):
    """Definite, defect-shaped blocks (as above) with an r-column rhs."""
    rng = np.random.default_rng(seed)
    w = 0.3 if d <= 16 else 1.0 / np.sqrt(d)
    H = np.eye(d) * 3 + w * rng.normal(size=(Bt, T, d, d))
    E = np.eye(s, d)
    cols = () if r is None else (r,)
    args = [0.5 * (H + np.swapaxes(H, -1, -2)),
            (0.2 if d <= 16 else 0.7 * w) * rng.normal(size=(Bt, T - 1, d, d)),
            -E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            (1.0 if d <= 16 else 0.5) * E + 0.1 * rng.normal(size=(Bt, T - 1, s, d)),
            rng.normal(size=(Bt, T, d, *cols)), rng.normal(size=(Bt, T - 1, s, *cols))]
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in args]


@pytest.mark.parametrize("d, s", [(15, 13), (47, 42)])
def test_multi_column_sweeps_match_plain_version(cuda, d, s):
    # the L-BFGS [rz | U] system: 13 columns through kernels 2 and 3
    args = _seeded_kkt(16, 8, d, s, 13, cuda, seed=d)
    k = kl.fwd_sweep_cuda(*args, 1e-8)
    r = kl.fwd_sweep_reference(*args, 1e-8)
    for o, ref in zip(k[:4] + (k[4][:, -1],), r[:5]):
        assert o.shape == ref.shape
        _close_rel(o, ref)
    dz, nu, ok = kl.solve_kkt_lanes(*args, 1e-8)
    dz_r, nu_r, ok_r = solve_kkt(*args, 1e-8)
    assert dz.shape == (16, 8, d, 13) and bool(ok.all()) and bool(ok_r.all())
    _close_rel(dz, dz_r)
    _close_rel(nu, nu_r)
    # column 0 as a single-column solve
    dz1, nu1, _ = kl.solve_kkt_lanes(*args[:4], args[4][..., 0].contiguous(),
                                     args[5][..., 0].contiguous(), 1e-8)
    _close_rel(dz[..., 0], dz1)
    _close_rel(nu[..., 0], nu1)


def test_step_kernels_match_plain_version(cuda):
    Bt, T, d, s = 32, 9, 15, 13
    H, C, A, B, rz, rnu = _seeded_kkt(Bt, T, d, s, None, cuda, seed=3)
    new = dict(dtype=torch.float32, device=cuda)
    L_P, L_S = torch.empty(Bt, T - 1, d, d, **new), torch.empty(Bt, T - 1, s, s, **new)
    X_A, qs = torch.empty(Bt, T - 1, d, s, **new), torch.empty(Bt, T - 1, d, **new)
    before = dict(build.launch_counts)
    Pn, qn = kl.fwd_step_cuda(H[:, 0].contiguous(), rz[:, 0].contiguous(), H, C, A, B, rz, rnu,
                              0, 1e-8, L_P, L_S, X_A, qs)
    ref = kl.fwd_step_reference(H[:, 0], rz[:, 0], H[:, 1], C[:, 0], A[:, 0], B[:, 0], rz[:, 1],
                                rnu[:, 0], 1e-8)
    for o, r in zip((Pn, qn, L_P[:, 0], L_S[:, 0], X_A[:, 0], qs[:, 0]), ref[:6]):
        _close_rel(o, r)
    dz = torch.zeros(Bt, T, d, **new)
    nu = torch.zeros(Bt, T - 1, s, **new)
    dz[:, 1] = torch.randn(Bt, d, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    kl.bwd_step_cuda(L_P, L_S, X_A, qs, C, A, B, rnu, dz, nu, 0)
    dz_r, nu_r = kl.bwd_step_reference(dz[:, 1], L_P[:, 0], L_S[:, 0], X_A[:, 0], qs[:, 0],
                                       C[:, 0], A[:, 0], B[:, 0], rnu[:, 0])
    _close_rel(dz[:, 0], dz_r)
    _close_rel(nu[:, 0], nu_r)
    assert build.launch_counts["kkt_fwd_step"] == before["kkt_fwd_step"] + 1
    assert build.launch_counts["kkt_bwd_step"] == before["kkt_bwd_step"] + 1
    # a whole scan solve: T-1 launches each way, against the plain solve
    dz, nu, ok = kl.solve_kkt_lanes_scan(H, C, A, B, rz, rnu, 1e-8)
    dz_r, nu_r, ok_r = solve_kkt(H, C, A, B, rz, rnu, 1e-8)
    assert bool(ok.all()) and bool(ok_r.all())
    _close_rel(dz, dz_r)
    _close_rel(nu, nu_r)
    assert build.launch_counts["kkt_fwd_step"] == before["kkt_fwd_step"] + T
    assert build.launch_counts["kkt_bwd_step"] == before["kkt_bwd_step"] + T


@pytest.mark.parametrize("mode", ["lbfgs", "scan"])
def test_lbfgs_and_scan_paths_launch_their_kernels(cuda, mode):
    sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["H"], 11, 0.2, Q=1e4, R=1e-3,
        ipopt_options=qt.SolverOptions(line_search="filter", kappa_mu=0.2, tol=1e-5,
                                       kkt_backend="lanes_scan" if mode == "scan" else "xla"),
        piccolo_options=qt.PiccoloOptions(verbose=False, eval_hessian=mode != "lbfgs"),
        rng=np.random.default_rng(0),
    )
    solver = prob.solver
    build.reset_launch_counts()
    res = prob.solve_batched(prob.initial_decision(8), max_iter=6)
    c, n, att = build.launch_counts, solver.last_steps, solver.kkt_attempts
    assert torch.isfinite(res.Z).all() and n > 0
    assert c["kkt_rhs_fwd_sweep"] == 0, c
    if mode == "lbfgs":
        # the bank (first order) at the iterate and at the previous one
        assert c["dyn_assembly"] == 0 and c["prop_bank"] >= n, c
        assert c["kkt_fwd_sweep"] == c["kkt_bwd_sweep"] == att + 1, c  # +1: multipliers
        assert c["kkt_fwd_step"] == c["kkt_bwd_step"] == 0, c
    else:
        assert c["dyn_assembly"] == n and c["prop_bank"] == 1, c
        assert c["kkt_fwd_sweep"] == c["kkt_bwd_sweep"] == 0, c
        assert c["kkt_fwd_step"] == c["kkt_bwd_step"] == 10 * (att + 1), c
