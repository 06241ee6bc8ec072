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
from quantumcollocation_tpu_torch import bench_util as bu
from quantumcollocation_tpu_torch.bench_util import seeded_bank, seeded_kkt
from quantumcollocation_tpu_torch.dynamics.expv import expv_krylov
from quantumcollocation_tpu_torch.ops import build
from quantumcollocation_tpu_torch.ops import dyn_assembly as da
from quantumcollocation_tpu_torch.ops import prop_bank as pb
from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
from quantumcollocation_tpu_torch.solver.ipm import InteriorPointSolver
from quantumcollocation_tpu_torch.solver.kkt import solve_kkt
from quantumcollocation_tpu_torch.solver.stage_nlp import jt_blocks

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


@pytest.mark.parametrize("d, s, Bt", [(15, 13, 4), (15, 13, 400), (47, 42, 4)])
def test_sweep_kernel_reports_a_failed_factorization(cuda, d, s, Bt):
    # instance 2 meets a negative pivot, never clamped: its NaN stays in its
    # own dz and nu, and the launch ends.  At d=15, B=400 it shares a block
    # with healthy instances; at d=47 every block holds one instance.
    rng = np.random.default_rng(1)
    T = 6
    H = np.broadcast_to(3 * np.eye(d), (Bt, T, d, d)).copy()
    H[2, 3] = -np.eye(d)
    args = [H, np.zeros((Bt, T - 1, d, d)), rng.normal(size=(Bt, T - 1, s, d)),
            rng.normal(size=(Bt, T - 1, s, d)), rng.normal(size=(Bt, T, d)),
            rng.normal(size=(Bt, T - 1, s))]
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in args]
    if Bt == 400:
        assert kl.sweep_config("kkt_fwd_sweep", Bt, d, s)["instances_per_block"] > 2
        assert kl.sweep_config("kkt_fwd_step", Bt, d, s)["instances_per_block"] > 2
    dz, nu, ok = kl.solve_kkt_lanes(*args, 1e-8)
    torch.cuda.synchronize()
    assert ok.tolist() == [i != 2 for i in range(Bt)]
    assert not (torch.isfinite(dz[2]).all() and torch.isfinite(nu[2]).all())
    # the same through the forward steps (kernel 6) of a lanes_scan solve
    dz, nu, ok = kl.solve_kkt_lanes_scan(*args, 1e-8)
    torch.cuda.synchronize()
    assert ok.tolist() == [i != 2 for i in range(Bt)]
    assert not (torch.isfinite(dz[2]).all() and torch.isfinite(nu[2]).all())


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


# (n, drives): kernel 5's strip design up to its drives (2 at n = 2, 4, 6;
# 5 at n = 8) and its entry design past them; each with a fixed and a free
# Δt
_STRIP_MAX = {2: 2, 4: 2, 6: 2, 8: 5}
_BANK_NNA = [(2, 1), (2, 2), (2, 3), (4, 1), (4, 2), (4, 3), (6, 1), (6, 2), (6, 3),
             (8, 1), (8, 4), (8, 5), (8, 6)]
_BANK_SHAPES = [(n, na, free) for n, na in _BANK_NNA for free in (False, True)]


def _design(n, na):
    return "strip" if na <= _STRIP_MAX[n] else "entry"


def _bank_into_poison(args, kw, monkeypatch):
    """The bank of args written into memory poisoned with NaN: the wrapper's
    output allocations come filled with NaN, so an entry the kernel never
    writes shows up."""
    full = torch.full
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", lambda shape, **k: full(shape, float("nan"), **k))
        out = pb.prop_bank(*args, **kw)
    torch.cuda.synchronize()
    return out


def _check_bank(args, kw, monkeypatch):
    """Kernel 5 against its plain version on NaN-poisoned outputs; a pair's
    outputs do not depend on its place in the batch (bit for bit)."""
    ref = pb.prop_bank_reference(*args, **kw)
    before = build.launch_counts["prop_bank"]
    out = _bank_into_poison(args, kw, monkeypatch)
    assert build.launch_counts["prop_bank"] == before + 1
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
            continue
        assert o.shape == r.shape and torch.isfinite(o).all()
        _close_rel(o, r)
    last = pb.prop_bank(*[x[-1:] for x in args[:2]], *args[2:], **kw)
    for o, x in zip(out, last):
        if o is not None:
            assert torch.equal(o[-1:], x)
    return out


@pytest.mark.parametrize("M", [1, 300, 301])  # 300 or 301: a ragged last block
@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("n, na, free_dt", _BANK_SHAPES)
def test_bank_kernel_matches_plain_version(cuda, monkeypatch, n, na, free_dt, order, M):
    assert pb.bank_config(n, na, free_dt, True, "pade")["design"] == _design(n, na)
    args = seeded_bank(M, n, na, cuda, seed=n + 10 * na + order)
    kw = dict(kind="pade", order=order, free_dt=free_dt, second_order=True)
    out = _check_bank(args, kw, monkeypatch)
    first = _check_bank(args, {**kw, "second_order": False}, monkeypatch)
    assert first[2] is None and first[5] is None
    _close_rel(first[4], out[4])


_EXP_CASES = [  # (n, drives, free Δt, second order, Padé order, squarings)
    (8, 5, False, True, 8, 2),  # the CNOT path's iterations
    (4, 2, True, False, 8, 1),  # the ket path's multiplier initialisation
    (4, 2, True, True, 8, 3),
    (2, 1, False, True, 8, 0),
    (2, 2, True, False, 8, 2),
    (6, 2, False, True, 8, 1),
    (6, 2, True, True, 8, 2),
    (8, 5, True, True, 8, 1),  # K = 6: more than 48 KB of shared memory a block
    # orders 2 and 4: the closed-form first step is the only step, or the
    # one before the last
    (4, 2, False, True, 2, 1),
    (4, 1, True, True, 2, 0),
    (8, 2, False, True, 2, 2),
    (8, 5, True, True, 2, 1),
    (2, 2, True, True, 4, 1),
    (8, 5, False, True, 4, 2),
    (6, 1, True, True, 4, 0),
    # the entry design
    (4, 3, False, True, 2, 1),
    (2, 3, True, True, 8, 1),
    (4, 4, False, True, 4, 2),
    (6, 3, True, False, 2, 1),
    (8, 6, False, True, 8, 2),
    (8, 6, True, True, 2, 1),
]


@pytest.mark.parametrize("M", [1, 300, 301])
@pytest.mark.parametrize("n, na, free_dt, second_order, order, nsq", _EXP_CASES)
def test_bank_kernel_exp_branch_matches_plain_version(cuda, monkeypatch, n, na, free_dt,
                                                      second_order, order, nsq, M):
    assert pb.bank_config(n, na, free_dt, second_order, "exp")["design"] == _design(n, na)
    args = seeded_bank(M, n, na, cuda, seed=n + nsq)
    kw = dict(kind="exp", order=order, num_squarings=nsq, free_dt=free_dt,
              second_order=second_order)
    assert len(_check_bank(args, kw, monkeypatch)) == 3


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


@pytest.mark.parametrize("qubits, drives, free_time, fused", [
    # (n, K) = (4, 3): the fused assembly's, the bank (entry design) at the
    # start
    (1, ["X", "Y", "Z"], False, "auto"),
    # the bank's entry design in every iteration: "auto" takes the bank
    # route, since the fused assembly takes K <= 3 only
    (1, ["X", "Y", "Z", "X"], True, "auto"),
    # the strip design below its most drives, in every iteration
    (2, ["XI", "IX"], False, "auto"),
    # the entry design, in every iteration
    (2, ["ZX", "XI", "YI", "IX", "IY", "ZZ"], False, "auto"),
])
def test_drive_counts_solve_on_the_card(cuda, qubits, drives, free_time, fused):
    P = qt.PAULIS
    op = lambda name: np.asarray(  # noqa: E731
        P[name] if qubits == 1 else np.kron(P[name[0]], P[name[1]]))
    drift = P["Z"] if qubits == 1 else 0.1 * op("ZZ")
    sysq = qt.QuantumSystem(drift, [op(x) for x in drives])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["H" if qubits == 1 else "CX"], 11, 0.3, Q=1e4, R=1e-3,
        ipopt_options=qt.SolverOptions(kkt_backend="lanes", line_search="filter",
                                       fused_assembly=fused),
        piccolo_options=qt.PiccoloOptions(verbose=False, free_time=free_time),
        rng=np.random.default_rng(7),
    )
    fused_on = qubits == 1 and len(drives) + int(free_time) <= 3
    assert prob.solver.fused_assembly_on == fused_on
    Z0 = prob.multistart_initial_decisions(4, sigma=0.3, rng=np.random.default_rng(0))
    build.reset_launch_counts()
    res = prob.solve_batched(Z0, max_iter=5)
    c = build.launch_counts
    assert torch.isfinite(res.Z).all()
    assert c["prop_bank"] >= (1 if fused_on else prob.solver.last_steps) > 0, c
    assert (c["dyn_assembly"] > 0) == fused_on, c
    assert c["kkt_fwd_sweep"] > 0, c


def _seeded_kkt(Bt, T, d, s, r, device, seed=0):
    """Definite, defect-shaped blocks (as above) with an r-column rhs."""
    return seeded_kkt(Bt, T, d, s, device, r, seed)[:6]


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


@pytest.mark.parametrize("T", [2, 11])
@pytest.mark.parametrize("Bt", [1, 133, 265])
@pytest.mark.parametrize("r", [1, 13])
@pytest.mark.parametrize("d, s", [(15, 13), (28, 24), (47, 42)])
def test_group_sweeps_match_plain_version(cuda, d, s, r, Bt, T):
    # kernels 2 and 3 (a group of warps per instance) against the plain
    # sweeps and the plain KKT solve: one instance, more instances than
    # SMs, and batches whose last block is ragged where a block holds
    # several groups (d <= 32: 2 and 3 instances per block on 132 SMs)
    cols = r if r > 1 else None
    args = _seeded_kkt(Bt, T, d, s, cols, cuda, seed=d + r + T)
    factors = r == 1
    k = kl.fwd_sweep_cuda(*args, 1e-8, want_factors=factors)
    ref = kl.fwd_sweep_reference(*args, 1e-8, want_factors=factors)
    pairs = list(zip(k[:4] + (k[4][:, -1],), ref[:5]))
    if factors:
        pairs += list(zip(k[5:], ref[6:]))
    for o, rr in pairs:
        assert o.shape == rr.shape
        _close_rel(o, rr)
    fac = [x.contiguous() for x in ref[:4]]
    dz_b, nu_b = kl.bwd_sweep_cuda(*fac, *args[1:4], args[5], k[4])
    dz_p, nu_p = kl.bwd_sweep_reference(*fac, *args[1:4], args[5], k[4][:, -1])
    _close_rel(dz_b, dz_p)
    _close_rel(nu_b, nu_p)
    dz, nu, ok = kl.solve_kkt_lanes(*args, 1e-8)
    dz_r, nu_r, ok_r = solve_kkt(*args, 1e-8)
    torch.cuda.synchronize()
    assert bool(ok.all()) and bool(ok_r.all())
    _close_rel(dz, dz_r)
    _close_rel(nu, nu_r)
    for kernel in ("kkt_fwd_sweep", "kkt_bwd_sweep"):
        cfg = kl.sweep_config(kernel, Bt, d, s, r)
        assert cfg["threads_per_instance"] == (128 if d <= 32 else 256), cfg


@pytest.mark.parametrize("T", [2, 11])
@pytest.mark.parametrize("Bt", [1, 133, 265])
@pytest.mark.parametrize("d, s", [(15, 13), (28, 24), (47, 42)])
def test_group_rhs_sweep_and_step_match_plain_version(cuda, d, s, Bt, T):
    # kernel 4 (the rhs-only sweep on kept factors) and kernel 6 (a forward
    # step), a group of warps per instance, against their plain versions,
    # and a whole lanes_scan solve against the plain KKT solve; ragged last
    # blocks where a block holds several groups (d <= 32)
    args = _seeded_kkt(Bt, T, d, s, None, cuda, seed=d + T)
    H, C, A, B, rz, rnu = args
    rhs2 = _seeded_kkt(Bt, T, d, s, None, cuda, seed=d + T + 1)[4:]
    ref = kl.fwd_sweep_reference(*args, 1e-8, want_factors=True)
    L_P, L_S, G, L_Pf = [x.contiguous() for x in (ref[0], ref[1], ref[6], ref[7])]
    q_k, dz_k = kl.rhs_fwd_sweep_cuda(L_P, L_S, G, C, A, *rhs2, L_Pf)
    q_r, dzl_r = kl.rhs_fwd_sweep_reference(L_P, L_S, G, C, A, *rhs2, L_Pf)
    _close_rel(q_k, q_r)
    _close_rel(dz_k[:, -1], dzl_r)
    new = dict(dtype=torch.float32, device=cuda)
    bufs = [torch.empty(Bt, T - 1, d, d, **new), torch.empty(Bt, T - 1, s, s, **new),
            torch.empty(Bt, T - 1, d, s, **new), torch.empty(Bt, T - 1, d, **new)]
    t = T - 2
    P, q = H[:, t].contiguous(), rz[:, t].contiguous()
    out = kl.fwd_step_cuda(P, q, H, C, A, B, rz, rnu, t, 1e-8, *bufs)
    r6 = kl.fwd_step_reference(P, q, H[:, t + 1], C[:, t], A[:, t], B[:, t], rz[:, t + 1],
                               rnu[:, t], 1e-8)
    for o, rr in zip(out + tuple(x[:, t] for x in bufs), r6[:6]):
        _close_rel(o, rr)
    dz, nu, ok = kl.solve_kkt_lanes_scan(*args, 1e-8)
    dz_r, nu_r, ok_r = solve_kkt(*args, 1e-8)
    torch.cuda.synchronize()
    assert bool(ok.all()) and bool(ok_r.all())
    _close_rel(dz, dz_r)
    _close_rel(nu, nu_r)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kernel in ("kkt_rhs_fwd_sweep", "kkt_fwd_step"):
        cfg = kl.sweep_config(kernel, Bt, d, s)
        assert cfg["threads_per_instance"] == (128 if d <= 32 else 256), cfg
        assert cfg["instances_per_block"] == min(-(-Bt // sms), 4 if d <= 32 else 1), cfg


@pytest.mark.parametrize("d, s, Bt", [(15, 13, 400), (47, 42, 4)])
def test_rhs_sweep_keeps_a_nan_factor_to_its_instance(cuda, d, s, Bt):
    # a NaN in instance 2's kept L_P reaches its q and dz_{T-1}, and no other
    # instance's; at d=15, B=400 it shares a block with healthy instances
    T = 6
    args = _seeded_kkt(Bt, T, d, s, None, cuda, seed=7)
    ref = kl.fwd_sweep_reference(*args, 1e-8, want_factors=True)
    L_P, L_S, G, L_Pf = [x.contiguous() for x in (ref[0], ref[1], ref[6], ref[7])]
    L_P[2, 3, 1, 0] = float("nan")
    if Bt == 400:
        assert kl.sweep_config("kkt_rhs_fwd_sweep", Bt, d, s)["instances_per_block"] > 2
    q, dz = kl.rhs_fwd_sweep_cuda(L_P, L_S, G, args[1], args[2], args[4], args[5], L_Pf)
    torch.cuda.synchronize()
    bad = ~(torch.isfinite(q).flatten(1).all(1) & torch.isfinite(dz[:, -1]).all(1))
    assert bad.tolist() == [i == 2 for i in range(Bt)]


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


@pytest.mark.parametrize("t_at", ["first", "last"])
@pytest.mark.parametrize("Bt", [1, 5, 265])
@pytest.mark.parametrize("d, s", [(15, 13), (28, 24), (47, 42)])
def test_bwd_step_matches_plain_version(cuda, d, s, Bt, t_at):
    # kernel 7 (kernel 3's group kernel for one knot) against its plain
    # version at knot 0 and T-2: it reads dz_{t+1} and writes dz_t and nu_t
    # only; at d <= 32 a block holds several groups, so B = 5 and 265 leave
    # the last block ragged.  At t = T-2, a whole lanes_scan solve against
    # the plain KKT solve as well.
    T = 6
    H, C, A, B, rz, rnu = _seeded_kkt(Bt, T, d, s, None, cuda, seed=d + Bt)
    L_P, L_S, X_A, qs = [x.contiguous() for x in kl.fwd_sweep_reference(H, C, A, B, rz, rnu,
                                                                         1e-8)[:4]]
    t = 0 if t_at == "first" else T - 2
    nan = float("nan")
    dz = torch.full((Bt, T, d), nan, device=cuda)
    nu = torch.full((Bt, T - 1, s), nan, device=cuda)
    dz[:, t + 1] = rz[:, t + 1]
    before = build.launch_counts["kkt_bwd_step"]
    kl.bwd_step_cuda(L_P, L_S, X_A, qs, C, A, B, rnu, dz, nu, t)
    torch.cuda.synchronize()
    assert build.launch_counts["kkt_bwd_step"] == before + 1
    dz_r, nu_r = kl.bwd_step_reference(dz[:, t + 1], L_P[:, t], L_S[:, t], X_A[:, t], qs[:, t],
                                       C[:, t], A[:, t], B[:, t], rnu[:, t])
    _close_rel(dz[:, t], dz_r)
    _close_rel(nu[:, t], nu_r)
    others = [k for k in range(T) if k not in (t, t + 1)]
    assert torch.isnan(dz[:, others]).all() and torch.isnan(nu[:, [k != t for k in range(T - 1)]]).all()
    assert kl.sweep_config("kkt_bwd_step", Bt, d, s) == kl.sweep_config("kkt_bwd_sweep", Bt, d, s)
    if t_at == "last":
        dz, nu, ok = kl.solve_kkt_lanes_scan(H, C, A, B, rz, rnu, 1e-8)
        dz_p, nu_p, ok_p = solve_kkt(H, C, A, B, rz, rnu, 1e-8)
        torch.cuda.synchronize()
        assert bool(ok.all()) and bool(ok_p.all())
        _close_rel(dz, dz_p)
        _close_rel(nu, nu_p)


@pytest.mark.parametrize("d, s, Bt", [(15, 13, 400), (47, 42, 4)])
def test_bwd_step_keeps_a_nan_factor_to_its_instance(cuda, d, s, Bt):
    # a NaN in instance 2's L_P at knot t reaches its dz_t and nu_t, and no
    # other instance's; at d=15, B=400 it shares a block with healthy ones
    T, t = 6, 3
    H, C, A, B, rz, rnu = _seeded_kkt(Bt, T, d, s, None, cuda, seed=11)
    L_P, L_S, X_A, qs = [x.contiguous() for x in kl.fwd_sweep_reference(H, C, A, B, rz, rnu,
                                                                         1e-8)[:4]]
    L_P[2, t, 1, 0] = float("nan")
    if Bt == 400:
        assert kl.sweep_config("kkt_bwd_step", Bt, d, s)["instances_per_block"] > 2
    dz = torch.zeros(Bt, T, d, device=cuda)
    nu = torch.zeros(Bt, T - 1, s, device=cuda)
    dz[:, t + 1] = rz[:, t + 1]
    kl.bwd_step_cuda(L_P, L_S, X_A, qs, C, A, B, rnu, dz, nu, t)
    torch.cuda.synchronize()
    bad = ~(torch.isfinite(dz[:, t]).all(1) & torch.isfinite(nu[:, t]).all(1))
    assert bad.tolist() == [i == 2 for i in range(Bt)]


_ASSEMBLY_CASES = {  # problem, options: one member (a unitary) or two (ket_exp's kets)
    "pade_free": ("unitary", {}),
    "pade_fixed": ("unitary", dict(free_time=False)),
    "exp_free": ("unitary", dict(integrator="exponential")),
    "exp_fixed": ("unitary", dict(integrator="exponential", free_time=False)),
    "ket_exp_free": ("kets", {}),
    "ket_exp_fixed": ("kets", dict(free_time=False)),
}


@pytest.mark.parametrize("Bt", [1, 37])
@pytest.mark.parametrize("case", list(_ASSEMBLY_CASES))
def test_assembly_kernel_writes_every_entry(cuda, case, Bt):
    # kernel 1 against its plain version, Padé and exponential, free and
    # fixed Δt, one and two members, B (T-1) not a multiple of the block's
    # pairs; the outputs land in memory poisoned with NaN just before the
    # call (the caching allocator hands back the freed blocks), so an entry
    # the kernel never writes shows up
    kind, opts = _ASSEMBLY_CASES[case]
    T = 11
    if kind == "unitary":
        sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
        prob = qt.UnitarySmoothPulseProblem(
            sysq, qt.GATES["H"], T, 0.2, piccolo_options=qt.PiccoloOptions(verbose=False, **opts),
            rng=np.random.default_rng(0), device="cpu")
    else:
        sysq = qt.QuantumSystem(0.1 * qt.PAULIS["Z"], [qt.PAULIS["X"], qt.PAULIS["Y"]])
        prob = qt.QuantumStateSmoothPulseProblem(
            sysq, [[1, 0], [0, 1]], [[0, 1], [1, 0]], T, 0.2,
            piccolo_options=qt.PiccoloOptions(verbose=False, integrator="exponential", **opts),
            rng=np.random.default_rng(0), device="cpu")
    an = prob.solver.nlp.analytic
    (g,) = an.groups
    assert len(g.members) == (2 if kind == "kets" else 1)
    assert g.kind == ("pade" if case.startswith("pade") else "exp")
    assert (g.dt_col is not None) == case.endswith("free")
    cfg = da.assembly_config(an)
    assert cfg["threads_per_pair"] == 16 and Bt * (T - 1) % cfg["pairs_per_block"] != 0, cfg
    rng = np.random.default_rng(Bt)
    z0 = np.asarray(prob.solver.nlp.z0)
    Z = torch.as_tensor(z0 + 0.05 * rng.standard_normal((Bt, *z0.shape)),
                        dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.standard_normal((Bt, T - 1, an.s)), dtype=torch.float32,
                          device=cuda)
    ref = da.dyn_assembly_reference(an, Z, lam)
    da.dyn_assembly(an, Z, lam)  # packs the argument table before the poisoning
    torch.cuda.synchronize()
    poison = [torch.full(r.shape, float("nan"), device=cuda) for r in ref]
    ptrs = sorted(x.data_ptr() for x in poison)
    del poison
    out = da.dyn_assembly(an, Z, lam)
    torch.cuda.synchronize()
    assert sorted(x.data_ptr() for x in out) == ptrs
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        if case.startswith("pade"):
            torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)
        else:
            _close_rel(o, r)


@pytest.mark.parametrize("Bt", [1, 37])
@pytest.mark.parametrize("phase_d", [13, 16])
def test_assembly_kernel_writes_the_global_columns(cuda, phase_d, Bt):
    # kernel 1 on the free-phase shapes: the smooth pulse with a global Z
    # phase (n=2, one drive, free Δt: d=13) and the bang-bang problem with
    # it (two drives: d=16, m=4).  The phase column belongs to no
    # integrator: its A, B columns and its curvature rows and columns must
    # be written as zeros into outputs poisoned with NaN
    if phase_d == 13:
        prob = bu.free_phase_problem(T=11, device="cpu")
    else:
        prob = bu.bang_bang_problem(T=11, phase=True, device="cpu")
    an = prob.solver.nlp.analytic
    (c0, c1), = prob.global_slices.values()
    assert (an.d, c1) == (phase_d, phase_d) and prob.solver.fused_assembly_on
    T = 11
    rng = np.random.default_rng(Bt)
    z0 = np.asarray(prob.solver.nlp.z0)
    Zn = z0 + 0.05 * rng.standard_normal((Bt, *z0.shape))
    Zn[:, :-1, c0:c1] = 0.0
    Z = torch.as_tensor(Zn, dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.standard_normal((Bt, T - 1, an.s)), dtype=torch.float32,
                          device=cuda)
    ref = da.dyn_assembly_reference(an, Z, lam)
    da.dyn_assembly(an, Z, lam)  # packs the argument table before the poisoning
    torch.cuda.synchronize()
    poison = [torch.full(r.shape, float("nan"), device=cuda) for r in ref]
    ptrs = sorted(x.data_ptr() for x in poison)
    del poison
    F, A, Bj, Hc, Cc = out = da.dyn_assembly(an, Z, lam)
    torch.cuda.synchronize()
    assert sorted(x.data_ptr() for x in out) == ptrs
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)
    for blk in (A, Bj):
        assert (blk[..., c0:c1] == 0).all()
    for blk in (Hc, Cc):
        assert (blk[..., c0:c1, :] == 0).all() and (blk[..., c0:c1] == 0).all()


def _phase_blocks(H, C, A, B, rz, rnu, u=8):
    """Seeded blocks given the free-phase structure of the last column φ:
    no integrator (zero A, B columns), pinned at t < T-1 (unit H row and
    column, zero C rows and columns, zero rz), free at the last knot with a
    dense U–φ block in H, diagonally dominant there."""
    c = H.shape[-1] - 1
    A[..., c] = 0.0
    B[..., c] = 0.0
    H[:, :-1, c, :] = 0.0
    H[:, :-1, :, c] = 0.0
    H[:, :-1, c, c] = 1.0
    C[..., c, :] = 0.0
    C[..., :, c] = 0.0
    rz[:, :-1, c] = 0.0
    g = torch.Generator(device=H.device).manual_seed(7)
    cpl = 0.5 * torch.randn(H.shape[0], u, generator=g, device=H.device)
    H[:, -1, c, :u] = cpl
    H[:, -1, :u, c] = cpl
    H[:, -1, c, c] = 3.0 + cpl.abs().sum(1)
    return H, C, A, B, rz, rnu


def _lifted_kkt(Bt, T, d, s, device, seed, phase=False):
    """Seeded blocks lifted as the solver lifts them (ρ from its Gershgorin
    rule): H + ρS_AA, C + ρS_AB, rz + ρJᵀrnu; and a second rhs.  With
    phase, the blocks have _phase_blocks' structure first."""
    H, C, A, B, rz, rnu, rz2, rnu2 = seeded_kkt(Bt, T, d, s, device, seed=seed)
    if phase:
        H, C, A, B, rz, rnu = _phase_blocks(H, C, A, B, rz, rnu)
    rho = InteriorPointSolver.lift_scale(H, C, 2.0)
    S_AA, S_AB = InteriorPointSolver._lift_S(A, B)
    r4 = rho[:, None, None, None]
    lifted = (H + r4 * S_AA, C + r4 * S_AB, A, B, rz + rho[:, None, None] * jt_blocks(A, B, rnu),
              rnu)
    return [x.contiguous() for x in lifted], (rz2, rnu2)


def _check_lifted_sweeps(cuda, monkeypatch, Bt, T, d, s, phase=False):
    """Kernel 2 with kept factors on lifted blocks, then kernel 4 (the
    refinement's rhs-only sweep on those factors) and kernel 3, each
    writing into memory poisoned with NaN, against their plain versions;
    and the whole re-solve on the kept factors against the plain KKT
    solve.  Returns the blocks and the kernel path's solve."""
    args, rhs2 = _lifted_kkt(Bt, T, d, s, cuda, seed=Bt + T, phase=phase)
    ref = kl.fwd_sweep_reference(*args, 1e-8, want_factors=True)
    full = torch.full
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", lambda *shape, **k: full(
            shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape,
            float("nan"), **k))
        k = kl.fwd_sweep_cuda(*args, 1e-8, want_factors=True)
        fac = [x.contiguous() for x in ref[:4]]
        q_k, dz_k = kl.rhs_fwd_sweep_cuda(k[0], k[1], k[5], args[1], args[2], *rhs2, k[6])
        dz_b, nu_b = kl.bwd_sweep_cuda(*fac, *args[1:4], args[5], k[4])
    torch.cuda.synchronize()
    for o, r in list(zip(k[:4] + (k[4][:, -1],), ref[:5])) + list(zip(k[5:], ref[6:])):
        assert torch.isfinite(o).all()
        _close_rel(o, r)
    q_r, dzl_r = kl.rhs_fwd_sweep_reference(*[x.contiguous() for x in (ref[0], ref[1], ref[6])],
                                            args[1], args[2], *rhs2, ref[7].contiguous())
    _close_rel(q_k, q_r)
    _close_rel(dz_k[:, -1], dzl_r)
    dz_p, nu_p = kl.bwd_sweep_reference(*fac, *args[1:4], args[5], k[4][:, -1])
    for o, r in ((dz_b, dz_p), (nu_b, nu_p)):
        assert torch.isfinite(o).all()
        _close_rel(o, r)
    dz, nu, ok, fac_k = kl.solve_kkt_lanes(*args, 1e-8, want_factors=True)
    dz2, nu2, ok2 = kl.resolve_kkt_lanes(fac_k, *rhs2)
    dz_r, nu_r, ok_r = solve_kkt(*args[:4], *rhs2, 1e-8)
    assert bool(ok.all()) and bool(ok2.all()) and bool(ok_r.all())
    _close_rel(dz2, dz_r)
    _close_rel(nu2, nu_r)
    return args, dz


@pytest.mark.parametrize("T", [2, 31])
@pytest.mark.parametrize("Bt", [1, 133, 512])
def test_sweeps_with_a_dense_terminal_phase_block(cuda, monkeypatch, Bt, T):
    # the free_phase_min_time path's lifted KKT attempt at (d, s) = (13, 11):
    # the φ column pinned at t < T-1 and coupled densely to U at the last
    # knot; the pinned entries of the step stay zero
    args, dz = _check_lifted_sweeps(cuda, monkeypatch, Bt, T, 13, 11, phase=True)
    assert (args[0][:, -1, -1, :8] != 0).all()
    assert dz[:, :-1, -1].abs().max() <= 1e-6 * max(1.0, dz.abs().max().item())


@pytest.mark.parametrize("T", [2, 51])
@pytest.mark.parametrize("Bt", [1, 133, 512])
def test_sweeps_on_lifted_blocks_match_plain_version(cuda, monkeypatch, Bt, T):
    # the min_time path's KKT attempt at d=15 (kernel 4 as
    # rhs_fwd_sweep_group<4>)
    _check_lifted_sweeps(cuda, monkeypatch, Bt, T, 15, 13)


@pytest.mark.parametrize("T", [2, 40])
@pytest.mark.parametrize("Bt", [1, 133, 256])
def test_sweeps_at_the_leakage_shape_match_plain_version(cuda, monkeypatch, Bt, T):
    # the leakage path's KKT attempt at (d, s) = (28, 22), m = 8 L1 rows
    # condensed into H before the lift
    _check_lifted_sweeps(cuda, monkeypatch, Bt, T, 28, 22)


def test_sweeps_at_the_su4_shape_match_plain_version(cuda):
    # kernels 2 (kept factors), 4 and 3 at B=512, T=33, d=47: one instance
    # a block, some four waves over the SMs
    Bt, T, d, s = 512, 33, 47, 42
    H, C, A, B, rz, rnu, rz2, rnu2 = seeded_kkt(Bt, T, d, s, cuda, seed=5)
    args = (H, C, A, B, rz, rnu)
    k = kl.fwd_sweep_cuda(*args, 1e-8, want_factors=True)
    ref = kl.fwd_sweep_reference(*args, 1e-8, want_factors=True)
    for o, r in list(zip(k[:4] + (k[4][:, -1],), ref[:5])) + list(zip(k[5:], ref[6:])):
        _close_rel(o, r)
    fac = [x.contiguous() for x in ref[:4]]
    dz_b, nu_b = kl.bwd_sweep_cuda(*fac, C, A, B, rnu, k[4])
    dz_p, nu_p = kl.bwd_sweep_reference(*fac, C, A, B, rnu, k[4][:, -1])
    _close_rel(dz_b, dz_p)
    _close_rel(nu_b, nu_p)
    L_P, L_S, G, L_Pf = [x.contiguous() for x in (ref[0], ref[1], ref[6], ref[7])]
    q_k, dz_k = kl.rhs_fwd_sweep_cuda(L_P, L_S, G, C, A, rz2, rnu2, L_Pf)
    q_r, dzl_r = kl.rhs_fwd_sweep_reference(L_P, L_S, G, C, A, rz2, rnu2, L_Pf)
    torch.cuda.synchronize()
    _close_rel(q_k, q_r)
    _close_rel(dz_k[:, -1], dzl_r)
    assert kl.sweep_config("kkt_fwd_sweep", Bt, d, s)["instances_per_block"] == 1


def test_su4_path_solves_on_the_card(cuda):
    prob = bu.su4_problem(T=11)
    goals = [qt.random_su(4, np.random.default_rng(s)) for s in (1, 2)]
    Z0 = qt.multigoal_initial_decisions(prob, goals, n_seeds_per_goal=4, sigma=0.2,
                                        rng=np.random.default_rng(100))
    build.reset_launch_counts()
    res = prob.solve_batched(Z0, max_iter=5)
    c = dict(build.launch_counts)
    Z = res.Z.double().cpu().numpy()
    assert np.isfinite(Z).all()
    free = np.asarray(prob.solver.nlp.free_mask)
    np.testing.assert_allclose(Z[:, ~free], Z0[:, ~free], atol=1e-6)  # the pinned W₀ = G†
    f = qt.multigoal_rollout_fidelities(prob, Z, goals, n_seeds_per_goal=4)
    assert np.isfinite(f).all()
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= prob.solver.last_steps > 0, c
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c


def test_min_time_path_solves_on_the_card(cuda):
    warm = bu.min_time_warm(T=11)
    build.reset_launch_counts()
    warm.solve(max_iter=10)
    c = dict(build.launch_counts)
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= warm.solver.last_steps > 0, c
    mt, dur0 = bu.min_time_problem(warm)
    s = mt.solver
    assert (s.fused_assembly_on, s.kkt_aug_on, s.retry_warm_on) == (True, True, True)
    build.reset_launch_counts()
    res = s.solve(bu.min_time_seeds(mt, 8, 0), max_iter=6)
    c = dict(build.launch_counts)
    assert torch.isfinite(res.Z).all()
    assert c["prop_bank"] == 1 and c["dyn_assembly"] >= s.last_steps > 0, c
    # every attempt refines once through its kept factors (the lift's pass)
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c
    assert int(s.kkt_lifted_rows) > 0 and dur0 > 0


def test_soc_resolve_on_lifted_min_time_factors(cuda):
    # the second-order correction on min_time's first lifted system (m = 1,
    # ρ > 0): its rhs rz + ρJᵀrnu re-solved on the kept factors by kernel
    # 4 then kernel 3, once each, against the plain re-solve on the same
    # factors.  These factors are far from float32's reach (PERF.md: the
    # first lifted min_time system), where the float32 re-solve of either
    # order carries errors of order one, so both are held, as chip_smoke.py's
    # reference phases hold solves, against the float64 re-solve on the
    # same (float32) factors: the kernels no worse than ten times the plain
    # version
    warm = bu.min_time_warm(T=11)
    warm.solve(max_iter=10)
    mt, _ = bu.min_time_problem(warm, soc=True)
    s = mt.solver
    assert s.soc_on and s.kkt_aug_on and s.nlp.m == 1
    st = s.init_state(bu.min_time_seeds(mt, 8, 0))
    kkt, aux = s._iteration_pre(st)
    dz, _, ok, _, _, rho, fac = s._solve_kkt_batched(kkt, st.delta_w, st, False, None, aux.rho0)
    kkt = [x.contiguous() for x in kkt]
    rz, rnu, _ = s._soc_rhs(st, aux, dz, rho, kkt)
    assert bool(ok.all()) and bool((rho > 0).all())
    assert (rz - kkt[4]).abs().max() > 0  # the lifted branch of the rhs
    build.reset_launch_counts()
    dz_k, nu_k, ok_k = kl.resolve_kkt_lanes(fac, rz, rnu)
    torch.cuda.synchronize()
    c = dict(build.launch_counts)
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_bwd_sweep"] == 1 and c["kkt_fwd_sweep"] == 0, c
    q_p, dzl_p = kl.rhs_fwd_sweep_reference(fac.L_P, fac.L_S, fac.G, fac.C, fac.A, rz, rnu,
                                            fac.L_Pf)
    plain = kl.bwd_sweep_reference(fac.L_P, fac.L_S, fac.X_A, q_p, fac.C, fac.A, fac.B, rnu,
                                   dzl_p)
    f64 = [x.double() for x in fac[:6]] + [fac.A.double(), fac.B.double()]
    L_P, L_S, X_A, G, L_Pf, C, A, Bj = f64
    q_r, dzl_r = kl.rhs_fwd_sweep_reference(L_P, L_S, G, C, A, rz.double(), rnu.double(), L_Pf)
    ref = kl.bwd_sweep_reference(L_P, L_S, X_A, q_r, C, A, Bj, rnu.double(), dzl_r)
    assert bool(ok_k.all())
    for k_out, p_out, r_out in zip((dz_k, nu_k), plain, ref):
        assert torch.isfinite(k_out).all()
        scale = max(1.0, r_out.abs().max().item())
        e_k = (k_out.double() - r_out).abs().max().item() / scale
        e_p = (p_out.double() - r_out).abs().max().item() / scale
        assert e_k <= 10 * e_p + 1e-6, (e_k, e_p)


@pytest.mark.parametrize("M", [1, 301, 9984])
def test_bank_kernel_at_the_leakage_shape(cuda, monkeypatch, M):
    # kernel 5 as the leakage path runs it every iteration: the transmon's
    # 6x6 generators (drive rows up to 2π√2), 2 drives within a_bound 0.5,
    # a fixed Δt = 0.2, Padé 4, second order; 9,984 = 256 x 39 pairs
    prob, _ = bu.leakage_problem(T=5, device="cpu")
    (g,) = prob.solver.nlp.analytic.groups
    assert pb.bank_config(6, 2, False, True, "pade")["design"] == "strip"
    rng = np.random.default_rng(M)
    f32 = dict(dtype=torch.float32, device=cuda)
    args = [torch.as_tensor(rng.uniform(-0.5, 0.5, (M, 2)), **f32), torch.full((M,), 0.2, **f32),
            torch.as_tensor(g.G_drift, **f32), torch.as_tensor(g.G_drives, **f32)]
    _check_bank(args, dict(kind="pade", order=4, free_dt=False, second_order=True), monkeypatch)


def test_leakage_path_solves_on_the_card(cuda):
    prob, goal = bu.leakage_problem()
    s = prob.solver
    assert (s.fused_assembly_on, s.kkt_refine_n, s.kkt_aug_on, s.retry_warm_on, s.nlp.m) == (
        False, 1, True, True, 8)
    Z0 = bu.leakage_seeds(prob, 8, 0)
    build.reset_launch_counts()
    res = s.solve(Z0, max_iter=60)
    c = dict(build.launch_counts)
    Z = res.Z.double().cpu().numpy()
    assert np.isfinite(Z).all()
    tr = prob.trajectory
    a = tr.comp_slice("a")

    def fid(Zx):
        return qt.batched_rollout_fidelity(Zx[:, :, a], np.full(Zx.shape[:2], 0.2), prob.system,
                                           tr.goal["Ũ⃗"], tr.initial["Ũ⃗"],
                                           subspace=goal.subspace)

    f0, f1 = fid(Z0), fid(Z)
    assert (f1 >= f0).all(), (f0, f1)
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= s.last_steps > 0, c
    # every attempt refines once through its kept factors (the lift's pass)
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c
    assert int(s.kkt_lifted_rows) > 0


@pytest.mark.parametrize("Bt", [1, 37, 512])
def test_assembly_kernel_on_two_sampling_groups(cuda, Bt):
    # kernel 1 on a two-system sampling problem (d=23, s=21): two
    # propagator groups of one (n, K) with different drifts, sharing the
    # controls and Δt; outputs into memory poisoned with NaN
    prob = bu.sampling_problem(T=11, zetas=(-0.05, 0.05), device="cpu")
    an = prob.solver.nlp.analytic
    assert (prob.solver.nlp.d, prob.solver.nlp.s) == (23, 21) and prob.solver.fused_assembly_on
    assert len(an.groups) == 2 and not np.array_equal(an.groups[0].G_drift,
                                                      an.groups[1].G_drift)
    rng = np.random.default_rng(Bt)
    z0 = np.asarray(prob.solver.nlp.z0)
    Z = torch.as_tensor(z0 + 0.05 * rng.standard_normal((Bt, *z0.shape)),
                        dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.standard_normal((Bt, an.T - 1, an.s)), dtype=torch.float32,
                          device=cuda)
    ref = da.dyn_assembly_reference(an, Z, lam)
    da.dyn_assembly(an, Z, lam)  # packs the argument table before the poisoning
    torch.cuda.synchronize()
    poison = [torch.full(r.shape, float("nan"), device=cuda) for r in ref]
    ptrs = sorted(x.data_ptr() for x in poison)
    del poison
    before = build.launch_counts["dyn_assembly"]
    out = da.dyn_assembly(an, Z, lam)
    torch.cuda.synchronize()
    assert build.launch_counts["dyn_assembly"] == before + 1
    assert sorted(x.data_ptr() for x in out) == ptrs
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)
    # each group's rows come from its own drift: the two state blocks differ
    F = out[0]
    assert (F[..., :8] - F[..., 8:16]).abs().max() > 0


@pytest.mark.parametrize("M", [301, 25088])
@pytest.mark.parametrize("group", [0, 1, 2])
def test_bank_kernel_on_the_sampling_groups(cuda, monkeypatch, group, M):
    # kernel 5 as the sampling path runs it, once per group an evaluation:
    # n=4, 2 drives, a free Δt, Padé 4, second order; 25,088 = 512 x 49
    # pairs, on NaN-poisoned outputs
    prob = bu.sampling_problem(T=5, device="cpu")
    g = prob.solver.nlp.analytic.groups[group]
    rng = np.random.default_rng(M + group)
    f32 = dict(dtype=torch.float32, device=cuda)
    args = [torch.as_tensor(rng.uniform(-1.0, 1.0, (M, 2)), **f32),
            torch.as_tensor(rng.uniform(0.1, 0.3, M), **f32),
            torch.as_tensor(g.G_drift, **f32), torch.as_tensor(g.G_drives, **f32)]
    _check_bank(args, dict(kind="pade", order=4, free_dt=True, second_order=True), monkeypatch)


@pytest.mark.parametrize("T", [2, 51])
@pytest.mark.parametrize("Bt", [1, 133, 256])
def test_sweeps_at_the_robustness_shape_match_plain_version(cuda, monkeypatch, Bt, T):
    # the robustness path's KKT attempt at (d, s) = (23, 21): seeded blocks
    # lifted by the solver's ρ rule
    _check_lifted_sweeps(cuda, monkeypatch, Bt, T, 23, 21)


def test_sweeps_on_the_robustness_ad_route_blocks(cuda, monkeypatch):
    # kernels 2 (kept factors), 3 and 4 (the refinement's re-solve on the
    # kept factors) on the robustness problem's own first-iteration blocks
    # from the AD route, lifted (H + δ_w I + ρS_AA, C + ρS_AB,
    # rz + ρJᵀrnu), outputs into memory poisoned with NaN.  These blocks
    # span ~1e8 (their factors' entries reach 1e4), beyond what a float32
    # factor comparison at 1e-4 resolves, so the kernel path's solves are
    # held, as chip_smoke.py's reference phases hold them, against the
    # float64 solve of the same float32 blocks: no worse than ten times the
    # plain float32 solve's error.  At the small δ_w of a first attempt the
    # kernel and its plain version each fail or succeed on their own
    # rounding; there the kernel's outputs are finite exactly on the
    # instances it reports solved
    prob, _ = bu.robustness_problem(T=51, device=cuda)
    s = prob.solver
    assert s.nlp.analytic is None and (s.nlp.d, s.nlp.s, s.nlp.m) == (23, 21, 1)
    st = s.init_state(bu.robustness_seeds(prob, 64, 7))
    kkt, aux = s._iteration_pre(st)
    kkt = [x.contiguous() for x in kkt]
    S = s._lift_S(kkt[2], kkt[3])
    small = [x.contiguous() for x in s._lifted(kkt, torch.full_like(aux.rho0, 1e-4), aux.rho0, S)]
    dz, nu, ok = kl.solve_kkt_lanes(*small, 1e-8)
    torch.cuda.synchronize()
    finite = torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)
    assert torch.equal(finite, ok) and bool(ok.any())
    args = [x.contiguous() for x in s._lifted(kkt, torch.full_like(aux.rho0, 1e3), aux.rho0, S)]
    rng = np.random.default_rng(3)
    rhs2 = [torch.as_tensor(rng.standard_normal(tuple(x.shape)), dtype=torch.float32,
                            device=cuda) for x in args[4:]]
    full = torch.full
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", lambda *shape, **k: full(
            shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape,
            float("nan"), **k))
        dz, nu, ok, fac = kl.solve_kkt_lanes(*args, 1e-8, want_factors=True)
        dz2, nu2, ok2 = kl.resolve_kkt_lanes(fac, *rhs2)
    torch.cuda.synchronize()
    assert bool(ok.all()) and bool(ok2.all())
    for rz, rnu, out_k in ((args[4], args[5], (dz, nu)), (rhs2[0], rhs2[1], (dz2, nu2))):
        blocks = list(args[:4]) + [rz, rnu]
        ref = solve_kkt(*[x.double() for x in blocks], 1e-8)
        plain = solve_kkt(*blocks, 1e-8)
        for k_out, p_out, r_out in zip(out_k, plain[:2], ref[:2]):
            assert torch.isfinite(k_out).all()
            scale = max(1.0, r_out.abs().max().item())
            e_k = (k_out.double() - r_out).abs().max().item() / scale
            e_p = (p_out.double() - r_out).abs().max().item() / scale
            assert e_k <= 10 * e_p + 1e-6, (e_k, e_p)


def test_sampling_path_solves_on_the_card(cuda):
    prob = bu.sampling_problem(T=11)
    s = prob.solver
    assert (s.fused_assembly_on, s.kkt_refine_n, s.kkt_aug_on) == (False, 1, False)
    Z0 = bu.sampling_seeds(prob, 8, 0)
    build.reset_launch_counts()
    res = s.solve(Z0, max_iter=10)
    c = dict(build.launch_counts)
    assert torch.isfinite(res.Z).all()
    # one bank launch per group an evaluation, none fused
    assert c["dyn_assembly"] == 0 and c["prop_bank"] >= 3 * s.last_steps > 0, c
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c


def test_robustness_path_solves_on_the_card(cuda):
    prob, warm = bu.robustness_problem()
    s = prob.solver
    assert (s.fused_assembly_on, s.kkt_aug_on, s.nlp.m) == (False, True, 1)
    Z0 = bu.robustness_seeds(prob, 8, 5)
    build.reset_launch_counts()
    res = s.solve(Z0, max_iter=20)
    c = dict(build.launch_counts)
    Z = res.Z.double().cpu().numpy()
    assert np.isfinite(Z).all()
    # the AD route: no assembly, no bank; every attempt refined once
    assert c["dyn_assembly"] == 0 and c["prop_bank"] == 0, c
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0 and c["kkt_bwd_sweep"] > 0, c
    tr = prob.trajectory
    a, dt = tr.comp_slice("a"), tr.comp_slice("Δt")
    before = bu.magnus_cost(Z0[:, :, a], Z0[:, :, dt][..., 0], warm.system, qt.PAULIS["Z"],
                            tr.initial["Ũ⃗"])
    after = bu.magnus_cost(Z[:, :, a], Z[:, :, dt][..., 0], warm.system, qt.PAULIS["Z"],
                           tr.initial["Ũ⃗"])
    assert np.median(after / before) < 0.9, after / before


def test_free_phase_paths_solve_on_the_card(cuda):
    # the free-phase smooth pulse (d=13: kernels 1, 2, 3), its chained
    # minimum-time stage (m=1, lifted: kernel 4 too) and bang-bang with a
    # phase (d=16, m=4), short solves at small sizes
    fp = bu.free_phase_problem(T=11)
    build.reset_launch_counts()
    fp.solve(max_iter=10)
    c = dict(build.launch_counts)
    assert c["dyn_assembly"] >= fp.solver.last_steps > 0 and c["kkt_rhs_fwd_sweep"] == 0, c
    phases = fp.trajectory.global_data["ϕ"]
    assert np.isfinite(phases).all() and phases.shape == (1,)
    mt, dur0 = bu.free_phase_min_time_problem(fp)
    assert mt.solver.nlp.m == 1 and mt.solver.kkt_aug_on and dur0 > 0
    build.reset_launch_counts()
    res = mt.solver.solve(bu.min_time_seeds(mt, 8, 0), max_iter=6)
    c = dict(build.launch_counts)
    assert torch.isfinite(res.Z).all()
    assert c["dyn_assembly"] >= mt.solver.last_steps > 0, c
    assert c["kkt_rhs_fwd_sweep"] == c["kkt_fwd_sweep"] - 1 > 0, c
    bb = bu.bang_bang_problem(T=11, phase=True)
    build.reset_launch_counts()
    res = bb.solver.solve(bu.hadamard_seeds(bb, 8, 0), max_iter=6)
    c = dict(build.launch_counts)
    assert torch.isfinite(res.Z).all() and bb.solver.nlp.d == 16
    assert c["dyn_assembly"] >= bb.solver.last_steps > 0 and c["kkt_rhs_fwd_sweep"] > 0, c


@pytest.mark.parametrize("Bt", [133, 512])  # 133: not a multiple of a block's instances
def test_sweeps_on_the_density_ad_route_blocks(cuda, monkeypatch, Bt):
    # kernels 2 and 3 on example 05's open-system problem's first-iteration
    # blocks from the AD route (d=15, s=13, m=0), at each instance's
    # accepted δ_w and one above it, outputs into memory poisoned with NaN.
    # These blocks' factors reach ~1e4 (most instances need δ_w ~2e2 at the
    # first iteration), where the kernel and its plain version differ by up
    # to ~3e-2 of the largest entry in float32 rounding alone, so the
    # kernel path's solves are held, as chip_smoke.py's reference phases and
    # the robustness blocks' test hold them, against the float64 solve of
    # the same float32 blocks: no worse than ten times the plain float32
    # solve's error, finite exactly on the instances it reports solved
    prob = bu.density_problem(T=30, device=cuda)
    s = prob.solver
    assert s.nlp.analytic is None and (s.nlp.d, s.nlp.s, s.nlp.m) == (15, 13, 0)
    assert (s.fused_assembly_on, s.kkt_refine_n, s.kkt_aug_on) == (False, 0, False)
    st = s.init_state(bu.density_seeds(prob, Bt, 7))
    kkt, _ = s._iteration_pre(st)
    dw = s._solve_kkt_batched(kkt, st.delta_w, st, False)[3]
    H, C, A, B, rz, rnu = [x.contiguous() for x in kkt]
    eye = torch.eye(15, device=cuda)
    full = torch.full
    for shift in (dw, dw + 1.0):
        real = [(H + shift[:, None, None, None] * eye).contiguous(), C, A, B, rz, rnu]
        with monkeypatch.context() as mp:
            mp.setattr(torch, "empty", lambda *shape, **k: full(
                shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape,
                float("nan"), **k))
            before = dict(build.launch_counts)
            dz, nu, ok = kl.solve_kkt_lanes(*real, 1e-8)
        torch.cuda.synchronize()
        assert build.launch_counts["kkt_fwd_sweep"] == before["kkt_fwd_sweep"] + 1
        assert build.launch_counts["kkt_bwd_sweep"] == before["kkt_bwd_sweep"] + 1
        finite = torch.isfinite(dz).flatten(1).all(1) & torch.isfinite(nu).flatten(1).all(1)
        assert torch.equal(finite, ok)
        plain = solve_kkt(*real, 1e-8)
        ref64 = solve_kkt(*[x.double() for x in real], 1e-8)
        keep = ok & plain[2] & ref64[2]
        assert int(keep.sum()) >= Bt - Bt // 100
        for k_out, p_out, r_out in zip((dz, nu), plain[:2], ref64[:2]):
            scale = max(1.0, r_out[keep].abs().max().item())
            e_k = (k_out[keep].double() - r_out[keep]).abs().max().item() / scale
            e_p = (p_out[keep].double() - r_out[keep]).abs().max().item() / scale
            assert e_k <= 10 * e_p + 1e-6, (e_k, e_p)


def test_lindblad_action_and_expv_on_the_card(cuda):
    # an open three-level system with two dissipators: float64 on the card
    # as on the CPU; float32 on the card within float32 rounding
    rng = np.random.default_rng(4)

    def herm(M):
        return 0.5 * (M + np.swapaxes(M, -1, -2).conj())

    cplx = lambda *shape: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)  # noqa
    sysq = qt.OpenQuantumSystem(herm(cplx(3, 3)), list(herm(cplx(2, 3, 3))),
                                [0.3 * cplx(3, 3), 0.3 * cplx(3, 3)])
    a = torch.as_tensor(rng.uniform(-1, 1, (64, 2)), dtype=torch.float64)
    v = torch.as_tensor(rng.standard_normal((64, 18)), dtype=torch.float64)
    t = torch.as_tensor(rng.uniform(0.1, 1.0, 64), dtype=torch.float64)
    cpu_act = sysq.lindblad_action(a, v)
    cpu_expv = expv_krylov(t, None, v, substeps=2, matvec=lambda x: sysq.lindblad_action(a, x))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        ac, vc, tc = (x.to(device=cuda, dtype=dtype) for x in (a, v, t))
        act = sysq.lindblad_action(ac, vc)
        assert act.dtype == dtype and act.device.type == cuda.type
        _close_rel(act.double().cpu(), cpu_act, tol)
        out = expv_krylov(tc, None, vc, substeps=2,
                          matvec=lambda x, ac=ac: sysq.lindblad_action(ac, x))
        assert torch.isfinite(out).all()
        _close_rel(out.double().cpu(), cpu_expv, tol)
        dense = sysq.lindblad_generator(ac) @ vc.unsqueeze(-1)
        _close_rel(dense.squeeze(-1).double().cpu(), cpu_act, tol)


def test_density_problem_builds_and_solves_on_the_card(cuda):
    # device=None means CUDA: example 05's open-system problem in float32,
    # the AD route (no kernel 1 or 5), kernels 2 and 3 once per KKT attempt
    # and once for the initial multipliers
    prob = bu.density_problem(T=11)
    s = prob.solver
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    assert s.nlp.analytic is None and s.nlp.d == 15
    Z0 = bu.density_seeds(prob, 8, 0)
    build.reset_launch_counts()
    res = s.solve(Z0, max_iter=20)
    c = dict(build.launch_counts)
    assert torch.isfinite(res.Z).all()
    assert c["dyn_assembly"] == 0 and c["prop_bank"] == 0 and c["kkt_rhs_fwd_sweep"] == 0, c
    assert c["kkt_fwd_sweep"] == c["kkt_bwd_sweep"] == s.kkt_attempts + 1 > 1, c
    fid0 = bu.density_fidelity(prob, Z0, device=cuda)
    fid = bu.density_fidelity(prob, res.Z.double().cpu().numpy(), device=cuda)
    assert np.median(fid) > np.median(fid0), (fid, fid0)
