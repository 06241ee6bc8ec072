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


def test_main_path_launches_every_kernel(cuda):
    sysq = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    prob = qt.UnitarySmoothPulseProblem(
        sysq, qt.GATES["H"], 21, 0.2, piccolo_options=qt.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    build.reset_launch_counts()
    f0 = qt.unitary_rollout_fidelity(prob.trajectory, sysq)
    prob.solve(max_iter=20)
    assert min(build.launch_counts.values()) > 0
    assert qt.unitary_rollout_fidelity(prob.trajectory, sysq) > f0
