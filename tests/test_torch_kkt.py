"""Port parity: the block-tridiagonal KKT solve.

The port's plain sweeps against the JAX Pallas sweeps (interpret mode) and
the JAX XLA Riccati solve, float64 on the CPU at d=15, s=13, T=6, B=3
(rtol 1e-9).  The CUDA sweeps are held against the plain version on the
card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcollocation_tpu.solver.kkt import solve_kkt as jax_solve_kkt
from quantumcollocation_tpu.solver.kkt_lanes import solve_kkt_lanes as jax_solve_kkt_lanes
from quantumcollocation_tpu_torch.solver import kkt_lanes as kl
from quantumcollocation_tpu_torch.solver.kkt import solve_kkt

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

RTOL = 1e-9
DC = 1e-8


def _random_kkt(Bt=3, T=6, d=15, s=13, seed=0, pd=True):
    rng = np.random.default_rng(seed)
    H = np.eye(d) * 3 + 0.3 * rng.normal(size=(Bt, T, d, d))
    H = 0.5 * (H + np.swapaxes(H, -1, -2))
    if not pd:
        H[0, 2] -= 10 * np.eye(d)  # instance 0: an indefinite stage block
    return (
        H,
        0.2 * rng.normal(size=(Bt, T - 1, d, d)),
        rng.normal(size=(Bt, T - 1, s, d)),
        rng.normal(size=(Bt, T - 1, s, d)),
        rng.normal(size=(Bt, T, d)),
        rng.normal(size=(Bt, T - 1, s)),
    )


def _jax_lanes(args):
    # the vectorized lanes family (vec_min_dim=1): the same elimination as
    # the unrolled one (tests/test_kkt_lanes.py pins them together), traced
    # in a third of the time at d=15
    return jax_solve_kkt_lanes(
        *[jnp.asarray(x) for x in args], DC, interpret=True, vec_min_dim=1
    )


def _jax_xla(args):
    return jax.vmap(lambda h, c, a, b, r1, r2: jax_solve_kkt(h, c, a, b, r1, r2, DC))(
        *[jnp.asarray(x) for x in args]
    )


def test_sweeps_match_jax_lanes_and_xla():
    args = _random_kkt()
    dz, nu, ok = kl.solve_kkt_lanes(*[torch.as_tensor(x) for x in args], DC)
    assert bool(ok.all())
    for ref in (_jax_lanes(args), _jax_xla(args)):
        scale = np.abs(np.asarray(ref[0])).max()
        np.testing.assert_allclose(dz.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=RTOL * scale)
        scale = np.abs(np.asarray(ref[1])).max()
        np.testing.assert_allclose(nu.numpy(), np.asarray(ref[1]), rtol=RTOL, atol=RTOL * scale)


def test_sweep_halves_compose_to_the_solve():
    args = [torch.as_tensor(x) for x in _random_kkt(seed=1)]
    L_P, L_S, X_A, q, dz_last, ok = kl.fwd_sweep_reference(*args, DC)
    dz, nu = kl.bwd_sweep_reference(L_P, L_S, X_A, q, args[1], args[2], args[3], args[5], dz_last)
    dz2, nu2, ok2 = solve_kkt(*args, DC)
    assert bool(ok.all()) and bool(ok2.all())
    torch.testing.assert_close(dz, dz2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(nu, nu2, rtol=1e-12, atol=1e-12)


def test_non_pd_block_fails_in_both_packages():
    args = _random_kkt(seed=2, pd=False)
    _, _, ok = kl.solve_kkt_lanes(*[torch.as_tensor(x) for x in args], DC)
    _, _, ok_j = _jax_lanes(args)
    _, _, ok_x = _jax_xla(args)
    assert ok.tolist() == [False, True, True]
    assert np.asarray(ok_j).tolist() == ok.tolist()
    assert np.asarray(ok_x).tolist() == ok.tolist()


def test_cuda_wrappers_refuse_cpu_tensors():
    args = [torch.as_tensor(x, dtype=torch.float32) for x in _random_kkt()]
    with pytest.raises(ValueError):
        kl.fwd_sweep_cuda(*args, DC)

