"""Port parity: the propagator-derivative bank (kernel 5's plain version).

`prop_bank_reference` against the JAX Pallas bank `prop_bank_lanes` in
interpret mode at small shapes (Padé: n=8 with two drives and fixed Δt, n=4
with two drives and free Δt, whose second order holds the pairs (a_1, a_2)
and (a_k, Δt); exponential: n=4, one drive, free Δt, two squarings, first
order, one drive because interpret mode's time grows with the drive
count), and
against the vmapped pure-JAX `pade_poly_frechet` and `expm_frechet_bank` at
the two-qubit shape (n=8, five drives, fixed Δt) and the two-transmon CZ
shape (n=18, four drives, free Δt) and, for the exponential
kind, at n=4 with a free Δt, second order, float64 on the CPU, rtol
1e-10.  The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

from quantumcollocation_tpu.dynamics.expm import expm_frechet_bank as jax_expm_frechet_bank
from quantumcollocation_tpu.dynamics.expm import pade_poly_frechet as jax_pade_poly_frechet
from quantumcollocation_tpu.ops.pallas_prop_bank import prop_bank_lanes
from quantumcollocation_tpu_torch.dynamics.expm import frechet_pairs
from quantumcollocation_tpu_torch.ops import prop_bank as pb

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

RTOL = 1e-10


def _inputs(n, na, M, seed):
    rng = np.random.default_rng(seed)
    Gd = rng.normal(size=(n, n))
    Gs = rng.normal(size=(na, n, n))
    a = rng.uniform(-1, 1, size=(M, na))
    dt = rng.uniform(0.1, 0.4, size=(M,))
    return a, dt, Gd, Gs


def _close(out, ref, what):
    for k, (o, r) in enumerate(zip(out, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=RTOL * np.abs(r).max(),
                                   err_msg=f"{what} output {k}")


@pytest.mark.parametrize("kind, n, free_dt", [
    pytest.param("pade", 8, False, id="8-False"), pytest.param("pade", 4, True, id="4-True"),
    pytest.param("exp", 4, True, id="exp-4-True"),
])
def test_bank_matches_jax_pallas_kernel(kind, n, free_dt):
    na = 1 if kind == "exp" else 2
    a, dt, Gd, Gs = _inputs(n, na, 37, seed=n)
    # the exponential case is first order, as the ket path runs it (in
    # interpret mode its second order takes ~10 s; the n=8 test below and
    # the assembly tests cover that)
    pade = kind == "pade"
    kw = dict(kind=kind, order=4 if pade else 8, num_squarings=0 if pade else 2,
              free_dt=free_dt, second_order=pade)
    ref = prop_bank_lanes(*[jnp.asarray(x) for x in (a, dt, Gd, Gs)], interpret=True, **kw)
    out = pb.prop_bank(*[torch.as_tensor(x) for x in (a, dt)], torch.as_tensor(Gd),
                       torch.as_tensor(Gs), **kw)
    K = na + int(free_dt)
    assert len(out) == (6 if pade else 3) and out[1].shape == (37, K, n, n)
    if pade:
        assert out[2].shape == (37, len(frechet_pairs(K)), n, n)
    else:
        assert out[2] is None and ref[2] is None
    _close([x for x in out if x is not None], [x for x in ref if x is not None], "pallas")


@pytest.mark.parametrize("n, na, free_dt, M", [
    pytest.param(8, 5, False, 24, id="cnot"),
    # two coupled three-level transmons (the embedded CZ): four drives, a
    # free Δt with its (a_k, Δt) cross terms d2X = G_k
    pytest.param(18, 4, True, 8, id="cz"),
])
def test_bank_matches_pure_jax_at_two_qubit_width(n, na, free_dt, M):
    a, dt, Gd, Gs = _inputs(n, na, M, seed=1)
    G = Gd + np.tensordot(a, Gs, axes=1)
    X = G * dt[:, None, None]
    dX = Gs[None] * dt[:, None, None, None]
    d2X = None
    if free_dt:
        dX = np.concatenate([dX, G[:, None]], axis=1)
        d2X = jnp.asarray(np.stack([Gs[k] if l == na and k < na else np.zeros((n, n))
                                    for k, l in frechet_pairs(na + 1)]))
    ref = jax.jit(jax.vmap(lambda x, dx: jax_pade_poly_frechet(x, dx, d2X, order=4)))(
        jnp.asarray(X), jnp.asarray(dX)
    )
    out = pb.prop_bank_reference(*[torch.as_tensor(x) for x in (a, dt, Gd, Gs)],
                                 kind="pade", order=4, free_dt=free_dt, second_order=True)
    K = na + int(free_dt)
    assert out[2].shape == (M, K * (K + 1) // 2, n, n)
    _close(out, ref, "pure jax")


def test_exp_bank_matches_pure_jax_at_two_qubit_width():
    a, dt, Gd, Gs = _inputs(8, 5, 24, seed=2)
    X = (Gd + np.tensordot(a, Gs, axes=1)) * dt[:, None, None]
    dX = Gs[None] * dt[:, None, None, None]
    ref = jax.jit(jax.vmap(
        lambda x, dx: jax_expm_frechet_bank(x, dx, None, order=8, num_squarings=2)))(
        jnp.asarray(X), jnp.asarray(dX)
    )
    out = pb.prop_bank_reference(*[torch.as_tensor(x) for x in (a, dt, Gd, Gs)],
                                 kind="exp", order=8, num_squarings=2, free_dt=False,
                                 second_order=True)
    assert len(out) == 3 and out[2].shape == (24, 15, 8, 8)
    _close(out, ref, "pure jax")


def test_exp_bank_second_order_free_dt_matches_pure_jax():
    # the second-order exponential bank with a free Δt, as kernel 1's
    # exponential branch computes it, with the (a_k, Δt) cross term
    # d2X = G_k
    a, dt, Gd, Gs = _inputs(4, 2, 16, seed=3)
    G = Gd + np.tensordot(a, Gs, axes=1)
    X = G * dt[:, None, None]
    dX = np.concatenate([Gs[None] * dt[:, None, None, None], G[:, None]], axis=1)
    d2X = np.stack([Gs[k] if l == 2 and k < 2 else np.zeros((4, 4))
                    for k, l in frechet_pairs(3)])
    ref = jax.jit(jax.vmap(lambda x, dx: jax_expm_frechet_bank(x, dx, jnp.asarray(d2X), order=8,
                                                               num_squarings=1)))(
        jnp.asarray(X), jnp.asarray(dX)
    )
    out = pb.prop_bank_reference(*[torch.as_tensor(x) for x in (a, dt, Gd, Gs)],
                                 kind="exp", order=8, num_squarings=1, free_dt=True,
                                 second_order=True)
    assert out[2].shape == (16, 6, 4, 4) and float(np.abs(ref[2][:, 2]).max()) > 0
    _close(out, ref, "pure jax")


def test_cuda_wrapper_refuses_cpu_tensors_and_the_exp_kind():
    # both kinds have a kernel; neither takes CPU tensors
    a, dt, Gd, Gs = [torch.as_tensor(x, dtype=torch.float32) for x in _inputs(4, 2, 5, 0)]
    kw = dict(order=4, free_dt=True, second_order=True)
    with pytest.raises(ValueError):
        pb.prop_bank_cuda(a, dt, Gd, Gs, kind="pade", **kw)
    with pytest.raises(ValueError):
        pb.prop_bank_cuda(a, dt, Gd, Gs, kind="exp", num_squarings=1, **kw)
