"""Port parity: Padé / exponential banks and rollouts against the JAX
package, float64 on the CPU (atol 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu.dynamics import expm as jexpm
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.dynamics import expm as texpm

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10


def _bank_inputs(seed, n=4, K=3, batch=5):
    rng = np.random.default_rng(seed)
    X = 0.3 * rng.standard_normal((batch, n, n))
    dX = 0.3 * rng.standard_normal((batch, K, n, n))
    d2X = 0.3 * rng.standard_normal((batch, K * (K + 1) // 2, n, n))
    return X, dX, d2X


@pytest.mark.parametrize("order", [4, 6, 8])
@pytest.mark.parametrize("with_d2X", [True, False])
def test_pade_poly_frechet_matches_jax(order, with_d2X):
    X, dX, d2X = _bank_inputs(order)
    t = texpm.pade_poly_frechet(
        torch.as_tensor(X), torch.as_tensor(dX),
        torch.as_tensor(d2X) if with_d2X else None, order=order,
    )
    for b in range(X.shape[0]):
        j = jexpm.pade_poly_frechet(
            jnp.asarray(X[b]), jnp.asarray(dX[b]),
            jnp.asarray(d2X[b]) if with_d2X else None, order=order,
        )
        for a, r in zip(t, j):
            np.testing.assert_allclose(a[b].numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("num_squarings", [0, 3])
def test_expm_frechet_bank_matches_jax(num_squarings):
    X, dX, d2X = _bank_inputs(11)
    t = texpm.expm_frechet_bank(
        torch.as_tensor(X), torch.as_tensor(dX), torch.as_tensor(d2X),
        order=8, num_squarings=num_squarings,
    )
    for b in range(X.shape[0]):
        j = jexpm.expm_frechet_bank(
            jnp.asarray(X[b]), jnp.asarray(dX[b]), jnp.asarray(d2X[b]),
            order=8, num_squarings=num_squarings,
        )
        for a, r in zip(t, j):
            np.testing.assert_allclose(a[b].numpy(), np.asarray(r), atol=ATOL)
    P = texpm.expm_squaring(torch.as_tensor(X), order=8, num_squarings=num_squarings)
    np.testing.assert_allclose(
        P.numpy(), np.stack([np.asarray(jexpm.expm_squaring(jnp.asarray(x), order=8,
                                                             num_squarings=num_squarings))
                             for x in X]), atol=ATOL,
    )


def test_unitary_rollout_fidelity_matches_jax():
    sj = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    st = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    pj = qct.UnitarySmoothPulseProblem(
        sj, qct.GATES["H"], 21, 0.2,
        piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(4),
    )
    traj = interop.trajectory_from_arrays(interop.problem_arrays(pj))
    f_j = float(qct.unitary_rollout_fidelity(pj.trajectory, sj))
    f_t = qt.unitary_rollout_fidelity(traj, st)
    np.testing.assert_allclose(f_t, f_j, atol=ATOL)
    # the full rollout, knot by knot
    a, dts = np.asarray(pj.trajectory["a"]), np.asarray(pj.trajectory.get_timesteps())
    v0 = np.asarray(pj.trajectory.initial["Ũ⃗"])
    Uj = np.asarray(jax.jit(lambda v, x, t: qct.unitary_rollout(v, x, t, sj))(v0, a, dts))
    Ut = qt.unitary_rollout(v0, a, dts, st).numpy()
    np.testing.assert_allclose(Ut, Uj, atol=ATOL)
