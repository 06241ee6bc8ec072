"""Port parity: kept factors and the rhs-only re-solve (kernel 4's plain
version).

At d=6, s=4, T=4 the port's `solve_kkt_lanes(want_factors=True)` and
`resolve_kkt_lanes` (rhs_fwd_sweep_reference + bwd_sweep_reference)
against the JAX Pallas sweeps in interpret mode; at the two-qubit stage
size d=47, s=42 against the JAX XLA factor_kkt / solve_with_factors (the
Pallas kernels in interpret mode take minutes there).  float64 on the CPU,
rtol 1e-9 as in tests/test_torch_kkt.py.  The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

from quantumcollocation_tpu.solver.kkt import factor_kkt as jax_factor_kkt
from quantumcollocation_tpu.solver.kkt import solve_with_factors as jax_solve_with_factors
from quantumcollocation_tpu.solver.kkt_lanes import resolve_kkt_lanes as jax_resolve
from quantumcollocation_tpu.solver.kkt_lanes import solve_kkt_lanes as jax_solve
from quantumcollocation_tpu_torch.solver import kkt_lanes as kl

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

RTOL = 1e-9
DC = 1e-8


def _random_kkt(Bt, T, d, s, seed):
    """A definite KKT system shaped like the solver's (defect-like A, B)
    and a second right-hand side."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.sqrt(d)  # noise that keeps H and the Riccati blocks definite at any d
    H = np.eye(d) * 3 + w * rng.normal(size=(Bt, T, d, d))
    E = np.eye(s, d)
    mats = (0.5 * (H + np.swapaxes(H, -1, -2)), 0.7 * w * rng.normal(size=(Bt, T - 1, d, d)),
            -E + 0.3 * rng.normal(size=(Bt, T - 1, s, d)),
            E + 0.3 * rng.normal(size=(Bt, T - 1, s, d)))
    rhs = tuple(rng.normal(size=shape) for shape in
                ((Bt, T, d), (Bt, T - 1, s), (Bt, T, d), (Bt, T - 1, s)))
    return mats, rhs


def _close(out, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                               err_msg=what)


def _lanes(x, Bt):  # JAX lanes layout (..., Bp) -> batch-first
    return np.moveaxis(np.asarray(x), -1, 0)[:Bt]


def test_kept_factors_and_resolve_match_jax_lanes():
    Bt = 3
    (H, C, A, B), (rz, rnu, rz2, rnu2) = _random_kkt(Bt, 4, 6, 4, seed=0)
    t = [torch.as_tensor(x) for x in (H, C, A, B, rz, rnu)]
    dz, nu, ok, fac = kl.solve_kkt_lanes(*t, DC, want_factors=True)
    jargs = [jnp.asarray(x) for x in (H, C, A, B, rz, rnu)]
    jdz, jnu, jok, jfac = jax_solve(*jargs, DC, interpret=True, want_factors=True, vec_min_dim=1)
    assert bool(ok.all()) and bool(np.asarray(jok).all())
    _close(dz, jdz, "dz")
    _close(nu, jnu, "nu")
    for name, mine, theirs in (("L_P", fac.L_P, jfac.LP), ("L_S", fac.L_S, jfac.LS),
                               ("X_A", fac.X_A, jfac.XA), ("G", fac.G, jfac.G),
                               ("L_Pf", fac.L_Pf, jfac.LPf)):
        _close(mine, _lanes(theirs, Bt), name)
    ez, enu, okr = kl.resolve_kkt_lanes(fac, torch.as_tensor(rz2), torch.as_tensor(rnu2))
    jez, jenu, jokr = jax_resolve(jfac, jnp.asarray(rz2), jnp.asarray(rnu2), interpret=True,
                                  vec_min_dim=1)
    assert bool(okr.all()) and bool(np.asarray(jokr).all())
    _close(ez, jez, "re-solve dz")
    _close(enu, jenu, "re-solve nu")
    # the plain halves of the re-solve compose to it
    q, dz_last = kl.rhs_fwd_sweep_reference(fac.L_P, fac.L_S, fac.G, fac.C, fac.A,
                                            torch.as_tensor(rz2), torch.as_tensor(rnu2), fac.L_Pf)
    dz3, nu3 = kl.bwd_sweep_reference(fac.L_P, fac.L_S, fac.X_A, q, fac.C, fac.A, fac.B,
                                      torch.as_tensor(rnu2), dz_last)
    torch.testing.assert_close(dz3, ez, rtol=0, atol=0)
    torch.testing.assert_close(nu3, enu, rtol=0, atol=0)


def test_resolve_at_two_qubit_stage_size_matches_jax_xla():
    Bt = 2
    (H, C, A, B), (rz, rnu, rz2, rnu2) = _random_kkt(Bt, 4, 47, 42, seed=1)
    t = [torch.as_tensor(x) for x in (H, C, A, B, rz, rnu)]
    _, _, ok, fac = kl.solve_kkt_lanes(*t, DC, want_factors=True)
    assert bool(ok.all())
    jfac = jax.jit(jax.vmap(lambda h, c, a, b: jax_factor_kkt(h, c, a, b, DC)))(
        *[jnp.asarray(x) for x in (H, C, A, B)]
    )
    _close(fac.G, jfac.G, "G")
    _close(fac.L_Pf, jfac.L_final, "L_Pf")
    ez, enu, _ = kl.resolve_kkt_lanes(fac, torch.as_tensor(rz2), torch.as_tensor(rnu2))
    jez, jenu, _ = jax.jit(jax.vmap(jax_solve_with_factors))(jfac, jnp.asarray(rz2),
                                                              jnp.asarray(rnu2))
    _close(ez, jez, "re-solve dz")
    _close(enu, jenu, "re-solve nu")


def test_rhs_sweep_wrapper_refuses_cpu_tensors():
    (H, C, A, B), (rz, rnu, _, _) = _random_kkt(2, 3, 6, 4, seed=2)
    t = [torch.as_tensor(x) for x in (H, C, A, B, rz, rnu)]
    _, _, _, fac = kl.solve_kkt_lanes(*t, DC, want_factors=True)
    f32 = [x.float() for x in (fac.L_P, fac.L_S, fac.G, fac.C, fac.A)]
    with pytest.raises(ValueError):
        kl.rhs_fwd_sweep_cuda(*f32, t[4].float(), t[5].float(), fac.L_Pf.float())
