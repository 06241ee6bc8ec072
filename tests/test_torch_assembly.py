"""Port parity: the fused dynamics assembly.

The port's plain version (dyn_assembly_reference = batched dyn_eval +
defect_curvature) against the JAX Pallas kernel run in interpret mode, in
scaled units, float64 on the CPU (atol 1e-10).  The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop
from quantumcollocation_tpu_torch.ops import dyn_assembly as da

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-10
CASES = {
    "pade_free_time": dict(integrator="pade", pade_order=4),
    "exp_free_time": dict(integrator="exponential"),
    "exp_fixed_time": dict(integrator="exponential", free_time=False),
}


@functools.lru_cache(maxsize=None)  # one build per case for the whole file
def _pair(case, T=9):
    sj = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    pj = qct.UnitarySmoothPulseProblem(
        sj, qct.GATES["H"], T, 0.2,
        ipopt_options=qct.SolverOptions(print_level=1),
        piccolo_options=qct.PiccoloOptions(verbose=False, **CASES[case]),
        rng=np.random.default_rng(0),
    )
    pt, _ = interop.unitary_smooth_pulse_from_arrays(
        interop.problem_arrays(pj), Q=100.0, R=1e-2,
        piccolo_options=qt.PiccoloOptions(verbose=False, **CASES[case]), device="cpu",
    )
    return pj, pt


def _inputs(nlp, B=3, seed=3):
    rng = np.random.default_rng(seed)
    Z = np.asarray(nlp.z0)[None] + 0.05 * rng.standard_normal((B, *np.asarray(nlp.z0).shape))
    lam = rng.standard_normal((B, nlp.T - 1, nlp.s))
    return Z, lam


@pytest.mark.parametrize("case", list(CASES))
def test_assembly_reference_matches_jax_kernel(case):
    pj, pt = _pair(case)
    Z, lam = _inputs(pj.solver.nlp)
    ref = pj.solver.nlp.analytic.assembly_batched(
        jnp.asarray(Z), jnp.asarray(lam), use_kernel=True, interpret=True
    )
    out = da.dyn_assembly(pt.solver.nlp.analytic, torch.as_tensor(Z), torch.as_tensor(lam))
    for name, o, r in zip(("F", "A", "B", "Hc", "Cc"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, err_msg=name)


def test_analytic_defects_match_integrator_definitions():
    # the analytic rows agree with the integrators' direct defect formulas
    _, pt = _pair("pade_free_time")
    an = pt.solver.nlp.analytic
    Z, _ = _inputs(pt.solver.nlp)
    Zt = torch.as_tensor(Z)
    Zp = Zt * torch.as_tensor(an.var_scale)
    traj = pt.trajectory
    direct = torch.cat(
        [ig.defect(Zp[:, :-1], Zp[:, 1:], traj) for ig in pt.integrators], dim=-1
    ) * torch.as_tensor(an.defect_scale)
    np.testing.assert_allclose(an.defects(Zt).numpy(), direct.numpy(), atol=1e-12)


def test_spec_table_and_exp_branch():
    _, pt = _pair("pade_free_time")
    ispec, fspec, nk, kind = da.pack_spec(pt.solver.nlp.analytic)
    assert nk == (4, 3) and nk in da.SUPPORTED_NK and kind == "pade"
    assert ispec[:3].tolist() == [1, 2, 1]  # one group, two derivative rows, one Δt row
    assert ispec[7] == 0  # no squarings
    assert fspec.shape[0] == 15 + 13 + 2 + 3 + 16 + 32 + 2
    # the exponential branch: its squaring count, the five order-8
    # coefficients and the generators scaled by 2^-s
    _, pe = _pair("exp_free_time")
    an = pe.solver.nlp.analytic
    (g,) = an.groups
    ispec, fspec, nk, kind = da.pack_spec(an)
    assert nk == (4, 3) and kind == "exp" and g.num_squarings >= 1
    assert ispec[3:9].tolist()[-2] == g.num_squarings
    assert fspec.shape[0] == 15 + 13 + 2 + 5 + 16 + 32 + 2
    g0 = 15 + 13
    assert fspec[g0 + 1] == 5
    np.testing.assert_allclose(fspec[g0 + 2:g0 + 7], qt.pade_coefficients(8))
    np.testing.assert_allclose(fspec[g0 + 7:g0 + 23], 2.0 ** -g.num_squarings * g.G_drift.ravel())


def test_cuda_wrapper_refuses_cpu_tensors():
    _, pt = _pair("pade_free_time")
    Z, lam = _inputs(pt.solver.nlp)
    with pytest.raises(ValueError):
        da.dyn_assembly_cuda(pt.solver.nlp.analytic, torch.as_tensor(Z), torch.as_tensor(lam))

