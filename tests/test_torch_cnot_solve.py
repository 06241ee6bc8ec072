"""Port parity: 12 IPM iterations of the two-qubit CNOT smooth-pulse solve.

tests/test_torch_cnot.py's problem (BASELINE #3's system and weights, T
cut to 6 knots, d=47), carried across by interop from two multistart
seeds, with one refinement pass per KKT attempt (the JAX side on its XLA
backend, which runs the same refinement arithmetic; its Pallas kernels in
interpret mode take minutes at d=47).  float64 on the CPU; Z within 1e-6
and the KKT error within rtol 1e-4 after 12 iterations, as
tests/test_torch_solve.py.  One item, so that `--dist loadfile` sends the
file out beside the long JAX files."""

import numpy as np
import torch
from test_torch_cnot import _options, _problem

import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)


def test_twelve_iterations_match_jax():
    pj = _problem("jax", kkt_backend="xla", kkt_refine=1)
    Z0 = np.asarray(pj.multistart_initial_decisions(2, sigma=0.3, rng=np.random.default_rng(1)))
    arrays = interop.problem_arrays(pj)
    arrays["Z0"] = Z0
    pt, Z0_t = interop.unitary_smooth_pulse_from_arrays(
        arrays, Q=1e4, R=1e-3, ipopt_options=_options(qt, kkt_refine=1),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    assert (pt.solver.fused_assembly_on, pt.solver.kkt_refine_n) == (False, 1)
    st_j = pj.solver._solve_loop(pj.solver._init_state_jit(Z0), 12)
    st_t = pt.solver.init_state(Z0_t)
    for _ in range(12):
        st_t = pt.solver.step(st_t)
    np.testing.assert_allclose(st_t.Z.numpy(), np.asarray(st_j.Z), atol=1e-6)
    np.testing.assert_allclose(
        st_t.kkt_err.numpy(), np.asarray(st_j.kkt_err), rtol=1e-4, atol=1e-8
    )
    np.testing.assert_array_equal(st_t.n_iter.numpy(), np.asarray(st_j.n_iter))
