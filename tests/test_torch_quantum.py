"""Port parity: quantum layer (iso layouts, generators, unitary fidelity)
against the JAX package, in float64 on the CPU."""

import numpy as np
import pytest
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)


def test_iso_vec_layout_matches_reference_fixture():
    # the fixture of tests/test_quantum.py: per-column [Re; Im] stacking
    np.testing.assert_allclose(
        qt.operator_to_iso_vec(np.eye(2, dtype=complex)), [1, 0, 0, 0, 0, 1, 0, 0]
    )
    np.testing.assert_allclose(qt.operator_to_iso_vec(qt.GATES["X"]), [0, 1, 0, 0, 1, 0, 0, 0])


@pytest.mark.parametrize("gate", ["H", "X", "Y", "Z", "S", "T", "CX"])
def test_iso_maps_match_jax(gate):
    U = qt.GATES[gate]
    v = qt.operator_to_iso_vec(U)
    np.testing.assert_array_equal(v, np.asarray(qct.operator_to_iso_vec(qct.GATES[gate])))
    np.testing.assert_allclose(qt.iso_vec_to_operator(v), U, atol=1e-15)
    vt = torch.as_tensor(v)
    np.testing.assert_allclose(qt.iso_vec_to_operator(vt).numpy(), U, atol=1e-15)
    np.testing.assert_array_equal(qt.iso_G(U), np.asarray(qct.iso_G(qct.GATES[gate])))


def test_quantum_system_generators_match_jax():
    H = [qct.GATES["X"], qct.GATES["Y"]]
    sj = qct.QuantumSystem(qct.GATES["Z"], H)
    st = qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"], qt.GATES["Y"]])
    np.testing.assert_array_equal(st.G_drift, np.asarray(sj.G_drift))
    np.testing.assert_array_equal(st.G_drives, np.asarray(sj.G_drives))
    a = np.random.default_rng(0).standard_normal((5, 2))
    np.testing.assert_allclose(
        st.generator(torch.as_tensor(a)).numpy(),
        np.stack([np.asarray(sj.generator(x)) for x in a]),
        atol=1e-14,
    )


def test_unitary_fidelity_matches_jax():
    rng = np.random.default_rng(1)
    goal = qct.operator_to_iso_vec(qct.GATES["H"])
    V = rng.standard_normal((16, 8))
    V[0] = np.asarray(goal)  # F = 1
    V[1] = qct.operator_to_iso_vec(np.eye(2, dtype=complex))  # tr(H^† I) = 0
    ref = np.array([float(qct.iso_vec_unitary_fidelity(v, goal)) for v in V])
    out = qt.iso_vec_unitary_fidelity(torch.as_tensor(V), torch.as_tensor(np.asarray(goal)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-12)
    U = qct.haar_random(2, seed=3)
    np.testing.assert_allclose(
        qt.unitary_fidelity(U, qt.GATES["H"]), qct.unitary_fidelity(U, qct.GATES["H"]), atol=1e-12
    )
