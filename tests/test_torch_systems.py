"""Port parity: the composite systems, the system templates and the
operators they need, against the JAX package (host numpy in both, so no
JAX compile): operator_from_string, haar_random and haar_identity (the
same matrix for the same seed or numpy Generator), coherent_ket,
QuantumSystemCoupling and CompositeQuantumSystem, TransmonDipoleCoupling
in the lab and rotating frames, MultiTransmonSystem with subsets of its
transmons and drives, RydbergChainSystem (N = 2, 3, all-to-all or
cutoff order 1, 2) and CatSystem with get_cat_controls; every matrix
within 1e-12, and the package roots export the same names."""

import numpy as np
import pytest
import torch

import quantumcollocation_tpu as qct
import quantumcollocation_tpu.quantum as qct_quantum
import quantumcollocation_tpu.systems as qct_systems
import quantumcollocation_tpu_torch as qt
import quantumcollocation_tpu_torch.quantum as qt_quantum
import quantumcollocation_tpu_torch.systems as qt_systems

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

ATOL = 1e-12


def _same(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=ATOL, err_msg=what)


def _same_system(mine, theirs):
    """Hamiltonians, iso generators, params and (open systems) dissipators."""
    for name in ("H_drift", "H_drives", "G_drift", "G_drives"):
        _same(getattr(mine, name), getattr(theirs, name), name)
    assert (mine.levels, mine.n_drives) == (theirs.levels, theirs.n_drives)
    assert mine.params == theirs.params
    if hasattr(theirs, "L_dissipators"):
        _same(mine.L_dissipators, theirs.L_dissipators, "L_dissipators")


def test_exports_match_jax():
    assert sorted(qt_quantum.__all__) == sorted(qct_quantum.__all__)
    assert sorted(qt_systems.__all__) == sorted(qct_systems.__all__)
    new = ("QuantumSystemCoupling", "CompositeQuantumSystem", "TransmonDipoleCoupling",
           "MultiTransmonSystem", "RydbergChainSystem", "CatSystem", "get_cat_controls",
           "operator_from_string", "haar_random", "haar_identity", "coherent_ket")
    for name in new:
        assert name in qt.__all__ and name in qct.__all__ and hasattr(qt, name), name


@pytest.mark.parametrize("spec", ["XIZ", "nYI", "ZZ", "n"])
def test_operator_from_string_matches_jax(spec):
    _same(qt.operator_from_string(spec), qct.operator_from_string(spec))
    lookup = {"a": qt.annihilate(3), "I": np.eye(3)}
    _same(qt.operator_from_string("aIa", lookup), qct.operator_from_string("aIa", lookup))


@pytest.mark.parametrize("n", [2, 5])
def test_haar_draws_match_jax(n):
    for seed in (0, 7):
        U = qt.haar_random(n, seed)
        _same(U, qct.haar_random(n, seed))
        _same(U @ U.conj().T, np.eye(n))
        V = qt.haar_identity(n, 0.3, seed)
        _same(V, qct.haar_identity(n, 0.3, seed))
        assert np.abs(V - np.eye(n)).max() < 0.3
    # a Generator is drawn from in place, by both in the same order
    g1, g2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        _same(qt.haar_random(n, g1), qct.haar_random(n, g2))
        _same(qt.haar_identity(n, 0.1, g1), qct.haar_identity(n, 0.1, g2))


@pytest.mark.parametrize("alpha, levels", [(0.5, 6), (1.2 - 0.7j, 13), (2.0, 39)])
def test_coherent_ket_matches_jax(alpha, levels):
    psi = qt.coherent_ket(alpha, levels)
    _same(psi, qct.coherent_ket(alpha, levels))
    assert psi.dtype == np.complex128 and abs(np.vdot(psi, psi) - 1) < 1e-3 * (levels < 30) + 1e-6


def test_composite_system_matches_jax():
    def build(pkg):
        qubit = pkg.QuantumSystem(pkg.GATES["Z"], [pkg.GATES["X"], pkg.GATES["Y"]])
        qutrit = pkg.QuantumSystem(np.diag([0.0, 1.0, 2.5]), [pkg.quad_op(3)])
        op = 0.05 * np.kron(pkg.GATES["X"], pkg.quad_op(3))
        c = pkg.QuantumSystemCoupling(op, g=0.05, pair=(0, 1), subsystem_levels=(2, 3))
        return pkg.CompositeQuantumSystem([qubit, qutrit], [c], params={"tag": 1})

    mine, theirs = build(qt), build(qct)
    _same_system(mine, theirs)
    assert mine.params["subsystem_levels"] == (2, 3) == mine.subsystem_levels
    assert len(mine.subsystems) == 2 and mine.couplings[0].g == 0.05
    assert mine.couplings[0].pair == theirs.couplings[0].pair
    assert isinstance(mine, qt.QuantumSystem)


@pytest.mark.parametrize("lab_frame", [False, True])
@pytest.mark.parametrize("multiply_by_2pi", [True, False])
def test_dipole_coupling_matches_jax(lab_frame, multiply_by_2pi):
    kw = dict(lab_frame=lab_frame, multiply_by_2pi=multiply_by_2pi)
    for levels, pair in (([3, 3], (0, 1)), ([2, 3, 4], (0, 2)), ([3, 2, 2], (1, 2))):
        mine = qt.TransmonDipoleCoupling(0.02, pair, levels, **kw)
        theirs = qct.TransmonDipoleCoupling(0.02, pair, levels, **kw)
        _same(mine.op, theirs.op)
        for field in ("g", "pair", "subsystem_levels", "coupling_type", "params"):
            assert getattr(mine, field) == getattr(theirs, field), field
    # the levels may come as systems
    subs = [qt.TransmonSystem(levels=n) for n in (3, 4)]
    _same(qt.TransmonDipoleCoupling(0.01, (0, 1), subs, **kw).op,
          qct.TransmonDipoleCoupling(0.01, (0, 1), [3, 4], **kw).op)


@pytest.mark.parametrize("lab_frame", [False, True])
@pytest.mark.parametrize("subsystems, drives", [
    (None, None), (None, [1]), ([0, 2], None), ([0, 2], [2]), ([1], [0, 1]),
])
def test_multi_transmon_system_matches_jax(lab_frame, subsystems, drives):
    gs = np.array([[0.0, 0.01, 0.02], [0.01, 0.0, 0.03], [0.02, 0.03, 0.0]])
    kw = dict(omegas=[4.0, 4.5, 5.1], deltas=[0.2, 0.21, 0.19], gs=gs,
              subsystem_levels=[3, 2, 3], lab_frame=lab_frame, subsystems=subsystems,
              subsystem_drive_indices=drives)
    mine, theirs = qt.MultiTransmonSystem(**kw), qct.MultiTransmonSystem(**kw)
    _same_system(mine, theirs)
    assert mine.subsystem_levels == theirs.subsystem_levels
    assert [s.n_drives for s in mine.subsystems] == [s.n_drives for s in theirs.subsystems]
    assert [c.pair for c in mine.couplings] == [c.pair for c in theirs.couplings]


def test_two_transmon_cz_system_matches_jax():
    # BASELINE #5's system and goal (JAX tests/test_baseline_configs.py:59-65)
    kw = dict(omegas=[4.0, 4.5], deltas=[0.2, 0.2], gs=[[0, 0.01], [0.01, 0]],
              levels_per_transmon=3)
    mine, theirs = qt.MultiTransmonSystem(**kw), qct.MultiTransmonSystem(**kw)
    _same_system(mine, theirs)
    assert (mine.levels, mine.n_drives, mine.iso_dim) == (9, 4, 18)
    gm, gj = qt.EmbeddedOperator(qt.GATES["CZ"], mine), qct.EmbeddedOperator(qct.GATES["CZ"],
                                                                             theirs)
    assert gm.subspace == tuple(gj.subspace) == (0, 1, 3, 4)
    _same(gm.operator, gj.operator)


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("all2all, cutoff_order", [(True, 1), (False, 1), (False, 2)])
@pytest.mark.parametrize("local_detune, ignore_Y_drive", [(False, False), (True, True)])
def test_rydberg_chain_matches_jax(N, all2all, cutoff_order, local_detune, ignore_Y_drive):
    kw = dict(N=N, all2all=all2all, cutoff_order=cutoff_order, local_detune=local_detune,
              ignore_Y_drive=ignore_Y_drive)
    mine, theirs = qt.RydbergChainSystem(**kw), qct.RydbergChainSystem(**kw)
    # the van der Waals drift is ~1e4 here: 1e-12 relative to it
    scale = max(1.0, np.abs(theirs.H_drift).max())
    np.testing.assert_allclose(mine.H_drift, theirs.H_drift, rtol=0, atol=ATOL * scale)
    np.testing.assert_allclose(mine.G_drift, theirs.G_drift, rtol=0, atol=ATOL * scale)
    _same(mine.H_drives, theirs.H_drives)
    assert mine.params == theirs.params and mine.n_drives == theirs.n_drives
    with pytest.raises(ValueError):
        qt.RydbergChainSystem(N=N, all2all=False, cutoff_order=3)


@pytest.mark.parametrize("kw", [{}, {"cat_levels": 5, "buffer_levels": 2, "prefactor": 0.5}])
def test_cat_system_matches_jax(kw):
    mine, theirs = qt.CatSystem(**kw), qct.CatSystem(**kw)
    for name in ("H_drift", "H_drives", "L_dissipators"):
        scale = max(1.0, np.abs(getattr(theirs, name)).max())
        np.testing.assert_allclose(getattr(mine, name), getattr(theirs, name), rtol=0,
                                   atol=ATOL * scale, err_msg=name)
    assert mine.params == theirs.params and isinstance(mine, qt.OpenQuantumSystem)
    levels = kw.get("cat_levels", 13) * kw.get("buffer_levels", 3)
    assert mine.levels == levels and 2 * levels**2 == (3042 if not kw else 200)
    _same(qt.get_cat_controls(mine, 1.5, 7), qct.get_cat_controls(theirs, 1.5, 7))
    with pytest.raises(ValueError):
        qt.get_cat_controls(qt.QuantumSystem(qt.GATES["Z"], [qt.GATES["X"]]), 1.0, 3)
