"""Transmon system templates (host numpy, build time only).

Counterpart of quantumcollocation_tpu/systems/transmons.py.
TransmonSystem: H = (omega - frame_omega) a'a - delta/2 a'a'aa in the
rotating frame (the default), or one of three lab-frame drifts (duffing,
quartic, cosine), with the drives a + a' and i(a - a'), in units of 2π by
default.  TransmonDipoleCoupling: g (a_i + a_i')(a_j + a_j') in the lab
frame, g (a_i a_j' + a_i' a_j) in the rotating frame.  MultiTransmonSystem:
transmons with a dipole coupling for every pair, as a
CompositeQuantumSystem.  Subsystem indices are 0-based.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..quantum.operators import annihilate, lift
from ..quantum.systems import CompositeQuantumSystem, QuantumSystem, QuantumSystemCoupling

__all__ = ["TransmonSystem", "TransmonDipoleCoupling", "MultiTransmonSystem"]


def TransmonSystem(
    *,
    omega: float = 4.0,  # GHz
    delta: float = 0.2,  # GHz (anharmonicity)
    levels: int = 3,
    lab_frame: bool = False,
    frame_omega: float | None = None,
    multiply_by_2pi: bool = True,
    lab_frame_type: str = "duffing",
    drives: bool = True,
) -> QuantumSystem:
    """A transmon qubit truncated to `levels` levels; a nonzero frame_omega
    selects the rotating frame, as in the JAX package."""
    if lab_frame_type not in ("duffing", "quartic", "cosine"):
        raise ValueError(f"lab_frame_type {lab_frame_type!r}")
    if frame_omega is None:
        frame_omega = 0.0 if lab_frame else omega
    if lab_frame and abs(frame_omega) > 1e-12:
        frame_omega = 0.0
    if abs(frame_omega) > 1e-12:
        lab_frame = False

    a = annihilate(levels)
    ad = a.conj().T
    n_op = ad @ a
    if not lab_frame:
        H_drift = (omega - frame_omega) * n_op - (delta / 2) * (ad @ ad @ a @ a)
    elif lab_frame_type == "duffing":
        H_drift = omega * n_op - (delta / 2) * (ad @ ad @ a @ a)
    elif lab_frame_type == "quartic":
        H_drift = (omega + delta) * n_op - (delta / 12) * np.linalg.matrix_power(a + ad, 4)
    else:  # cosine
        E_C = delta
        E_J = (omega + delta) ** 2 / (8 * E_C)
        n_hat = 1j / 2 * (E_J / (2 * E_C)) ** 0.25 * (a - ad)
        phi_hat = (2 * E_C / E_J) ** 0.25 * (a + ad)
        H_drift = 4 * E_C * (n_hat @ n_hat) - E_J * np.real(sla.cosm(phi_hat)).astype(complex)
    H_drives = [a + ad, 1j * (a - ad)] if drives else []
    if multiply_by_2pi:
        H_drift = H_drift * 2 * np.pi
        H_drives = [H * 2 * np.pi for H in H_drives]
    params = {
        "omega": omega, "delta": delta, "levels": levels, "lab_frame": lab_frame,
        "frame_omega": frame_omega, "multiply_by_2pi": multiply_by_2pi,
        "lab_frame_type": lab_frame_type, "drives": drives,
    }
    return QuantumSystem(H_drift, H_drives, params=params)


def TransmonDipoleCoupling(g_ij: float, pair: tuple, subsystem_levels, *,
                           lab_frame: bool = False,
                           multiply_by_2pi: bool = True) -> QuantumSystemCoupling:
    """The dipole coupling of transmons pair = (i, j); subsystem_levels is
    a list of levels or of QuantumSystems (their .levels)."""
    if subsystem_levels and hasattr(subsystem_levels[0], "levels"):
        subsystem_levels = [sub.levels for sub in subsystem_levels]
    levels = list(subsystem_levels)
    i, j = pair
    a_i = lift(annihilate(levels[i]), i, levels)
    a_j = lift(annihilate(levels[j]), j, levels)
    if lab_frame:
        op = g_ij * (a_i + a_i.conj().T) @ (a_j + a_j.conj().T)
    else:
        op = g_ij * (a_i @ a_j.conj().T + a_i.conj().T @ a_j)
    if multiply_by_2pi:
        op = op * 2 * np.pi
    return QuantumSystemCoupling(
        op=op, g=g_ij, pair=tuple(pair), subsystem_levels=tuple(levels),
        coupling_type="TransmonDipoleCoupling",
        params={"lab_frame": lab_frame, "multiply_by_2pi": multiply_by_2pi},
    )


def MultiTransmonSystem(omegas, deltas, gs, *, levels_per_transmon: int = 3,
                        subsystem_levels=None, lab_frame: bool = False, subsystems=None,
                        subsystem_drive_indices=None) -> CompositeQuantumSystem:
    """Transmons omegas[i], deltas[i] with the dipole coupling gs[i, j] for
    every pair i < j of those kept: `subsystems` (default all) picks the
    transmons, `subsystem_drive_indices` (default all) those with drives."""
    omegas, deltas = list(omegas), list(deltas)
    n = len(omegas)
    gs = np.asarray(gs)
    if len(deltas) != n or gs.shape != (n, n):
        raise ValueError(f"{n} omegas need {n} deltas and an {n} x {n} gs")
    if subsystem_levels is None:
        subsystem_levels = [levels_per_transmon] * n
    kept = list(range(n)) if subsystems is None else [i for i in range(n) if i in subsystems]
    driven = list(range(n)) if subsystem_drive_indices is None else subsystem_drive_indices
    systems = [
        TransmonSystem(levels=subsystem_levels[i], omega=omegas[i], delta=deltas[i],
                       lab_frame=lab_frame, drives=i in driven)
        for i in kept
    ]
    kept_levels = [subsystem_levels[i] for i in kept]
    couplings = [
        TransmonDipoleCoupling(float(gs[i, j]), (ii, jj), kept_levels, lab_frame=lab_frame)
        for ii, i in enumerate(kept) for jj, j in enumerate(kept) if i < j
    ]
    return CompositeQuantumSystem(systems, couplings)
