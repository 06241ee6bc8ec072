"""Transmon system template (host numpy, build time only).

Counterpart of quantumcollocation_tpu/systems/transmons.py::TransmonSystem:
H = (omega - frame_omega) a'a - delta/2 a'a'aa in the rotating frame (the
default), or one of three lab-frame drifts (duffing, quartic, cosine),
with the drives a + a' and i(a - a'), in units of 2π by default.  The
composite templates (TransmonDipoleCoupling, MultiTransmonSystem) need
CompositeQuantumSystem, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..quantum.operators import annihilate
from ..quantum.systems import QuantumSystem

__all__ = ["TransmonSystem"]


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
