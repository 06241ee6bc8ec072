"""Cat-qubit open system template (host numpy, build time only).

Counterpart of quantumcollocation_tpu/systems/cats.py: a cat mode ⊗ a
buffer mode with Kerr terms, two-photon exchange g2 and the dissipators
sqrt(kappa) a and sqrt(kappa) b; the drives are the buffer drive b + b'
and the Kerr correction a'a, in units of 2π.  get_cat_controls gives the
steady-state control values.  The port builds the system; a solve on it
(a density iso vec of 2·39² = 3,042 rows at the default levels) is not
ported.
"""

from __future__ import annotations

import numpy as np

from ..quantum.operators import annihilate, coherent_ket
from ..quantum.systems import OpenQuantumSystem

__all__ = ["CatSystem", "get_cat_controls", "coherent_ket"]


def CatSystem(*, g2: float = 0.36, chi_aa: float = -7e-3, chi_bb: float = -32.0,
              chi_ab: float = 0.79, kappa_a: float = 53e-3, kappa_b: float = 13.0,
              cat_levels: int = 13, buffer_levels: int = 3,
              prefactor: float = 1.0) -> OpenQuantumSystem:
    """The cat ⊗ buffer system (params keep the rates times prefactor; the
    operators use the rates as given, as the JAX package's do)."""
    params = {
        "g2": prefactor * g2, "chi_aa": prefactor * chi_aa, "chi_bb": prefactor * chi_bb,
        "chi_ab": prefactor * chi_ab, "kappa_a": prefactor * kappa_a,
        "kappa_b": prefactor * kappa_b, "cat_levels": cat_levels,
        "buffer_levels": buffer_levels, "prefactor": prefactor,
    }
    a = np.kron(annihilate(cat_levels), np.eye(buffer_levels, dtype=complex))
    b = np.kron(np.eye(cat_levels, dtype=complex), annihilate(buffer_levels))
    ad, bd = a.conj().T, b.conj().T
    H_drift = (-chi_aa / 2 * (ad @ ad @ a @ a) - chi_bb / 2 * (bd @ bd @ b @ b)
               - chi_ab * (ad @ a @ bd @ b) + g2 * (ad @ ad @ b) + np.conj(g2) * (a @ a @ bd))
    H_drives = [b + bd, ad @ a]
    L_dissipators = [np.sqrt(kappa_a) * a, np.sqrt(kappa_b) * b]
    return OpenQuantumSystem(H_drift * 2 * np.pi, [H * 2 * np.pi for H in H_drives],
                             [L * np.sqrt(2 * np.pi) for L in L_dissipators], params=params)


def get_cat_controls(system, alpha: float, T: int) -> np.ndarray:
    """(T, 2) steady-state controls of a cat system: the buffer drive
    |alpha|² g2 and the Kerr correction (2|alpha|² + 1) chi_aa."""
    if "g2" not in system.params:
        raise ValueError("Requires photon transfer coupling between buffer and cat")
    if "chi_aa" not in system.params:
        raise ValueError("Requires Kerr coupling for cat")
    buffer_drive = abs(alpha) ** 2 * system.params["g2"]
    kerr_correction = (2.0 * abs(alpha) ** 2 + 1.0) * system.params["chi_aa"]
    return np.stack([np.full(T, buffer_drive), np.full(T, kerr_correction)], axis=1)
