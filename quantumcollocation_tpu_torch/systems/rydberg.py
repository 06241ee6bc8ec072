"""Rydberg atom chain system template (host numpy, build time only).

Counterpart of quantumcollocation_tpu/systems/rydberg.py: van der Waals
C/r^6 interactions between excited atoms (all pairs, or nearest and
next-nearest neighbours by cutoff_order), global X and Y drives and a
global detuning, in the spin basis |g⟩ = [1, 0], |r⟩ = [0, 1].
"""

from __future__ import annotations

import numpy as np

from ..quantum.operators import PAULIS, operator_from_string
from ..quantum.systems import QuantumSystem

__all__ = ["RydbergChainSystem"]

_LOOKUP = {**PAULIS, "n": np.array([[0, 0], [0, 1]], dtype=complex)}


def _pair_pattern(N: int, i: int, gap: int) -> str:
    """N characters 'I' with 'n' at atoms i and i + gap + 1 (all 'I' where
    the second passes the chain's end)."""
    chars = ["I"] * N
    if i + gap + 1 < N:
        chars[i] = chars[i + gap + 1] = "n"
    return "".join(chars)


def _site_sum(ch: str, N: int, weight=lambda i: 1.0):
    """sum_i weight(i) (ch on atom i)."""
    return sum(weight(i) * operator_from_string("I" * i + ch + "I" * (N - i - 1), lookup=_LOOKUP)
               for i in range(N))


def RydbergChainSystem(*, N: int = 3, C: float = 862690 * 2 * np.pi, distance: float = 8.7,
                       cutoff_order: int = 1, local_detune: bool = False, all2all: bool = True,
                       ignore_Y_drive: bool = False) -> QuantumSystem:
    """A chain of N atoms at `distance` (um), C in MHz um^6: drift
    sum_{i<j} C / r_ij^6 n_i n_j; drives 0.5 sum X_i, 0.5 sum Y_i (unless
    ignore_Y_drive), -sum n_i, and with local_detune a staggered
    -sum_{i odd} n_i."""
    dim = 2**N
    H_drift = np.zeros((dim, dim), dtype=complex)
    if all2all:
        gaps = [(gap, (gap + 1) * distance) for gap in range(N - 1)]
    else:
        if cutoff_order not in (1, 2):
            raise ValueError("Higher cutoff order not supported")
        gaps = [(0, distance)] + ([(1, 2 * distance)] if cutoff_order == 2 else [])
    for gap, r in gaps:
        for i in range(N - gap - 1):
            H_drift += C * operator_from_string(_pair_pattern(N, i, gap), lookup=_LOOKUP) / r**6
    H_drives = [0.5 * _site_sum("X", N)]
    if not ignore_Y_drive:
        H_drives.append(0.5 * _site_sum("Y", N))
    H_drives.append(-_site_sum("n", N))
    if local_detune:
        H_drives.append(-_site_sum("n", N, weight=lambda i: i % 2))
    params = {"N": N, "C": C, "distance": distance, "cutoff_order": cutoff_order,
              "local_detune": local_detune, "all2all": all2all, "ignore_Y_drive": ignore_Y_drive}
    return QuantumSystem(H_drift, H_drives, params=params)
