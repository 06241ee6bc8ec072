"""Standard operator library (host numpy, complex128).

Counterpart of quantumcollocation_tpu/quantum/operators.py: the GATES and
PAULIS tables.  Operators stay host numpy; the solver only ever sees their
real iso generators.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np

__all__ = ["GATES", "PAULIS"]

_SQ2 = 1.0 / math.sqrt(2.0)

PAULIS: Mapping[str, np.ndarray] = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}

GATES: Mapping[str, np.ndarray] = {
    "I": np.eye(2, dtype=np.complex128),
    "X": PAULIS["X"],
    "Y": PAULIS["Y"],
    "Z": PAULIS["Z"],
    "H": _SQ2 * np.array([[1, 1], [1, -1]], dtype=np.complex128),
    "S": np.array([[1, 0], [0, 1j]], dtype=np.complex128),
    "T": np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128),
    "CZ": np.diag([1, 1, 1, -1]).astype(np.complex128),
    "CX": np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
        dtype=np.complex128,
    ),
}
