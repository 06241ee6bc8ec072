"""Standard operator library (host numpy, complex128).

Counterpart of quantumcollocation_tpu/quantum/operators.py: the GATES and
PAULIS tables, the truncated bosonic operators and the tensor-product
lift.  Operators stay host numpy; the solver only ever sees their real iso
generators.  Subsystem indices are 0-based.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Mapping, Sequence

import numpy as np

__all__ = ["GATES", "PAULIS", "annihilate", "create", "number_op", "quad_op", "kron_all",
           "lift"]

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


def annihilate(levels: int) -> np.ndarray:
    """Bosonic annihilation operator truncated to `levels` levels."""
    return np.diag(np.sqrt(np.arange(1, levels, dtype=np.float64)), k=1).astype(np.complex128)


def create(levels: int) -> np.ndarray:
    """Bosonic creation operator truncated to `levels` levels."""
    return annihilate(levels).conj().T


def number_op(levels: int) -> np.ndarray:
    """Number operator a'a."""
    return np.diag(np.arange(levels, dtype=np.float64)).astype(np.complex128)


def quad_op(levels: int) -> np.ndarray:
    """Position-like quadrature a + a'."""
    a = annihilate(levels)
    return a + a.conj().T


def kron_all(ops: Sequence[np.ndarray]) -> np.ndarray:
    """Kronecker product of a list of operators, left to right."""
    return reduce(np.kron, [np.asarray(op) for op in ops])


def lift(op: np.ndarray, index: int, subsystem_levels) -> np.ndarray:
    """`op` on subsystem `index` (0-based) lifted into the tensor product;
    subsystem_levels is a list of subsystem dimensions or an int (that many
    qubits)."""
    if isinstance(subsystem_levels, int):
        subsystem_levels = [2] * subsystem_levels
    return kron_all([
        np.asarray(op) if i == index else np.eye(levels, dtype=np.complex128)
        for i, levels in enumerate(subsystem_levels)
    ])
