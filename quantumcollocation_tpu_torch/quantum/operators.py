"""Standard operator library (host numpy, complex128).

Counterpart of quantumcollocation_tpu/quantum/operators.py: the GATES and
PAULIS tables, the truncated bosonic operators, the tensor-product lift,
operators from character strings, Haar-random unitaries (one near the
identity) and truncated coherent kets.  Operators stay host numpy; the
solver only ever sees their real iso generators.  Subsystem indices are
0-based.  For the same seed or numpy Generator the Haar draws equal the
JAX package's: both draw from numpy in the same order.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Mapping, Sequence

import numpy as np

__all__ = ["GATES", "PAULIS", "annihilate", "create", "number_op", "quad_op", "lift",
           "operator_from_string", "kron_all", "haar_random", "haar_identity", "coherent_ket"]

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


def operator_from_string(op_string: str, lookup: Mapping[str, np.ndarray] | None = None
                         ) -> np.ndarray:
    """The tensor product of the operators named by each character, left
    to right: operator_from_string("XIZ") = X ⊗ I ⊗ Z.  The default lookup
    holds the Paulis and n = |1⟩⟨1|."""
    if lookup is None:
        lookup = {**PAULIS, "n": np.array([[0, 0], [0, 1]], dtype=np.complex128)}
    return kron_all([lookup[ch] for ch in op_string])


def _rng(seed) -> np.random.Generator:
    return seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)


def haar_random(n: int, seed: int | np.random.Generator = 0) -> np.ndarray:
    """A Haar-random n x n unitary: the QR of a complex Ginibre matrix,
    with R's diagonal phases moved into Q."""
    rng = _rng(seed)
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def haar_identity(n: int, radius: float, seed: int | np.random.Generator = 0) -> np.ndarray:
    """A random unitary near the identity: exp(-i radius H) for a random
    Hermitian H of unit Frobenius norm."""
    rng = _rng(seed)
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h = (z + z.conj().T) / 2.0
    h = h / np.linalg.norm(h)
    evals, evecs = np.linalg.eigh(h)
    return (evecs * np.exp(-1j * radius * evals)) @ evecs.conj().T


def coherent_ket(alpha, levels: int) -> np.ndarray:
    """The coherent state |alpha⟩ truncated to `levels` levels (not
    renormalised): e^{-|alpha|²/2} alpha^k / sqrt(k!)."""
    k = np.arange(levels)
    log_fact = np.cumsum(np.log(np.maximum(k, 1)))
    amp = np.exp(-0.5 * abs(alpha) ** 2) * np.power(complex(alpha), k) / np.exp(0.5 * log_fact)
    return amp.astype(np.complex128)
