"""Embedded operators and the subspace and leakage index bookkeeping (host
numpy, build time only).

Counterpart of quantumcollocation_tpu/quantum/embedded.py: a gate on the
computational subspace embedded in a larger Hilbert space (identity on the
leakage levels), and the indices of the subspace, of the leakage levels,
and of both in the unitary iso-vec layout, where entry (r, c) of U sits at
c·2N + r (real part) and c·2N + N + r (imaginary part).
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Any, Sequence

import numpy as np

__all__ = [
    "EmbeddedOperator",
    "embed",
    "unembed",
    "get_subspace_indices",
    "get_leakage_indices",
    "get_iso_vec_leakage_indices",
    "get_iso_vec_subspace_indices",
]


def get_subspace_indices(subspaces, subsystem_levels=None) -> list[int]:
    """Indices of the tensor-product basis states whose every subsystem
    level lies in that subsystem's retained levels; subspaces holds one
    list of retained levels per subsystem (or one list for a single
    system, with subsystem_levels an int): get_subspace_indices([0, 1], 3)
    == [0, 1]."""
    if subsystem_levels is None:
        raise ValueError("subsystem_levels required")
    if isinstance(subsystem_levels, int):
        subsystem_levels = [subsystem_levels]
        if len(subspaces) and isinstance(subspaces[0], int):
            subspaces = [list(subspaces)]
    indices = []
    for combo in product(*[list(s) for s in subspaces]):
        idx = 0
        for c, dim in zip(combo, subsystem_levels):
            idx = idx * dim + c
        indices.append(idx)
    return sorted(indices)


def embed(op, subspace_indices, levels: int | None = None) -> np.ndarray:
    """op placed at subspace_indices of a levels x levels operator, with the
    identity on the leakage levels (so a unitary stays unitary);
    embed(op, embedded_operator) takes both from the embedded operator."""
    if isinstance(subspace_indices, EmbeddedOperator):
        subspace_indices, levels = subspace_indices.subspace, subspace_indices.levels
    out = np.zeros((levels, levels), dtype=np.complex128)
    out[np.ix_(subspace_indices, subspace_indices)] = np.asarray(op)
    leakage = [i for i in range(levels) if i not in set(subspace_indices)]
    out[leakage, leakage] = 1.0
    return out


def unembed(U, subspace_indices) -> np.ndarray:
    """The subspace block U[..., idx, idx] of a full-space operator."""
    if isinstance(subspace_indices, EmbeddedOperator):
        subspace_indices = subspace_indices.subspace
    idx = np.asarray(subspace_indices)
    return np.asarray(U)[..., idx[:, None], idx[None, :]]


@dataclasses.dataclass(frozen=True)
class EmbeddedOperator:
    """A target gate embedded in a larger Hilbert space: `.operator` (the
    full-space matrix, identity on the leakage levels), `.subspace` (=
    `.subspace_indices`), `.levels`, `.subsystem_levels`.

    Constructors, as the JAX package's:
      EmbeddedOperator(op, system)                    # the system's qubit subspace
      EmbeddedOperator(op, subspace_indices, levels)
      EmbeddedOperator(op, subspace_indices, subsystem_levels=[...])
    """

    operator: Any
    subspace: tuple
    levels: int
    subsystem_levels: tuple

    def __init__(self, op, system_or_indices=None, levels=None, *, subsystem_levels=None):
        op = np.asarray(op)
        if hasattr(system_or_indices, "levels") and not isinstance(
            system_or_indices, (list, tuple, np.ndarray)
        ):
            sys = system_or_indices
            sub_levels = tuple(sys.params.get("subsystem_levels", (sys.levels,)))
            if len(sub_levels) == 1:
                # one system: the first op.shape[0] levels
                indices = list(range(op.shape[0]))
            else:
                indices = get_subspace_indices([[0, 1]] * len(sub_levels), list(sub_levels))
                if len(indices) != op.shape[0]:
                    raise ValueError(
                        f"operator dim {op.shape[0]} != subspace size {len(indices)}")
            total = int(np.prod(sub_levels))
        else:
            indices = list(system_or_indices)
            if levels is not None:
                total = int(levels)
                sub_levels = (total,)
            elif subsystem_levels is not None:
                sub_levels = tuple(subsystem_levels)
                total = int(np.prod(sub_levels))
            else:
                raise ValueError("need levels or subsystem_levels")
        object.__setattr__(self, "operator", embed(op, indices, total))
        object.__setattr__(self, "subspace", tuple(indices))
        object.__setattr__(self, "levels", total)
        object.__setattr__(self, "subsystem_levels", tuple(sub_levels))

    @property
    def subspace_indices(self):
        return self.subspace

    @property
    def shape(self):
        return (self.levels, self.levels)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.operator, dtype=dtype)


def get_leakage_indices(op: "EmbeddedOperator | Sequence[int]",
                        levels: int | None = None) -> list[int]:
    """The levels outside the subspace."""
    if isinstance(op, EmbeddedOperator):
        subspace, levels = set(op.subspace), op.levels
    else:
        subspace = set(op)
    return [i for i in range(levels) if i not in subspace]


def _iso_vec_entries(N, rows, cols):
    """Sorted iso-vec positions (real and imaginary) of U[r, c], r in rows,
    c in cols."""
    return sorted(p for c in cols for r in rows for p in (c * 2 * N + r, c * 2 * N + N + r))


def get_iso_vec_subspace_indices(op: EmbeddedOperator) -> list[int]:
    """Iso-vec positions of the subspace block's entries."""
    return _iso_vec_entries(op.levels, op.subspace, op.subspace)


def get_iso_vec_leakage_indices(op: EmbeddedOperator) -> list[int]:
    """Iso-vec positions of the leakage amplitudes U[r, c]: c in the
    subspace (the driven columns), r a leakage level; the entries the L1
    leakage suppression penalizes."""
    return _iso_vec_entries(op.levels, get_leakage_indices(op), op.subspace)
