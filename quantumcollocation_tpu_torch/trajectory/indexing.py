"""Flat-index helpers: knot point <-> flat decision vector (0-based).

Counterpart of quantumcollocation_tpu/trajectory/indexing.py.  The flat
decision vector is Z = [z_0; z_1; ...; z_{T-1}] with rows of length dim.
"""

from __future__ import annotations

__all__ = ["index", "slice_at", "comp_slice_at"]


def index(t: int, pos: int, dim: int) -> int:
    """Flat index of coordinate `pos` at knot `t`."""
    return t * dim + pos


def slice_at(t: int, dim: int, *, start: int = 0, stop: int | None = None) -> slice:
    """Flat slice of knot t's row (optionally a sub-range [start, stop))."""
    stop = dim if stop is None else stop
    return slice(t * dim + start, t * dim + stop)


def comp_slice_at(traj, name: str, t: int) -> slice:
    """Flat slice of component `name` at knot `t`."""
    start, stop = traj.components[name]
    return slice(t * traj.dim + start, t * traj.dim + stop)
