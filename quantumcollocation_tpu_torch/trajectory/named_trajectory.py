"""NamedTrajectory: knot-point trajectory container (host numpy).

Counterpart of quantumcollocation_tpu/trajectory/named_trajectory.py.
Data is TIME-MAJOR, (T, dim).  The trajectory is problem-construction
data: it stays float64 numpy on the host, and the solver copies what it
needs to its device once.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Sequence

import numpy as np

__all__ = ["NamedTrajectory", "derivative"]


def derivative(data, dt):
    """Forward difference along axis 0, last row duplicated."""
    data = np.asarray(data, dtype=float)
    dt = np.asarray(dt, dtype=float)
    dts = (
        np.full((data.shape[0] - 1, 1), float(dt))
        if dt.ndim == 0
        else dt.reshape(-1)[: data.shape[0] - 1, None]
    )
    diff = (data[1:] - data[:-1]) / dts
    return np.concatenate([diff, diff[-1:]], axis=0)


def _as_bound_pair(bound, size):
    if isinstance(bound, tuple) and len(bound) == 2:
        lo = np.broadcast_to(np.asarray(bound[0], dtype=float), (size,)).copy()
        hi = np.broadcast_to(np.asarray(bound[1], dtype=float), (size,)).copy()
        return lo, hi
    arr = np.broadcast_to(np.asarray(bound, dtype=float), (size,)).copy()
    return -arr, arr


class NamedTrajectory:
    """Named components over T knots plus bounds/initial/final/goal data."""

    def __init__(
        self,
        components: Mapping[str, Any],
        *,
        controls: Sequence[str] | str = (),
        timestep: float | str = 1.0,
        bounds: Mapping[str, Any] | None = None,
        initial: Mapping[str, Any] | None = None,
        final: Mapping[str, Any] | None = None,
        goal: Mapping[str, Any] | None = None,
        global_data: Mapping[str, Any] | None = None,
    ):
        if isinstance(controls, str):
            controls = (controls,)
        comps = OrderedDict()
        arrays = []
        T = None
        offset = 0
        for name, arr in components.items():
            arr = np.asarray(arr, dtype=float)
            if arr.ndim == 1:
                arr = arr[:, None]
            T = arr.shape[0] if T is None else T
            if arr.shape[0] != T:
                raise ValueError(f"component {name!r} has {arr.shape[0]} knots, expected {T}")
            comps[name] = (offset, offset + arr.shape[1])
            arrays.append(arr)
            offset += arr.shape[1]
        self._components = comps
        self.data = np.concatenate(arrays, axis=1)
        self.T = int(T)
        self.dim = int(offset)

        controls = tuple(controls)
        if isinstance(timestep, str):
            if timestep not in comps:
                raise KeyError(f"timestep component {timestep!r} missing")
            if timestep not in controls:
                controls = controls + (timestep,)
        self.controls = controls
        self.timestep = timestep

        def _norm(d, pad_bounds=False):
            out = OrderedDict()
            for name, val in (d or {}).items():
                size = comps[name][1] - comps[name][0]
                out[name] = (
                    _as_bound_pair(val, size)
                    if pad_bounds
                    else np.broadcast_to(np.asarray(val, dtype=float), (size,)).copy()
                )
            return out

        self.bounds = _norm(bounds, pad_bounds=True)
        self.initial = _norm(initial)
        self.final = _norm(final)
        self.goal = _norm(goal)
        self.global_data = OrderedDict(
            (k, np.asarray(v)) for k, v in (global_data or {}).items()
        )

    @property
    def names(self) -> tuple:
        return tuple(self._components)

    @property
    def components(self) -> OrderedDict:
        return self._components

    def comp_slice(self, name: str) -> slice:
        start, stop = self._components[name]
        return slice(start, stop)

    def comp_size(self, name: str) -> int:
        start, stop = self._components[name]
        return stop - start

    def __getitem__(self, name):
        if isinstance(name, str):
            return self.data[..., self.comp_slice(name)]
        raise KeyError(name)

    def get_timesteps(self):
        """(T,) timestep durations."""
        if isinstance(self.timestep, str):
            return self[self.timestep][..., 0]
        return np.full((self.T,), self.timestep)

    def duration(self):
        return float(np.sum(self.get_timesteps()[:-1]))

    def with_data(self, data, global_data=None) -> "NamedTrajectory":
        obj = object.__new__(NamedTrajectory)
        obj.__dict__.update(self.__dict__)
        obj.data = np.asarray(data, dtype=float)
        if global_data is not None:
            obj.global_data = OrderedDict(global_data)
        return obj

    def __repr__(self):
        comps = ", ".join(f"{n}:{self.comp_size(n)}" for n in self._components)
        return (
            f"NamedTrajectory(T={self.T}, dim={self.dim}, [{comps}], "
            f"controls={self.controls}, timestep={self.timestep!r})"
        )
