"""Trajectory interpolation and resampling (host numpy, build time only).

Counterpart of quantumcollocation_tpu/trajectory/interpolation.py:
per-component linear (or previous-value) interpolants over a trajectory's
time grid, sampled at given times or resampled to a new knot count.  A
named timestep component is recomputed from the new grid's differences,
not interpolated.
"""

from __future__ import annotations

import numpy as np

from .named_trajectory import NamedTrajectory

__all__ = ["DataInterpolation", "resample_free_time"]


class DataInterpolation:
    """Interpolates a NamedTrajectory's components over time.

    interp = DataInterpolation(traj)
    interp(ts)      -> a new NamedTrajectory sampled at the times ts
    interp(T=120)   -> resampled to 120 evenly spaced knots over the duration
    kind "linear" interpolates each column; "previous" holds the value of
    the last knot at or before each time.
    """

    def __init__(self, traj: NamedTrajectory, *, kind: str = "linear"):
        if kind not in ("linear", "previous"):
            raise ValueError(f"kind must be 'linear' or 'previous', not {kind!r}")
        self.traj = traj
        self.kind = kind
        self.times = np.asarray(traj.get_times(), dtype=float)

    def __call__(self, times=None, *, T: int | None = None) -> NamedTrajectory:
        if times is None:
            if T is None:
                raise ValueError("provide times or T")
            times = np.linspace(self.times[0], self.times[-1], T)
        times = np.asarray(times, dtype=float)
        traj = self.traj
        named_dt = isinstance(traj.timestep, str)
        if self.kind == "previous":
            idx = np.clip(np.searchsorted(self.times, times, side="right") - 1,
                          0, len(self.times) - 1)
        comps = {}
        for name in traj.names:
            block = np.asarray(traj[name], dtype=float)
            if named_dt and name == traj.timestep:
                dts = np.diff(times)
                comps[name] = np.append(dts, dts[-1] if len(dts) else 1.0)[:, None]
            elif self.kind == "previous":
                comps[name] = block[idx]
            else:
                comps[name] = np.stack([np.interp(times, self.times, block[:, j])
                                        for j in range(block.shape[1])], axis=1)
        return NamedTrajectory(
            comps,
            controls=tuple(c for c in traj.controls if not (named_dt and c == traj.timestep)),
            timestep=(traj.timestep if named_dt
                      else float(np.diff(times).mean() if len(times) > 1 else traj.timestep)),
            bounds=dict(traj.bounds), initial=dict(traj.initial), final=dict(traj.final),
            goal=dict(traj.goal), global_data=dict(traj.global_data),
        )


def resample_free_time(traj: NamedTrajectory, *, T: int | None = None,
                       timestep_name: str = "Δt", dt_bounds=None) -> NamedTrajectory:
    """Warm start for a minimum-time stage: resample a solved trajectory to
    T knots (default its own) with a free timestep.  A fixed-time
    trajectory gains the component timestep_name, bounded by dt_bounds
    (default (0.5, 1.5) times the mean Δt); a free-time one keeps its own
    (and raises if it has another name)."""
    new = DataInterpolation(traj)(T=T or traj.T)
    if isinstance(new.timestep, str):
        if new.timestep != timestep_name:
            raise ValueError(f"trajectory already has free timestep {new.timestep!r}")
        return new
    dt = float(new.timestep)
    comps = {name: np.asarray(new[name]) for name in new.names}
    comps[timestep_name] = np.full((new.T, 1), dt)
    bounds = dict(new.bounds)
    bounds[timestep_name] = (0.5 * dt, 1.5 * dt) if dt_bounds is None else dt_bounds
    return NamedTrajectory(
        comps, controls=new.controls, timestep=timestep_name, bounds=bounds,
        initial=dict(new.initial), final=dict(new.final), goal=dict(new.goal),
        global_data=dict(new.global_data),
    )
