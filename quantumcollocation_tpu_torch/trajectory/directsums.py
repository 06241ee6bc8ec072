"""Direct sums of trajectories: suffixing and merging.

Counterpart of quantumcollocation_tpu/trajectory/directsums.py.
`add_suffix` renames components (or a name, a list of names, an
integrator); `merge` concatenates trajectories into one, keeping a single
copy of each component listed in `merge_names`.  The merged layout is the
JAX package's: components in the order the trajectories list them, and
bounds, initial, final and goal data carried with them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Sequence

import numpy as np

from .named_trajectory import NamedTrajectory

__all__ = ["add_suffix", "merge", "get_suffix", "remove_suffix"]


def add_suffix(obj, suffix: str):
    """Suffix a name, a list or tuple of names, every component name of a
    trajectory, or an integrator's component names."""
    if isinstance(obj, str):
        return obj + suffix
    if isinstance(obj, (list, tuple)):
        return type(obj)(add_suffix(o, suffix) for o in obj)
    if isinstance(obj, NamedTrajectory):
        rename = lambda d: {k + suffix: v for k, v in d.items()}  # noqa: E731
        return NamedTrajectory(
            {name + suffix: np.asarray(obj[name]) for name in obj.names},
            controls=tuple(c + suffix for c in obj.controls),
            timestep=obj.timestep + suffix if isinstance(obj.timestep, str) else obj.timestep,
            bounds=rename(obj.bounds),
            initial=rename(obj.initial),
            final=rename(obj.final),
            goal=rename(obj.goal),
            global_data=rename(obj.global_data),
        )
    if hasattr(obj, "add_suffix"):
        return obj.add_suffix(suffix)
    raise TypeError(f"cannot suffix {type(obj)}")


def get_suffix(name: str, base: str) -> str:
    assert name.startswith(base)
    return name[len(base):]


def remove_suffix(name: str, suffix: str) -> str:
    assert name.endswith(suffix)
    return name[: -len(suffix)] if suffix else name


def merge(
    trajs: Sequence[NamedTrajectory],
    *,
    merge_names: Mapping[str, int] | None = None,
    free_time: bool | None = None,
    timestep_name: str = "Δt",
) -> NamedTrajectory:
    """One trajectory with the components of all of `trajs`, in order.

    merge_names maps a component name to the 1-based index of the
    trajectory whose copy is kept; such a component appears once, where
    its name first occurs.  Every other name must already be distinct
    (suffixed)."""
    merge_names = dict(merge_names or {})
    T = trajs[0].T
    assert all(t.T == T for t in trajs), "all trajectories must share T"

    comps = OrderedDict()
    bounds, initial, final, goal, global_data = {}, {}, {}, {}, {}
    controls = []
    timestep = None

    def take(traj, name):
        comps[name] = np.asarray(traj[name])
        for src, dst in ((traj.bounds, bounds), (traj.initial, initial),
                         (traj.final, final), (traj.goal, goal)):
            if name in src:
                dst[name] = src[name]
        if name in traj.controls:
            controls.append(name)

    done = set()
    for traj in trajs:
        for name in traj.names:
            if name not in merge_names:
                take(traj, name)
            elif name not in done:
                take(trajs[merge_names[name] - 1], name)
                done.add(name)
        for gname, gval in traj.global_data.items():
            global_data.setdefault(gname, gval)
        if timestep is None:
            timestep = traj.timestep

    if free_time is None:
        free_time = isinstance(timestep, str)
    if free_time and not isinstance(timestep, str):
        timestep = timestep_name
    return NamedTrajectory(
        comps,
        controls=tuple(dict.fromkeys(controls)),
        timestep=timestep,
        bounds=bounds,
        initial=initial,
        final=final,
        goal=goal,
        global_data=global_data,
    )
