from .directsums import add_suffix, get_suffix, merge, remove_suffix
from .indexing import comp_slice_at, index, slice_at
from .initialization import (
    initialize_control_trajectory,
    initialize_density_trajectory,
    initialize_state_trajectory,
    initialize_trajectory,
    initialize_unitary_trajectory,
    linear_interpolation,
    unitary_geodesic,
)
from .named_trajectory import NamedTrajectory, derivative

__all__ = [
    "NamedTrajectory",
    "add_suffix",
    "comp_slice_at",
    "derivative",
    "get_suffix",
    "index",
    "initialize_control_trajectory",
    "initialize_density_trajectory",
    "initialize_state_trajectory",
    "initialize_trajectory",
    "initialize_unitary_trajectory",
    "linear_interpolation",
    "merge",
    "remove_suffix",
    "slice_at",
    "unitary_geodesic",
]
