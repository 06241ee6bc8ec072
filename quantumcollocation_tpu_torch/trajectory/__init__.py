from .indexing import comp_slice_at, index, slice_at
from .initialization import (
    initialize_control_trajectory,
    initialize_state_trajectory,
    initialize_trajectory,
    initialize_unitary_trajectory,
    linear_interpolation,
    unitary_geodesic,
)
from .named_trajectory import NamedTrajectory, derivative

__all__ = [
    "NamedTrajectory",
    "comp_slice_at",
    "derivative",
    "index",
    "initialize_control_trajectory",
    "initialize_state_trajectory",
    "initialize_trajectory",
    "initialize_unitary_trajectory",
    "linear_interpolation",
    "slice_at",
    "unitary_geodesic",
]
