"""Collocation integrators: defect rows F_t(z_t, z_{t+1}) = 0.

Counterpart of quantumcollocation_tpu/dynamics/integrators.py (the
integrators of the unitary and ket smooth-pulse templates).  `defect` takes knot rows with
any leading batch axes, (..., dim), and returns (..., defect_dim).  The
solver assembles these rows analytically (solver/analytic.py); `defect` is
the direct definition the analytic assembly is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..quantum.systems import QuantumSystem
from .expm import default_num_squarings, expm_squaring, pade_numerator_denominator

__all__ = [
    "UnitaryExponentialIntegrator",
    "UnitaryPadeIntegrator",
    "QuantumStateExponentialIntegrator",
    "QuantumStatePadeIntegrator",
    "DerivativeIntegrator",
    "TimeStepEqualityIntegrator",
]


def _norm_bound(system: QuantumSystem, drive_bounds, dt_max: float) -> float:
    """Upper bound on ||G(a) dt|| used to pick the static squaring count."""
    G0 = np.linalg.norm(system.G_drift, 2)
    Gs = [np.linalg.norm(system.G_drives[j], 2) for j in range(system.n_drives)]
    if drive_bounds is None:
        drive_bounds = [1.0] * system.n_drives
    return float((G0 + sum(b * g for b, g in zip(drive_bounds, Gs))) * dt_max)


def _get(traj, z, name):
    start, stop = traj.components[name]
    return z[..., start:stop]


def _dt(traj, z, timestep_name=None):
    name = timestep_name if timestep_name is not None else (
        traj.timestep if isinstance(traj.timestep, str) else None
    )
    if name is not None and name in traj.components:
        return _get(traj, z, name)[..., 0]
    return torch.full(z.shape[:-1], float(traj.timestep), dtype=z.dtype, device=z.device)


def _iso_mats(traj, z, name):
    """iso-vec state -> (..., 2N, N) iso operator."""
    v = _get(traj, z, name)
    N = int(round((v.shape[-1] / 2) ** 0.5))
    return v.reshape(*v.shape[:-1], N, 2 * N).transpose(-1, -2)


def _iso_vec(M):
    return M.transpose(-1, -2).reshape(*M.shape[:-2], -1)


@dataclasses.dataclass
class UnitaryExponentialIntegrator:
    """Defect iso_vec(U_{t+1}) - exp(G(a_t) dt_t) U_t."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 8
    num_squarings: int | None = None
    drive_bounds: Any = None
    dt_max: float = 1.0
    timestep_name: Any = None

    def __post_init__(self):
        if self.num_squarings is None:
            self.num_squarings = default_num_squarings(
                _norm_bound(self.system, self.drive_bounds, self.dt_max),
                self.order,
            )

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        G = self.system.generator(_get(traj, zt, self.control_name))
        X = G * _dt(traj, zt, self.timestep_name)[..., None, None]
        P = expm_squaring(X, order=self.order, num_squarings=self.num_squarings)
        U_t = _iso_mats(traj, zt, self.state_name)
        U_tp1 = _iso_mats(traj, ztp1, self.state_name)
        return _iso_vec(U_tp1 - P @ U_t)


@dataclasses.dataclass
class UnitaryPadeIntegrator:
    """Implicit Padé defect q(-X) U_{t+1} - q(X) U_t, X = G(a_t) dt_t."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 4
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        G = self.system.generator(_get(traj, zt, self.control_name))
        X = G * _dt(traj, zt, self.timestep_name)[..., None, None]
        N, D = pade_numerator_denominator(X, self.order)
        U_t = _iso_mats(traj, zt, self.state_name)
        U_tp1 = _iso_mats(traj, ztp1, self.state_name)
        return _iso_vec(D @ U_tp1 - N @ U_t)


def _apply(M, v):
    """(..., n, n) @ (..., n) -> (..., n)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass
class QuantumStateExponentialIntegrator:
    """Ket defect psi_{t+1} - exp(G(a_t) dt_t) psi_t on iso kets."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 8
    num_squarings: int | None = None
    drive_bounds: Any = None
    dt_max: float = 1.0
    timestep_name: Any = None

    def __post_init__(self):
        if self.num_squarings is None:
            self.num_squarings = default_num_squarings(
                _norm_bound(self.system, self.drive_bounds, self.dt_max),
                self.order,
            )

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        G = self.system.generator(_get(traj, zt, self.control_name))
        X = G * _dt(traj, zt, self.timestep_name)[..., None, None]
        P = expm_squaring(X, order=self.order, num_squarings=self.num_squarings)
        return _get(traj, ztp1, self.state_name) - _apply(P, _get(traj, zt, self.state_name))


@dataclasses.dataclass
class QuantumStatePadeIntegrator:
    """Ket implicit Padé defect q(-X) psi_{t+1} - q(X) psi_t."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 4
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        G = self.system.generator(_get(traj, zt, self.control_name))
        X = G * _dt(traj, zt, self.timestep_name)[..., None, None]
        N, D = pade_numerator_denominator(X, self.order)
        return (_apply(D, _get(traj, ztp1, self.state_name))
                - _apply(N, _get(traj, zt, self.state_name)))


@dataclasses.dataclass
class DerivativeIntegrator:
    """Defect x_{t+1} - x_t - dx_t dt_t."""

    x_name: str
    dx_name: str
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.x_name)

    def defect(self, zt, ztp1, traj):
        dt = _dt(traj, zt, self.timestep_name)[..., None]
        return (
            _get(traj, ztp1, self.x_name) - _get(traj, zt, self.x_name)
            - _get(traj, zt, self.dx_name) * dt
        )


@dataclasses.dataclass
class TimeStepEqualityIntegrator:
    """Defect dt_{t+1} - dt_t (equal timesteps, kept block-tridiagonal)."""

    timestep_name: str = "Δt"

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.timestep_name)

    def defect(self, zt, ztp1, traj):
        return _get(traj, ztp1, self.timestep_name) - _get(traj, zt, self.timestep_name)
