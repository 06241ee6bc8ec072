"""Collocation integrators: defect rows F_t(z_t, z_{t+1}) = 0.

Counterpart of quantumcollocation_tpu/dynamics/integrators.py (the
integrators of the unitary, ket and density smooth-pulse templates and
the robustness accumulator).  `defect` takes knot rows with any leading
batch axes, (..., dim), and returns (..., defect_dim).  The solver
assembles the propagator, derivative and timestep rows analytically
(solver/analytic.py), and `defect` is the direct definition that assembly
is held against; an integrator list with a robustness accumulator or a
density integrator goes through `defect` and torch.func instead
(solver/stage_nlp.py, the AD route), so every defect is real arithmetic:
torch.func's tangents stay real.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch

from ..quantum.systems import OpenQuantumSystem, QuantumSystem
from .expm import default_num_squarings, expm_squaring, expm_taylor, pade_numerator_denominator

__all__ = [
    "UnitaryExponentialIntegrator",
    "UnitaryPadeIntegrator",
    "QuantumStateExponentialIntegrator",
    "QuantumStatePadeIntegrator",
    "DensityOperatorExponentialIntegrator",
    "DerivativeIntegrator",
    "TimeStepEqualityIntegrator",
    "RobustnessAccumulatorIntegrator",
]


def _norm_bound(system: QuantumSystem, drive_bounds, dt_max: float) -> float:
    """Upper bound on ||G(a) dt|| used to pick the static squaring count."""
    G0 = np.linalg.norm(system.G_drift, 2)
    Gs = [np.linalg.norm(system.G_drives[j], 2) for j in range(system.n_drives)]
    if drive_bounds is None:
        drive_bounds = [1.0] * system.n_drives
    return float((G0 + sum(b * g for b, g in zip(drive_bounds, Gs))) * dt_max)


class _Suffixable:
    """add_suffix: a copy with its component names suffixed (direct sums)."""

    _NAME_FIELDS = ("state_name", "control_name", "x_name", "dx_name", "accumulator_name",
                    "timestep_name")

    def add_suffix(self, suffix: str):
        new = dataclasses.replace(self)
        for field in self._NAME_FIELDS:
            if getattr(new, field, None) is not None:
                setattr(new, field, getattr(new, field) + suffix)
        return new


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
class UnitaryExponentialIntegrator(_Suffixable):
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
class UnitaryPadeIntegrator(_Suffixable):
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
class QuantumStateExponentialIntegrator(_Suffixable):
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
class QuantumStatePadeIntegrator(_Suffixable):
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
class DensityOperatorExponentialIntegrator(_Suffixable):
    """Lindblad defect rho_{t+1} - exp(D(a_t) dt_t) rho_t on density iso
    vecs.  The JAX package exponentiates by Padé order 8 after 6
    squarings; here exp(X) is a degree-12 Taylor polynomial of X 2^-6,
    then 6 squarings (expm_taylor): matmuls only, because torch.func's
    vmap of a Hessian through a linear solve is wrong past the first
    instance of a batch (scripts/vmap_solve_hessian_probe.py), and this
    defect takes the AD route.  Its truncation error, ~1.6e-10 x^13 at
    x = ||X|| 2^-6, is below Padé 8's ~3.9e-8 x^9 for every x < 3.9, so
    the two agree to float64 rounding wherever Padé 8 is accurate."""

    state_name: str
    control_name: str
    system: OpenQuantumSystem = None
    order: int = 8
    num_squarings: int = 6
    timestep_name: Any = None
    taylor_degree: ClassVar[int] = 12

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        D = self.system.lindblad_generator(_get(traj, zt, self.control_name))
        X = D * _dt(traj, zt, self.timestep_name)[..., None, None]
        P = expm_taylor(X, self.taylor_degree, self.num_squarings)
        return _get(traj, ztp1, self.state_name) - _apply(P, _get(traj, zt, self.state_name))


@dataclasses.dataclass
class DerivativeIntegrator(_Suffixable):
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
class TimeStepEqualityIntegrator(_Suffixable):
    """Defect dt_{t+1} - dt_t (equal timesteps, kept block-tridiagonal)."""

    timestep_name: str = "Δt"

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.timestep_name)

    def defect(self, zt, ztp1, traj):
        return _get(traj, ztp1, self.timestep_name) - _get(traj, zt, self.timestep_name)


@dataclasses.dataclass
class RobustnessAccumulatorIntegrator(_Suffixable):
    """Defect M_{t+1} - M_t - dt_t iso_vec(U_t† H_e U_t) of the first-order
    Magnus accumulator M (an iso-vec state, M_0 = 0), which makes the
    robustness cost ||Σ_t dt_t U_t† H_e U_t||² a terminal cost on M_T.
    U_t† H_e U_t is formed from the real blocks of the iso operator
    [Re U; Im U] and of H_e = H_r + i H_i."""

    state_name: str = "Ũ⃗"
    accumulator_name: str = "m_rob"
    control_name: str = "a"
    H_error: Any = None
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.accumulator_name)

    def defect(self, zt, ztp1, traj):
        H = np.asarray(self.H_error, dtype=np.complex128)
        Hr, Hi = (torch.as_tensor(x, dtype=zt.dtype, device=zt.device) for x in (H.real, H.imag))
        Ut = _iso_mats(traj, zt, self.state_name)
        N = Ut.shape[-1]
        Ur, Ui = Ut[..., :N, :], Ut[..., N:, :]
        # W = H_e U, then U† W = (Ur^T Wr + Ui^T Wi) + i (Ur^T Wi - Ui^T Wr)
        Wr, Wi = Hr @ Ur - Hi @ Ui, Hr @ Ui + Hi @ Ur
        Urt, Uit = Ur.transpose(-1, -2), Ui.transpose(-1, -2)
        V = _iso_vec(torch.cat([Urt @ Wr + Uit @ Wi, Urt @ Wi - Uit @ Wr], dim=-2))
        dt = _dt(traj, zt, self.timestep_name)[..., None]
        return (_get(traj, ztp1, self.accumulator_name) - _get(traj, zt, self.accumulator_name)
                - dt * V)
