"""Closed and open (Lindblad) quantum system containers.

Counterpart of quantumcollocation_tpu/quantum/systems.py::QuantumSystem
and OpenQuantumSystem.  Complex Hamiltonians, dissipators and their real
iso generators and superoperators are host numpy; an open system keeps one
copy of its superoperators and complex operators on each (dtype, device)
it is evaluated on.
"""

from __future__ import annotations

import numpy as np
import torch

from .isomorphisms import iso_D, iso_G

__all__ = ["QuantumSystem", "OpenQuantumSystem"]


def _stack_drives(H_drives, levels):
    if H_drives is None or (
        isinstance(H_drives, (list, tuple)) and len(H_drives) == 0
    ):
        return np.zeros((0, levels, levels), dtype=np.complex128)
    if isinstance(H_drives, (list, tuple)):
        return np.stack([np.asarray(H, dtype=np.complex128) for H in H_drives])
    H_drives = np.asarray(H_drives, dtype=np.complex128)
    return H_drives[None] if H_drives.ndim == 2 else H_drives


class QuantumSystem:
    """H(a) = H_drift + sum_j a_j H_drives[j], with real iso generators
    G_drift (2N, 2N) and G_drives (n_drives, 2N, 2N) as numpy."""

    def __init__(self, H_drift=None, H_drives=None, *, params=None):
        if H_drives is None and isinstance(H_drift, (list, tuple)):
            H_drives, H_drift = H_drift, None
        if H_drift is None:
            if H_drives is None:
                raise ValueError("need at least one of H_drift / H_drives")
            first = H_drives[0] if isinstance(H_drives, (list, tuple)) else H_drives
            n = np.asarray(first).shape[-1]
            H_drift = np.zeros((n, n), dtype=np.complex128)
        self.H_drift = np.asarray(H_drift, dtype=np.complex128)
        self.levels = int(self.H_drift.shape[-1])
        self.H_drives = _stack_drives(H_drives, self.levels)
        self.n_drives = int(self.H_drives.shape[0])
        self.G_drift = iso_G(self.H_drift)
        self.G_drives = (
            np.stack([iso_G(H) for H in self.H_drives])
            if self.n_drives
            else np.zeros((0, 2 * self.levels, 2 * self.levels))
        )
        self.params = dict(params) if params else {}

    @property
    def iso_dim(self) -> int:
        return 2 * self.levels

    def generator(self, a):
        """G(a) = G_drift + sum_j a_j G_drives[j] for a (..., n_drives)
        tensor; returns (..., 2N, 2N) on a's device and dtype."""
        Gd = torch.as_tensor(self.G_drift, dtype=a.dtype, device=a.device)
        if self.n_drives == 0:
            return Gd.expand(*a.shape[:-1], *Gd.shape)
        Gs = torch.as_tensor(self.G_drives, dtype=a.dtype, device=a.device)
        return Gd + torch.tensordot(a, Gs, dims=1)


class OpenQuantumSystem(QuantumSystem):
    """A QuantumSystem with Lindblad dissipators L_dissipators (k, N, N)
    and the real iso superoperators D_drift (2N^2, 2N^2), of -i[H_drift, .]
    plus the dissipators, and D_drives (n_drives, 2N^2, 2N^2), of
    -i[H_j, .].  The superoperators are materialized up to
    SUPEROP_MAX_LEVELS levels (or as materialize_superops says); without
    them D_drift and D_drives are None, and rollouts take the matrix-free
    lindblad_action with the Krylov expv."""

    SUPEROP_MAX_LEVELS = 32

    def __init__(self, H_drift=None, H_drives=None, L_dissipators=None, *, params=None,
                 materialize_superops=None):
        super().__init__(H_drift, H_drives, params=params)
        Ls = [] if L_dissipators is None else L_dissipators
        if isinstance(Ls, (list, tuple)):
            Ls = (np.stack([np.asarray(L, dtype=np.complex128) for L in Ls]) if len(Ls)
                  else np.zeros((0, self.levels, self.levels), dtype=np.complex128))
        self.L_dissipators = np.asarray(Ls, dtype=np.complex128)
        if materialize_superops is None:
            materialize_superops = self.levels <= self.SUPEROP_MAX_LEVELS
        self.D_drift = self.D_drives = None
        if materialize_superops:
            n2 = 2 * self.levels**2
            self.D_drift = iso_D(self.H_drift, list(self.L_dissipators))
            self.D_drives = (np.stack([iso_D(H, []) for H in self.H_drives]) if self.n_drives
                             else np.zeros((0, n2, n2)))
        self._on = {}

    def _tensors(self, dtype, device):
        """(D_drift, D_drives, H_drift, H_drives, L_dissipators) on device:
        the superoperators in dtype (None where not materialized), the
        complex operators in complex128 for float64 and complex64 for
        float32."""
        key = (dtype, torch.device(device))
        if key not in self._on:
            cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
            real = dict(dtype=dtype, device=device)
            cplx = dict(dtype=cdtype, device=device)
            self._on[key] = (
                None if self.D_drift is None else torch.as_tensor(self.D_drift, **real),
                None if self.D_drives is None else torch.as_tensor(self.D_drives, **real),
                torch.as_tensor(self.H_drift, **cplx), torch.as_tensor(self.H_drives, **cplx),
                torch.as_tensor(self.L_dissipators, **cplx),
            )
        return self._on[key]

    def lindblad_generator(self, a):
        """D(a) = D_drift + sum_j a_j D_drives[j] for a (..., n_drives)
        tensor; returns (..., 2N^2, 2N^2) on a's device and dtype."""
        if self.D_drift is None:
            raise ValueError(
                f"dense superoperators were not materialized for this {self.levels}-level "
                f"system (> SUPEROP_MAX_LEVELS={self.SUPEROP_MAX_LEVELS}); use the "
                f"matrix-free lindblad_action with the expv rollout, or construct with "
                f"materialize_superops=True")
        Dd, Ds = self._tensors(a.dtype, a.device)[:2]
        if self.n_drives == 0:
            return Dd.expand(*a.shape[:-1], *Dd.shape)
        return Dd + torch.tensordot(a, Ds, dims=1)

    def lindblad_action(self, a, rho_iso_vec):
        """D(a) applied to density iso vecs (..., 2N^2) without forming the
        superoperator: -i[H(a), rho] + sum_k (L rho L^† - 1/2 {L^†L, rho})
        by N x N complex matmuls (complex128 for float64 input, complex64
        for float32), a (..., n_drives).  Returns (..., 2N^2) in the input's
        dtype."""
        v = rho_iso_vec
        N, n2 = self.levels, self.levels**2
        _, _, H, Hs, Ls = self._tensors(v.dtype, v.device)
        if self.n_drives:
            a = torch.as_tensor(a, dtype=v.dtype, device=v.device)
            H = H + torch.tensordot(a.to(H.dtype), Hs, dims=1)
        vec = torch.complex(v[..., :n2], v[..., n2:])
        rho = vec.reshape(*vec.shape[:-1], N, N).transpose(-1, -2)
        drho = -1j * (H @ rho - rho @ H)
        if Ls.shape[0]:
            LdL = torch.einsum("kji,kjl->il", Ls.conj(), Ls)
            drho = drho + torch.einsum("kij,...jl,kml->...im", Ls, rho, Ls.conj())
            drho = drho - 0.5 * (LdL @ rho + rho @ LdL)
        out = drho.transpose(-1, -2).reshape(*drho.shape[:-2], n2)
        return torch.cat([out.real, out.imag], dim=-1)
