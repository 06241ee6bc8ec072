"""Closed quantum system container.

Counterpart of quantumcollocation_tpu/quantum/systems.py::QuantumSystem.
Complex Hamiltonians and their real iso generators are host numpy; the
solver materializes the generators on its device once, at construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .isomorphisms import iso_G

__all__ = ["QuantumSystem"]


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
