"""Real isomorphisms of complex quantum objects.

Counterpart of quantumcollocation_tpu/quantum/isomorphisms.py (ket,
unitary and generator parts).  Layouts:

- ket psi (N,) -> [Re psi; Im psi] (2N,)
- unitary U (N, N) -> iso operator [Re U; Im U] (2N, N) -> iso vec of its
  columns, iso_vec[c*2N + r] = [Re U; Im U][r, c]
- G(H) = [[Im H, Re H], [-Re H, Im H]], the real generator of -i H

Functions take numpy arrays and return numpy (problem construction), or
torch tensors and return torch (the solver path), by the input type.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ket_to_iso",
    "iso_to_ket",
    "operator_to_iso_operator",
    "iso_operator_to_operator",
    "iso_operator_to_iso_vec",
    "iso_vec_to_iso_operator",
    "operator_to_iso_vec",
    "iso_vec_to_operator",
    "iso_G",
]


def _cat(xs, axis):
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs, dim=axis)
    return np.concatenate(xs, axis=axis)


def _swap(x):
    if isinstance(x, torch.Tensor):
        return x.transpose(-1, -2)
    return np.swapaxes(x, -1, -2)


def ket_to_iso(psi):
    """Complex ket (..., N) -> real iso vector (..., 2N) = [Re; Im]."""
    if not isinstance(psi, torch.Tensor):
        psi = np.asarray(psi)
    return _cat([psi.real, psi.imag], -1)


def iso_to_ket(psi_iso):
    """Real iso vector (..., 2N) -> complex ket (..., N)."""
    n = psi_iso.shape[-1] // 2
    return psi_iso[..., :n] + 1j * psi_iso[..., n:]


def operator_to_iso_operator(U):
    """Complex (N, N) -> real (2N, N) iso operator [Re U; Im U]."""
    if not isinstance(U, torch.Tensor):
        U = np.asarray(U)
    return _cat([U.real, U.imag], -2)


def iso_operator_to_operator(U_iso):
    """Real (2N, N) iso operator -> complex (N, N)."""
    n = U_iso.shape[-2] // 2
    return U_iso[..., :n, :] + 1j * U_iso[..., n:, :]


def iso_operator_to_iso_vec(U_iso):
    """(2N, N) iso operator -> flat (2N*N,) iso vec (column-major stack)."""
    return _swap(U_iso).reshape(*U_iso.shape[:-2], -1)


def iso_vec_to_iso_operator(v):
    """Flat (2N*N,) iso vec -> (2N, N) iso operator."""
    n = int(round((v.shape[-1] / 2) ** 0.5))
    return _swap(v.reshape(*v.shape[:-1], n, 2 * n))


def operator_to_iso_vec(U):
    """Complex (N, N) -> flat real (2N^2,) iso vec."""
    return iso_operator_to_iso_vec(operator_to_iso_operator(U))


def iso_vec_to_operator(v):
    """Flat real (2N^2,) iso vec -> complex (N, N)."""
    return iso_operator_to_operator(iso_vec_to_iso_operator(v))


def iso_G(H):
    """Hamiltonian -> real iso generator of -i H (host numpy)."""
    H = np.asarray(H)
    A, B = H.real, H.imag
    top = np.concatenate([B, A], axis=-1)
    bot = np.concatenate([-A, B], axis=-1)
    return np.concatenate([top, bot], axis=-2)
