"""Padé polynomials and matrix exponentials with static structure, batched.

Counterpart of quantumcollocation_tpu/dynamics/expm.py.  Every function
takes matrices with any leading batch axes, (..., n, n); the squaring count
is a Python int, so each call is a fixed chain of batched matmuls.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "pade_coefficients",
    "pade_numerator_denominator",
    "expm_pade",
    "expm_squaring",
    "expm_taylor",
    "default_num_squarings",
    "frechet_pairs",
    "pade_poly_frechet",
    "expm_frechet_bank",
]


def pade_coefficients(order: int):
    """Coefficients c_k of the [m/m] Padé numerator q_m(X) = sum c_k X^k,
    m = order / 2."""
    if order % 2 != 0:
        raise ValueError("pade order must be even")
    m = order // 2
    return tuple(
        math.factorial(2 * m - k) * math.factorial(m)
        / (math.factorial(2 * m) * math.factorial(k) * math.factorial(m - k))
        for k in range(m + 1)
    )


def _eye_like(X):
    return torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)


def _polyval_matrix(coeffs, X):
    eye = _eye_like(X)
    acc = coeffs[-1] * eye.expand_as(X)
    for c in reversed(coeffs[:-1]):
        acc = X @ acc + c * eye
    return acc


def pade_numerator_denominator(X, order: int = 4):
    """(N, D) with exp(X) ≈ D^{-1} N: N = q(X), D = q(-X)."""
    coeffs = pade_coefficients(order)
    num = _polyval_matrix(coeffs, X)
    den = _polyval_matrix(
        tuple(c * (-1.0) ** k for k, c in enumerate(coeffs)), X
    )
    return num, den


def expm_pade(X, order: int = 8):
    """Single-step diagonal Padé approximant of exp(X)."""
    N, D = pade_numerator_denominator(X, order)
    return torch.linalg.solve(D, N)


def default_num_squarings(norm_bound: float, order: int = 8) -> int:
    """Static squaring count with ||X|| / 2^s <= 0.5."""
    if norm_bound <= 0.5:
        return 0
    return max(0, math.ceil(math.log2(norm_bound / 0.5)))


def expm_squaring(X, order: int = 8, num_squarings: int = 4):
    """exp(X) by scaling and squaring with a static squaring count."""
    P = expm_pade(X * 2.0 ** (-num_squarings), order=order)
    for _ in range(num_squarings):
        P = P @ P
    return P


def expm_taylor(X, degree: int = 18, num_squarings: int = 6):
    """exp(X) by a degree-`degree` Taylor polynomial (Horner) of X 2^-s,
    then s squarings: matmuls only, so torch.func's vmap of a Hessian
    through it stays exact (it has no linear solve, whose batched
    forward-mode derivative returns NaN for all but the first instance in
    torch 2.13 on the CPU).  Degree 18 with 6 squarings is within float64
    rounding of scipy's expm for ||X|| up to 60
    (scripts/free_phase_expm_probe.py)."""
    Xs = X * 2.0 ** (-num_squarings)
    eye = _eye_like(X)
    P = eye.expand_as(X)
    for k in range(degree, 0, -1):
        P = eye + (Xs @ P) / k
    for _ in range(num_squarings):
        P = P @ P
    return P


def frechet_pairs(K: int):
    """Canonical (k, l), k <= l, ordering of second-derivative pairs."""
    return tuple((k, l) for k in range(K) for l in range(k, K))


def pade_poly_frechet(X, dX, d2X=None, *, order: int = 4, second_order: bool = True):
    """N = q(X), D = q(-X) with first and second directional derivatives.

    X (..., n, n); dX (..., K, n, n); d2X (..., Kp, n, n) in frechet_pairs
    order or None (X linear in θ).  Returns (N, dN, d2N, D, dD, d2D); the
    second-order entries are None when second_order is False.
    """
    K = dX.shape[-3]
    pairs = frechet_pairs(K)
    coeffs = pade_coefficients(order)
    eye = _eye_like(X)

    def horner(sign):
        Xe = sign * X
        dXe = sign * dX
        acc = coeffs[-1] * eye.expand_as(X)
        dacc = torch.zeros_like(dX)
        d2acc = (
            dX.new_zeros(*dX.shape[:-3], len(pairs), *dX.shape[-2:])
            if second_order
            else None
        )
        Xk = Xe.unsqueeze(-3)
        for c in reversed(coeffs[:-1]):
            if second_order:
                new = Xk @ d2acc
                if d2X is not None:
                    new = new + sign * d2X @ acc.unsqueeze(-3)
                cross = torch.stack(
                    [
                        dXe[..., k, :, :] @ dacc[..., l, :, :]
                        + dXe[..., l, :, :] @ dacc[..., k, :, :]
                        for (k, l) in pairs
                    ],
                    dim=-3,
                )
                d2acc = new + cross
            dacc = dXe @ acc.unsqueeze(-3) + Xk @ dacc
            acc = Xe @ acc + c * eye
        return acc, dacc, d2acc

    N, dN, d2N = horner(1.0)
    D, dD, d2D = horner(-1.0)
    return N, dN, d2N, D, dD, d2D


def expm_frechet_bank(
    X, dX, d2X=None, *, order: int = 8, num_squarings: int = 4,
    second_order: bool = True,
):
    """exp(X) with first and second directional derivatives in one
    scaling-and-squaring pass.  Shapes as pade_poly_frechet; returns
    (P, dP, d2P), d2P None when second_order is False."""
    K = dX.shape[-3]
    pairs = frechet_pairs(K)
    scale = 2.0 ** (-num_squarings)
    N, dN, d2N, D, dD, d2D = pade_poly_frechet(
        X * scale, dX * scale,
        d2X * scale if (second_order and d2X is not None) else None,
        order=order, second_order=second_order,
    )
    Dinv = torch.linalg.inv(D)
    P = Dinv @ N
    dP = Dinv.unsqueeze(-3) @ (dN - dD @ P.unsqueeze(-3))
    d2P = None
    if second_order:
        t = d2N - d2D @ P.unsqueeze(-3)
        cross = torch.stack(
            [
                dD[..., k, :, :] @ dP[..., l, :, :]
                + dD[..., l, :, :] @ dP[..., k, :, :]
                for (k, l) in pairs
            ],
            dim=-3,
        )
        d2P = Dinv.unsqueeze(-3) @ (t - cross)
    for _ in range(num_squarings):
        if second_order:
            Pk = P.unsqueeze(-3)
            cross = torch.stack(
                [
                    dP[..., k, :, :] @ dP[..., l, :, :]
                    + dP[..., l, :, :] @ dP[..., k, :, :]
                    for (k, l) in pairs
                ],
                dim=-3,
            )
            d2P = d2P @ Pk + Pk @ d2P + cross
        dP = dP @ P.unsqueeze(-3) + P.unsqueeze(-3) @ dP
        P = P @ P
    return P, dP, d2P
