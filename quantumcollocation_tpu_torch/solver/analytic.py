"""Analytic stage dynamics: defects, Jacobian blocks and defect curvature
from one propagator bank per knot, batched over instances.

Counterpart of quantumcollocation_tpu/solver/analytic.py.  The defect
kinds and their blocks:

    exponential defect   F = u_{t+1} - (I ⊗ P(θ_t)) u_t,       θ = (a, Δt)
    implicit Padé defect F = (I ⊗ D(θ_t)) u_{t+1} - (I ⊗ N(θ_t)) u_t
                             with N = q(X), D = q(-X), X = G(a)Δt
    (u is a unitary's iso vec, ncols = N columns, or an iso ket, ncols = 1)
    derivative defect    F = x_{t+1} - x_t - dx_t Δt_t          (bilinear)
    Δt-equality defect   F = Δt_{t+1} - Δt_t                    (linear)

Every function takes a (B, T, d) decision tensor in the solver's SCALED
coordinates.  Two routes to the blocks, chosen by the solver
(solver/options.py::resolve_modes): `assembly_batched` launches the fused
assembly kernel (ops/dyn_assembly.py), whose plain version is `dyn_eval`
on `banks_reference` + `defect_curvature`; or `banks_batched` launches the
propagator-bank kernel (ops/prop_bank.py) and `dyn_eval(Z, banks)` +
`defect_curvature` assemble the blocks from its banks in PyTorch.
`dyn_eval` without banks (the Jacobian blocks alone) runs banks_batched.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..dynamics import integrators as igs
from ..dynamics.expm import expm_squaring, frechet_pairs, pade_numerator_denominator
from ..ops.prop_bank import prop_bank, prop_bank_reference

__all__ = ["AnalyticStageDynamics", "build_analytic_dynamics"]


@dataclasses.dataclass(frozen=True)
class _PropGroup:
    """Integrators sharing one propagator bank."""

    kind: str  # "exp" | "pade"
    G_drift: Any  # (n, n) numpy
    G_drives: Any  # (na, n, n) numpy
    a_slice: tuple
    dt_col: int | None
    dt_static: float | None
    order: int
    num_squarings: int
    members: tuple  # of (u0, u1, r0, r1, ncols)


@dataclasses.dataclass(frozen=True)
class _DerivRow:
    x0: int
    x1: int
    dx0: int
    dx1: int
    r0: int
    r1: int
    dt_col: int | None
    dt_static: float | None


@dataclasses.dataclass(frozen=True)
class _DtEqRow:
    c0: int
    c1: int
    r0: int
    r1: int


@dataclasses.dataclass
class AnalyticStageDynamics:
    """Structured F / ∂F / λ·∂²F evaluators, optionally in the scaled
    coordinates of scale_stage_nlp (var_scale v, defect_scale r)."""

    T: int
    d: int
    s: int
    groups: tuple
    deriv_rows: tuple
    dteq_rows: tuple
    var_scale: Any = None
    defect_scale: Any = None
    _consts: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def with_scaling(self, var_scale, defect_scale):
        return dataclasses.replace(
            self, var_scale=np.asarray(var_scale), defect_scale=np.asarray(defect_scale)
        )

    def _c(self, key, value, like):
        """numpy constant -> tensor on like's device/dtype, cached."""
        k = (key, like.dtype, like.device)
        if k not in self._consts:
            self._consts[k] = torch.as_tensor(
                np.asarray(value), dtype=like.dtype, device=like.device
            )
        return self._consts[k]

    def _v(self, like):
        return None if self.var_scale is None else self._c("v", self.var_scale, like)

    def _r(self, like):
        return None if self.defect_scale is None else self._c("r", self.defect_scale, like)

    def _phys(self, Z):
        v = self._v(Z)
        return Z if v is None else Z * v

    def _dts(self, Zp, col, static):
        if col is not None:
            return Zp[:, :-1, col]
        return torch.full(Zp[:, :-1, 0].shape, static, dtype=Zp.dtype, device=Zp.device)

    def _X(self, Zp, gi, g):
        Gd = self._c(("Gd", gi), g.G_drift, Zp)
        Gs = self._c(("Gs", gi), g.G_drives, Zp)
        a = Zp[:, :-1, g.a_slice[0]:g.a_slice[1]]
        dts = self._dts(Zp, g.dt_col, g.dt_static)
        G = Gd + torch.tensordot(a, Gs, dims=1)  # (B, T-1, n, n)
        return G, Gs, dts

    def _banks(self, Z, bank_fn, second_order):
        """exp: (P, dP, d2P); pade: (N, dN, d2N, D, dD, d2D) per group, from
        bank_fn over all B*(T-1) (instance, knot) pairs at once; leading
        axes (B, T-1), derivative axis K = na [+ Δt] or the Kp pairs."""
        Zp = self._phys(Z)
        Bt, Tm1 = Zp.shape[0], self.T - 1
        out = []
        for gi, g in enumerate(self.groups):
            na = g.G_drives.shape[0]
            bank = bank_fn(
                Zp[:, :-1, g.a_slice[0]:g.a_slice[1]].reshape(-1, na),
                self._dts(Zp, g.dt_col, g.dt_static).reshape(-1),
                self._c(("Gd", gi), g.G_drift, Zp), self._c(("Gs", gi), g.G_drives, Zp),
                kind=g.kind, order=g.order, num_squarings=g.num_squarings,
                free_dt=g.dt_col is not None, second_order=second_order,
            )
            out.append(tuple(None if x is None else x.reshape(Bt, Tm1, *x.shape[1:])
                             for x in bank))
        return tuple(out)

    def banks_batched(self, Z, *, second_order: bool = True):
        """The banks of every group for scaled (B, T, d) Z: the CUDA kernel
        (ops/prop_bank.py) for a CUDA tensor, the plain version for a CPU
        one.  Feeds dyn_eval(Z, banks)."""
        return self._banks(Z, prop_bank, second_order)

    def banks_reference(self, Z, *, second_order: bool = True):
        """banks_batched through the plain version on any device: the bank
        inside the plain version of the fused assembly kernel."""
        return self._banks(Z, prop_bank_reference, second_order)

    @staticmethod
    def _umats(Zp, u0, u1, nrows):
        """iso-vec slice -> (B, T', nrows, ncols); index c*nrows + r."""
        ncols = (u1 - u0) // nrows
        return Zp[..., u0:u1].reshape(*Zp.shape[:-1], ncols, nrows).transpose(-1, -2)

    @staticmethod
    def _vec(M):
        return M.transpose(-1, -2).reshape(*M.shape[:-2], -1)

    # ------------------------------------------------------------------ #
    def _defect_rows(self, Zp, banks):
        """(B, T-1, s) defects in physical units."""
        F = Zp.new_zeros(Zp.shape[0], self.T - 1, self.s)
        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            for (u0, u1, r0, r1, ncols) in g.members:
                U = self._umats(Zp, u0, u1, nrows)
                if g.kind == "exp":
                    resid = U[:, 1:] - bank[0] @ U[:, :-1]
                else:
                    Dm = bank[1] if len(bank) == 2 else bank[3]
                    resid = Dm @ U[:, 1:] - bank[0] @ U[:, :-1]
                F[..., r0:r1] = self._vec(resid)
        for dr in self.deriv_rows:
            dts = self._dts(Zp, dr.dt_col, dr.dt_static)
            x = Zp[..., dr.x0:dr.x1]
            dx = Zp[:, :-1, dr.dx0:dr.dx1]
            F[..., dr.r0:dr.r1] = x[:, 1:] - x[:, :-1] - dx * dts[..., None]
        for er in self.dteq_rows:
            c = Zp[..., er.c0:er.c1]
            F[..., er.r0:er.r1] = c[:, 1:] - c[:, :-1]
        return F

    def defects(self, Z):
        """Scaled defects (B, T-1, s) from the propagator alone."""
        Zp = self._phys(Z)
        banks = []
        for gi, g in enumerate(self.groups):
            G, _, dts = self._X(Zp, gi, g)
            X = G * dts[..., None, None]
            if g.kind == "exp":
                banks.append((expm_squaring(X, order=g.order, num_squarings=g.num_squarings),))
            else:
                banks.append(pade_numerator_denominator(X, g.order))
        F = self._defect_rows(Zp, banks)
        r = self._r(F)
        return F if r is None else F * r

    def dyn_eval(self, Z, banks=None, *, second_order: bool = True):
        """(F, A, B, aux): scaled defects and Jacobian blocks
        (B, T-1, s, d); aux feeds defect_curvature.  banks: those of
        banks_batched(Z) or banks_reference(Z), else banks_batched runs
        here."""
        Zp = self._phys(Z)
        Bt, Tm1, d, s = Z.shape[0], self.T - 1, self.d, self.s
        if banks is None:
            banks = self.banks_batched(Z, second_order=second_order)
        F = self._defect_rows(Zp, banks)
        A = Zp.new_zeros(Bt, Tm1, s, d)
        Bj = Zp.new_zeros(Bt, Tm1, s, d)
        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            na = g.G_drives.shape[0]
            a0, a1 = g.a_slice
            for (u0, u1, r0, r1, ncols) in g.members:
                eye_c = torch.eye(ncols, dtype=Z.dtype, device=Z.device)
                U = self._umats(Zp, u0, u1, nrows)
                if g.kind == "exp":
                    P, dP, _ = bank
                    cols = -torch.einsum("btkij,btjc->btkci", dP, U[:, :-1])
                    A_state, B_state = -P, None
                else:
                    Nm, dN, _, Dm, dD, _ = bank
                    cols = torch.einsum("btkij,btjc->btkci", dD, U[:, 1:]) - torch.einsum(
                        "btkij,btjc->btkci", dN, U[:, :-1]
                    )
                    A_state, B_state = -Nm, Dm
                nn = ncols * nrows
                A[..., r0:r1, u0:u1] = torch.einsum(
                    "cd,btij->btcidj", eye_c, A_state
                ).reshape(Bt, Tm1, nn, nn)
                if B_state is None:
                    Bj[..., r0:r1, u0:u1] = torch.eye(nn, dtype=Z.dtype, device=Z.device)
                else:
                    Bj[..., r0:r1, u0:u1] = torch.einsum(
                        "cd,btij->btcidj", eye_c, B_state
                    ).reshape(Bt, Tm1, nn, nn)
                cols = cols.reshape(Bt, Tm1, cols.shape[2], nn)
                A[..., r0:r1, a0:a1] = cols[:, :, :na].transpose(-1, -2)
                if g.dt_col is not None:
                    A[..., r0:r1, g.dt_col] = cols[:, :, na]
        for dr in self.deriv_rows:
            eye_k = torch.eye(dr.x1 - dr.x0, dtype=Z.dtype, device=Z.device)
            dts = self._dts(Zp, dr.dt_col, dr.dt_static)
            A[..., dr.r0:dr.r1, dr.x0:dr.x1] = -eye_k
            A[..., dr.r0:dr.r1, dr.dx0:dr.dx1] = -eye_k * dts[..., None, None]
            if dr.dt_col is not None:
                A[..., dr.r0:dr.r1, dr.dt_col] = -Zp[:, :-1, dr.dx0:dr.dx1]
            Bj[..., dr.r0:dr.r1, dr.x0:dr.x1] = eye_k
        for er in self.dteq_rows:
            eye_k = torch.eye(er.c1 - er.c0, dtype=Z.dtype, device=Z.device)
            A[..., er.r0:er.r1, er.c0:er.c1] = -eye_k
            Bj[..., er.r0:er.r1, er.c0:er.c1] = eye_k
        r, v = self._r(Z), self._v(Z)
        if r is not None:
            F = F * r
            A = A * r[:, None]
            Bj = Bj * r[:, None]
        if v is not None:
            A = A * v
            Bj = Bj * v
        return F, A, Bj, (Zp, banks)

    def defect_curvature(self, lam, aux):
        """Curvature of -λ·F at aux's point: (Hc (B, T, d, d),
        Cc (B, T-1, d, d)), scaled units."""
        Zp, banks = aux
        Bt, Tm1, d = Zp.shape[0], self.T - 1, self.d
        r = self._r(lam)
        lam_p = lam if r is None else lam * r
        Hc = Zp.new_zeros(Bt, self.T, d, d)
        Cc = Zp.new_zeros(Bt, Tm1, d, d)
        Hk = Hc[:, :-1]
        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            na = g.G_drives.shape[0]
            a0, a1 = g.a_slice
            free = g.dt_col is not None
            pairs = frechet_pairs(na + (1 if free else 0))
            theta_cols = list(range(a0, a1)) + ([g.dt_col] if free else [])
            for (u0, u1, r0, r1, ncols) in g.members:
                U = self._umats(Zp, u0, u1, nrows)
                nn = ncols * nrows
                Lam = lam_p[..., r0:r1].reshape(Bt, Tm1, ncols, nrows).transpose(-1, -2)
                W0 = torch.einsum("btrc,btsc->btrs", Lam, U[:, :-1])
                if g.kind == "exp":
                    _, dP, d2P = bank
                    h = torch.einsum("btpij,btij->btp", d2P, W0)
                    m_t = torch.einsum("btkrs,btrc->btkcs", dP, Lam).reshape(Bt, Tm1, -1, nn)
                    m_tp1 = None
                else:
                    _, dN, d2N, _, dD, d2D = bank
                    W1 = torch.einsum("btrc,btsc->btrs", Lam, U[:, 1:])
                    h = torch.einsum("btpij,btij->btp", d2N, W0) - torch.einsum(
                        "btpij,btij->btp", d2D, W1
                    )
                    m_t = torch.einsum("btkrs,btrc->btkcs", dN, Lam).reshape(Bt, Tm1, -1, nn)
                    m_tp1 = -torch.einsum("btkrs,btrc->btkcs", dD, Lam).reshape(
                        Bt, Tm1, -1, nn
                    )
                for p, (k, l) in enumerate(pairs):
                    ck, cl = theta_cols[k], theta_cols[l]
                    Hk[:, :, ck, cl] += h[..., p]
                    if ck != cl:
                        Hk[:, :, cl, ck] += h[..., p]
                Hk[:, :, u0:u1, a0:a1] += m_t[:, :, :na].transpose(-1, -2)
                Hk[:, :, a0:a1, u0:u1] += m_t[:, :, :na]
                if free:
                    Hk[:, :, u0:u1, g.dt_col] += m_t[:, :, na]
                    Hk[:, :, g.dt_col, u0:u1] += m_t[:, :, na]
                if m_tp1 is not None:
                    Cc[:, :, a0:a1, u0:u1] += m_tp1[:, :, :na]
                    if free:
                        Cc[:, :, g.dt_col, u0:u1] += m_tp1[:, :, na]
        for dr in self.deriv_rows:
            if dr.dt_col is None:
                continue
            lam_rows = lam_p[..., dr.r0:dr.r1]
            Hk[:, :, dr.dx0:dr.dx1, dr.dt_col] += lam_rows
            Hk[:, :, dr.dt_col, dr.dx0:dr.dx1] += lam_rows
        v = self._v(Zp)
        if v is not None:
            vv = v[:, None] * v[None, :]
            Hc = Hc * vv
            Cc = Cc * vv
        return Hc, Cc

    def assembly_batched(self, Z, lam):
        """Fused F/A/B/Hc/Cc for scaled (B, T, d) Z and (B, T-1, s) lam:
        the CUDA kernel for a CUDA tensor, its plain version on the CPU."""
        from ..ops.dyn_assembly import dyn_assembly

        return dyn_assembly(self, Z, lam)


def build_analytic_dynamics(traj, integrators, d_aug: int):
    """Compile an integrator list into AnalyticStageDynamics, or None if an
    integrator has no analytic assembly."""
    tname = traj.timestep if isinstance(traj.timestep, str) else None

    def dt_spec(ig):
        name = getattr(ig, "timestep_name", None) or tname
        if name is not None and name in traj.components:
            return traj.components[name][0], None
        return None, float(traj.timestep)

    groups: dict = {}
    deriv_rows, dteq_rows = [], []
    r0 = 0
    for ig in integrators:
        r1 = r0 + ig.defect_dim(traj)
        kind = (
            "exp" if isinstance(ig, (igs.UnitaryExponentialIntegrator,
                                     igs.QuantumStateExponentialIntegrator))
            else "pade" if isinstance(ig, (igs.UnitaryPadeIntegrator,
                                           igs.QuantumStatePadeIntegrator))
            else None
        )
        if kind is not None:
            u0, u1 = traj.components[ig.state_name]
            a0, a1 = traj.components[ig.control_name]
            dt_col, dt_static = dt_spec(ig)
            sysm = ig.system
            nsq = getattr(ig, "num_squarings", 0) or 0
            key = (kind, id(sysm), (a0, a1), dt_col, dt_static, ig.order, nsq)
            nrows = 2 * sysm.levels
            if (u1 - u0) % nrows != 0:
                return None
            member = (u0, u1, r0, r1, (u1 - u0) // nrows)
            if key in groups:
                groups[key]["members"].append(member)
            else:
                groups[key] = dict(
                    kind=kind,
                    G_drift=np.asarray(sysm.G_drift),
                    G_drives=np.asarray(sysm.G_drives).reshape(sysm.n_drives, nrows, nrows),
                    a_slice=(a0, a1),
                    dt_col=dt_col,
                    dt_static=dt_static,
                    order=ig.order,
                    num_squarings=nsq,
                    members=[member],
                )
        elif isinstance(ig, igs.DerivativeIntegrator):
            x0, x1 = traj.components[ig.x_name]
            dx0, dx1 = traj.components[ig.dx_name]
            deriv_rows.append(_DerivRow(x0, x1, dx0, dx1, r0, r1, *dt_spec(ig)))
        elif isinstance(ig, igs.TimeStepEqualityIntegrator):
            c0, c1 = traj.components[ig.timestep_name]
            dteq_rows.append(_DtEqRow(c0, c1, r0, r1))
        else:
            return None
        r0 = r1
    return AnalyticStageDynamics(
        T=traj.T,
        d=d_aug,
        s=r0,
        groups=tuple(
            _PropGroup(**{**v, "members": tuple(v["members"])}) for v in groups.values()
        ),
        deriv_rows=tuple(deriv_rows),
        dteq_rows=tuple(dteq_rows),
    )
