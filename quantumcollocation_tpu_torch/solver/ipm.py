"""Batched primal-dual interior-point method over stage-structured NLPs.

Counterpart of quantumcollocation_tpu/solver/ipm.py, main-path subset:
every tensor carries a leading batch axis (B, ...), and instances advance
in lockstep with per-instance convergence masks (a converged instance
freezes).  One iteration (`_step`):

  1. the dynamics blocks: with the fused assembly on (small stage sizes,
     exact Hessian; solver/options.py::resolve_modes) one kernel
     (ops/dyn_assembly.py) gives F, A, B and the defect curvature; off,
     the propagator-bank kernel (ops/prop_bank.py) gives the banks and
     solver/analytic.py assembles the blocks from them.  torch.func gives
     the cost blocks.  With eval_hessian=False (quasi_newton="lbfgs") the
     bank runs first order, and the Hessian is the compact L-BFGS
     σI - U M⁻¹ Uᵀ (solver/lbfgs.py), its memory updated from the last
     step's pair (∇L at both points with the current multipliers);
  2. residuals, the KKT error, the monotone barrier update and the
     feasibility-restoration state machine (Ipopt A-9 analog; off under
     L-BFGS, as in JAX);
  3. the condensed block-tridiagonal KKT system goes through the Riccati
     sweep kernels (solver/kkt_lanes.py), with per-instance δ_w
     regularization retries while an instance's factorization fails.
     With kkt_refine passes, each attempt keeps its factors and corrects
     its step by iterative refinement: the residual of the regularized
     system at (dz, ν) re-solved against the same factors (the rhs-only
     forward sweep, then the backward sweep).  Under L-BFGS the σI +
     barrier base and the 13-column right-hand side [rz | U] go through
     one sweep pair and Sherman-Morrison-Woodbury adds the low-rank part.
     kkt_backend="lanes_scan" solves through the per-knot step kernels
     instead (2(T-1) launches per attempt), and refines, when kkt_refine
     asks for it, through a fresh scan solve;
  4. fraction-to-boundary, a filter or merit line search, and the update
     with Ipopt's κ_Σ bound-dual safeguard.

The JAX solve is one lax.while_loop on the device.  Here the loop runs in
Python; each iteration synchronizes with the host once, to read "did every
factorization succeed" and "had every instance converged" together (a
retry adds one more).  The line search evaluates all backtracking
candidates in one batched pass and picks the first acceptable one per
instance, which gives the sequential loop's result without a host read per
trial.

Not ported yet (the solver raises NotImplementedError): stage inequality
rows (m > 0) and with them the ρJᵀJ lift and retry warm start, second-order
correction, recalc_y, Gauss-Newton Hessians, the watchdog, adaptive μ, and
the cyclic-reduction KKT backend.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .kkt_lanes import resolve_kkt_lanes, solve_kkt_lanes, solve_kkt_lanes_scan
from .lbfgs import lbfgs_compact, lbfgs_rhs, lbfgs_update
from .options import SolverOptions, resolve_modes
from .stage_nlp import StageNLP, jt_blocks, make_nlp_functions, scale_stage_nlp

__all__ = ["IPMState", "IPMResult", "InteriorPointSolver"]

_BIG = 1e20


@dataclasses.dataclass
class IPMState:
    Z: Any  # (B, T, d)
    lam: Any  # (B, T-1, s)
    zl: Any  # (B, T, d)
    zu: Any  # (B, T, d)
    mu: Any  # (B,)
    delta_w: Any  # (B,)
    converged: Any  # (B,) bool
    n_iter: Any  # (B,) int32
    kkt_err: Any  # (B,)
    alpha: Any  # (B,) accepted primal step
    e_dual: Any
    e_pr: Any
    e_comp: Any
    ls_k: Any  # (B,) line-search trials used
    reg_dw: Any  # (B,) δ_w of the accepted factorization
    alpha_du: Any
    d_norm: Any
    acc_count: Any  # (B,) consecutive E0 <= acceptable_tol
    # filter line search (None with the merit line search)
    flt_theta: Any = None  # (B, Fs), +inf = empty slot
    flt_phi: Any = None
    flt_ptr: Any = None  # (B,) ring pointer
    theta_ref: Any = None  # (B,) max(1, theta_0)
    # limited-memory BFGS (None unless quasi_newton == "lbfgs")
    qn_S: Any = None  # (B, mem, T*d) step history (chronological)
    qn_Y: Any = None  # (B, mem, T*d) Lagrangian-gradient differences
    qn_sty: Any = None  # (B, mem) s_i^T y_i
    qn_count: Any = None  # (B,) int32 valid pairs
    qn_prevZ: Any = None  # (B, T, d) previous iterate
    qn_sigma: Any = None  # (B,) B0 = σI scaling
    # feasibility restoration (None when off)
    ls_fail: Any = None
    stall_count: Any = None
    in_resto: Any = None
    resto_zR: Any = None
    resto_theta0: Any = None
    resto_k: Any = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class IPMResult(NamedTuple):
    Z: Any
    lam: Any
    converged: Any
    n_iter: Any
    kkt_err: Any
    mu: Any
    objective: Any


class _Aux(NamedTuple):
    F: Any
    mu: Any
    tau: Any
    sl: Any
    su: Any
    Sig_l: Any
    Sig_u: Any
    E0: Any
    E_dual: Any
    E_pr: Any
    E_comp0: Any
    now_converged: Any
    gcost: Any
    mu_changed: Any
    in_resto: Any = None
    resto_zR: Any = None
    stall_count: Any = None
    resto_theta0: Any = None
    resto_k: Any = None
    qn: Any = None  # L-BFGS: the updated memory (dict of IPMState fields)
    lowrank: Any = None  # L-BFGS: (U (B, n, 2m), M (B, 2m, 2m))


def _bmax(x, initial=None):
    """Per-instance max over all non-batch axes."""
    m = x.flatten(1).amax(1) if x[0].numel() else x.new_full((x.shape[0],), -np.inf)
    return m if initial is None else torch.clamp_min(m, initial)


def _bsum(x):
    return x.flatten(1).sum(1)


def _col(v, ndim):
    """(B,) -> (B, 1, ..., 1) broadcastable against an ndim tensor."""
    return v.reshape(-1, *([1] * (ndim - 1)))


class InteriorPointSolver:
    """Batched IPM for one StageNLP structure."""

    def __init__(self, nlp: StageNLP, options: SolverOptions | None = None,
                 exact_hessian: bool = True):
        o = options or SolverOptions()
        self.options = o
        self.exact_hessian = exact_hessian
        unsupported = {
            "eval_hessian=False with quasi_newton='gauss-newton'": (
                not exact_hessian and o.quasi_newton != "lbfgs"
            ),
            "stage inequality rows (m > 0)": nlp.m > 0,
            "mu_strategy='adaptive'": o.mu_strategy != "monotone",
            "soc=True": bool(o.soc),
            "watchdog_trials > 0": o.watchdog_trials > 0,
            "recalc_y=True": bool(o.recalc_y),
            f"kkt_backend={o.kkt_backend!r}": o.kkt_backend == "cr",
            "kkt_aug=True": o.kkt_aug is True,
            "kkt_retry_warm=True": o.kkt_retry_warm is True,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError("not ported yet: " + ", ".join(bad))
        self.qn_lbfgs = not exact_hessian
        self.scan = o.kkt_backend == "lanes_scan"
        if self.qn_lbfgs and self.scan:
            raise ValueError(
                "kkt_backend='lanes_scan' (the per-knot backend) supports exact Hessians "
                "only; use kkt_backend='lanes' or 'xla' with quasi_newton='lbfgs'"
            )
        # L-BFGS: no restoration, and no refinement (the SMW-combined step
        # keeps no factors), as in JAX
        self.resto_on = bool(o.restoration) and not self.qn_lbfgs
        self.fused_assembly_on, self.kkt_refine_n = resolve_modes(
            o, nlp.d, nlp.s,
            has_groups=nlp.analytic is not None and len(nlp.analytic.groups) > 0,
            exact_hessian=exact_hessian,
        )
        if self.qn_lbfgs:
            self.kkt_refine_n = 0
        self.kkt_attempts = 0  # KKT attempts since the last solve began
        self.device, self.dtype = nlp.device, nlp.dtype
        self.var_scale = np.ones(nlp.d)
        self.defect_scale = np.ones(nlp.s)
        self.obj_scale = 1.0
        self.nlp = self._build_scaled_nlp(nlp) if o.nlp_scaling else nlp
        self.funcs = make_nlp_functions(self.nlp)
        n = self.nlp
        lb = np.asarray(n.lb, dtype=np.float64)
        ub = np.asarray(n.ub, dtype=np.float64)
        free = np.asarray(n.free_mask, dtype=np.float64)
        has_lb = (np.isfinite(lb) & (free > 0)).astype(np.float64)
        has_ub = (np.isfinite(ub) & (free > 0)).astype(np.float64)
        self._n_bounds = int(has_lb.sum() + has_ub.sum())
        t = dict(dtype=self.dtype, device=self.device)
        self._free = torch.as_tensor(free, **t)
        self._has_lb = torch.as_tensor(has_lb, **t)
        self._has_ub = torch.as_tensor(has_ub, **t)
        self._lb = torch.as_tensor(np.where(np.isfinite(lb), lb, -_BIG), **t)
        self._ub = torch.as_tensor(np.where(np.isfinite(ub), ub, _BIG), **t)
        self._v = torch.as_tensor(self.var_scale, **t)
        self._eye = torch.eye(n.d, **t)
        self._tiny = 1e-100 if self.dtype == torch.float64 else 1e-30

    # ------------------------------------------------------------------ #
    def _build_scaled_nlp(self, nlp: StageNLP) -> StageNLP:
        """Ipopt-style gradient scaling plus Jacobian-column variable
        scaling, computed once at the initial point."""
        f0 = make_nlp_functions(nlp)
        z0 = torch.as_tensor(np.asarray(nlp.z0), dtype=nlp.dtype, device=nlp.device)[None]
        A, B = f0.jac_blocks(z0)
        gphi = f0.grad_cost(z0)[0]
        A = np.abs(A[0].double().cpu().numpy())
        B = np.abs(B[0].double().cpu().numpy())
        free = np.asarray(nlp.free_mask, dtype=np.float64)
        col = np.maximum(A.max(axis=(0, 1)), B.max(axis=(0, 1))) * (free.max(axis=0) > 0)
        v = 1.0 / np.maximum(1.0, col)
        rowA = (A * v[None, None, :]).max(axis=(0, 2))
        rowB = (B * v[None, None, :]).max(axis=(0, 2))
        r = 1.0 / np.maximum(1.0, np.maximum(rowA, rowB))
        gmax = float(np.max(np.abs(gphi.double().cpu().numpy()) * v[None, :]))
        self.var_scale = v
        self.defect_scale = r
        self.obj_scale = 100.0 / max(100.0, gmax)
        return scale_stage_nlp(nlp, v, r, self.obj_scale)

    def unscale(self, Z):
        """Solver (scaled) coordinates -> problem units."""
        return np.asarray(Z) * self.var_scale

    # ------------------------------------------------------------------ #
    def init_state(self, Z0) -> IPMState:
        """Z0: (B, T, d) initial decisions in PROBLEM units."""
        o, nlp = self.options, self.nlp
        Z0 = Z0 if torch.is_tensor(Z0) else torch.as_tensor(np.array(Z0))
        Z0 = Z0.to(device=self.device, dtype=self.dtype)
        if Z0.ndim != 3:
            raise ValueError(f"Z0 must be (batch, T, d), got shape {tuple(Z0.shape)}")
        if o.nlp_scaling:
            Z0 = Z0 / self._v
        Bt = Z0.shape[0]
        lb, ub, has_lb, has_ub = self._lb, self._ub, self._has_lb, self._has_ub
        # push strictly inside the bounds (Ipopt kappa_1 = 1e-2)
        width = torch.where(has_lb * has_ub > 0, ub - lb, torch.ones_like(lb))
        pert = 1e-2 * torch.minimum(torch.clamp_min(lb.abs(), 1.0), width)
        pert_u = 1e-2 * torch.minimum(torch.clamp_min(ub.abs(), 1.0), width)
        zlo = torch.where(has_lb > 0, lb + pert, torch.full_like(lb, -_BIG))
        zhi = torch.where(has_ub > 0, ub - pert_u, torch.full_like(ub, _BIG))
        Z = torch.where(self._free > 0, torch.minimum(torch.maximum(Z0, zlo), zhi), Z0)

        # least-squares initial multipliers: the saddle solve with H = I,
        # C = 0; discarded when absurdly large
        free = self._free
        A, Bj = self.funcs.jac_blocks(Z)
        A = A * free[:-1, None, :]
        Bj = Bj * free[1:, None, :]
        gphi = self.funcs.grad_cost(Z) * free
        H = self._eye.expand(Bt, nlp.T, nlp.d, nlp.d).contiguous()
        Cz = Z.new_zeros(Bt, nlp.T - 1, nlp.d, nlp.d)
        _, nu, ok = (solve_kkt_lanes_scan if self.scan else solve_kkt_lanes)(
            H, Cz, A.contiguous(), Bj.contiguous(), gphi.contiguous(),
            Z.new_zeros(Bt, nlp.T - 1, nlp.s), 1e-8,
        )
        lam = torch.where(_col(ok, 3), nu, torch.zeros_like(nu))
        lam = torch.where(_col(_bmax(lam.abs()) > 1e3, 3), torch.zeros_like(lam), lam)

        zeros = lambda: Z.new_zeros(Bt)  # noqa: E731
        izeros = lambda: torch.zeros(Bt, dtype=torch.int32, device=self.device)  # noqa: E731
        extra = {}
        if o.line_search == "filter":
            theta0 = _bsum(self.funcs.defects(Z).abs())
            extra.update(
                flt_theta=Z.new_full((Bt, o.filter_size), float("inf")),
                flt_phi=Z.new_full((Bt, o.filter_size), float("inf")),
                flt_ptr=izeros(),
                theta_ref=torch.clamp_min(theta0, 1.0),
            )
        if self.qn_lbfgs:
            mem, n = o.lbfgs_memory, nlp.T * nlp.d
            extra.update(
                qn_S=Z.new_zeros(Bt, mem, n), qn_Y=Z.new_zeros(Bt, mem, n),
                qn_sty=Z.new_zeros(Bt, mem), qn_count=izeros(),
                qn_prevZ=Z.clone(),  # the first pair (s = 0) is skipped
                qn_sigma=Z.new_ones(Bt),
            )
        if self.resto_on:
            extra.update(
                ls_fail=torch.zeros(Bt, dtype=torch.bool, device=self.device),
                stall_count=izeros(),
                in_resto=torch.zeros(Bt, dtype=torch.bool, device=self.device),
                resto_zR=Z.clone(),
                resto_theta0=zeros(),
                resto_k=izeros(),
            )
        return IPMState(
            Z=Z, lam=lam,
            zl=has_lb.expand_as(Z).clone(), zu=has_ub.expand_as(Z).clone(),
            mu=Z.new_full((Bt,), o.mu_init), delta_w=zeros(),
            converged=torch.zeros(Bt, dtype=torch.bool, device=self.device),
            n_iter=izeros(), kkt_err=Z.new_full((Bt,), float("inf")),
            alpha=zeros(), e_dual=zeros(), e_pr=zeros(), e_comp=zeros(),
            ls_k=izeros(), reg_dw=zeros(), alpha_du=zeros(), d_norm=zeros(),
            acc_count=izeros(), **extra,
        )

    # ------------------------------------------------------------------ #
    def _iteration_pre(self, st: IPMState):
        o, nlp = self.options, self.nlp
        T, s = nlp.T, nlp.s
        Z, lam, zl, zu, mu = st.Z, st.lam, st.zl, st.zu, st.mu
        free, has_lb, has_ub = self._free, self._has_lb, self._has_ub
        one = torch.ones_like(Z)
        sl = torch.where(has_lb > 0, torch.clamp_min(Z - self._lb, self._tiny), one)
        su = torch.where(has_ub > 0, torch.clamp_min(self._ub - Z, self._tiny), one)

        an = self.nlp.analytic
        if self.fused_assembly_on:
            F, A, Bj, Hc, Cc = an.assembly_batched(Z, lam)
        else:
            banks = an.banks_batched(Z, second_order=self.exact_hessian)
            F, A, Bj, dyn_aux = an.dyn_eval(Z, banks)
            if self.exact_hessian:
                Hc, Cc = an.defect_curvature(lam, dyn_aux)
        gcost = self.funcs.grad_cost(Z)
        E_pr = _bmax(F.abs())

        resto = {}
        mu3 = _col(mu, 3)
        if self.resto_on:
            theta_cur = _bsum(F.abs())
            stall_c = torch.where(
                st.ls_fail & ~st.in_resto, st.stall_count + 1, 0
            ).to(torch.int32)
            enter = (
                ~st.in_resto & (stall_c >= o.resto_trigger)
                & (theta_cur > 1e2 * o.tol) & ~st.converged
            )
            exit_ = st.in_resto & (
                (theta_cur <= o.resto_kappa * st.resto_theta0)
                | (theta_cur <= o.tol)
                | (st.resto_k >= o.resto_max_iters)
            )
            in_resto = (st.in_resto | enter) & ~exit_
            zR = torch.where(_col(enter, 3), Z, st.resto_zR)
            resto = dict(
                in_resto=in_resto,
                resto_zR=zR,
                resto_theta0=torch.where(enter, theta_cur, st.resto_theta0),
                resto_k=torch.where(
                    in_resto, torch.where(enter, 1, st.resto_k + 1), 0
                ).to(torch.int32),
                stall_count=torch.where(enter, 0, stall_c).to(torch.int32),
            )
            resto_flip = enter | exit_
            Dr2 = 1.0 / torch.clamp_min(zR * zR, 1.0)

        jt_lam = jt_blocks(A, Bj, lam)
        gL = gcost - jt_lam
        gcost_kkt = gcost
        if self.resto_on:
            g_resto = o.resto_zeta * Dr2 * (Z - zR)
            gcost_kkt = torch.where(_col(in_resto, 3), g_resto, gcost)
        gL_kkt = gcost_kkt - jt_lam
        r_dual = (gL - has_lb * zl + has_ub * zu) * free

        n_duals = (T - 1) * s + self._n_bounds
        dual_sum = _bsum(lam.abs()) + _bsum(zl.abs() * has_lb) + _bsum(zu.abs() * has_ub)
        s_d = torch.clamp_min(dual_sum / max(n_duals, 1), 100.0) / 100.0
        E_dual = _bmax(r_dual.abs()) / s_d

        def comp_err(muv):
            e = _bmax((sl * zl - _col(muv, 3)).abs() * has_lb, 0.0)
            e = torch.maximum(e, _bmax((su * zu - _col(muv, 3)).abs() * has_ub, 0.0))
            return e / s_d

        E_comp0 = comp_err(torch.zeros_like(mu))
        E0 = torch.maximum(torch.maximum(E_dual, E_pr), E_comp0)
        now_converged = E0 <= o.tol

        # monotone (Fiacco-McCormick) barrier update
        E_mu = torch.maximum(torch.maximum(E_dual, E_pr), comp_err(mu))
        mu_new = torch.where(
            E_mu <= o.kappa_epsilon * mu,
            torch.clamp_min(torch.minimum(o.kappa_mu * mu, mu**o.theta_mu), o.tol / 10.0),
            mu,
        )
        mu_changed = mu_new != mu
        if self.resto_on:
            mu_changed = mu_changed | resto_flip
        mu = mu_new
        mu3 = _col(mu, 3)
        tau = torch.clamp_min(1.0 - mu, o.tau_min)

        # condensed KKT blocks
        qn, lowrank = None, None
        if self.qn_lbfgs:
            # insert the pair of the last transition (the same multipliers
            # at both points, as Ipopt's limited-memory mode), then
            # B = σI - U M⁻¹ Uᵀ with the low-rank part applied by SMW in
            # the KKT solve
            Bt = Z.shape[0]
            y_vec = ((gL - self.funcs.grad_lagrangian(st.qn_prevZ, lam)) * free).flatten(1)
            s_vec = ((Z - st.qn_prevZ) * free).flatten(1)
            qS, qY, qsty, qcount, sig_new, acc = lbfgs_update(
                st.qn_S, st.qn_Y, st.qn_sty, st.qn_count, s_vec, y_vec
            )
            sigma = torch.where(acc, torch.clamp(sig_new, 1e-8, 1e8), st.qn_sigma)
            qn = dict(qn_S=qS, qn_Y=qY, qn_sty=qsty, qn_count=qcount, qn_sigma=sigma)
            lowrank = lbfgs_compact(qS, qY, qsty, qcount, sigma)
            H = _col(sigma, 4) * self._eye.expand(Bt, T, nlp.d, nlp.d)
            C = Z.new_zeros(Bt, T - 1, nlp.d, nlp.d)
        else:
            H, C = self.funcs.cost_hess(Z)
            H = H + Hc
            C = C + Cc
        if self.resto_on:
            ir4 = _col(in_resto, 4)
            H = torch.where(ir4, torch.diag_embed(o.resto_zeta * Dr2), H)
            C = torch.where(ir4, torch.zeros_like(C), C)
        Sig_l = torch.where(has_lb > 0, zl / sl, torch.zeros_like(Z))
        Sig_u = torch.where(has_ub > 0, zu / su, torch.zeros_like(Z))
        H = H + torch.diag_embed(Sig_l + Sig_u)
        Mf = free
        H = H * Mf[:, :, None] * Mf[:, None, :] + torch.diag_embed(1.0 - Mf)
        C = C * Mf[:-1, :, None] * Mf[1:, None, :]
        A = A * Mf[:-1, None, :]
        Bj = Bj * Mf[1:, None, :]
        zero = torch.zeros_like(Z)
        r_z = (
            gL_kkt
            - torch.where(has_lb > 0, mu3 / sl, zero)
            + torch.where(has_ub > 0, mu3 / su, zero)
        ) * free
        kkt_in = (H, C, A, Bj, -r_z, -F)
        aux = _Aux(
            F=F, mu=mu, tau=tau, sl=sl, su=su, Sig_l=Sig_l, Sig_u=Sig_u, E0=E0,
            E_dual=E_dual, E_pr=E_pr, E_comp0=E_comp0,
            now_converged=now_converged, gcost=gcost_kkt, mu_changed=mu_changed,
            qn=qn, lowrank=lowrank, **resto,
        )
        return kkt_in, aux

    # ------------------------------------------------------------------ #
    def _refine(self, kkt_in, dw, dz, nu, resolve):
        """kkt_refine passes: the residual of the ORIGINAL (δ_w- and
        δ_c-regularized) system at (dz, ν), re-solved by resolve(rz, rnu)
        (against the kept factors, or a fresh lanes_scan solve); a
        correction applies where the re-solve is finite."""
        H, C, A, Bj, rz, rnu = kkt_in
        for _ in range(self.kkt_refine_n):
            Hdz = torch.einsum("btij,btj->bti", H, dz) + _col(dw, 3) * dz
            Hdz[:, :-1] += torch.einsum("btij,btj->bti", C, dz[:, 1:])
            Hdz[:, 1:] += torch.einsum("btji,btj->bti", C, dz[:, :-1])
            r1 = Hdz + jt_blocks(A, Bj, nu) - rz
            Jdz = torch.einsum("btsd,btd->bts", A, dz[:, :-1]) + torch.einsum(
                "btsd,btd->bts", Bj, dz[:, 1:]
            )
            r2 = Jdz - self.options.delta_c * nu - rnu
            ez, enu, okr = resolve(-r1, -r2)
            dz = dz + torch.where(_col(okr, 3), ez, torch.zeros_like(ez))
            nu = nu + torch.where(_col(okr, 3), enu, torch.zeros_like(enu))
        return dz, nu

    def _lbfgs_solve(self, H, C, A, Bj, rz, rnu, U, M):
        """L-BFGS step by Sherman-Morrison-Woodbury: the σI + barrier base
        and the right-hand side [rz | U] (1 + 2m columns) through one sweep
        pair, then x = x0 - W (-M + Uᵀ W_z)⁻¹ Uᵀ dz0 with W = K0⁻¹ [U; 0],
        one small (2m)² solve per instance."""
        Bt, T, d = rz.shape
        k2 = U.shape[-1]
        DZ, NU, okm = solve_kkt_lanes(H, C, A, Bj, *lbfgs_rhs(rz, rnu, U), self.options.delta_c)
        dz0, Wz = DZ[..., 0], DZ[..., 1:]
        nu0, Wnu = NU[..., 0], NU[..., 1:]
        Wzf = Wz.reshape(Bt, T * d, k2)
        h, info = torch.linalg.solve_ex(-M + U.mT @ Wzf, U.mT @ dz0.reshape(Bt, -1, 1))
        dz = dz0 - (Wzf @ h).reshape(Bt, T, d)
        nu = nu0 - torch.einsum("btsk,bk->bts", Wnu, h[..., 0])
        return dz, nu, okm & torch.isfinite(h).flatten(1).all(1) & (info == 0)

    def _solve_kkt_batched(self, kkt_in, delta_w0, st: IPMState, stop_if_converged,
                           lowrank=None):
        """KKT solve with per-instance δ_w escalation on factorization
        failure (Ipopt: try 0, then δ_last/3, then x8 per retry), each
        attempt refined kkt_refine_n times.  lowrank = (U, M) of the L-BFGS
        Hessian.  Returns None when every instance had already converged
        on entry."""
        o = self.options
        kkt_in = [x.contiguous() for x in kkt_in]
        H, C, A, Bj, rz, rnu = kkt_in
        refine = self.kkt_refine_n > 0
        Bt = H.shape[0]
        ok = torch.zeros(Bt, dtype=torch.bool, device=self.device)
        dz = torch.zeros_like(rz)
        nu = torch.zeros_like(rnu)
        dw_try = torch.zeros_like(delta_w0)
        dw_used = torch.zeros_like(delta_w0)
        first = torch.where(
            delta_w0 > 0, torch.clamp_min(delta_w0 / 3.0, o.delta_w_min),
            torch.full_like(delta_w0, 1e-4),
        )
        for k in range(12):
            if k == 0:
                dw_next = torch.zeros_like(delta_w0)
                Hreg = H
            else:
                dw_next = torch.where(
                    dw_try == 0.0, first, torch.clamp_max(dw_try * 8.0, o.delta_w_max)
                )
                Hreg = H + _col(dw_next, 4) * self._eye
            self.kkt_attempts += 1
            if self.scan:
                dz2, nu2, ok2 = solve_kkt_lanes_scan(Hreg, C, A, Bj, rz, rnu, o.delta_c)

                def resolve(r1, r2, Hreg=Hreg):
                    return solve_kkt_lanes_scan(Hreg, C, A, Bj, r1, r2, o.delta_c)
            elif lowrank is not None:
                dz2, nu2, ok2 = self._lbfgs_solve(Hreg, C, A, Bj, rz, rnu, *lowrank)
            else:
                dz2, nu2, ok2, *fac = solve_kkt_lanes(
                    Hreg, C, A, Bj, rz, rnu, o.delta_c, want_factors=refine
                )

                def resolve(r1, r2, fac=fac):
                    return resolve_kkt_lanes(fac[0], r1, r2)
            if refine:
                dz2, nu2 = self._refine(kkt_in, dw_next, dz2, nu2, resolve)
            dz = torch.where(_col(ok, 3), dz, dz2)
            nu = torch.where(_col(ok, 3), nu, nu2)
            dw_used = torch.where(ok, dw_used, dw_next)
            ok = ok | ok2
            dw_try = dw_next
            # the one host read of the iteration (one more per retry)
            if k == 0 and stop_if_converged:
                all_ok, all_conv = torch.stack([ok.all(), st.converged.all()]).tolist()
                if all_conv:
                    return None
            else:
                all_ok = bool(ok.all())
            if all_ok:
                break
        delta_w_new = torch.where(dw_used > 0, dw_used, delta_w0)
        dz = torch.where(_col(ok, 3), dz, torch.zeros_like(dz))
        dlam = -torch.where(_col(ok, 3), nu, torch.zeros_like(nu))
        return dz, dlam, ok, dw_used, delta_w_new

    # ------------------------------------------------------------------ #
    def _line_search(self, st: IPMState, aux: _Aux, dz, dlam, a_pri):
        """Filter (Wächter-Biegler, Ipopt A-5.4/A-6) or l1-merit
        backtracking.  All max_ls_iters candidates α_k = a_pri 2^-k are
        evaluated in one batched pass; per instance the first acceptable
        one wins, else the best-merit candidate (restoration-phase
        fallback) — the result of the sequential loop."""
        o, f = self.options, self.funcs
        Z, mu = st.Z, aux.mu
        Bt, T, d = Z.shape
        K = o.max_ls_iters
        has_lb, has_ub, free = self._has_lb, self._has_ub, self._free
        nu_pen = 1.2 * _bmax((st.lam + dlam).abs(), 1.0)

        def theta_phi(Zc, Fc, in_resto, zR, mu_c):
            """(theta, phi) for (N, T, d) points."""
            cost = f.total_cost(Zc)
            if self.resto_on:
                Dr2 = 1.0 / torch.clamp_min(zR * zR, 1.0)
                c_resto = 0.5 * o.resto_zeta * _bsum(Dr2 * (Zc - zR) ** 2)
                cost = torch.where(in_resto, c_resto, cost)
            one = torch.ones_like(Zc)
            slc = torch.where(has_lb > 0, Zc - self._lb, one)
            suc = torch.where(has_ub > 0, self._ub - Zc, one)
            barrier = _bsum(torch.log(torch.clamp_min(slc, 1e-300)) * has_lb)
            barrier = barrier + _bsum(torch.log(torch.clamp_min(suc, 1e-300)) * has_ub)
            return _bsum(Fc.abs()), cost - mu_c * barrier

        theta_k, phi_0 = theta_phi(Z, aux.F, aux.in_resto, aux.resto_zR, mu)
        m0 = phi_0 + nu_pen * theta_k

        a = a_pri[:, None] * (0.5 ** torch.arange(K, device=Z.device, dtype=Z.dtype))
        Zc = (Z[:, None] + a[:, :, None, None] * dz[:, None]).reshape(Bt * K, T, d)
        rep = lambda x: None if x is None else x.repeat_interleave(K, 0)  # noqa: E731
        th, ph = theta_phi(
            Zc, f.defects(Zc), rep(aux.in_resto), rep(aux.resto_zR), rep(mu)
        )
        th, ph = th.reshape(Bt, K), ph.reshape(Bt, K)
        mval = ph + nu_pen[:, None] * th

        if o.line_search == "filter":
            gphi_dz = (
                _bsum(aux.gcost * dz * free)
                - mu * _bsum(dz / aux.sl * has_lb)
                + mu * _bsum(dz / aux.su * has_ub)
            )
            theta_min = 1e-4 * st.theta_ref
            theta_max = o.theta_max_fact * st.theta_ref
            inf = torch.full_like(st.flt_theta, float("inf"))
            flt_t = torch.where(aux.mu_changed[:, None], inf, st.flt_theta)
            flt_p = torch.where(aux.mu_changed[:, None], inf, st.flt_phi)
            gth, gph = o.gamma_theta, o.gamma_phi
            f_ok = (
                (th[:, :, None] <= (1.0 - gth) * flt_t[:, None])
                | (ph[:, :, None] <= flt_p[:, None] - gph * flt_t[:, None])
            ).all(-1) & (th <= theta_max[:, None])
            tk, p0, gd = theta_k[:, None], phi_0[:, None], gphi_dz[:, None]
            switching = (gd < 0) & (a * (-gd) ** o.s_phi > o.delta_ls * tk**o.s_theta)
            case1 = (tk <= theta_min[:, None]) & switching
            armijo = ph <= p0 + o.armijo_eta * a * gd
            suff = (th <= (1.0 - gth) * tk) | (ph <= p0 - gph * tk)
            good = f_ok & torch.where(case1, armijo, suff)
            ftype = case1 & armijo
        else:
            good = mval <= (m0 - 1e-12 * m0.abs())[:, None]

        accepted = good.any(1)
        k_first = torch.argmax(good.to(torch.int32), dim=1)
        mv = torch.where(torch.isnan(mval), torch.full_like(mval, float("inf")), mval)
        best_m, k_best = mv.min(1)
        best_a = torch.where(
            torch.isinf(best_m), torch.zeros_like(best_m), a.gather(1, k_best[:, None])[:, 0]
        )
        alpha = torch.where(accepted, a.gather(1, k_first[:, None])[:, 0], best_a)
        k_ls = torch.where(accepted, k_first + 1, K).to(torch.int32)

        flt = {}
        if o.line_search == "filter":
            ftype_acc = ftype.gather(1, k_first[:, None])[:, 0] & accepted
            do_aug = (~accepted | ~ftype_acc) & ~st.converged & ~aux.now_converged
            slot = torch.nn.functional.one_hot(
                st.flt_ptr.long(), o.filter_size
            ).bool() & do_aug[:, None]
            flt = dict(
                flt_theta=torch.where(slot, ((1.0 - gth) * theta_k)[:, None], flt_t),
                flt_phi=torch.where(slot, (phi_0 - gph * theta_k)[:, None], flt_p),
                flt_ptr=torch.where(
                    do_aug, (st.flt_ptr + 1) % o.filter_size, st.flt_ptr
                ).to(torch.int32),
            )
        return alpha, k_ls, accepted, flt

    def _iteration_post(self, st: IPMState, aux: _Aux, dz, dlam, ok, dw_used, delta_w):
        o = self.options
        Z, lam, zl, zu = st.Z, st.lam, st.zl, st.zu
        has_lb, has_ub, free = self._has_lb, self._has_ub, self._free
        mu, tau = aux.mu, aux.tau
        mu3 = _col(mu, 3)
        now_converged = aux.now_converged
        acc_count = st.acc_count
        if o.acceptable_iter > 0:
            acc_count = torch.where(aux.E0 <= o.acceptable_tol, acc_count + 1, 0).to(torch.int32)
            now_converged = now_converged | (acc_count >= o.acceptable_iter)

        # bound-dual directions and fraction-to-boundary steps
        zero = torch.zeros_like(Z)
        dzl = torch.where(has_lb > 0, mu3 / aux.sl - zl - aux.Sig_l * dz, zero)
        dzu = torch.where(has_ub > 0, mu3 / aux.su - zu + aux.Sig_u * dz, zero)
        tau3 = _col(tau, 3)

        def max_step(val, dval, mask):
            neg = (dval < 0) & (mask > 0)
            ratio = torch.where(neg, -tau3 * val / torch.where(neg, dval, -1.0), 1.0)
            return torch.clamp_max(ratio.flatten(1).amin(1), 1.0)

        a_pri = torch.minimum(max_step(aux.sl, dz, has_lb), max_step(aux.su, -dz, has_ub))
        a_dual = torch.minimum(max_step(zl, dzl, has_lb), max_step(zu, dzu, has_ub))

        alpha, k_ls, accepted, flt = self._line_search(st, aux, dz, dlam, a_pri)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        upd = ~st.converged & ~now_converged
        scale = upd.to(Z.dtype)
        step = _col(scale * alpha, 3) * dz * free
        Z_new = Z + step
        lam_scale = torch.where(aux.in_resto, 0.0, scale) if self.resto_on else scale
        lam_new = lam + _col(lam_scale * alpha, 3) * dlam
        # dual safeguard: rescale runaway equality multipliers
        lam_new = lam_new * _col(torch.clamp_max(1e4 / _bmax(lam_new.abs(), 1.0), 1.0), 3)
        zl_new = zl + _col(scale * a_dual, 3) * dzl
        zu_new = zu + _col(scale * a_dual, 3) * dzu
        # Ipopt kappa_Sigma safeguard: bound duals near mu / slack
        ks = 1e10
        one = torch.ones_like(Z)
        sl_new = torch.where(has_lb > 0, torch.clamp_min(Z_new - self._lb, self._tiny), one)
        su_new = torch.where(has_ub > 0, torch.clamp_min(self._ub - Z_new, self._tiny), one)
        upd3 = _col(upd, 3)
        zl_new = torch.where(
            upd3, torch.clamp(zl_new, mu3 / (ks * sl_new), ks * mu3 / sl_new) * has_lb, zl
        )
        zu_new = torch.where(
            upd3, torch.clamp(zu_new, mu3 / (ks * su_new), ks * mu3 / su_new) * has_ub, zu
        )
        extra = dict(flt)
        if self.qn_lbfgs:
            # keep the memory updated in _iteration_pre, and advance prevZ to
            # the current iterate (the next pair spans this transition)
            extra.update(
                {k: torch.where(_col(upd, v.ndim), v, getattr(st, k)) for k, v in aux.qn.items()},
                qn_prevZ=torch.where(upd3, Z, st.qn_prevZ),
            )
        if self.resto_on:
            extra.update(
                ls_fail=torch.where(upd, ~accepted, st.ls_fail),
                stall_count=torch.where(upd, aux.stall_count, st.stall_count),
                in_resto=torch.where(upd, aux.in_resto, st.in_resto),
                resto_zR=torch.where(upd3, aux.resto_zR, st.resto_zR),
                resto_theta0=torch.where(upd, aux.resto_theta0, st.resto_theta0),
                resto_k=torch.where(upd, aux.resto_k, st.resto_k),
            )
        return st.replace(
            Z=Z_new, lam=lam_new, zl=zl_new, zu=zu_new, mu=mu, delta_w=delta_w,
            converged=st.converged | now_converged,
            n_iter=(st.n_iter + upd.to(torch.int32)).to(torch.int32),
            kkt_err=aux.E0, alpha=alpha, e_dual=aux.E_dual, e_pr=aux.E_pr,
            e_comp=aux.E_comp0, ls_k=k_ls, reg_dw=dw_used,
            alpha_du=torch.where(upd, a_dual, torch.zeros_like(a_dual)),
            d_norm=_bmax(step.abs()), acc_count=acc_count, **extra,
        )

    # ------------------------------------------------------------------ #
    def _step(self, st: IPMState, stop_if_converged: bool):
        with torch.no_grad():
            kkt_in, aux = self._iteration_pre(st)
            out = self._solve_kkt_batched(kkt_in, st.delta_w, st, stop_if_converged,
                                          aux.lowrank)
            if out is None:
                return None
            return self._iteration_post(st, aux, *out)

    def step(self, st: IPMState) -> IPMState:
        """One batched IPM iteration."""
        return self._step(st, False)

    def solve(self, Z0, *, max_iter=None, callback=None) -> IPMResult:
        """Iterate to convergence of every instance or max_iter.  With a
        callback (called as callback(iter, state); return False to stop),
        mirroring the Ipopt intermediate-callback protocol."""
        max_iter = max_iter or self.options.max_iter
        state = self.init_state(Z0)
        self.last_steps = 0  # iterations the last solve ran
        self.kkt_attempts = 0
        for k in range(max_iter):
            new = self._step(state, True)
            if new is None:
                break
            state = new
            self.last_steps += 1
            if callback is not None and callback(k, state) is False:
                break
        with torch.no_grad():
            obj = self.funcs.total_cost(state.Z)
        return IPMResult(
            Z=state.Z * self._v if self.options.nlp_scaling else state.Z,
            lam=state.lam, converged=state.converged, n_iter=state.n_iter,
            kkt_err=state.kkt_err, mu=state.mu, objective=obj,
        )
