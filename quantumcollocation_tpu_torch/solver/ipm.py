"""Batched primal-dual interior-point method over stage-structured NLPs.

Counterpart of quantumcollocation_tpu/solver/ipm.py, main-path subset:
every tensor carries a leading batch axis (B, ...), and instances advance
in lockstep with per-instance convergence masks (a converged instance
freezes).  One iteration (`_step`):

  1. the dynamics blocks: with the fused assembly on (small stage sizes,
     exact Hessian, no recalc_y, (n, K) covered by the kernel;
     solver/options.py::resolve_modes) one kernel (ops/dyn_assembly.py)
     gives F, A, B and the defect curvature; off, the propagator-bank
     kernel (ops/prop_bank.py) gives the banks and solver/analytic.py
     assembles the blocks from them.  An NLP without an analytic assembly
     (a robustness accumulator, or jacobian_structure=False) takes the AD
     route instead: torch.func over its defect function gives F, A, B and
     the curvature -λ·∇²F (solver/stage_nlp.py), and the same sweep
     kernels solve its blocks.  torch.func gives the cost blocks
     and the stage inequality rows g (m per knot), their Jacobian Jg and
     the curvature -w·∇²g.  With eval_hessian=False
     (quasi_newton="lbfgs") the bank runs first order, and the Hessian is
     the compact L-BFGS σI - U M⁻¹ Uᵀ (solver/lbfgs.py), its memory
     updated from the last step's pair (∇L at both points with the
     current multipliers);
  2. residuals, the KKT error, the monotone barrier update, the
     feasibility-restoration state machine (Ipopt A-9 analog; off under
     L-BFGS, as in JAX), and with recalc_y the least-squares reset of
     the equality multipliers at near-feasible points (the H = I saddle
     solve through the sweep kernels, kept per instance where it shrinks
     the dual residual);
  3. the condensed block-tridiagonal KKT system (the inequality rows
     condensed into H as Jgᵀ (w/σ) Jg, the slacks σ and duals w
     eliminated) goes through the Riccati sweep kernels
     (solver/kkt_lanes.py), with per-instance δ_w regularization retries
     while an instance's factorization fails.  With m > 0 ("auto") the
     retries carry the ρJᵀJ lift: H + ρS_AA, C + ρS_AB and rz + ρJᵀrnu,
     an exact transform of the saddle system whose stage blocks stay PD
     at a δ_w of the reduced Hessian's size; instances that needed δ_w
     last iteration start at δ_w/3 with the lift (the retry warm start).
     With kkt_refine passes, or the lift on, each attempt keeps its
     factors and corrects its step by iterative refinement: the residual
     of the regularized, unlifted system at (dz, ν) re-solved against
     the same factors (the rhs-only forward sweep, then the backward
     sweep).  Under L-BFGS the σI + barrier base and the 13-column
     right-hand side [rz | U] go through one sweep pair and
     Sherman-Morrison-Woodbury adds the low-rank part.
     kkt_backend="lanes_scan" solves through the per-knot step kernels
     instead (2(T-1) launches per attempt), and refines, when asked,
     through a fresh scan solve.  Past the kernels' stage sizes
     (max(d, s) > 64; solver/options.py::kkt_route) every one of these
     solves, the kept-factor re-solves included, takes the batched
     Riccati of solver/kkt.py instead ("riccati_torch", as JAX takes its
     XLA scan there);
  4. fraction-to-boundary on the bounds and the slacks σ, a filter or
     merit line search, and the update with Ipopt's κ_Σ safeguard on the
     bound duals and w.

The solver modes of the JAX package: with soc=True (Ipopt A-5.1) every
attempt keeps its factors, merged per instance like dz, so each
instance's second-order correction re-solves on the factors of its own
accepted attempt: the corrected defect rhs at the full
fraction-to-boundary step goes through the rhs-only forward sweep and the
backward sweep once for the whole batch every iteration, and the line
search takes the corrected step where it wins on merit (inert, with a
note, on lanes_scan and under L-BFGS, which keep no factors).  The
watchdog (watchdog_trials > 0, filter line search) takes the full step
where the filter rejects every trial, up to watchdog_trials times, then
rewinds to its snapshot and cools down for 3 iterations.
quasi_newton="gauss-newton" with eval_hessian=False drops the defect
curvature (the bank runs first order, the AD route skips its -λ·∇²F
passes) and keeps the exact cost Hessians.  mu_strategy="adaptive" sets μ
by the LOQO centrality oracle every iteration, within [0.01μ, 10μ] and
[tol/10, mu_max], and resets the filter only on a 10x drop.  print_level
>= 5 prints the live iteration table of instance 0.

The JAX solve is one lax.while_loop on the device.  Here the loop runs in
Python; each iteration synchronizes with the host once, to read "did every
factorization succeed" and "had every instance converged" together (a
retry adds one more).  The line search evaluates all backtracking
candidates in one batched pass and picks the first acceptable one per
instance, which gives the sequential loop's result without a host read per
trial.

Not ported yet (the solver raises NotImplementedError): the
cyclic-reduction KKT backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.dyn_assembly import SUPPORTED_NK
from .kkt import KKTFactors, factor_kkt, solve_with_factors
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
    sig: Any  # (B, T, m) inequality slacks
    w: Any  # (B, T, m) inequality duals
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
    # watchdog (None unless watchdog_trials > 0 with the filter line search)
    wd_count: Any = None  # (B,) int32 non-monotone steps taken in a row
    wd_cool: Any = None  # (B,) int32 iterations left of the cool-down
    wd_Z: Any = None  # the snapshot: the iterate before the excursion
    wd_lam: Any = None
    wd_sig: Any = None
    wd_w: Any = None
    wd_zl: Any = None
    wd_zu: Any = None
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
    g: Any  # (B, T, m) inequality rows
    Jg: Any  # (B, T, m, d) their Jacobian (None when m = 0)
    lam: Any  # equality multipliers after the recalc_y reset
    rho0: Any  # (B,) ρJᵀJ lift scale (zeros when the lift is off)
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
        if o.kkt_backend == "cr":
            raise NotImplementedError("not ported yet: kkt_backend='cr'")
        # without an exact Hessian: L-BFGS, or Gauss-Newton (the exact cost
        # Hessians without the defect curvature)
        self.qn_lbfgs = not exact_hessian and o.quasi_newton == "lbfgs"
        groups = nlp.analytic.groups if nlp.analytic is not None else ()
        # every KKT solve of the iteration goes through one route, chosen
        # here from the stage sizes (_kkt_solve, _kkt_resolve)
        self.fused_assembly_on, self.kkt_refine_n, self.kkt_route = resolve_modes(
            o, nlp.d, nlp.s,
            group_nk=[(g.G_drift.shape[0], g.G_drives.shape[0] + int(g.dt_col is not None))
                      for g in groups],
            supported_nk=SUPPORTED_NK, exact_hessian=exact_hessian,
        )
        if (self.kkt_route == "riccati_torch" and o.kkt_backend in ("lanes", "lanes_scan")
                and o.print_level >= 1):
            print(f"[qct] note: stage dims (d={nlp.d}, s={nlp.s}) exceed the sweep kernels' "
                  f"{max(o.lanes_max_dim, o.lanes_vec_max_dim or 0)}; kkt_backend "
                  f"{o.kkt_backend!r} -> the batched Riccati of solver/kkt.py")
        self.scan = self.kkt_route == "lanes_scan"
        if self.qn_lbfgs and self.scan:
            raise ValueError(
                "kkt_backend='lanes_scan' (the per-knot backend) supports exact Hessians "
                "only; use kkt_backend='lanes' or 'xla' with quasi_newton='lbfgs'"
            )
        if o.soc and (self.scan or self.qn_lbfgs):
            # the JAX package's note, word for word
            print(
                "[qct] note: soc=True is inert with "
                f"kkt_backend={o.kkt_backend!r}"
                + (" + quasi_newton='lbfgs'" if self.qn_lbfgs else "")
                + " (no reusable KKT factors); steps fall back to the "
                "plain filter/merit line search"
            )
        # second-order correction on each instance's kept factors
        self.soc_on = bool(o.soc) and not (self.scan or self.qn_lbfgs)
        self.wd_on = o.watchdog_trials > 0 and o.line_search == "filter"
        # L-BFGS: no restoration, and no refinement (the SMW-combined step
        # keeps no factors), as in JAX
        self.resto_on = bool(o.restoration) and not self.qn_lbfgs
        # the ρJᵀJ lift: "auto" = on iff the NLP has stage inequality rows;
        # never under L-BFGS (its σI base is PD).  The retry warm start
        # follows the lift under "auto".
        self.kkt_aug_on = (
            (nlp.m > 0 if o.kkt_aug == "auto" else bool(o.kkt_aug)) and not self.qn_lbfgs
        )
        self.retry_warm_on = (
            self.kkt_aug_on if o.kkt_retry_warm == "auto" else bool(o.kkt_retry_warm)
        )
        if self.qn_lbfgs:
            self.kkt_refine_n = 0
        self.kkt_attempts = 0  # KKT attempts since the last solve began
        # per-iteration events of the solver modes (mode_events)
        self.mode_log = {}
        # instance rows of those attempts, and those that ran lifted (a
        # device count, read when wanted)
        self.kkt_attempt_rows, self.kkt_lifted_rows = 0, 0
        self.device, self.dtype = nlp.device, nlp.dtype
        self.var_scale = np.ones(nlp.d)
        self.defect_scale = np.ones(nlp.s)
        self.ineq_scale = np.ones(nlp.m)
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
        Jg = f0.jac_ineq(z0)[0]
        gphi = f0.grad_cost(z0)[0]
        A = np.abs(A[0].double().cpu().numpy())
        B = np.abs(B[0].double().cpu().numpy())
        free = np.asarray(nlp.free_mask, dtype=np.float64)
        col = np.maximum(A.max(axis=(0, 1)), B.max(axis=(0, 1))) * (free.max(axis=0) > 0)
        v = 1.0 / np.maximum(1.0, col)
        rowA = (A * v[None, None, :]).max(axis=(0, 2))
        rowB = (B * v[None, None, :]).max(axis=(0, 2))
        r = 1.0 / np.maximum(1.0, np.maximum(rowA, rowB))
        Jg = np.abs(Jg.double().cpu().numpy())
        q = 1.0 / np.maximum(1.0, (Jg * v[None, None, :]).max(axis=(0, 2))) if nlp.m else np.ones(0)
        gmax = float(np.max(np.abs(gphi.double().cpu().numpy()) * v[None, :]))
        self.var_scale = v
        self.defect_scale = r
        self.ineq_scale = q
        self.obj_scale = 100.0 / max(100.0, gmax)
        return scale_stage_nlp(nlp, v, r, q, self.obj_scale)

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

        # inequality slacks and duals
        mu0 = Z.new_full((Bt,), o.mu_init)
        g0 = self.funcs.ineqs(Z)
        sig = torch.clamp_min(g0, 1e-2)
        w = _col(mu0, 3) / sig if nlp.m > 0 else torch.zeros_like(sig)

        # least-squares initial multipliers: the saddle solve with H = I,
        # C = 0; discarded when absurdly large
        free = self._free
        A, Bj = self.funcs.jac_blocks(Z)
        gphi = self.funcs.grad_cost(Z)
        if nlp.m > 0:
            gphi = gphi - torch.einsum("btmi,btm->bti", self.funcs.jac_ineq(Z), w)
        nu, ok = self._ls_multipliers(A * free[:-1, None, :], Bj * free[1:, None, :], gphi * free)
        lam = torch.where(_col(ok, 3), nu, torch.zeros_like(nu))
        lam = torch.where(_col(_bmax(lam.abs()) > 1e3, 3), torch.zeros_like(lam), lam)

        zeros = lambda: Z.new_zeros(Bt)  # noqa: E731
        zl0, zu0 = has_lb.expand_as(Z).clone(), has_ub.expand_as(Z).clone()
        izeros = lambda: torch.zeros(Bt, dtype=torch.int32, device=self.device)  # noqa: E731
        extra = {}
        if o.line_search == "filter":
            theta0 = _bsum(self.funcs.defects(Z).abs()) + _bsum((g0 - sig).abs())
            extra.update(
                flt_theta=Z.new_full((Bt, o.filter_size), float("inf")),
                flt_phi=Z.new_full((Bt, o.filter_size), float("inf")),
                flt_ptr=izeros(),
                theta_ref=torch.clamp_min(theta0, 1.0),
            )
        if self.wd_on:
            extra.update(
                wd_count=izeros(), wd_cool=izeros(),
                wd_Z=Z.clone(), wd_lam=lam.clone(), wd_sig=sig.clone(), wd_w=w.clone(),
                wd_zl=zl0.clone(), wd_zu=zu0.clone(),
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
            Z=Z, lam=lam, sig=sig, w=w,
            zl=zl0, zu=zu0,
            mu=mu0, delta_w=zeros(),
            converged=torch.zeros(Bt, dtype=torch.bool, device=self.device),
            n_iter=izeros(), kkt_err=Z.new_full((Bt,), float("inf")),
            alpha=zeros(), e_dual=zeros(), e_pr=zeros(), e_comp=zeros(),
            ls_k=izeros(), reg_dw=zeros(), alpha_du=zeros(), d_norm=zeros(),
            acc_count=izeros(), **extra,
        )

    def _ls_multipliers(self, A, Bj, g):
        """ν of the saddle solve with H = I, C = 0 (the least-squares
        multipliers of J^T ν = g, J from the masked blocks A, Bj), and
        whether each instance's solve succeeded."""
        Bt, T, d = g.shape
        H = self._eye.expand(Bt, T, d, d).contiguous()
        Cz = g.new_zeros(Bt, T - 1, d, d)
        _, nu, ok = self._kkt_solve(H, Cz, A.contiguous(), Bj.contiguous(), g.contiguous(),
                                    g.new_zeros(Bt, T - 1, self.nlp.s), 1e-8)
        return nu, ok

    def _kkt_solve(self, H, C, A, Bj, rz, rnu, delta_c, want_factors=False):
        """One KKT solve through the solver's route: (dz, ν, ok), and the
        kept factors as a fourth entry with want_factors (KKTFactors on
        "riccati_torch", LanesFactors on "lanes"; lanes_scan keeps none)."""
        if self.kkt_route == "riccati_torch":
            fac = factor_kkt(H, C, A, Bj, delta_c)
            out = solve_with_factors(fac, rz, rnu)
            return out + (fac,) if want_factors else out
        if self.scan:
            return solve_kkt_lanes_scan(H, C, A, Bj, rz, rnu, delta_c)
        return solve_kkt_lanes(H, C, A, Bj, rz, rnu, delta_c, want_factors=want_factors)

    @staticmethod
    def _kkt_resolve(fac, rz, rnu):
        """A right-hand side re-solved against kept factors: (dz, ν, ok)."""
        if isinstance(fac, KKTFactors):
            return solve_with_factors(fac, rz, rnu)
        return resolve_kkt_lanes(fac, rz, rnu)

    # ------------------------------------------------------------------ #
    def _iteration_pre(self, st: IPMState):
        o, nlp = self.options, self.nlp
        T, s, m = nlp.T, nlp.s, nlp.m
        Z, lam, zl, zu, mu = st.Z, st.lam, st.zl, st.zu, st.mu
        sig, w = st.sig, st.w
        free, has_lb, has_ub = self._free, self._has_lb, self._has_ub
        one = torch.ones_like(Z)
        sl = torch.where(has_lb > 0, torch.clamp_min(Z - self._lb, self._tiny), one)
        su = torch.where(has_ub > 0, torch.clamp_min(self._ub - Z, self._tiny), one)

        an = self.nlp.analytic
        if self.fused_assembly_on:
            F, A, Bj, Hc, Cc = an.assembly_batched(Z, lam)
        elif an is None:  # the AD route: torch.func over the defects
            F, A, Bj = self.funcs.dyn_eval(Z)
        else:
            banks = an.banks_batched(Z, second_order=self.exact_hessian)
            F, A, Bj, dyn_aux = an.dyn_eval(Z, banks)
        gcost = self.funcs.grad_cost(Z)
        g = self.funcs.ineqs(Z)
        if m > 0:
            Jg = self.funcs.jac_ineq(Z)
            jg_w = torch.einsum("btmi,btm->bti", Jg, w)
        else:
            Jg, jg_w = None, 0.0
        E_pr = torch.maximum(_bmax(F.abs()), _bmax((g - sig).abs(), 0.0))

        resto = {}
        mu3 = _col(mu, 3)
        if self.resto_on:
            theta_cur = _bsum(F.abs()) + _bsum((g - sig).abs())
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

        if o.recalc_y:
            # least-squares multiplier reset at near-feasible points: the
            # H = I saddle solve for argmin ||∇φ - Jgᵀw - zl + zu - Jᵀλ||,
            # kept where it shrinks that residual (the solve carries an
            # O(δ) floor) and E_pr <= recalc_y_feas_tol
            A_m, B_m = A * free[:-1, None, :], Bj * free[1:, None, :]
            gother = (gcost - jg_w - has_lb * zl + has_ub * zu) * free
            nu_ls, ok_ls = self._ls_multipliers(A_m, B_m, gother)
            res_cur = _bmax((gother - jt_blocks(A_m, B_m, lam)).abs())
            res_ls = _bmax((gother - jt_blocks(A_m, B_m, nu_ls)).abs())
            good = ok_ls & (E_pr <= o.recalc_y_feas_tol) & (res_ls < res_cur)
            lam = torch.where(_col(good, 3), nu_ls, lam)
        # the defect curvature -λ·∇²F: none under Gauss-Newton or L-BFGS
        if not self.fused_assembly_on and self.exact_hessian:
            Hc, Cc = (self.funcs.defect_curvature(Z, lam) if an is None
                      else an.defect_curvature(lam, dyn_aux))

        jt_lam = jt_blocks(A, Bj, lam) + jg_w
        gL = gcost - jt_lam
        gcost_kkt = gcost
        if self.resto_on:
            g_resto = o.resto_zeta * Dr2 * (Z - zR)
            gcost_kkt = torch.where(_col(in_resto, 3), g_resto, gcost)
        gL_kkt = gcost_kkt - jt_lam
        r_dual = (gL - has_lb * zl + has_ub * zu) * free

        n_duals = (T - 1) * s + T * m + self._n_bounds
        dual_sum = (_bsum(lam.abs()) + _bsum(w.abs()) + _bsum(zl.abs() * has_lb)
                    + _bsum(zu.abs() * has_ub))
        s_d = torch.clamp_min(dual_sum / max(n_duals, 1), 100.0) / 100.0
        E_dual = _bmax(r_dual.abs()) / s_d

        def comp_err(muv):
            e = _bmax((sl * zl - _col(muv, 3)).abs() * has_lb, 0.0)
            e = torch.maximum(e, _bmax((su * zu - _col(muv, 3)).abs() * has_ub, 0.0))
            e = torch.maximum(e, _bmax((sig * w - _col(muv, 3)).abs(), 0.0))
            return e / s_d

        E_comp0 = comp_err(torch.zeros_like(mu))
        E0 = torch.maximum(torch.maximum(E_dual, E_pr), E_comp0)
        now_converged = E0 <= o.tol

        n_comp = self._n_bounds + T * m
        if o.mu_strategy == "adaptive" and n_comp > 0:
            # LOQO centrality oracle: μ = σ·avg(comp), σ = 0.1 min(0.05
            # (1-ξ)/ξ, 2)³, ξ = min(comp)/avg(comp), held to [0.01μ, 10μ]
            # an iteration and to [tol/10, mu_max]
            inf = torch.full_like(Z, float("inf"))
            csum = _bsum(sl * zl * has_lb) + _bsum(su * zu * has_ub) + _bsum(sig * w)
            cmin = torch.minimum(-_bmax(-torch.where(has_lb > 0, sl * zl, inf)),
                                 -_bmax(-torch.where(has_ub > 0, su * zu, inf)))
            if m > 0:
                cmin = torch.minimum(cmin, -_bmax(-sig * w))
            avg = csum / n_comp
            xi = torch.clamp(cmin / torch.clamp_min(avg, 1e-300), 1e-12, 1.0)
            mu_loqo = 0.1 * torch.clamp_max(0.05 * (1.0 - xi) / xi, 2.0) ** 3 * avg
            mu_loqo = torch.minimum(torch.maximum(mu_loqo, 1e-2 * mu), 1e1 * mu)
            mu_new = torch.clamp(mu_loqo, o.tol / 10.0, o.mu_max)
        else:
            # monotone (Fiacco-McCormick) barrier update
            E_mu = torch.maximum(torch.maximum(E_dual, E_pr), comp_err(mu))
            mu_new = torch.where(
                E_mu <= o.kappa_epsilon * mu,
                torch.clamp_min(torch.minimum(o.kappa_mu * mu, mu**o.theta_mu), o.tol / 10.0),
                mu,
            )
        # the oracle moves μ every iteration: reset the filter only on a
        # 10x drop
        mu_changed = mu_new < 0.1 * mu if o.mu_strategy == "adaptive" else mu_new != mu
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
            y_vec = ((gL - self.funcs.grad_lagrangian(st.qn_prevZ, lam, w)) * free).flatten(1)
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
            H, C = self.funcs.cost_hess(Z, w)
            if self.exact_hessian:
                H = H + Hc
                C = C + Cc
        if self.resto_on:
            ir4 = _col(in_resto, 4)
            H = torch.where(ir4, torch.diag_embed(o.resto_zeta * Dr2), H)
            C = torch.where(ir4, torch.zeros_like(C), C)
        # the lift scale from the pre-barrier Lagrangian Hessian: a
        # Gershgorin bound on the block rows |H_t| + |C_t| + |C_{t-1}^T|
        # (the PSD barrier terms would push ρ up near convergence)
        if self.kkt_aug_on:
            rho0 = self.lift_scale(H, C, o.kkt_aug_rho_factor)
        else:
            rho0 = Z.new_zeros(Z.shape[0])
        Sig_l = torch.where(has_lb > 0, zl / sl, torch.zeros_like(Z))
        Sig_u = torch.where(has_ub > 0, zu / su, torch.zeros_like(Z))
        H = H + torch.diag_embed(Sig_l + Sig_u)
        if m > 0:
            H = H + torch.einsum("btmi,btm,btmj->btij", Jg, w / sig, Jg)
        Mf = free
        H = H * Mf[:, :, None] * Mf[:, None, :] + torch.diag_embed(1.0 - Mf)
        C = C * Mf[:-1, :, None] * Mf[1:, None, :]
        A = A * Mf[:-1, None, :]
        Bj = Bj * Mf[1:, None, :]
        zero = torch.zeros_like(Z)
        if m > 0:
            # ∇L at the slack-eliminated duals ŵ = μ/σ - (w/σ)(g - σ)
            w_hat = mu3 / sig - (w / sig) * (g - sig)
            gL_kkt = gL_kkt - torch.einsum("btmi,btm->bti", Jg, w_hat - w)
        r_z = (
            gL_kkt
            - torch.where(has_lb > 0, mu3 / sl, zero)
            + torch.where(has_ub > 0, mu3 / su, zero)
        ) * free
        kkt_in = (H, C, A, Bj, -r_z, -F)
        aux = _Aux(
            F=F, g=g, Jg=Jg, lam=lam, rho0=rho0, mu=mu, tau=tau, sl=sl, su=su,
            Sig_l=Sig_l, Sig_u=Sig_u, E0=E0,
            E_dual=E_dual, E_pr=E_pr, E_comp0=E_comp0,
            now_converged=now_converged, gcost=gcost_kkt, mu_changed=mu_changed,
            qn=qn, lowrank=lowrank, **resto,
        )
        return kkt_in, aux

    # ------------------------------------------------------------------ #
    @staticmethod
    def lift_scale(H, C, factor):
        """(B,) ρ of the lift: factor × the largest Gershgorin row sum
        |H_t| + |C_t| + |C_{t-1}^T| of the block-tridiagonal H, C."""
        rowsum = H.abs().sum(-1)
        rowsum[:, :-1] += C.abs().sum(-1)
        rowsum[:, 1:] += C.abs().sum(-2)
        return factor * _bmax(rowsum)

    @staticmethod
    def _lift_S(A, Bj):
        """(S_AA (B, T, d, d), S_AB (B, T-1, d, d)): the blocks of JᵀJ for
        the block-bidiagonal J of the masked A, B."""
        S_AA = A.new_zeros(A.shape[0], A.shape[1] + 1, A.shape[3], A.shape[3])
        S_AA[:, :-1] += torch.einsum("btsi,btsj->btij", A, A)
        S_AA[:, 1:] += torch.einsum("btsi,btsj->btij", Bj, Bj)
        return S_AA, torch.einsum("btsi,btsj->btij", A, Bj)

    def _lifted(self, kkt_in, dw, rho, S=None):
        """The blocks of one attempt: H + δ_w I, and with the lift
        (S = (S_AA, S_AB), ρ per instance) H + ρS_AA, C + ρS_AB and
        rz + ρJᵀrnu."""
        H, C, A, Bj, rz, rnu = kkt_in
        Hreg = H + _col(dw, 4) * self._eye
        if rho is None:
            return Hreg, C, A, Bj, rz, rnu
        r4 = _col(rho, 4)
        return (Hreg + r4 * S[0], C + r4 * S[1], A, Bj,
                rz + _col(rho, 3) * jt_blocks(A, Bj, rnu), rnu)

    def _refine(self, kkt_in, dw, dz, nu, resolve, rho=None, n_pass=None):
        """Refinement passes (kkt_refine, or one under the lift): the
        residual of the ORIGINAL (δ_w- and δ_c-regularized, unlifted)
        system at (dz, ν), re-solved by resolve(rz, rnu) (against the kept
        factors, or a fresh lanes_scan solve) after the lift's rhs
        transform rz + ρJᵀrnu where rho is given; a correction applies
        where the re-solve is finite."""
        H, C, A, Bj, rz, rnu = kkt_in
        for _ in range(self.kkt_refine_n if n_pass is None else n_pass):
            Hdz = torch.einsum("btij,btj->bti", H, dz) + _col(dw, 3) * dz
            Hdz[:, :-1] += torch.einsum("btij,btj->bti", C, dz[:, 1:])
            Hdz[:, 1:] += torch.einsum("btji,btj->bti", C, dz[:, :-1])
            r1 = Hdz + jt_blocks(A, Bj, nu) - rz
            Jdz = torch.einsum("btsd,btd->bts", A, dz[:, :-1]) + torch.einsum(
                "btsd,btd->bts", Bj, dz[:, 1:]
            )
            r2 = Jdz - self.options.delta_c * nu - rnu
            e1 = -r1 if rho is None else -r1 - _col(rho, 3) * jt_blocks(A, Bj, r2)
            ez, enu, okr = resolve(e1, -r2)
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
        DZ, NU, okm = self._kkt_solve(H, C, A, Bj, *lbfgs_rhs(rz, rnu, U), self.options.delta_c)
        dz0, Wz = DZ[..., 0], DZ[..., 1:]
        nu0, Wnu = NU[..., 0], NU[..., 1:]
        Wzf = Wz.reshape(Bt, T * d, k2)
        h, info = torch.linalg.solve_ex(-M + U.mT @ Wzf, U.mT @ dz0.reshape(Bt, -1, 1))
        dz = dz0 - (Wzf @ h).reshape(Bt, T, d)
        nu = nu0 - torch.einsum("btsk,bk->bts", Wnu, h[..., 0])
        return dz, nu, okm & torch.isfinite(h).flatten(1).all(1) & (info == 0)

    def _solve_kkt_batched(self, kkt_in, delta_w0, st: IPMState, stop_if_converged,
                           lowrank=None, rho0=None):
        """KKT solve with per-instance δ_w escalation on factorization
        failure (Ipopt: try 0, then δ_last/3, then x8 per retry), each
        attempt refined kkt_refine_n times (once at least under the lift).
        lowrank = (U, M) of the L-BFGS Hessian; rho0 (B,) the lift scale,
        engaged from attempt kkt_aug_start, and on a warm-started δ_w > 0
        first attempt.  Returns None when every instance had already
        converged on entry, else (dz, dλ, ok, δ_w used, new δ_w, ρ used,
        the kept factors of each instance's accepted attempt (soc only,
        else None))."""
        o = self.options
        kkt_in = [x.contiguous() for x in kkt_in]
        H, C, A, Bj, rz, rnu = kkt_in
        aug = self.kkt_aug_on and rho0 is not None
        n_ref = max(self.kkt_refine_n, int(aug))
        keep = self.soc_on and lowrank is None
        fac_acc = None
        Bt = H.shape[0]
        ok = torch.zeros(Bt, dtype=torch.bool, device=self.device)
        dz = torch.zeros_like(rz)
        nu = torch.zeros_like(rnu)
        dw_try = torch.zeros_like(delta_w0)
        dw_used = torch.zeros_like(delta_w0)
        rho_used = torch.zeros_like(delta_w0)
        S = self._lift_S(A, Bj) if aug else None
        first = torch.where(
            delta_w0 > 0, torch.clamp_min(delta_w0 / 3.0, o.delta_w_min),
            torch.full_like(delta_w0, 1e-4),
        )
        if self.retry_warm_on:
            # instances that needed δ_w last iteration skip the plain
            # attempt and start at δ_w/3 with the lift, until δ_w/3 decays
            # below kkt_retry_warm_min
            dw_warm = torch.where(delta_w0 / 3.0 >= o.kkt_retry_warm_min, first,
                                  torch.zeros_like(delta_w0))
        else:
            dw_warm = torch.zeros_like(delta_w0)
        for k in range(12):
            if k == 0:
                dw_next = dw_warm
            else:
                dw_next = torch.where(
                    dw_try == 0.0, first, torch.clamp_max(dw_try * 8.0, o.delta_w_max)
                )
            if aug and k >= o.kkt_aug_start:
                rho = rho0
            elif aug and self.retry_warm_on:
                rho = torch.where(dw_next > 0, rho0, torch.zeros_like(rho0))
            else:
                rho = None
            Hreg, C_in, _, _, rz_in, _ = self._lifted(kkt_in, dw_next, rho, S)
            self.kkt_attempts += 1
            self.kkt_attempt_rows += Bt
            if rho is not None:
                self.kkt_lifted_rows = self.kkt_lifted_rows + (rho > 0).sum()
            if lowrank is not None:
                dz2, nu2, ok2 = self._lbfgs_solve(Hreg, C_in, A, Bj, rz_in, rnu, *lowrank)
            else:
                dz2, nu2, ok2, *fac = self._kkt_solve(
                    Hreg, C_in, A, Bj, rz_in, rnu, o.delta_c,
                    want_factors=not self.scan and (n_ref > 0 or keep),
                )

                def resolve(r1, r2, fac=fac, Hreg=Hreg, C_in=C_in):
                    # lanes_scan keeps no factors: a fresh solve
                    if self.scan:
                        return self._kkt_solve(Hreg, C_in, A, Bj, r1, r2, o.delta_c)
                    return self._kkt_resolve(fac[0], r1, r2)
            if n_ref > 0 and lowrank is None:
                dz2, nu2 = self._refine(kkt_in, dw_next, dz2, nu2, resolve,
                                        rho=rho, n_pass=n_ref)
            dz = torch.where(_col(ok, 3), dz, dz2)
            nu = torch.where(_col(ok, 3), nu, nu2)
            if keep and fac_acc is None:
                fac_acc = fac[0]
            elif keep:
                # each instance keeps the factors of the attempt it accepts
                # (the constraint blocks A, B are the same in every attempt)
                fac_acc = fac[0]._replace(**{
                    name: torch.where(_col(ok, new.ndim), getattr(fac_acc, name), new)
                    for name, new in zip(fac[0]._fields, fac[0]) if name not in ("A", "B")
                })
            dw_used = torch.where(ok, dw_used, dw_next)
            rho_used = torch.where(ok, rho_used, 0.0 if rho is None else rho)
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
        return dz, dlam, ok, dw_used, delta_w_new, rho_used, fac_acc

    def _soc_rhs(self, st: IPMState, aux: _Aux, dz, rho_used, kkt_in):
        """The second-order correction's right-hand side (Ipopt A-5.1), per
        instance: the corrected defect rhs at the full fraction-to-boundary
        step, rnu = -(a·F + F(Z + a·dz)), and whether the violation grew
        (θ(Z + a·dz) >= κ_soc θ(Z), the slacks' rows included).  Where the
        accepted factorization was lifted the rhs becomes rz + ρJᵀrnu; with
        δ_c > 0 that transform is exact only to O(ρδ_c), which the line
        search guards (the corrected step is taken only where it wins on
        merit).  Returns (rz, rnu, θ grew)."""
        o, f = self.options, self.funcs
        dsig, _, _, _, a_pri, _ = self._dir_quants(st, aux, dz)
        a3 = _col(a_pri, 3)
        Z1 = st.Z + a3 * dz
        F1 = f.defects(Z1)
        theta0, theta1 = _bsum(aux.F.abs()), _bsum(F1.abs())
        if self.nlp.m > 0:
            theta0 = theta0 + _bsum((aux.g - st.sig).abs())
            theta1 = theta1 + _bsum((f.ineqs(Z1) - (st.sig + a3 * dsig)).abs())
        rnu = -(a3 * aux.F + F1)
        rz = kkt_in[4]
        if self.kkt_aug_on:
            rz = rz + _col(rho_used, 3) * jt_blocks(kkt_in[2], kkt_in[3], rnu)
        return rz.contiguous(), rnu.contiguous(), theta1 >= o.kappa_soc * theta0

    def _soc_step(self, st: IPMState, aux: _Aux, dz, ok, fac, rho_used, kkt_in):
        """The batched second-order correction: its rhs (_soc_rhs)
        re-solved once for the whole batch on each instance's kept factors
        (kernel 4, then kernel 3).  ok_c holds only where the instance's
        factorization succeeded: a failed one leaves NaN in the kernels'
        factors (and in JAX's), but finite values in the plain version's.
        Returns (dz_c, ν_c, ok_c, θ grew)."""
        rz, rnu, theta_grew = self._soc_rhs(st, aux, dz, rho_used, kkt_in)
        dz_c, nu_c, ok_c = self._kkt_resolve(fac, rz, rnu)
        return dz_c, nu_c, ok_c & ok, theta_grew

    # ------------------------------------------------------------------ #
    def _line_search(self, st: IPMState, aux: _Aux, dz, dlam, dsig, dw_ineq, a_pri):
        """Filter (Wächter-Biegler, Ipopt A-5.4/A-6) or l1-merit
        backtracking along (dz, dσ).  All max_ls_iters candidates
        α_k = a_pri 2^-k are evaluated in one batched pass; per instance
        the first acceptable one wins, else the best-merit candidate
        (restoration-phase fallback) — the result of the sequential
        loop.  Returns (α, trials, accepted, the filter's new fields, the
        merit at α (the least of the candidates where none was accepted),
        the merit m0 at the iterate, and merit(Z, σ) for other points)."""
        o, f = self.options, self.funcs
        Z, mu, sig = st.Z, aux.mu, st.sig
        Bt, T, d = Z.shape
        K = o.max_ls_iters
        has_lb, has_ub, free = self._has_lb, self._has_ub, self._free
        nu_pen = 1.2 * torch.maximum(_bmax((aux.lam + dlam).abs(), 1.0),
                                     _bmax((st.w + dw_ineq).abs(), 1.0))

        def theta_phi(Zc, Fc, gc, sigc, in_resto, zR, mu_c):
            """(theta, phi) for (N, T, d) points with slacks (N, T, m)."""
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
            barrier = barrier + _bsum(torch.log(torch.clamp_min(sigc, 1e-300)))
            return _bsum(Fc.abs()) + _bsum((gc - sigc).abs()), cost - mu_c * barrier

        theta_k, phi_0 = theta_phi(Z, aux.F, aux.g, sig, aux.in_resto, aux.resto_zR, mu)
        m0 = phi_0 + nu_pen * theta_k

        a = a_pri[:, None] * (0.5 ** torch.arange(K, device=Z.device, dtype=Z.dtype))
        Zc = (Z[:, None] + a[:, :, None, None] * dz[:, None]).reshape(Bt * K, T, d)
        sigc = (sig[:, None] + a[:, :, None, None] * dsig[:, None]).reshape(Bt * K, T, -1)
        rep = lambda x: None if x is None else x.repeat_interleave(K, 0)  # noqa: E731
        th, ph = theta_phi(
            Zc, f.defects(Zc), f.ineqs(Zc), sigc, rep(aux.in_resto), rep(aux.resto_zR), rep(mu)
        )
        th, ph = th.reshape(Bt, K), ph.reshape(Bt, K)
        mval = ph + nu_pen[:, None] * th

        if o.line_search == "filter":
            gphi_dz = (
                _bsum(aux.gcost * dz * free)
                - mu * _bsum(dz / aux.sl * has_lb)
                + mu * _bsum(dz / aux.su * has_ub)
                - mu * _bsum(dsig / sig)
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
        # the sequential loop's merit at α: the accepted candidate's, else
        # the least over all candidates (NaN if one is NaN)
        m_alpha = torch.where(accepted, mval.gather(1, k_first[:, None])[:, 0], mval.amin(1))

        def merit(Zc, sigc):
            th_, ph_ = theta_phi(Zc, f.defects(Zc), f.ineqs(Zc), sigc, aux.in_resto,
                                 aux.resto_zR, mu)
            return ph_ + nu_pen * th_

        return alpha, k_ls, accepted, flt, m_alpha, m0, merit

    def _dir_quants(self, st: IPMState, aux: _Aux, dz):
        """The slack, inequality-dual and bound-dual directions of a primal
        direction dz and its fraction-to-boundary steps (shared by the
        Newton step and the second-order correction): (dσ, dw, dzl, dzu,
        a_pri, a_dual)."""
        has_lb, has_ub = self._has_lb, self._has_ub
        sig, w, zl, zu = st.sig, st.w, st.zl, st.zu
        mu3, tau3 = _col(aux.mu, 3), _col(aux.tau, 3)
        zero = torch.zeros_like(dz)
        dzl = torch.where(has_lb > 0, mu3 / aux.sl - zl - aux.Sig_l * dz, zero)
        dzu = torch.where(has_ub > 0, mu3 / aux.su - zu + aux.Sig_u * dz, zero)

        def max_step(val, dval, mask):
            neg = (dval < 0) & (mask > 0)
            ratio = torch.where(neg, -tau3 * val / torch.where(neg, dval, -1.0), 1.0)
            return torch.clamp_max(ratio.flatten(1).amin(1), 1.0)

        a_pri = torch.minimum(max_step(aux.sl, dz, has_lb), max_step(aux.su, -dz, has_ub))
        a_dual = torch.minimum(max_step(zl, dzl, has_lb), max_step(zu, dzu, has_ub))
        if self.nlp.m == 0:
            return sig, w, dzl, dzu, a_pri, a_dual
        # slack and inequality-dual directions, and their
        # fraction-to-boundary steps
        dsig = torch.einsum("btmi,bti->btm", aux.Jg, dz) + (aux.g - sig)
        dw_ineq = mu3 / sig - w - (w / sig) * dsig
        ones = torch.ones_like(sig)
        a_pri = torch.minimum(a_pri, max_step(sig, dsig, ones))
        a_dual = torch.minimum(a_dual, max_step(w, dw_ineq, ones))
        return dsig, dw_ineq, dzl, dzu, a_pri, a_dual

    def _iteration_post(self, st: IPMState, aux: _Aux, dz, dlam, ok, dw_used, delta_w,
                        soc=None):
        o = self.options
        Z, lam, zl, zu = st.Z, aux.lam, st.zl, st.zu
        sig, w = st.sig, st.w
        has_lb, has_ub, free = self._has_lb, self._has_ub, self._free
        mu = aux.mu
        mu3 = _col(mu, 3)
        now_converged = aux.now_converged
        acc_count = st.acc_count
        if o.acceptable_iter > 0:
            acc_count = torch.where(aux.E0 <= o.acceptable_tol, acc_count + 1, 0).to(torch.int32)
            now_converged = now_converged | (acc_count >= o.acceptable_iter)

        dsig, dw_ineq, dzl, dzu, a_pri, a_dual = self._dir_quants(st, aux, dz)
        alpha, k_ls, accepted, flt, m_alpha, m0, merit = self._line_search(
            st, aux, dz, dlam, dsig, dw_ineq, a_pri)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        soc_used = torch.zeros_like(ok)
        if soc is not None:
            # the corrected step where the full step was cut or rejected,
            # the violation grew, and the correction wins on merit
            dz_c, nu_c, ok_c, theta_grew = soc
            dz_c = dz_c * free
            dsig_c, dw_c, dzl_c, dzu_c, a_p_c, a_d_c = self._dir_quants(st, aux, dz_c)
            m_soc = merit(Z + _col(a_p_c, 3) * dz_c, sig + _col(a_p_c, 3) * dsig_c)
            trigger = ((alpha < a_pri) | ~accepted) & theta_grew
            soc_used = (trigger & ok_c & (m_soc <= m0 - 1e-12 * m0.abs())
                        & (m_soc < m_alpha))
            u3 = _col(soc_used, 3)
            dz, dlam = torch.where(u3, dz_c, dz), torch.where(u3, -nu_c, dlam)
            dsig, dw_ineq = torch.where(u3, dsig_c, dsig), torch.where(u3, dw_c, dw_ineq)
            dzl, dzu = torch.where(u3, dzl_c, dzl), torch.where(u3, dzu_c, dzu)
            alpha = torch.where(soc_used, a_p_c, alpha)
            a_dual = torch.where(soc_used, a_d_c, a_dual)
            self._log("soc_trigger", trigger)
            self._log("soc_taken", soc_used)

        if self.wd_on:
            # where the filter rejects every trial, the full step anyway,
            # up to watchdog_trials times in a row; then rewind to the
            # snapshot and cool down
            acc_eff = accepted | soc_used
            active = st.wd_count > 0
            failed = ~acc_eff & ok
            activate = ~active & failed & (st.wd_cool <= 0)
            succeed = active & acc_eff
            go_on = active & failed & (st.wd_count < o.watchdog_trials)
            rewind = active & failed & (st.wd_count >= o.watchdog_trials)
            alpha = torch.where(activate | go_on, a_pri, alpha)
            wd_count = torch.where(activate, 1, torch.where(
                go_on, st.wd_count + 1, torch.where(succeed | rewind, 0, st.wd_count)))
            wd_cool = torch.where(rewind, 3, torch.clamp_min(st.wd_cool - 1, 0))

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
        if self.nlp.m > 0:
            sig_new = torch.clamp_min(sig + _col(scale * alpha, 3) * dsig, self._tiny)
            w_new = w + _col(scale * a_dual, 3) * dw_ineq
        else:
            sig_new, w_new = sig, w
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
        if self.nlp.m > 0:
            w_new = torch.where(
                upd3, torch.clamp(w_new, mu3 / (ks * sig_new), ks * mu3 / sig_new), w
            )
        extra = dict(flt)
        upd_qn = upd
        if self.wd_on:
            # the snapshot of the pre-step iterate on activation; a rewind
            # restores it as it was
            snap, rw = activate & upd, rewind & upd
            self._log("wd_activate", snap)
            self._log("wd_rewind", rw)
            extra.update(
                wd_count=torch.where(upd, wd_count, st.wd_count).to(torch.int32),
                wd_cool=torch.where(upd, wd_cool, st.wd_cool).to(torch.int32),
            )
            for name, cur in (("Z", Z), ("lam", lam), ("sig", sig), ("w", w), ("zl", zl),
                              ("zu", zu)):
                old = getattr(st, "wd_" + name)
                extra["wd_" + name] = torch.where(_col(snap, cur.ndim), cur, old)
            Z_new, lam_new, sig_new, w_new, zl_new, zu_new = (
                torch.where(_col(rw, new.ndim), old, new) for new, old in (
                    (Z_new, st.wd_Z), (lam_new, st.wd_lam), (sig_new, st.wd_sig),
                    (w_new, st.wd_w), (zl_new, st.wd_zl), (zu_new, st.wd_zu)))
            # a rewind keeps the memory from before the excursion
            upd_qn = upd & ~rw
        if self.qn_lbfgs:
            # keep the memory updated in _iteration_pre, and advance prevZ to
            # the current iterate (the next pair spans this transition)
            extra.update(
                {k: torch.where(_col(upd_qn, v.ndim), v, getattr(st, k))
                 for k, v in aux.qn.items()},
                qn_prevZ=torch.where(_col(upd_qn, 3), Z, st.qn_prevZ),
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
            Z=Z_new, lam=lam_new, sig=sig_new, w=w_new, zl=zl_new, zu=zu_new, mu=mu,
            delta_w=delta_w,
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
                                          aux.lowrank, aux.rho0)
            if out is None:
                return None
            dz, dlam, ok, dw_used, delta_w, rho_used, fac = out
            soc = (self._soc_step(st, aux, dz, ok, fac, rho_used, kkt_in) if self.soc_on
                   else None)
            if self.options.mu_strategy == "adaptive":
                self._log("filter_reset", aux.mu_changed)
            return self._iteration_post(st, aux, dz, dlam, ok, dw_used, delta_w, soc)

    def _log(self, name, value):
        self.mode_log.setdefault(name, []).append(value)

    def mode_events(self, name):
        """The per-iteration record of one of the solver modes' events
        since the last solve began, as a numpy array (iterations, ...):
        "soc_trigger", "soc_taken" (per instance: the correction was tried,
        taken) with soc; "wd_activate",
        "wd_rewind" with the watchdog; "filter_reset" with adaptive μ.
        Empty when the mode is off."""
        vals = self.mode_log.get(name, [])
        if not vals:
            return np.zeros((0,))
        if torch.is_tensor(vals[0]):
            return torch.stack(vals).cpu().numpy()
        return np.asarray(vals)

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
        self.kkt_attempt_rows, self.kkt_lifted_rows = 0, 0
        self.mode_log = {}
        live_table = self.options.print_level >= 5
        if live_table:
            print(
                f"{'iter':>4} {'objective':>14} {'inf_pr':>9} "
                f"{'inf_du':>9} {'lg(mu)':>7} {'||d||':>9} "
                f"{'lg(rg)':>7} {'alpha_du':>9} {'alpha_pr':>9} {'ls':>3}"
            )
        for k in range(max_iter):
            new = self._step(state, True)
            if new is None:
                break
            state = new
            self.last_steps += 1
            if live_table:
                self._print_iter_row(k, state)
            if callback is not None and callback(k, state) is False:
                break
        with torch.no_grad():
            obj = self.funcs.total_cost(state.Z)
        return IPMResult(
            Z=state.Z * self._v if self.options.nlp_scaling else state.Z,
            lam=state.lam, converged=state.converged, n_iter=state.n_iter,
            kkt_err=state.kkt_err, mu=state.mu, objective=obj,
        )

    def iteration_stats(self, state: IPMState, b: int = 0) -> dict:
        """Instance b's numbers of an iteration, as Ipopt's intermediate
        callback gives them; the objective in problem units."""
        with torch.no_grad():
            obj = self.funcs.total_cost(state.Z[b:b + 1])
        row = torch.stack([obj[0] / self.obj_scale] + [
            getattr(state, k)[b].to(obj.dtype)
            for k in ("n_iter", "e_pr", "e_dual", "mu", "d_norm", "reg_dw", "alpha_du",
                      "alpha", "ls_k")]).tolist()
        keys = ("obj_value", "iter_count", "inf_pr", "inf_du", "mu", "d_norm",
                "regularization_size", "alpha_du", "alpha_pr", "ls_trials")
        out = dict(zip(keys, row))
        out["iter_count"], out["ls_trials"] = int(out["iter_count"]), int(out["ls_trials"])
        return out

    def _print_iter_row(self, k: int, state: IPMState):
        """A row of the live iteration table (print_level >= 5), the JAX
        package's format: instance 0."""
        st = self.iteration_stats(state, 0)
        rg = st["regularization_size"]
        lg_rg = f"{math.log10(rg):7.1f}" if rg > 0 else "      -"
        mu = max(st["mu"], 1e-300)
        print(
            f"{k:>4} {st['obj_value']:>14.7e} {st['inf_pr']:>9.2e} "
            f"{st['inf_du']:>9.2e} {math.log10(mu):>7.1f} "
            f"{st['d_norm']:>9.2e} {lg_rg} {st['alpha_du']:>9.2e} "
            f"{st['alpha_pr']:>9.2e} {st['ls_trials']:>3}"
        )
