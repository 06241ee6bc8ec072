"""Stage-structured NLP and its batched block evaluators.

Counterpart of quantumcollocation_tpu/solver/stage_nlp.py.  Variables z_t
per knot couple only to t±1 through the defects F_t(z_t, z_{t+1}) and the
pair costs, so the KKT ingredients are block-tridiagonal:

    H_t  (d,d)   Hessian of the Lagrangian, stage-diagonal blocks
    C_t  (d,d)   Hessian coupling blocks (z_t, z_{t+1})
    A_t  (s,d)   defect Jacobian wrt z_t
    B_t  (s,d)   defect Jacobian wrt z_{t+1}
    Jg_t (m,d)   stage inequality Jacobian (g_t(z_t) >= 0)

The dynamics blocks come from the analytic assembly (solver/analytic.py)
where the NLP has one; otherwise from torch.func over the defect function
(the AD route): F and the A/B blocks by jacrev of defect(z_t, z_{t+1}) over
the pair, and the defect curvature -λ·∇²F of each pair either structured
(forward passes along the nl_coords only, where the defects are
nonlinear) or as the dense Hessian of -λ·F over the pair.  The cost blocks
come from torch.func (grad, hessian, vmap) over the objective's stage,
pair and terminal functions, the counterpart of the JAX package's jax.grad
/ jax.hessian; the inequality rows ineq(z, t) (m per knot, the rows of
every constraint stacked) get their Jacobian from torch.func.jacrev and
their curvature -w·∇²g inside the stage Hessian blocks.  Every evaluator
takes a (B, T, d) batch.  grad_lagrangian (the L-BFGS pair's ∇L) is
∇φ - J^T λ - Jg^T w.  Each λ·F and w·g is a product and a sum: `@` of two
vectors under torch.func's forward passes mixes float32 with float64
tangents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, hessian, jacrev, jvp, vmap

__all__ = [
    "StageNLP", "NLPFunctions", "make_nlp_functions", "scale_stage_nlp", "jt_blocks",
]


@dataclasses.dataclass
class StageNLP:
    """stage_cost(z, t) -> scalar summed over all T knots,
    pair_cost(z_t, z_{t+1}, t) -> scalar summed over t < T-1 (None: no
    pair terms), terminal_cost(z_T) -> scalar, defect(z_t, z_{t+1}, t) ->
    (s,) and ineq(z, t) -> (m,) rows g >= 0 (inactive rows return +1; None
    when m = 0) act on single knot rows; their constants live on `device`
    in `dtype`.  lb, ub, free_mask, z0 are (T, d) numpy.  analytic holds
    the structured dynamics (None: the AD route over `defect`); nl_coords
    the knot-row coordinates in which the defects are nonlinear (None:
    the dense pair Hessian)."""

    T: int
    d: int
    s: int
    m: int
    stage_cost: Callable
    terminal_cost: Callable
    lb: Any
    ub: Any
    free_mask: Any
    z0: Any
    dtype: Any
    device: Any
    analytic: Any = None
    ineq: Callable | None = None
    pair_cost: Callable | None = None
    defect: Callable | None = None
    nl_coords: Any = None


@dataclasses.dataclass
class NLPFunctions:
    """Batched whole-trajectory evaluators derived from a StageNLP."""

    total_cost: Callable  # (B, T, d) -> (B,)
    grad_cost: Callable  # (B, T, d) -> (B, T, d)
    cost_hess: Callable  # (B, T, d), w (B, T, m) -> H (B, T, d, d), C (B, T-1, d, d)
    defects: Callable  # (B, T, d) -> (B, T-1, s)
    jac_blocks: Callable  # (B, T, d) -> A, B (B, T-1, s, d)
    # the AD route (None with an analytic assembly):
    dyn_eval: Callable | None  # (B, T, d) -> F, A, B
    defect_curvature: Callable | None  # (B, T, d), λ -> Hc (B, T, d, d), Cc (B, T-1, d, d)
    grad_lagrangian: Callable  # (B, T, d), λ (B, T-1, s), w (B, T, m) -> (B, T, d)
    ineqs: Callable  # (B, T, d) -> (B, T, m)
    jac_ineq: Callable  # (B, T, d) -> (B, T, m, d)


def jt_blocks(A, B, lam):
    """J^T λ assembled from the Jacobian blocks: (B, T, d)."""
    out = A.new_zeros(A.shape[0], A.shape[1] + 1, A.shape[3])
    out[:, :-1] += torch.einsum("btsd,bts->btd", A, lam)
    out[:, 1:] += torch.einsum("btsd,bts->btd", B, lam)
    return out


def scale_stage_nlp(nlp: StageNLP, var_scale, defect_scale, ineq_scale, obj_scale):
    """The NLP in scaled coordinates ẑ = z / v:
    min s_obj φ(v∘ẑ)  s.t.  r ∘ F(v∘ẑ) = 0,  q ∘ g(v∘ẑ) >= 0,
    lb/v <= ẑ <= ub/v."""
    v_np = np.asarray(var_scale, dtype=float)
    v = torch.as_tensor(v_np, dtype=nlp.dtype, device=nlp.device)
    q = torch.as_tensor(np.asarray(ineq_scale, dtype=float), dtype=nlp.dtype, device=nlp.device)
    s_obj = float(obj_scale)
    r = torch.as_tensor(np.asarray(defect_scale, dtype=float), dtype=nlp.dtype,
                        device=nlp.device)
    stage, terminal, ineq = nlp.stage_cost, nlp.terminal_cost, nlp.ineq
    pair, defect = nlp.pair_cost, nlp.defect
    return dataclasses.replace(
        nlp,
        stage_cost=lambda z, t: s_obj * stage(v * z, t),
        terminal_cost=lambda zT: s_obj * terminal(v * zT),
        ineq=None if ineq is None else (lambda z, t: q * ineq(v * z, t)),
        pair_cost=None if pair is None else (
            lambda zt, ztp1, t: s_obj * pair(v * zt, v * ztp1, t)),
        defect=None if defect is None else (
            lambda zt, ztp1, t: r * defect(v * zt, v * ztp1, t)),
        lb=np.asarray(nlp.lb) / v_np[None, :],
        ub=np.asarray(nlp.ub) / v_np[None, :],
        z0=np.asarray(nlp.z0) / v_np[None, :],
        analytic=(
            nlp.analytic.with_scaling(v_np, defect_scale)
            if nlp.analytic is not None else None
        ),
    )


def make_nlp_functions(nlp: StageNLP) -> NLPFunctions:
    T, d, m = nlp.T, nlp.d, nlp.m
    ad = nlp.analytic is None
    if ad and nlp.defect is None:
        raise ValueError("a StageNLP needs an analytic assembly or a defect function")
    ts = torch.arange(T, device=nlp.device)
    ts_pair = ts[:-1]
    pair = nlp.pair_cost

    def cost_one(Z):
        total = vmap(nlp.stage_cost)(Z, ts).sum() + nlp.terminal_cost(Z[-1])
        if pair is not None:
            total = total + vmap(pair)(Z[:-1], Z[1:], ts_pair).sum()
        return total

    def pairs(Z):
        """(B, T-1, 2d): the rows [z_t | z_{t+1}]."""
        return torch.cat([Z[:, :-1], Z[:, 1:]], dim=-1)

    def add_pair_blocks(H, Hp):
        """H (B, T, d, d) plus the pair blocks Hp (B, T-1, 2d, 2d); returns
        (H, C)."""
        H[:, :-1] += Hp[..., :d, :d]
        H[:, 1:] += Hp[..., d:, d:]
        return H, Hp[..., :d, d:]

    term_hess = vmap(hessian(nlp.terminal_cost))
    if pair is not None:
        pair_hess = vmap(vmap(hessian(lambda zz, t: pair(zz[:d], zz[d:], t))),
                         in_dims=(0, None))
    if m > 0:
        def stage_lag(z, t, w_t):
            return nlp.stage_cost(z, t) - (w_t * nlp.ineq(z, t)).sum()

        lag_hess = vmap(vmap(hessian(stage_lag)), in_dims=(0, None, 0))
        ineq_all = vmap(vmap(nlp.ineq), in_dims=(0, None))
        jac_g = vmap(vmap(jacrev(nlp.ineq)), in_dims=(0, None))

        def ineqs(Z):
            return ineq_all(Z, ts)

        def jac_ineq(Z):
            return jac_g(Z, ts)
    else:
        stage_hess = vmap(vmap(hessian(nlp.stage_cost)), in_dims=(0, None))

        def ineqs(Z):
            return Z.new_zeros(Z.shape[0], T, 0)

        def jac_ineq(Z):
            return Z.new_zeros(Z.shape[0], T, 0, d)

    def cost_hess(Z, w=None):
        """Cost blocks, the pair costs' coupling blocks in C, with the
        inequality curvature -w·∇²g of each knot when m > 0."""
        H = lag_hess(Z, ts, w) if m > 0 else stage_hess(Z, ts)
        H[:, -1] += term_hess(Z[:, -1])
        if pair is None:
            return H, Z.new_zeros(Z.shape[0], T - 1, d, d)
        return add_pair_blocks(H, pair_hess(pairs(Z), ts_pair))

    dyn_eval = defect_curvature = None
    if ad:
        def defect_pair(zz, t):
            return nlp.defect(zz[:d], zz[d:], t)

        def defect_twice(zz, t):
            out = defect_pair(zz, t)
            return out, out

        jac_pair = vmap(vmap(jacrev(defect_twice, has_aux=True)), in_dims=(0, None))
        defect_all = vmap(vmap(defect_pair), in_dims=(0, None))

        def dyn_eval(Z):
            """F, A, B of the AD route: one jacrev pass over the pairs."""
            J, F = jac_pair(pairs(Z), ts_pair)
            return F, J[..., :d], J[..., d:]

        def defects(Z):
            return defect_all(pairs(Z), ts_pair)

        def jac_blocks(Z):
            return dyn_eval(Z)[1:]

        def lam_F(zz, t, lam_t):
            return -(lam_t * defect_pair(zz, t)).sum()

        nl = None if nlp.nl_coords is None else [int(i) for i in nlp.nl_coords]
        if nl is not None and 0 < len(nl) < d:
            # the defects are linear in every other coordinate (and in
            # z_{t+1}), so -λ·∇²F has support on the rows and columns nl:
            # len(nl) forward passes through its gradient instead of 2d
            g_lam_F = grad(lam_F)
            nl_idx = torch.as_tensor(nl, device=nlp.device)

            def curv_cols(zz, t, lam_t):
                E = torch.eye(2 * d, dtype=zz.dtype, device=zz.device)[nl_idx]
                return vmap(lambda e: jvp(lambda x: g_lam_F(x, t, lam_t), (zz,), (e,))[1])(E)

            cols_all = vmap(vmap(curv_cols), in_dims=(0, None, 0))

            def pair_curv(zz, lam):
                colsT = cols_all(zz, ts_pair, lam)  # (B, T-1, n_nl, 2d)
                Hp = zz.new_zeros(*zz.shape[:2], 2 * d, 2 * d)
                Hp[..., :, nl_idx] = colsT.transpose(-1, -2)
                Hp[..., nl_idx, :] = colsT
                return Hp
        else:
            dense = vmap(vmap(hessian(lam_F)), in_dims=(0, None, 0))

            def pair_curv(zz, lam):
                return dense(zz, ts_pair, lam)

        def defect_curvature(Z, lam):
            """(Hc, Cc): the blocks of -λ·∇²F."""
            return add_pair_blocks(Z.new_zeros(Z.shape[0], T, d, d), pair_curv(pairs(Z), lam))
    else:
        defects = nlp.analytic.defects

        def jac_blocks(Z):
            _, A, B, _ = nlp.analytic.dyn_eval(Z, second_order=False)
            return A, B

    grad_cost = vmap(grad(cost_one))

    def grad_lagrangian(Z, lam, w=None):
        # ∇φ - J^T λ - Jg^T w of L = φ - λ·F - w·g; the JAX package
        # differentiates the defects by AD, here J comes from the
        # first-order bank (kernel 5) or the AD route's blocks
        g = grad_cost(Z) - jt_blocks(*jac_blocks(Z), lam)
        if m > 0:
            g = g - torch.einsum("btmi,btm->bti", jac_ineq(Z), w)
        return g

    return NLPFunctions(
        total_cost=vmap(cost_one),
        grad_cost=grad_cost,
        cost_hess=cost_hess,
        defects=defects,
        jac_blocks=jac_blocks,
        grad_lagrangian=grad_lagrangian,
        ineqs=ineqs,
        jac_ineq=jac_ineq,
        dyn_eval=dyn_eval,
        defect_curvature=defect_curvature,
    )
