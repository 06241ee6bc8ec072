"""Stage-structured NLP and its batched block evaluators.

Counterpart of quantumcollocation_tpu/solver/stage_nlp.py.  Variables z_t
per knot couple only to t±1 through the defects F_t(z_t, z_{t+1}), so the
KKT ingredients are block-tridiagonal:

    H_t  (d,d)   Hessian of the Lagrangian, stage-diagonal blocks
    C_t  (d,d)   Hessian coupling blocks (z_t, z_{t+1})
    A_t  (s,d)   defect Jacobian wrt z_t
    B_t  (s,d)   defect Jacobian wrt z_{t+1}
    Jg_t (m,d)   stage inequality Jacobian (g_t(z_t) >= 0)

The dynamics blocks come from the analytic assembly (solver/analytic.py);
the cost blocks from torch.func (grad, hessian, vmap) over the objective's
stage and terminal functions, the counterpart of the JAX package's
jax.grad / jax.hessian; the inequality rows ineq(z, t) (m per knot, the
rows of every constraint stacked) get their Jacobian from torch.func.jacrev
and their curvature -w·∇²g inside the stage Hessian blocks.  Every
evaluator takes a (B, T, d) batch.  grad_lagrangian (the L-BFGS pair's ∇L)
is ∇φ - J^T λ - Jg^T w with J from the first-order propagator bank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, hessian, jacrev, vmap

__all__ = [
    "StageNLP", "NLPFunctions", "make_nlp_functions", "scale_stage_nlp", "jt_blocks",
]


@dataclasses.dataclass
class StageNLP:
    """stage_cost(z, t) -> scalar summed over all T knots,
    terminal_cost(z_T) -> scalar and ineq(z, t) -> (m,) rows g >= 0
    (inactive rows return +1; None when m = 0) act on single knot rows;
    their constants live on `device` in `dtype`.  lb, ub, free_mask, z0
    are (T, d) numpy."""

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


@dataclasses.dataclass
class NLPFunctions:
    """Batched whole-trajectory evaluators derived from a StageNLP."""

    total_cost: Callable  # (B, T, d) -> (B,)
    grad_cost: Callable  # (B, T, d) -> (B, T, d)
    cost_hess: Callable  # (B, T, d), w (B, T, m) -> H (B, T, d, d), C (B, T-1, d, d)
    defects: Callable  # (B, T, d) -> (B, T-1, s)
    jac_blocks: Callable  # (B, T, d) -> A, B (B, T-1, s, d)
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
    stage, terminal, ineq = nlp.stage_cost, nlp.terminal_cost, nlp.ineq
    return dataclasses.replace(
        nlp,
        stage_cost=lambda z, t: s_obj * stage(v * z, t),
        terminal_cost=lambda zT: s_obj * terminal(v * zT),
        ineq=None if ineq is None else (lambda z, t: q * ineq(v * z, t)),
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
    if nlp.analytic is None:
        raise NotImplementedError(
            "the port assembles dynamics analytically only "
            "(PiccoloOptions.jacobian_structure=True with Padé/exp/derivative "
            "integrators)"
        )
    ts = torch.arange(T, device=nlp.device)

    def cost_one(Z):
        return vmap(nlp.stage_cost)(Z, ts).sum() + nlp.terminal_cost(Z[-1])

    term_hess = vmap(hessian(nlp.terminal_cost))
    if m > 0:
        def stage_lag(z, t, w_t):
            # w·g as a product and a sum: `@` of two vectors under
            # hessian's forward pass mixes float32 with float64 tangents
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
        """Cost blocks, with the inequality curvature -w·∇²g of each knot
        when m > 0."""
        H = lag_hess(Z, ts, w) if m > 0 else stage_hess(Z, ts)
        H[:, -1] += term_hess(Z[:, -1])
        return H, Z.new_zeros(Z.shape[0], T - 1, d, d)

    def jac_blocks(Z):
        _, A, B, _ = nlp.analytic.dyn_eval(Z, second_order=False)
        return A, B

    grad_cost = vmap(grad(cost_one))

    def grad_lagrangian(Z, lam, w=None):
        # ∇φ - J^T λ - Jg^T w of L = φ - λ·F - w·g; the JAX package
        # differentiates the defects by AD, here J comes from the
        # first-order bank (kernel 5)
        g = grad_cost(Z) - jt_blocks(*jac_blocks(Z), lam)
        if m > 0:
            g = g - torch.einsum("btmi,btm->bti", jac_ineq(Z), w)
        return g

    return NLPFunctions(
        total_cost=vmap(cost_one),
        grad_cost=grad_cost,
        cost_hess=cost_hess,
        defects=nlp.analytic.defects,
        jac_blocks=jac_blocks,
        grad_lagrangian=grad_lagrangian,
        ineqs=ineqs,
        jac_ineq=jac_ineq,
    )
