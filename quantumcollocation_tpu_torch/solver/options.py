"""Solver and framework option structs.

Counterpart of quantumcollocation_tpu/solver/options.py, field for field,
so a configuration carries over unchanged.  `resolve_modes` turns the
"auto" switches into the solver's modes exactly as the JAX solver does:

  fused_assembly  "auto": on iff the NLP has analytic propagator groups,
                  the Hessian is exact, recalc_y is off and
                  max(d, s) <= lanes_max_dim.  Off, the solver evaluates
                  the propagator bank (ops/prop_bank.py) and assembles the
                  blocks from it.  The ceiling is not only a TPU compile
                  limit: the fused kernel keeps a whole (instance, knot)
                  bank in one thread's registers, which does not fit at
                  the two-qubit sizes (n=8, K=5: 10,752 bytes of bank).
  kkt_refine      "auto": one refinement pass through the kept factors iff
                  kkt_backend == "lanes" and max(d, s) > lanes_max_dim.
                  An int is taken as given.  (The JAX solver also sends
                  max(d, s) > lanes_vec_max_dim to its XLA backend, without
                  refinement: a TPU compile ceiling the port does not have,
                  so lanes_vec_max_dim is not read here.)

matmul_precision and eval_precision are kept for surface parity and
ignored: the port's precision is its dtype (float32 on the GPU with TF32
off, float64 on the CPU).  kkt_backend "xla" and "lanes" both take the
fused sweep kernels (the name only feeds the kkt_refine rule);
"lanes_scan" takes the per-knot step kernels.  quasi_newton "lbfgs" (with
PiccoloOptions(eval_hessian=False)) runs the L-BFGS mode, lbfgs_memory
pairs.  The solver raises NotImplementedError for options whose code paths
are not ported yet (see InteriorPointSolver).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["SolverOptions", "IpoptOptions", "PiccoloOptions", "resolve_modes"]


@dataclasses.dataclass
class SolverOptions:
    """Options for the batched primal-dual interior-point solver; see the
    JAX package's SolverOptions for the meaning of each field."""

    print_level: int = 1
    max_iter: int = 100
    tol: float = 1e-8
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15
    mu_init: float = 1e-1
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_epsilon: float = 10.0
    tau_min: float = 0.99
    mu_strategy: str = "monotone"
    mu_max: float = 1e2
    delta_w_init: float = 1e-8
    delta_w_min: float = 1e-20
    delta_w_max: float = 1e6
    delta_c: float = 1e-8
    kkt_aug: Any = "auto"
    kkt_aug_rho_factor: float = 2.0
    kkt_aug_start: int = 1
    kkt_retry_warm: Any = "auto"
    kkt_retry_warm_min: float = 1e-6
    restoration: bool = True
    resto_trigger: int = 8
    fused_assembly: Any = "auto"
    kkt_refine: Any = "auto"
    resto_kappa: float = 0.1
    resto_zeta: float = 1e-3
    resto_max_iters: int = 10
    line_search: str = "merit"
    max_ls_iters: int = 10
    armijo_eta: float = 1e-4
    theta_max_fact: float = 1e4
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_ls: float = 1.0
    filter_size: int = 8
    watchdog_trials: int = 0
    soc: bool = False
    kappa_soc: float = 0.99
    recalc_y: bool = False
    recalc_y_feas_tol: float = 1e-6
    quasi_newton: str = "lbfgs"
    lbfgs_memory: int = 6
    dtype: str | None = None
    matmul_precision: str = "highest"
    eval_precision: str | None = None
    nlp_scaling: bool = True
    kkt_backend: str = "xla"
    lanes_max_dim: int = 24
    lanes_vec_max_dim: int | None = 64

    _ENUMS = {
        "mu_strategy": ("monotone", "adaptive"),
        "quasi_newton": ("lbfgs", "gauss-newton"),
        "kkt_backend": ("xla", "lanes", "lanes_scan", "cr"),
        "matmul_precision": ("default", "high", "highest"),
        "eval_precision": (None, "default", "high", "highest"),
        "dtype": (None, "float32", "float64"),
        "line_search": ("filter", "merit"),
    }

    def __post_init__(self):
        if isinstance(self.recalc_y, str):
            self.recalc_y = self.recalc_y.lower() in ("yes", "true", "on")
        if self.kkt_aug not in (True, False, "auto"):
            raise ValueError(
                f"SolverOptions.kkt_aug={self.kkt_aug!r} must be True, False, or 'auto'"
            )
        for field, allowed in self._ENUMS.items():
            if getattr(self, field) not in allowed:
                raise ValueError(
                    f"SolverOptions.{field}={getattr(self, field)!r} is not one of {allowed}"
                )

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


IpoptOptions = SolverOptions


def resolve_modes(o: SolverOptions, d: int, s: int, *, has_groups: bool,
                  exact_hessian: bool) -> tuple[bool, int]:
    """(fused_assembly_on, kkt_refine_n) for stage sizes d, s; see the
    module docstring."""
    big = max(d, s)
    if o.kkt_refine == "auto":
        refine = int(o.kkt_backend == "lanes" and big > o.lanes_max_dim)
    else:
        refine = int(o.kkt_refine)
    fa = o.fused_assembly
    fused = (
        has_groups and exact_hessian and not o.recalc_y
        and (big <= o.lanes_max_dim if fa == "auto" else bool(fa))
    )
    return bool(fused), refine


@dataclasses.dataclass
class PiccoloOptions:
    """Framework-level flags threaded through every problem template."""

    verbose: bool = True
    free_time: bool = True
    timesteps_all_equal: bool = True
    integrator: str = "pade"  # or "exponential"
    pade_order: int = 4
    rollout_integrator: str = "expm"
    geodesic: bool = True
    bound_state: bool = False
    eval_hessian: bool = True
    leakage_suppression: bool = False
    R_leakage: float = 1.0
    complex_control_norm_constraint_name: str | None = None
    complex_control_norm_constraint_radius: float = 1.0
    build_trajectory_constraints: bool = True
    jacobian_structure: bool = True

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)
