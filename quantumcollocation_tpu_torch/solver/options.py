"""Solver and framework option structs.

Counterpart of quantumcollocation_tpu/solver/options.py, field for field,
so a configuration carries over unchanged.  `resolve_modes` turns the
"auto" switches into the solver's modes exactly as the JAX solver does:

  fused_assembly  "auto": on iff the NLP has analytic propagator groups,
                  the Hessian is exact, recalc_y is off,
                  max(d, s) <= lanes_max_dim, and the fused kernel is built
                  for every group's (n, K) (ops/dyn_assembly.py
                  SUPPORTED_NK; the JAX kernel takes any (n, K)).  Off, the
                  solver evaluates the propagator bank (ops/prop_bank.py)
                  and assembles the blocks from it, the route JAX's result
                  also comes from.  The ceiling is not only a TPU compile
                  limit: the fused kernel keeps a whole (instance, knot)
                  bank in shared memory, which does not fit at the
                  two-qubit sizes (n=8, K=5: 10,752 bytes of bank per
                  pair).  True with an (n, K) outside SUPPORTED_NK raises.
  kkt_route       from the stage sizes alone, as the JAX solver sends its
                  lanes backends to its XLA scan Riccati (JAX
                  solver/ipm.py:180-202): max(d, s) > max(lanes_max_dim,
                  lanes_vec_max_dim) takes "riccati_torch", the batched
                  Riccati of solver/kkt.py (torch.linalg.cholesky_ex and
                  solve_triangular, every instance at once; the JAX
                  counterpart has no Pallas kernel either); below it
                  "lanes_scan" for that backend, else "lanes" (the sweep
                  kernels, which take d, s <= 64).  The route is chosen,
                  not fallen back to: at or below the ceiling a refused
                  kernel launch still raises.
  kkt_refine      "auto": one refinement pass through the kept factors iff
                  the route is "lanes", kkt_backend == "lanes" and
                  max(d, s) > lanes_max_dim; none on "riccati_torch" (JAX's
                  "xla" rule).  An int is taken as given.

matmul_precision and eval_precision are kept for surface parity and
ignored: the port's precision is its dtype (float32 on the GPU with TF32
off, float64 on the CPU).  kkt_backend "xla" and "lanes" both take the
fused sweep kernels (the name only feeds the kkt_refine rule);
"lanes_scan" takes the per-knot step kernels.  With
PiccoloOptions(eval_hessian=False), quasi_newton "lbfgs" runs the L-BFGS
mode (lbfgs_memory pairs) and "gauss-newton" keeps the exact cost
Hessians without the defect curvature, which also keeps the fused assembly
off (it computes the curvature).  soc, watchdog_trials, mu_strategy
"adaptive" and print_level >= 5 run as in the JAX solver; kkt_backend "cr"
is not ported yet (the solver raises NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["SolverOptions", "IpoptOptions", "PiccoloOptions", "kkt_route", "resolve_modes"]


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


def kkt_route(o: SolverOptions, d: int, s: int) -> str:
    """"riccati_torch", "lanes_scan" or "lanes" for stage sizes d, s (see
    the module docstring)."""
    vec_max = o.lanes_max_dim if o.lanes_vec_max_dim is None else o.lanes_vec_max_dim
    if max(d, s) > max(o.lanes_max_dim, vec_max):
        return "riccati_torch"
    return "lanes_scan" if o.kkt_backend == "lanes_scan" else "lanes"


def resolve_modes(o: SolverOptions, d: int, s: int, *, group_nk=(), supported_nk=(),
                  exact_hessian: bool) -> tuple[bool, int, str]:
    """(fused_assembly_on, kkt_refine_n, kkt_route) for stage sizes d, s;
    group_nk holds the (n, K) of each analytic propagator group (empty
    without them), supported_nk the fused kernel's.  See the module
    docstring."""
    big = max(d, s)
    route = kkt_route(o, d, s)
    if o.kkt_refine == "auto":
        refine = int(route == "lanes" and o.kkt_backend == "lanes" and big > o.lanes_max_dim)
    else:
        refine = int(o.kkt_refine)
    fa = o.fused_assembly
    covered = set(group_nk) <= set(supported_nk)
    fused = (
        len(group_nk) > 0 and exact_hessian and not o.recalc_y
        and (big <= o.lanes_max_dim and covered if fa == "auto" else bool(fa))
    )
    if fused and not covered:
        raise NotImplementedError(
            f"fused_assembly=True: the fused kernel takes (n, K) in SUPPORTED_NK "
            f"{sorted(supported_nk)}, not {sorted(set(group_nk) - set(supported_nk))}"
        )
    return bool(fused), refine, route


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
