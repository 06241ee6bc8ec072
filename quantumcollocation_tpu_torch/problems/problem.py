"""QuantumControlProblem: compile trajectory + objective + integrators into
a StageNLP and solve it with the batched interior-point method.

Counterpart of quantumcollocation_tpu/problems/problem.py.  Lowering:
integrators -> stacked defect rows; TimeStepsAllEqualConstraint -> extra
defect rows; trajectory bounds -> barrier bounds; initial/final pins ->
fixed masks.

Device rule: `device=None` means CUDA; without CUDA that raises, and the
caller passes device="cpu" to run on the CPU on purpose.  The dtype
follows SolverOptions.dtype, else float32 on CUDA and float64 on the CPU.
On CUDA, TF32 is switched off for matmuls and cuDNN
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False): reduced-precision float32 breaks the KKT arithmetic, as the JAX
package records for the TPU's default matmul precision.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..dynamics.integrators import (
    DerivativeIntegrator,
    QuantumStateExponentialIntegrator,
    QuantumStatePadeIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from ..dynamics.rollouts import rollout, unitary_rollout
from ..objectives.constraints import AbstractConstraint, TimeStepsAllEqualConstraint
from ..objectives.objectives import Objective
from ..solver.analytic import build_analytic_dynamics
from ..solver.ipm import InteriorPointSolver
from ..solver.options import PiccoloOptions, SolverOptions
from ..solver.stage_nlp import StageNLP
from ..trajectory.named_trajectory import NamedTrajectory

__all__ = ["QuantumControlProblem", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None -> CUDA (raises without it); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _resolve_dtype(options: SolverOptions, device: torch.device):
    if options.dtype is not None:
        return getattr(torch, options.dtype)
    return torch.float32 if device.type == "cuda" else torch.float64


class QuantumControlProblem:
    def __init__(
        self,
        traj: NamedTrajectory,
        objective: Objective,
        integrators: Sequence,
        *,
        constraints: Sequence[AbstractConstraint] = (),
        ipopt_options: SolverOptions | None = None,
        piccolo_options: PiccoloOptions | None = None,
        control_name: str = "a",
        system=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.trajectory = traj
        self.integrators = list(integrators)
        self.ipopt_options = ipopt_options or SolverOptions()
        self.piccolo_options = piccolo_options or PiccoloOptions()
        self.system = system
        self.control_name = control_name
        self.objective = objective
        self.dtype = _resolve_dtype(self.ipopt_options, self.device)
        self.constraints = []
        for con in constraints:
            if isinstance(con, TimeStepsAllEqualConstraint):
                self.integrators.append(con.as_integrator())
            elif con.ineq_dim(traj) > 0:
                raise NotImplementedError("stage inequality constraints are not ported yet")
            else:
                self.constraints.append(con)
        self._compile()

    def _compile(self):
        traj = self.trajectory
        T, d = traj.T, traj.dim
        if traj.global_data:
            raise NotImplementedError("global (free-phase) variables are not ported yet")
        s = sum(ig.defect_dim(traj) for ig in self.integrators)
        dt_dev = dict(dtype=self.dtype, device=self.device)
        stage_fns = [
            (t.weight, t.make(**dt_dev)) for t in self.objective.terms if t.kind == "stage"
        ]
        term_fns = [
            (t.weight, t.make(**dt_dev)) for t in self.objective.terms if t.kind == "terminal"
        ]

        def stage_cost(z, t):
            total = z.new_zeros(())
            for w, fn in stage_fns:
                total = total + w * fn(z, t)
            return total

        def terminal_cost(zT):
            total = zT.new_zeros(())
            for w, fn in term_fns:
                total = total + w * fn(zT)
            return total

        lb = np.full((T, d), -np.inf)
        ub = np.full((T, d), np.inf)
        free = np.ones((T, d), dtype=bool)
        z0 = np.array(traj.data, dtype=float)
        if self.piccolo_options.build_trajectory_constraints:
            for name, (lo, hi) in traj.bounds.items():
                sl = traj.comp_slice(name)
                lb[:, sl] = lo[None, :]
                ub[:, sl] = hi[None, :]
            for pins, t in ((traj.initial, 0), (traj.final, T - 1)):
                for name, val in pins.items():
                    sl = traj.comp_slice(name)
                    z0[t, sl] = val
                    free[t, sl] = False
        self._d = d
        self.nlp = StageNLP(
            T=T, d=d, s=s, m=0,
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            lb=lb, ub=ub, free_mask=free, z0=z0,
            dtype=self.dtype, device=self.device,
            analytic=(
                build_analytic_dynamics(traj, self.integrators, d)
                if self.piccolo_options.jacobian_structure else None
            ),
        )
        self.solver = InteriorPointSolver(
            self.nlp, self.ipopt_options, exact_hessian=self.piccolo_options.eval_hessian
        )
        self.result = None

    def initial_decision(self, batch: int = 1):
        """(batch, T, d) initial decisions (numpy, problem units)."""
        return np.broadcast_to(self.nlp.z0[None], (batch, *self.nlp.z0.shape)).copy()

    def write_back(self, Z_row) -> NamedTrajectory:
        """A trajectory carrying the solution row Z_row (T, d)."""
        return self.trajectory.with_data(np.asarray(Z_row, dtype=float)[:, : self._d])

    def solve(self, *, max_iter: int | None = None, callback=None):
        """Solve from the trajectory's guess and write the optimum back."""
        res = self.solver.solve(self.initial_decision(1), max_iter=max_iter, callback=callback)
        self.result = res
        self.trajectory = self.write_back(res.Z[0].double().cpu().numpy())
        if self.ipopt_options.print_level >= 3:
            print(
                f"[qct] converged={bool(res.converged[0])} iters={int(res.n_iter[0])} "
                f"kkt_err={float(res.kkt_err[0]):.3e} obj={float(res.objective[0]):.6e}"
            )
        return self

    def solve_batched(self, Z0, *, max_iter: int | None = None):
        """Solve a batch of initial decisions (B, T, d); returns IPMResult."""
        return self.solver.solve(Z0, max_iter=max_iter)

    def multistart_initial_decisions(self, n_seeds: int, *, sigma: float = 0.1, rng=None):
        """(n_seeds, T, d) numpy initial decisions with diverse,
        dynamics-consistent seeds: per seed (seed 0 stays clean) the
        interior controls are perturbed by sigma·N(0, 1) and clipped to
        their bounds, the derivative chain is recomputed, and every unitary
        and ket state is rolled out (float64) under the perturbed controls, so each
        seed starts with zero defects.  The draws are the JAX package's, in
        its order, so both give the same rows from one numpy Generator."""
        rng = rng or np.random.default_rng(0)
        traj = self.trajectory
        T = traj.T
        z0 = self.initial_decision(1)[0]
        dts = np.asarray(traj.get_timesteps(), dtype=np.float64)
        a_sl = traj.comp_slice(self.control_name)

        rows = np.broadcast_to(z0, (n_seeds, *z0.shape)).copy()
        a_all = np.array(rows[:, :, a_sl], dtype=np.float64)
        a_all[1:, 1:-1] += sigma * rng.standard_normal(a_all[1:, 1:-1].shape)
        if self.control_name in traj.bounds:
            lo, hi = traj.bounds[self.control_name]
            a_all = np.clip(a_all, lo[None, None, :], hi[None, None, :])
        rows[:, :, a_sl] = a_all

        for ig in self.integrators:
            if isinstance(ig, DerivativeIntegrator):
                x = rows[:, :, traj.comp_slice(ig.x_name)]
                diff = (x[:, 1:] - x[:, :-1]) / dts[None, : T - 1, None]
                rows[:, :, traj.comp_slice(ig.dx_name)] = np.concatenate(
                    [diff, diff[:, -1:]], axis=1
                )
        for ig in self.integrators:
            if isinstance(ig, (UnitaryExponentialIntegrator, UnitaryPadeIntegrator)):
                roll = unitary_rollout
            elif isinstance(ig, (QuantumStateExponentialIntegrator, QuantumStatePadeIntegrator)):
                roll = rollout
            else:
                continue
            s_sl = traj.comp_slice(ig.state_name)
            rows[:, :, s_sl] = roll(
                rows[0, 0, s_sl], a_all, np.broadcast_to(dts, (n_seeds, T)), ig.system,
                device=self.device,
            ).cpu().numpy()
        return rows

    solve_batch = solve_batched

    def get_objective(self) -> Objective:
        return self.objective
