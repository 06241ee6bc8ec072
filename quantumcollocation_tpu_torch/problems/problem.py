"""QuantumControlProblem: compile trajectory + objective + integrators into
a StageNLP and solve it with the batched interior-point method.

Counterpart of quantumcollocation_tpu/problems/problem.py.  Lowering:
integrators -> stacked defect rows; TimeStepsAllEqualConstraint -> extra
defect rows; global variables (the free phases) -> appended to every knot
row (d_aug = d + Σ|global|), pinned at z = 0 for t < T-1 and free only at
the terminal knot, where the terminal costs and the free-phase floor read
them; inequality constraints -> m = Σ ineq_dim rows per knot, the
constraints' rows stacked, inactive knots +1; trajectory bounds -> barrier
bounds; initial/final pins -> fixed masks; objective terms -> stage, pair
and terminal costs.  The dynamics are assembled analytically where every
integrator has an analytic form and PiccoloOptions.jacobian_structure is
on; otherwise (a robustness accumulator, or jacobian_structure=False) the
NLP has analytic=None and the solver differentiates the stacked defect
function (the AD route), structured on the coordinates where the defects
are nonlinear (`_nonlinear_defect_coords`).

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

from ..dynamics import integrators as igs
from ..dynamics.integrators import (
    DensityOperatorExponentialIntegrator,
    DerivativeIntegrator,
    QuantumStateExponentialIntegrator,
    QuantumStatePadeIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from ..dynamics.rollouts import open_rollout, rollout, unitary_rollout
from ..objectives.constraints import (
    AbstractConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
    TimeStepsAllEqualConstraint,
)
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
            else:
                self.constraints.append(con)
        self._compile()

    def _compile(self):
        traj = self.trajectory
        T, d = traj.T, traj.dim
        self.global_slices = {}
        d_aug = d
        for name, val in traj.global_data.items():
            k = int(np.prod(np.shape(val)))
            self.global_slices[name] = (d_aug, d_aug + k)
            d_aug += k
        gslices = dict(self.global_slices)
        for con in self.constraints:
            if isinstance(con, FinalUnitaryFreePhaseFidelityConstraint):
                con.global_slices = gslices
        s = sum(ig.defect_dim(traj) for ig in self.integrators)
        dt_dev = dict(dtype=self.dtype, device=self.device)
        stage_fns = [
            (t.weight, t.make(**dt_dev)) for t in self.objective.terms if t.kind == "stage"
        ]
        term_fns = [
            (t.weight, t.make(**dt_dev)) for t in self.objective.terms if t.kind == "terminal"
        ]
        pair_fns = [
            (t.weight, t.make(**dt_dev)) for t in self.objective.terms if t.kind == "pair"
        ]

        def stage_cost(z, t):
            total = z.new_zeros(())
            for w, fn in stage_fns:
                total = total + w * fn(z, t)
            return total

        def terminal_cost(zT):
            globals_ = {name: zT[gs:ge] for name, (gs, ge) in gslices.items()}
            total = zT.new_zeros(())
            for w, fn in term_fns:
                total = total + w * fn(zT, globals_)
            return total

        def pair_cost(zt, ztp1, t):
            total = zt.new_zeros(())
            for w, fn in pair_fns:
                total = total + w * fn(zt, ztp1, t)
            return total

        integrators = self.integrators

        def defect(zt, ztp1, t):
            return torch.cat([ig.defect(zt, ztp1, traj) for ig in integrators], dim=-1)

        ineq_cons = [c for c in self.constraints if c.ineq_dim(traj) > 0]
        m = sum(c.ineq_dim(traj) for c in ineq_cons)
        ineq_fns = [c.make(traj, **dt_dev) for c in ineq_cons]

        def ineq(z, t):
            return torch.cat([fn(z, t) for fn in ineq_fns])

        lb = np.full((T, d_aug), -np.inf)
        ub = np.full((T, d_aug), np.inf)
        free = np.ones((T, d_aug), dtype=bool)
        z0 = np.zeros((T, d_aug))
        z0[:, :d] = traj.data
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
        for name, (gs, ge) in gslices.items():
            free[: T - 1, gs:ge] = False
            z0[T - 1, gs:ge] = np.asarray(traj.global_data[name], dtype=float).reshape(-1)
        self._d = d
        structure = self.piccolo_options.jacobian_structure
        self.nlp = StageNLP(
            T=T, d=d_aug, s=s, m=m,
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            ineq=ineq if m > 0 else None,
            pair_cost=pair_cost if pair_fns else None,
            defect=defect,
            nl_coords=self._nonlinear_defect_coords() if structure else None,
            lb=lb, ub=ub, free_mask=free, z0=z0,
            dtype=self.dtype, device=self.device,
            analytic=build_analytic_dynamics(traj, integrators, d_aug) if structure else None,
        )
        self.solver = InteriorPointSolver(
            self.nlp, self.ipopt_options, exact_hessian=self.piccolo_options.eval_hessian
        )
        self.result = None

    def _nonlinear_defect_coords(self):
        """The knot-row coordinates in which the defects are nonlinear:
        (controls, timestep) for the propagator integrators, (dx, timestep)
        for a derivative chain, (state, timestep) for the robustness
        accumulator; none for equal timesteps.  None (the dense pair
        Hessian) if an integrator is of another kind."""
        traj = self.trajectory
        tname = traj.timestep if isinstance(traj.timestep, str) else None
        idx = set()

        def add(name):
            if name is not None and name in traj.components:
                idx.update(range(*traj.components[name]))

        propagators = (igs.UnitaryExponentialIntegrator, igs.UnitaryPadeIntegrator,
                       igs.QuantumStateExponentialIntegrator, igs.QuantumStatePadeIntegrator,
                       igs.DensityOperatorExponentialIntegrator)
        for ig in self.integrators:
            ig_t = getattr(ig, "timestep_name", None) or tname
            if isinstance(ig, propagators):
                add(ig.control_name)
            elif isinstance(ig, igs.DerivativeIntegrator):
                add(ig.dx_name)
            elif isinstance(ig, igs.RobustnessAccumulatorIntegrator):
                add(ig.state_name)
            elif isinstance(ig, igs.TimeStepEqualityIntegrator):
                continue
            else:
                return None
            add(ig_t)
        return tuple(sorted(idx))

    def initial_decision(self, batch: int = 1):
        """(batch, T, d_aug) initial decisions (numpy, problem units)."""
        return np.broadcast_to(self.nlp.z0[None], (batch, *self.nlp.z0.shape)).copy()

    def write_back(self, Z_row) -> NamedTrajectory:
        """A trajectory carrying the solution row Z_row (T, d_aug): its
        knot data and the global variables read at the last knot."""
        Z_row = np.asarray(Z_row, dtype=float)
        traj = self.trajectory
        globals_ = dict(traj.global_data)
        globals_.update({name: Z_row[traj.T - 1, gs:ge].copy()
                         for name, (gs, ge) in self.global_slices.items()})
        return traj.with_data(Z_row[:, : self._d], global_data=globals_)

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
        """Solve a batch of initial decisions (B, T, d_aug); returns IPMResult."""
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
            elif isinstance(ig, DensityOperatorExponentialIntegrator):
                roll = open_rollout
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

    def get_constraints(self):
        return list(self.constraints)
