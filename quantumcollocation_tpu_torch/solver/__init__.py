from .analytic import AnalyticStageDynamics, build_analytic_dynamics
from .ipm import InteriorPointSolver, IPMResult, IPMState
from .kkt import factor_kkt, solve_kkt, solve_with_factors
from .kkt_lanes import solve_kkt_lanes
from .options import IpoptOptions, PiccoloOptions, SolverOptions
from .stage_nlp import StageNLP, make_nlp_functions, scale_stage_nlp

__all__ = [
    "AnalyticStageDynamics",
    "IPMResult",
    "IPMState",
    "InteriorPointSolver",
    "IpoptOptions",
    "PiccoloOptions",
    "SolverOptions",
    "StageNLP",
    "build_analytic_dynamics",
    "factor_kkt",
    "make_nlp_functions",
    "scale_stage_nlp",
    "solve_kkt",
    "solve_kkt_lanes",
    "solve_with_factors",
]
