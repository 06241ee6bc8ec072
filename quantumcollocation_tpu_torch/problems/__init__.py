from .density_operator_smooth_pulse import DensityOperatorSmoothPulseProblem
from .multigoal import (
    UnitaryMultiGoalProblem,
    multigoal_initial_decisions,
    multigoal_rollout_fidelities,
    random_su,
)
from .problem import QuantumControlProblem, resolve_device
from .quantum_state_minimum_time import QuantumStateMinimumTimeProblem
from .quantum_state_smooth_pulse import QuantumStateSmoothPulseProblem
from .unitary_bang_bang import UnitaryBangBangProblem
from .unitary_minimum_time import UnitaryMinimumTimeProblem
from .unitary_robustness import UnitaryRobustnessProblem
from .unitary_sampling import UnitarySamplingProblem, UnitarySamplingProblemFromDistribution
from .unitary_smooth_pulse import UnitarySmoothPulseProblem

__all__ = [
    "DensityOperatorSmoothPulseProblem",
    "QuantumControlProblem",
    "QuantumStateMinimumTimeProblem",
    "QuantumStateSmoothPulseProblem",
    "UnitaryBangBangProblem",
    "UnitaryMinimumTimeProblem",
    "UnitaryMultiGoalProblem",
    "UnitaryRobustnessProblem",
    "UnitarySamplingProblem",
    "UnitarySamplingProblemFromDistribution",
    "UnitarySmoothPulseProblem",
    "multigoal_initial_decisions",
    "multigoal_rollout_fidelities",
    "random_su",
    "resolve_device",
]
