from .problem import QuantumControlProblem, resolve_device
from .quantum_state_smooth_pulse import QuantumStateSmoothPulseProblem
from .unitary_smooth_pulse import UnitarySmoothPulseProblem

__all__ = [
    "QuantumControlProblem",
    "QuantumStateSmoothPulseProblem",
    "UnitarySmoothPulseProblem",
    "resolve_device",
]
