from .problem import QuantumControlProblem, resolve_device
from .unitary_smooth_pulse import UnitarySmoothPulseProblem

__all__ = ["QuantumControlProblem", "UnitarySmoothPulseProblem", "resolve_device"]
