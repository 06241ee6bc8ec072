from .constraints import AbstractConstraint, BoundsConstraint, TimeStepsAllEqualConstraint
from .objectives import (
    Objective,
    ObjectiveTerm,
    QuadraticRegularizer,
    QuantumStateObjective,
    UnitaryInfidelityObjective,
)

__all__ = [
    "AbstractConstraint",
    "BoundsConstraint",
    "Objective",
    "ObjectiveTerm",
    "QuadraticRegularizer",
    "QuantumStateObjective",
    "TimeStepsAllEqualConstraint",
    "UnitaryInfidelityObjective",
]
