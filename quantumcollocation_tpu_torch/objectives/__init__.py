from .constraints import AbstractConstraint, BoundsConstraint, TimeStepsAllEqualConstraint
from .objectives import (
    Objective,
    ObjectiveTerm,
    QuadraticRegularizer,
    UnitaryInfidelityObjective,
)

__all__ = [
    "AbstractConstraint",
    "BoundsConstraint",
    "Objective",
    "ObjectiveTerm",
    "QuadraticRegularizer",
    "TimeStepsAllEqualConstraint",
    "UnitaryInfidelityObjective",
]
