from .constraints import (
    AbstractConstraint,
    BoundsConstraint,
    FinalQuantumStateFidelityConstraint,
    FinalUnitaryFidelityConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
    TimeStepsAllEqualConstraint,
)
from .objectives import (
    MinimumTimeObjective,
    Objective,
    ObjectiveTerm,
    QuadraticRegularizer,
    QuantumStateObjective,
    UnitaryInfidelityObjective,
)

__all__ = [
    "AbstractConstraint",
    "BoundsConstraint",
    "FinalQuantumStateFidelityConstraint",
    "FinalUnitaryFidelityConstraint",
    "FinalUnitaryFreePhaseFidelityConstraint",
    "MinimumTimeObjective",
    "Objective",
    "ObjectiveTerm",
    "QuadraticRegularizer",
    "QuantumStateObjective",
    "TimeStepsAllEqualConstraint",
    "UnitaryInfidelityObjective",
]
