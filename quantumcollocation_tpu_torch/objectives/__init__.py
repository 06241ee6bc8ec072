from .constraints import (
    AbstractConstraint,
    BoundsConstraint,
    ComplexModulusConstraint,
    ComplexModulusContraint,
    FinalQuantumStateFidelityConstraint,
    FinalUnitaryFidelityConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
    L1SlackConstraint,
    TimeStepsAllEqualConstraint,
)
from .objectives import (
    L1Regularizer,
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
    "ComplexModulusConstraint",
    "ComplexModulusContraint",
    "FinalQuantumStateFidelityConstraint",
    "FinalUnitaryFidelityConstraint",
    "FinalUnitaryFreePhaseFidelityConstraint",
    "L1Regularizer",
    "L1SlackConstraint",
    "MinimumTimeObjective",
    "Objective",
    "ObjectiveTerm",
    "QuadraticRegularizer",
    "QuantumStateObjective",
    "TimeStepsAllEqualConstraint",
    "UnitaryInfidelityObjective",
]
