from .expm import (
    default_num_squarings,
    expm_frechet_bank,
    expm_pade,
    expm_squaring,
    frechet_pairs,
    pade_coefficients,
    pade_numerator_denominator,
    pade_poly_frechet,
)
from .integrators import (
    DerivativeIntegrator,
    QuantumStateExponentialIntegrator,
    QuantumStatePadeIntegrator,
    TimeStepEqualityIntegrator,
    UnitaryExponentialIntegrator,
    UnitaryPadeIntegrator,
)
from .rollouts import (
    batched_ket_rollout_fidelity,
    batched_rollout_fidelity,
    rollout,
    rollout_fidelity,
    unitary_rollout,
    unitary_rollout_fidelity,
)

__all__ = [
    "DerivativeIntegrator",
    "QuantumStateExponentialIntegrator",
    "QuantumStatePadeIntegrator",
    "TimeStepEqualityIntegrator",
    "UnitaryExponentialIntegrator",
    "UnitaryPadeIntegrator",
    "batched_ket_rollout_fidelity",
    "batched_rollout_fidelity",
    "default_num_squarings",
    "expm_frechet_bank",
    "expm_pade",
    "expm_squaring",
    "frechet_pairs",
    "pade_coefficients",
    "pade_numerator_denominator",
    "pade_poly_frechet",
    "rollout",
    "rollout_fidelity",
    "unitary_rollout",
    "unitary_rollout_fidelity",
]
