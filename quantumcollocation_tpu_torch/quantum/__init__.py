from .embedded import (
    EmbeddedOperator,
    embed,
    get_iso_vec_leakage_indices,
    get_iso_vec_subspace_indices,
    get_leakage_indices,
    get_subspace_indices,
    unembed,
)
from .fidelities import (
    density_pure_state_fidelity,
    fidelity,
    free_phase_iso_rotation,
    iso_fidelity,
    iso_vec_density_pure_state_fidelity,
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
    unitary_fidelity,
)
from .isomorphisms import (
    density_to_iso_vec,
    iso_D,
    iso_G,
    iso_operator_to_iso_vec,
    iso_operator_to_operator,
    iso_to_ket,
    iso_vec_to_density,
    iso_vec_to_iso_operator,
    iso_vec_to_operator,
    ket_to_iso,
    mat_to_iso,
    operator_to_iso_operator,
    operator_to_iso_vec,
)
from .operators import (
    GATES,
    PAULIS,
    annihilate,
    coherent_ket,
    create,
    haar_identity,
    haar_random,
    kron_all,
    lift,
    number_op,
    operator_from_string,
    quad_op,
)
from .systems import (
    CompositeQuantumSystem,
    OpenQuantumSystem,
    QuantumSystem,
    QuantumSystemCoupling,
)

# every public name, the submodules included, as the JAX package's quantum/
__all__ = [name for name in dir() if not name.startswith("_")]
