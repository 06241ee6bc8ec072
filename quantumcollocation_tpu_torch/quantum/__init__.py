from .fidelities import fidelity, iso_fidelity, iso_vec_unitary_fidelity, unitary_fidelity
from .isomorphisms import (
    iso_G,
    iso_operator_to_iso_vec,
    iso_operator_to_operator,
    iso_to_ket,
    iso_vec_to_iso_operator,
    iso_vec_to_operator,
    ket_to_iso,
    operator_to_iso_operator,
    operator_to_iso_vec,
)
from .operators import GATES, PAULIS
from .systems import QuantumSystem

__all__ = [
    "GATES",
    "PAULIS",
    "QuantumSystem",
    "fidelity",
    "iso_G",
    "iso_fidelity",
    "iso_operator_to_iso_vec",
    "iso_operator_to_operator",
    "iso_to_ket",
    "iso_vec_to_iso_operator",
    "iso_vec_to_operator",
    "iso_vec_unitary_fidelity",
    "ket_to_iso",
    "operator_to_iso_operator",
    "operator_to_iso_vec",
    "unitary_fidelity",
]
