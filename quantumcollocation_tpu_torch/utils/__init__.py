"""Convenience accessors.

Counterpart of quantumcollocation_tpu/utils/: the rollout `fidelity` of a
problem or trajectory and the Krylov `expv` (utils/losses.py).  The
callbacks, serialization and plotting helpers are not ported yet.
"""

from .losses import expv, fidelity

__all__ = ["expv", "fidelity"]
