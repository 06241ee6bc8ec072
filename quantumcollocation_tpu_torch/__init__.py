"""quantumcollocation_tpu_torch — the PyTorch/CUDA port of quantumcollocation_tpu.

Direct collocation for quantum optimal control: a problem template compiles
into a stage-structured NLP, and a batched primal-dual interior-point
method solves it over a block-tridiagonal KKT system, many instances in
lockstep on one GPU.  The dynamics assembly and the two Riccati sweeps of
the KKT solve are hand-written CUDA kernels (csrc/); everything else is
plain PyTorch.  The package imports neither JAX nor the JAX package.
"""

from .dynamics import *  # noqa: F401,F403
from .dynamics import __all__ as _dynamics_all
from .objectives import *  # noqa: F401,F403
from .objectives import __all__ as _objectives_all
from .problems import *  # noqa: F401,F403
from .problems import __all__ as _problems_all
from .quantum import *  # noqa: F401,F403
from .quantum import __all__ as _quantum_all
from .solver import *  # noqa: F401,F403
from .solver import __all__ as _solver_all
from .trajectory import *  # noqa: F401,F403
from .trajectory import __all__ as _trajectory_all

__version__ = "0.1.0"

__all__ = (
    list(_quantum_all) + list(_trajectory_all) + list(_dynamics_all)
    + list(_objectives_all) + list(_solver_all) + list(_problems_all)
)
