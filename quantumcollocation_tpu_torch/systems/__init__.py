"""Physics model library: transmon, Rydberg and cat system templates."""

from .transmons import MultiTransmonSystem, TransmonDipoleCoupling, TransmonSystem
from .rydberg import RydbergChainSystem
from .cats import CatSystem, get_cat_controls

__all__ = [
    "MultiTransmonSystem",
    "TransmonDipoleCoupling",
    "TransmonSystem",
    "RydbergChainSystem",
    "CatSystem",
    "get_cat_controls",
]
