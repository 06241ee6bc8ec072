"""Physics model library: the transmon system template."""

from .transmons import TransmonSystem

__all__ = ["TransmonSystem"]
