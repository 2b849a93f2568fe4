"""Microbenchmarks of the port: ``collectives.ici_bench``, the bandwidth of
the collectives the sharded engine uses, over a mesh's model group."""

from .collectives import ici_bench

__all__ = ["ici_bench"]
