"""Collectives over a mesh's axes (``device``: SPMD verbs on a rank's
tensor, and the Megatron operators)."""
