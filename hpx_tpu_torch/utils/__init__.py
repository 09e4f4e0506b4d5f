"""Utilities of the port that stand in for what JAX provided."""
