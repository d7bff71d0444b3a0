"""Metric scripts over image folders (counterparts of the JAX repo's
scripts/metrics/)."""
