"""Checkpoint conversion (counterpart of the JAX repo's
scripts/model_conversion/)."""
