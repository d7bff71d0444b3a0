"""Dataset preparation scripts (counterparts of the JAX repo's
scripts/data_preparation/)."""
