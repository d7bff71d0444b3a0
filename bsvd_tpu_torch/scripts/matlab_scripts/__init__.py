"""MATLAB-parity data scripts (counterparts of the JAX repo's
scripts/matlab_scripts/)."""
