"""Inference and training of the port."""
