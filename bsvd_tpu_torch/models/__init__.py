"""Inference algorithms of the port."""
