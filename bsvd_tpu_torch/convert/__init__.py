"""Checkpoint conversion into the port's parameter tree."""
