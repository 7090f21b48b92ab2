"""Checks of the port that run on a CUDA card (not on the serving path)."""
