"""Utilities of the port (checkpoints)."""
