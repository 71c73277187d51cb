"""Utilities of the port: checkpoints, and the entry points' logger and metric table."""
