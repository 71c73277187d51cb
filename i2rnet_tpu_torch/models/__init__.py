"""Model modules of the port (eval path)."""
