"""Observability utilities of the port: the stage timer."""
