"""Utilities of the port: the scheduling strategies users pass."""
