"""Frozen copies of the port's host code, used by the reference alone."""
