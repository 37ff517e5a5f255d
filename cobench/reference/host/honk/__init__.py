"""Frozen copies of the port's host UltraHonk code (builder, keys, verifier)."""
