"""Frozen copies of the port's ACIR format and Poseidon2."""
