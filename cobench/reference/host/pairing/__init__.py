"""The BN254 optimal ate pairing on host integers (frozen copies)."""
