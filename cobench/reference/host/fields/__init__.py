"""Curve parameters and host curve arithmetic (frozen copies)."""

from .params import BN254, BLS12_381, CurveParams, HostField, curve_by_name  # noqa: F401
