from .params import (  # noqa: F401
    BN254,
    BLS12_381,
    CurveParams,
    HostField,
    curve_by_name,
)
