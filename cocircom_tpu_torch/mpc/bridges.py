"""Protocol bridges: REP3 -> Shamir share translation.

Each party deals a fresh degree-t Shamir sharing of its additive component
x_i (x = x0 + x1 + x2) and the parties sum the received sub-shares: one
communication round, semi-honest.
"""

from __future__ import annotations

from ..fields.params import CurveParams
from ..ops.field import get_field
from .net import Network
from .rep3 import Rep3FieldShare
from .shamir import _eval_poly_shares


def translate_rep3_to_shamir(curve: CurveParams, net: Network, share: Rep3FieldShare,
                             threshold: int = 1):
    """Each party Shamir-deals its additive component `a`; the result, on
    the share's device, is the sum of all parties' deals: a degree-t
    sharing of the replicated secret."""
    from ..utils.chacha import ChaChaStream, fresh_seed

    device = share.a.device
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    n = net.n_parties
    stream = ChaChaStream(fresh_seed(), domain=5, device=device)
    coeffs = [stream.rand_mont(fr, share.a.shape[1:]) for _ in range(threshold)]
    deals = _eval_poly_shares(fr, share.a, coeffs, list(range(1, n + 1)))
    for p in range(n):
        if p != net.id:
            net.send(p, deals[p])
    acc = deals[net.id]
    for p in range(n):
        if p != net.id:
            acc = fr.add(acc, net.recv(p).to(device))
    return acc
