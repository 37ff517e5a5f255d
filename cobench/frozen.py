"""Frozen copies of the input generators and the round counter that the
benchmark's cells use.  Each is copied from the program's repository as it
stood at commit c520732 and is kept here so that a later change to the
program cannot change the yardstick:

- `synthetic_zkey`: `chip_smoke.py` `synthetic_zkey` (after `bench.py`'s
  synthetic circuit), returning every query's multipliers, not two, and
  drawing them from the run's seed;
- `counting_net`: `chip_smoke.py` `counting_net`.

The zkey is built through the program's own curve operations (it is the
program's input, in the program's layout); the reference reads only the
multipliers.
"""

from __future__ import annotations

from types import SimpleNamespace



def synthetic_zkey(curve, log_n: int, device, seed: int):
    """The zkey of a synthetic circuit at 2^log_n constraints, built on the
    device: n_vars = domain = 2^log_n, nc = domain - 10, one term a row in A
    and B (column 7j + 1 and 13j + 3 of row j, coefficient 1), every query
    point a known 15-bit odd multiple of the generator; alpha, beta, gamma,
    delta are 3, 5, 7, 11 times it.  Returns (zkey, multipliers) with
    multipliers {"a", "b1", "l", "h", "b2"} as int64 numpy arrays."""
    import torch

    from cocircom_tpu_torch.fields.ec_host import ec_mul
    from cocircom_tpu_torch.io.zkey import G1Array, G2Array
    from cocircom_tpu_torch.ops.curve import g1_ops, g2_ops
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.pairing.tower import Tower

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    g1, g2 = g1_ops(curve, device), g2_ops(curve, device)
    n_vars = domain = 1 << log_n
    n_public = 1
    nc = domain - 10
    wlen = n_vars - 1 - n_public
    gen = torch.Generator().manual_seed(seed)

    tower = Tower(curve)
    host_g1 = (tower.fp(curve.g1_gen[0]), tower.fp(curve.g1_gen[1]))
    (x0, x1), (y0, y1) = curve.g2_gen
    host_g2 = (tower.fp2(x0, x1), tower.fp2(y0, y1))

    def mul_g1(k):
        p = ec_mul(host_g1, k)
        return (p[0].v, p[1].v)

    def mul_g2(k):
        p = ec_mul(host_g2, k)
        return ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))

    def multipliers(n):
        return torch.randint(0, 1 << 15, (n,), generator=gen, dtype=torch.int64) | 1

    def gen_g1(n):
        k = multipliers(n)
        base = g1.encode_points([curve.g1_gen])
        pts = g1.scalar_mul(base, k[None].to(torch.int32).to(device), nbits=15)
        ax, ay = g1.to_affine_limbs(pts)
        return G1Array(ax, ay), k.numpy()

    def gen_g2(n, piece=1 << 17):
        k = multipliers(n)
        base = g2.encode_points([curve.g2_gen])
        parts = []
        for lo in range(0, n, piece):       # bounded working set
            pts = g2.scalar_mul(base, k[None, lo:lo + piece].to(torch.int32).to(device),
                                nbits=15)
            parts.append(g2.to_affine_limbs(pts))
        cat = lambda sel: torch.cat([sel(p) for p in parts], dim=1)  # noqa: E731
        return G2Array(cat(lambda p: p[0][0]), cat(lambda p: p[0][1]),
                       cat(lambda p: p[1][0]), cat(lambda p: p[1][1])), k.numpy()

    a_query, k_a = gen_g1(n_vars)
    b_g1_query, k_b1 = gen_g1(n_vars)
    l_query, k_l = gen_g1(wlen)
    h_query, k_h = gen_g1(domain)
    b_g2_query, k_b2 = gen_g2(n_vars)

    rows = torch.arange(nc, dtype=torch.int64, device=device)
    coeffs = fr.one_mont((nc,)).contiguous()
    mats = SimpleNamespace(
        num_constraints=nc, num_instance=n_public + 1,
        a_rows=rows, a_cols=(rows * 7 + 1) % n_vars, a_coeffs=coeffs,
        b_rows=rows, b_cols=(rows * 13 + 3) % n_vars, b_coeffs=coeffs)
    zkey = SimpleNamespace(
        curve=curve, n_vars=n_vars, n_public=n_public, domain_size=domain, pow=log_n,
        alpha_g1=mul_g1(3), beta_g1=mul_g1(5), beta_g2=mul_g2(5), gamma_g2=mul_g2(7),
        delta_g1=mul_g1(11), delta_g2=mul_g2(11),
        ic=None, a_query=a_query, b_g1_query=b_g1_query, b_g2_query=b_g2_query,
        l_query=l_query, h_query=h_query, matrices=mats)
    return zkey, {"a": k_a, "b1": k_b1, "l": k_l, "h": k_h, "b2": k_b2}


def payload_bytes(obj) -> int:
    """The bytes of a message's data: a tensor's or an array's elements,
    a string's or a byte string's length, containers summed, any other
    value 8 (the benchmark's own count, not the program's)."""
    nbytes = getattr(obj, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if hasattr(obj, "element_size"):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    if isinstance(obj, dict):
        return sum(payload_bytes(o) for o in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(payload_bytes(o) for o in obj)
    return 8


def counting_net(net):
    """A party's network that counts its messages to the next party (one a
    REP3 round) and, beyond the copy, the bytes of everything it sends."""
    from cocircom_tpu_torch.mpc.net import Network

    class Counted(Network):
        def __init__(self, inner):
            self.id, self.n_parties, self._inner, self.rounds = inner.id, inner.n_parties, inner, 0
            self.sent = 0

        def send(self, to, obj):
            self.rounds += to == self.next_id
            self.sent += payload_bytes(obj)
            self._inner.send(to, obj)

        def recv(self, frm):
            return self._inner.recv(frm)

        def stats(self):
            return self._inner.stats()

    return Counted(net)
