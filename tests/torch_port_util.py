"""Shared helpers of the tests that hold the PyTorch port to the JAX package.

Inputs are made from a seed with numpy and handed to both sides; the port
runs with device="cpu" on its plain versions; results are compared with
tolerance 0 (exact integer arithmetic), points by affine decode.
"""

import dataclasses

import numpy as np
import torch

from cocircom_tpu_torch import convert

# The plain versions are thousands of small tensor ops: more intra-op threads
# do not help them, and the test run has several worker processes already.
torch.set_num_threads(2)


PARTY_SEEDS = [bytes([i + 1]) * 32 for i in range(3)]


def pin_rep3_seeds(monkeypatch, *modules):
    """Party i's REP3 driver draws PARTY_SEEDS[i] as its PRF seed in every
    module named: parties construct their drivers in any order, so the
    seed is chosen by the calling thread's name (see `run_named`)."""
    import threading

    def pinned():
        return PARTY_SEEDS[int(threading.current_thread().name.split("-")[-1])]

    for m in modules:
        monkeypatch.setattr(m, "fresh_seed", pinned)


def run_named(run, fn, n: int = 3):
    """Run fn under the runner `run`, naming each party thread party-<i>."""
    import threading

    def wrapped(i, net):
        threading.current_thread().name = f"party-{i}"
        return fn(i, net)

    return run(wrapped, n)


def rand_ints(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


def to_port(limbs16) -> torch.Tensor:
    """reference limb array (jax or numpy) -> port tensor on the CPU."""
    return convert.field_from_reference(np.asarray(limbs16), device="cpu")


def same(port_tensor: torch.Tensor, ref_limbs16) -> bool:
    """Equal after the limb repack, bit for bit."""
    return np.array_equal(convert.field_to_reference(port_tensor),
                          np.asarray(ref_limbs16))


def multiplier_chain(curve, r1cs_cls, n_mul: int, a_val: int):
    """R1CS of y = a^(n_mul+1) as a chain of multiplications.  Wires: 0 = 1,
    1 = y (public output), 2 = a (public input), 3.. = intermediates.
    Returns (r1cs, witness values as ints)."""
    p = curve.fr.p
    vals = [1, None, a_val % p]
    cons = []
    cur = 2
    for i in range(n_mul):
        out = 1 if i == n_mul - 1 else len(vals)
        cons.append(([(cur, 1)], [(2, 1)], [(out, 1)]))
        v = vals[cur] * vals[2] % p
        if out == 1:
            vals[1] = v
        else:
            vals.append(v)
        cur = out
    r1cs = r1cs_cls(curve=curve, n_wires=len(vals), n_pub_out=1, n_pub_in=1, n_prv_in=0,
                    n_labels=len(vals), n_constraints=len(cons), constraints=cons,
                    wire_mapping=[])
    return r1cs, vals


def small_msm_engines(monkeypatch):
    """Rank split T = 2 for the engines both packages create during one
    test (fewer idle lanes at toy sizes); cached engines are dropped before
    and after so no other test sees them."""
    import cocircom_tpu.ops.msm as ref_msm
    import cocircom_tpu_torch.ops.msm as port_msm

    monkeypatch.setenv("COCIRCOM_MSM_T", "2")          # read by the JAX package
    monkeypatch.setattr(port_msm.MSM, "T_DEFAULT", 2)
    ref_msm.msm_engine.cache_clear()
    port_msm.msm_engine.cache_clear()

    def restore():
        ref_msm.msm_engine.cache_clear()
        port_msm.msm_engine.cache_clear()

    return restore


def plonk_chain(curve, r1cs_cls, n_mul: int, a_val: int):
    """`multiplier_chain` plus one constraint (a + x3 + x4) * 1 = s with s a
    new wire: PLONK's setup turns its three-term side into two additions,
    the second reading the first.  Returns (r1cs, witness values as ints)."""
    r1cs, vals = multiplier_chain(curve, r1cs_cls, n_mul, a_val)
    s = len(vals)
    vals = vals + [(vals[2] + vals[3] + vals[4]) % curve.fr.p]
    cons = list(r1cs.constraints) + [([(2, 1), (3, 1), (4, 1)], [(0, 1)], [(s, 1)])]
    return dataclasses.replace(r1cs, n_wires=len(vals), n_labels=len(vals),
                               n_constraints=len(cons), constraints=cons), vals


def run_tcp(fn, n: int = 3, tls=None, timeout: float = 300.0) -> list:
    """fn(party_id, net) in n threads named party-<i>, each over its own
    `TcpNetwork` on localhost with device="cpu" (tls: a list of n TlsConfig
    or None); returns the results and raises the first error.  A party's
    network is closed when it ends, so a failed party ends its peers'
    receives too."""
    import threading

    from chip_smoke import free_ports
    from cocircom_tpu_torch.mpc.net import TcpNetwork

    addrs = [("127.0.0.1", p) for p in free_ports(n)]
    results, errors = [None] * n, [None] * n

    def party(i):
        try:
            net = TcpNetwork(i, addrs, tls=None if tls is None else tls[i], device="cpu")
            try:
                results[i] = fn(i, net)
            finally:
                net.close()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=party, args=(i,), name=f"party-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a party thread did not finish"
    failed = [(i, e) for i, e in enumerate(errors) if e is not None]
    if failed:
        # a party's error often only ends its peers' receives: name them all
        first = failed[0][1]
        for i, e in failed[1:]:
            first.add_note(f"party {i} failed too: {e!r}")
        raise first
    return results
