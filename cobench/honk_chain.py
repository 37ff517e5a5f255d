"""The co-UltraHonk cells' circuit: a frozen copy of the Poseidon-style
permutation chain of `tests/torch_port_util.py` `poseidon_chain` (commit
e513b03), split so that the circuit comes from the configuration's seed
alone and the witness from each proof's inputs.

A round is an x^5 S-box on each lane of a width-4 state (three multiply
gates: x^2, x^4, x^5) and a width-4 linear layer (one gate a lane:
y_j = c_j + c_{j+1} + 2 c_{j+2} + rc_j): 16 assert_zero opcodes and 16 new
witnesses a round.  Lane 0 of the state is a public parameter, lanes 1-3
private ones, the last round's lane 0 the return value; the public inputs
are [lane 0 in, lane 0 out].  The round constants are full field elements
hashed from the seed, and the state is drawn a proof, so every proof of a
run has the same circuit (the same verifying key) and a fresh witness.

`circuit` takes the ACIR module whose types it builds: the program's
(`cocircom_tpu_torch.noir.acir`) for the provers, the reference's frozen
copy for the verifying key.  `witness` and `output` are host integers.
"""

from __future__ import annotations

import hashlib

LANES = 4
GATES_PER_ROUND = 16


def field_element(p: int, *tags) -> int:
    """A field element hashed from the tags (any values)."""
    text = ":".join(str(t) for t in tags).encode()
    return int.from_bytes(hashlib.sha512(text).digest(), "little") % p


def round_constants(p: int, seed: int, rounds: int) -> list:
    return [[field_element(p, seed, "rc", r, j) for j in range(LANES)] for r in range(rounds)]


def state(p: int, seed: int, k) -> list:
    """Proof k's input state: lane 0 public, lanes 1-3 private."""
    return [field_element(p, seed, "state", k, j) for j in range(LANES)]


def circuit(acir, p: int, rc: list):
    """The chain's ACIR circuit (witness indices as the values are made:
    the state 0-3, then 16 a round)."""
    E = acir.Expression
    n = LANES
    lanes = list(range(LANES))
    ops = []

    def new():
        nonlocal n
        n += 1
        return n - 1

    for consts in rc:
        c5 = []
        for j in range(LANES):
            s = lanes[j]
            a = new()
            ops.append(acir.Opcode("assert_zero", expr=E([(1, s, s)], [(p - 1, a)], 0)))
            b = new()
            ops.append(acir.Opcode("assert_zero", expr=E([(1, a, a)], [(p - 1, b)], 0)))
            c = new()
            ops.append(acir.Opcode("assert_zero", expr=E([(1, b, s)], [(p - 1, c)], 0)))
            c5.append(c)
        out = []
        for j in range(LANES):
            x0, x1, x2 = c5[j], c5[(j + 1) % LANES], c5[(j + 2) % LANES]
            y = new()
            ops.append(acir.Opcode("assert_zero", expr=E(
                [], [(1, x0), (1, x1), (2, x2), (p - 1, y)], consts[j])))
            out.append(y)
        lanes = out
    return acir.Circuit(current_witness_index=n - 1, opcodes=ops, expression_width=4,
                        private_parameters=[1, 2, 3], public_parameters=[0],
                        return_values=[lanes[0]], recursive=False)


def witness(p: int, rc: list, st: list) -> list:
    """Every witness value of the chain on input state `st`, in index order."""
    w = list(st)
    lanes = list(range(LANES))
    for consts in rc:
        c5 = []
        for j in range(LANES):
            s = w[lanes[j]]
            a = s * s % p
            b = a * a % p
            c = b * s % p
            w += [a, b, c]
            c5.append(c)
        base = len(w)
        for j in range(LANES):
            w.append((c5[j] + c5[(j + 1) % LANES] + 2 * c5[(j + 2) % LANES] + consts[j]) % p)
        lanes = list(range(base, base + LANES))
    return w


def output(p: int, rc: list, st: list) -> int:
    """The chain's return value (lane 0 after the last round)."""
    lanes = list(st)
    for consts in rc:
        c5 = [pow(x, 5, p) for x in lanes]
        lanes = [(c5[j] + c5[(j + 1) % LANES] + 2 * c5[(j + 2) % LANES] + consts[j]) % p
                 for j in range(LANES)]
    return lanes[0]
