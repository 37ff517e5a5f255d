"""Witness-extension VM: executes the leveled op tape.

Two execution paths (parity: circom-mpc-vm's driver-generic dispatch,
mpc_vm.rs:281-782, redesigned for vectorized execution):
  * host path (Plain): python-int semantics exactly mirroring the plain
    driver ground truth (mpc-core plain.rs:449-560 signed comparisons,
    biguint bit ops, integer div/mod).
  * share path (REP3/Shamir): per level, ops of the same kind are gathered
    and executed as ONE batched driver call — every multiplicative level is
    a single communication round regardless of circuit width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mpc.driver import as_index
from ..ops.curve import leaves, pmap
from ..ops.field import ints_to_limbs_np
from .compiler import CompiledCircuit


def _val(x: int, p: int) -> int:
    return x - p if x > p // 2 else x


def tonelli_shanks(n: int, p: int) -> int | None:
    """Square root mod p (None if non-residue); standard Tonelli-Shanks."""
    n %= p
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def _sqrt_host(a: int, p: int) -> int:
    """Field sqrt normalized to the root 'closest to zero' (non-negative in
    circom's signed convention) — parity: plain.rs:454-462 vm_sqrt."""
    r = tonelli_shanks(a, p)
    if r is None:
        raise ValueError(f"sqrt of non-residue {a}")
    return p - r if r > p // 2 else r


def _host_op(op: str, args: list[int], p: int) -> int:
    a = args[0] if args else 0
    b = args[1] if len(args) > 1 else 0
    if op == "add":
        return (a + b) % p
    if op == "sub":
        return (a - b) % p
    if op == "mul":
        return a * b % p
    if op == "div":
        # guarded-division semantics: x/0 -> 0 (the snarkjs `c ? 1/x : 0`
        # pattern evaluates both branches under cmux elaboration)
        return a * pow(b, -1, p) % p if b % p else 0
    if op == "idiv":
        return a // b
    if op == "mod":
        return a % b
    if op == "pow":
        return pow(a, b, p)
    if op == "neg":
        return (-a) % p
    if op == "lt":
        return int(_val(a, p) < _val(b, p))
    if op == "gt":
        return int(_val(a, p) > _val(b, p))
    if op == "le":
        return int(_val(a, p) <= _val(b, p))
    if op == "ge":
        return int(_val(a, p) >= _val(b, p))
    if op == "eq":
        return int(a == b)
    if op == "neq":
        return int(a != b)
    if op == "land":
        return int(bool(a) and bool(b))
    if op == "lor":
        return int(bool(a) or bool(b))
    if op == "lnot":
        return int(not a)
    if op == "band":
        return (a & b) % p
    if op == "bor":
        return (a | b) % p
    if op == "bxor":
        return (a ^ b) % p
    if op == "bnot":
        return (~a) % p
    if op == "shl":
        return (a << b) % p if b < 256 else 0
    if op == "shr":
        return (a >> b) if b < 256 else 0
    if op == "cmux":
        return args[1] if args[0] else args[2]
    if op == "sqrt":
        return _sqrt_host(a, p)
    raise ValueError(f"unknown op {op}")


def flatten_inputs(d):
    """input.json value -> flat list of ints (row-major, circom order).

    String values accept an optional '-' sign and 0x hex magnitudes, like
    the reference (bin/co-circom.rs:722-757 parse_field)."""
    if isinstance(d, list):
        out = []
        for e in d:
            out.extend(flatten_inputs(e))
        return out
    if isinstance(d, str):
        s = d.strip()
        neg = s.startswith("-")
        mag = s[1:] if neg else s
        v = int(mag, 16) if mag.lower().startswith("0x") else int(mag)
        return [-v if neg else v]
    return [int(d)]


class WitnessExtension:
    """Parity: circom-mpc-vm WitnessExtension::run (mpc_vm.rs:899)."""

    def __init__(self, driver, circuit: CompiledCircuit):
        self.d = driver
        self.c = circuit

    # ------------------------------------------------------------ host path

    def run_host(self, inputs: dict) -> list[int]:
        """Plain witness extension on host ints; returns full witness values
        [1, signals...]."""
        c = self.c
        p = c.curve.fr.p
        # flat value space: [witness slots | temps] — input slots are flat
        # indices (O2-eliminated inputs live in the temp range)
        flat = [0] * (c.n_vars + c.n_temps)
        flat[0] = 1
        self._bind_inputs(inputs, lambda s, v: flat.__setitem__(s, v % p))

        def get(o):
            k, v = o
            if k == "c":
                return v
            if k == "w":
                return flat[v]
            return flat[c.n_vars + v]

        for level in c.levels:
            for op, dst, ops_ in level:
                if op == "setc":
                    res = ops_[0][1] % p
                elif op == "sett":
                    res = get(ops_[0])
                else:
                    res = _host_op(op, [get(o) for o in ops_], p)
                if dst[0] == "w":
                    flat[dst[1]] = res
                else:
                    flat[c.n_vars + dst[1]] = res
        return flat[: c.n_vars]

    def all_input_slots(self) -> list[int]:
        out = []
        for slots in self.c.input_slots.values():
            out.extend(slots)
        return out

    def _bind_inputs(self, inputs: dict, setter):
        named = all(name in inputs for name in self.c.input_slots)
        if not named and "in" in inputs:
            # flat positional binding over all main inputs (the upstream KAT
            # harness convention, tests/witness_extension_tests/rep3.rs:81-99)
            flat = flatten_inputs(inputs["in"])
            slots = self.all_input_slots()
            if len(flat) != len(slots):
                raise ValueError(f"flat input: expected {len(slots)} values")
            for s, v in zip(slots, flat):
                setter(s, v)
            return
        for name, slots in self.c.input_slots.items():
            if name not in inputs:
                raise KeyError(f"missing input {name!r}")
            flat = flatten_inputs(inputs[name])
            if len(flat) != len(slots):
                raise ValueError(f"input {name!r}: expected {len(slots)} values")
            for s, v in zip(slots, flat):
                setter(s, v)

    def run_plain_inputs(self, inputs: dict) -> np.ndarray:
        """host path -> (L, n_vars) uint32 standard-form 32-bit limbs (the
        wtns payload)."""
        vals = self.run_host(inputs)
        return ints_to_limbs_np(vals, self.d.fr.L)

    # ------------------------------------------------------------ share path

    ARITH = {"add", "sub", "mul", "div", "neg", "cmux", "setc", "sett"}
    COMPARE = {"lt", "le", "gt", "ge", "eq", "neq"}
    LOGIC = {"land", "lor", "lnot", "bnot"}
    BINARY = {"band", "bor", "bxor"}  # need the a2b domain
    CONST2 = {"shl", "shr", "pow"}  # second operand must be public const

    def run_shared(self, input_share_vec, input_slot_order: list[int]):
        """MPC witness extension over a driver share-vec of main inputs.

        input_share_vec: driver share vec (N_inputs,) whose k-th element is
        the input signal for slot input_slot_order[k]. Returns the driver
        share-vec of the FULL witness (n_vars)."""
        V = self._init_signals()
        V = self._scatter(V, np.asarray(input_slot_order, np.int64), input_share_vec)
        V = self._exec_levels(V)
        return self.d.slice_share(V, 0, self.c.n_vars)

    def run_shared_input(self, shared_input):
        """Full MPC witness extension from a SharedInput: bind public inputs
        in-clear and private inputs as shares, execute, then post-process
        into a SharedWitness: open [1, outputs, public inputs] (the witness
        prefix) and keep the rest secret-shared.

        Parity: WitnessExtension::run + post_processing
        (circom-mpc-vm/src/mpc_vm.rs:899, :812-834)."""
        from ..snark.groth16 import SharedWitness

        d = self.d
        c = self.c
        fr = d.fr
        V = self._init_signals()
        amount_public = 0
        for name, slots in c.input_slots.items():
            idx = np.asarray(slots, np.int64)
            if name in shared_input.public_inputs:
                vals = shared_input.public_inputs[name]
                if len(vals) != len(slots):
                    raise ValueError(f"input {name!r}: expected {len(slots)} values")
                amount_public += len(vals)
                V = self._scatter(V, idx, d.promote_public(fr.encode(vals)))
            elif name in shared_input.shared_inputs:
                share = shared_input.shared_inputs[name]
                if leaves(share)[0].shape[1] != len(slots):
                    raise ValueError(f"input {name!r}: expected {len(slots)} shares")
                V = self._scatter(V, idx, share)
            else:
                raise KeyError(f"cannot find signal {name!r} in input share")
        V = self._exec_levels(V)
        n_pub = 1 + c.n_outputs + amount_public
        opened = d.open_many(d.slice_share(V, 0, n_pub))
        publics = [int(v) for v in fr.from_limbs(fr.from_mont(opened))]
        witness = d.slice_share(V, n_pub, c.n_vars)
        return SharedWitness(publics, witness)

    def _init_signals(self):
        d = self.d
        fr = d.fr
        total = self.c.n_vars + self.c.n_temps
        one = d.promote_public(fr.encode([1]))
        zeros = d.promote_public(fr.zeros((total - 1,)))
        return d.concat_shares(one, zeros)

    # ------------------------------------------------- BitShared analysis
    # Values produced by bit ops and consumed ONLY by bit ops stay in the
    # binary (XOR-shared) domain between ops, the upstream
    # Rep3VmType::BitShared (witness_extension_impl.rs:22-29). This kills
    # the a2b/b2a round-trips that dominate bit-decomposition circuits
    # (each `(x >> k) & 1` chain costs ONE shared a2b of x, local shifts,
    # one batched AND and a 2-round bit_inject, instead of 4 conversions).

    BIN_OPS = {"band", "bor", "bxor"}

    def _bin_analysis(self):
        """(binary_resident keys, value bit-widths) over the whole tape."""
        bitlen = self.d.binary.bitlen
        consumers: dict = {}
        producer_op: dict = {}
        for level in self.c.levels:
            for op, dst, ops_ in level:
                producer_op[dst] = op
                for pos, o in enumerate(ops_):
                    if o[0] in ("w", "t"):
                        consumers.setdefault(o, []).append((op, pos))
        binres = set()
        for key, op in producer_op.items():
            if key[0] != "t":
                continue  # witness slots must exit to arithmetic shares
            if op not in self.BIN_OPS and op != "shr":
                continue
            if all(
                cop in self.BIN_OPS or (cop == "shr" and pos == 0)
                for cop, pos in consumers.get(key, [])
            ):
                binres.add(key)
        width: dict = {}

        def w_of(o):
            if o[0] == "c":
                return max(int(o[1]).bit_length(), 1)
            return width.get(o, bitlen)

        for level in self.c.levels:  # levels are topologically ordered
            for op, dst, ops_ in level:
                if op in self.BIN_OPS:
                    a, b = w_of(ops_[0]), w_of(ops_[1])
                    width[dst] = min(a, b) if op == "band" else max(a, b)
                elif op == "shr" and ops_[1][0] == "c":
                    width[dst] = max(w_of(ops_[0]) - int(ops_[1][1]), 0)
        return binres, width

    @staticmethod
    def _pow2pad(lst):
        w = max(1, 1 << (len(lst) - 1).bit_length())
        return lst + [lst[-1]] * (w - len(lst))

    def _bin_gather(self, V, Vb, operands, oidx, binres):
        """Batched binary share for a list of operand descriptors (mixed
        binary-resident / arithmetic / constant sources)."""
        d = self.d
        bny = d.binary
        fr = d.fr
        dev = d.device
        out = bny.zeros((len(operands),))
        bpos = [(i, oidx(o)) for i, o in enumerate(operands)
                if o[0] != "c" and o in binres]
        cpos = [(i, int(o[1])) for i, o in enumerate(operands) if o[0] == "c"]
        apos = [(i, oidx(o)) for i, o in enumerate(operands)
                if o[0] != "c" and o not in binres]
        if bpos:
            pos = as_index([p for p, _ in bpos], dev)
            idx = as_index([x for _, x in bpos], dev)
            for o, src in zip(out, Vb):
                o[:, pos] = src.index_select(1, idx)
        if cpos:
            pos = as_index([p for p, _ in cpos], dev)
            bits = ints_to_limbs_np([v % fr.p for _, v in cpos], bny.L).view(np.int32)
            pub = bny.promote_public(torch.from_numpy(bits.copy()).to(dev))
            for o, src in zip(out, pub):
                o[:, pos] = src
        if apos:
            # dedup arithmetic sources: bit-decompositions consume the SAME
            # value hundreds of times per level; convert each source once
            uniq: dict = {}
            for _, x in apos:
                uniq.setdefault(x, len(uniq))
            src = self._pow2pad(list(uniq.keys()))
            gb = bny.a2b(d.gather(V, np.asarray(src, np.int64)))
            pos = as_index([p for p, _ in apos], dev)
            sel = as_index([uniq[x] for _, x in apos], dev)
            for o, g in zip(out, gb):
                o[:, pos] = g.index_select(1, sel)
        return out

    def _bin_store(self, V, Vb, dst_keys, res, binres, width, oidx, reduce=False):
        """Scatter batched binary results: binary-resident dsts stay in Vb;
        the rest exit via bit_inject (1-bit) or the general b2a.  With
        `reduce` (the results of bor / bxor, which may reach 2^bitlen) the
        binary-resident ones are first reduced mod p, as circom reduces
        every bit op; b2a reduces on its way out anyway."""
        d = self.d
        bny = d.binary
        groups = {"bin": [], "inj": [], "b2a": []}
        for i, k in enumerate(dst_keys):
            if k in binres:
                groups["bin"].append(i)
            elif width.get(k, bny.bitlen) <= 1:
                groups["inj"].append(i)
            else:
                groups["b2a"].append(i)
        for name, pos in groups.items():
            if not pos:
                continue
            posp = self._pow2pad(pos)
            lanes = as_index(posp, d.device)
            sub = pmap(lambda a: a.index_select(1, lanes), res)
            dsts = np.asarray([oidx(dst_keys[i]) for i in posp], np.int64)
            if name == "bin":
                Vb = self._scatter(Vb, dsts, bny.sub_p_cmux(sub) if reduce else sub)
            elif name == "inj":
                # bit_inject lifts the share COMPONENTS as field elements,
                # so they must be masked down to the single value bit (the
                # AND reshare re-randomizes components over all bits)
                onec = bny._bc(1, sub.a.shape[1:])
                V = self._scatter(V, dsts, bny.bit_inject(bny.and_public(sub, onec)))
            else:
                V = self._scatter(V, dsts, bny.b2a(sub))
        return V, Vb

    def _exec_levels(self, V):
        d = self.d
        c = self.c
        fr = d.fr

        def oidx(o):
            k, v = o
            return v if k == "w" else c.n_vars + v

        binres: set = set()
        bwidth: dict = {}
        Vb = None
        if hasattr(d, "binary"):
            binres, bwidth = self._bin_analysis()
            if binres:
                Vb = d.binary.zeros((c.n_vars + c.n_temps,))

        needs_binary = self.COMPARE | self.BINARY | {"shr", "sqrt"}
        for level in c.levels:
            by_op: dict = {}
            for op, dst, ops_ in level:
                if op not in (
                    self.ARITH | self.LOGIC | self.CONST2 | {"sqrt"}
                ) and not (op in needs_binary and hasattr(d, "binary")):
                    raise NotImplementedError(
                        f"op {op!r} on secret shares is not supported by the "
                        f"{d.protocol} driver (upstream parity: "
                        "witness_extension_impl.rs todo!)"
                    )
                if op in needs_binary and not hasattr(d, "binary"):
                    raise NotImplementedError(
                        f"op {op!r} needs the binary (a2b) domain, which the "
                        f"{d.protocol} driver does not provide"
                    )
                key = op
                if op in self.CONST2:
                    second = ops_[1]
                    if second[0] != "c":
                        raise NotImplementedError(
                            f"{op} with a secret shift/exponent is "
                            "unsupported (witness_extension_impl.rs:224,395)"
                        )
                    key = (op, int(second[1]))
                by_op.setdefault(key, []).append((dst, ops_))
            for key, items in by_op.items():
                op = key[0] if isinstance(key, tuple) else key
                # each batch is padded to a power of two by repeating its
                # last item, as the JAX package does: the padded width sets
                # how far the PRF streams advance
                items = self._pow2pad(items)
                dsts = np.asarray([oidx(dst) for dst, _ in items], np.int64)
                if op == "setc":
                    res = d.promote_public(fr.encode([o[0][1] for _, o in items]))
                elif op == "sett":
                    src = np.asarray([oidx(o[0]) for _, o in items], np.int64)
                    res = d.gather(V, src)
                elif op in ("add", "sub", "mul", "div"):
                    xs, ys = self._operands2(V, items, oidx)
                    if op == "add":
                        res = d.add(xs, ys)
                    elif op == "sub":
                        res = d.sub(xs, ys)
                    elif op == "mul":
                        res = d.mul_vec(xs, ys)
                    else:
                        res = d.mul_vec(xs, getattr(d, "inv_many_guarded", d.inv_many)(ys))
                elif op == "neg":
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    res = d.neg(xs)
                elif op == "cmux":
                    cs = self._gather_operand(V, [o[0] for _, o in items], oidx)
                    xs = self._gather_operand(V, [o[1] for _, o in items], oidx)
                    ys = self._gather_operand(V, [o[2] for _, o in items], oidx)
                    diff = d.sub(xs, ys)
                    res = d.add(d.mul_vec(cs, diff), ys)
                elif op in self.COMPARE:
                    xs, ys = self._operands2(V, items, oidx)
                    res = self._compare(op, xs, ys)
                elif op == "land":
                    xs, ys = self._operands2(V, items, oidx)
                    res = d.mul_vec(xs, ys)
                elif op == "lor":
                    xs, ys = self._operands2(V, items, oidx)
                    res = d.sub(d.add(xs, ys), d.mul_vec(xs, ys))
                elif op == "lnot":
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    res = d.sub(self._one(xs), xs)
                elif op == "bnot":
                    # (~a) mod p == (-a - 1) mod p: linear, no binary domain
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    res = d.neg(d.add(xs, self._one(xs)))
                elif op in self.BINARY:
                    # binary-domain path with BitShared residency: operands
                    # already in the XOR domain skip a2b, results consumed
                    # only by bit ops skip b2a.  An or / xor result that
                    # stays in the domain is reduced mod p first: the JAX
                    # package keeps it unreduced (as upstream's
                    # Rep3VmType::BitShared), so a chain such as
                    # (a & b) ^ (a | b) there differs from circom's (and
                    # run_host's) value whenever a | b >= p.
                    xb = self._bin_gather(V, Vb, [o[0] for _, o in items], oidx, binres)
                    yb = self._bin_gather(V, Vb, [o[1] for _, o in items], oidx, binres)
                    if op == "bxor":
                        rb = d.binary.xor(xb, yb)
                    elif op == "band":
                        rb = d.binary.and_(xb, yb)
                    else:
                        rb = d.binary.xor(d.binary.xor(xb, yb), d.binary.and_(xb, yb))
                    V, Vb = self._bin_store(V, Vb, [dst for dst, _ in items], rb,
                                            binres, bwidth, oidx, reduce=op != "band")
                    continue
                elif op == "shl":
                    s = key[1]
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    if s >= 256:
                        res = d.promote_public(fr.zeros(leaves(xs)[0].shape[1:]))
                    else:
                        res = d.mul_public(xs, fr._bc(fr.const_mont(1 << s), leaves(xs)[0]))
                elif op == "shr":
                    s = key[1]
                    if s >= 256:
                        xs, _ = self._operands2(V, items, oidx, unary=True)
                        res = d.promote_public(fr.zeros(leaves(xs)[0].shape[1:]))
                    else:
                        xb = self._bin_gather(V, Vb, [o[0] for _, o in items], oidx, binres)
                        V, Vb = self._bin_store(V, Vb, [dst for dst, _ in items],
                                                d.binary.shr(xb, s), binres, bwidth, oidx)
                        continue
                elif op == "pow":
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    res = self._pow_public(xs, key[1])
                elif op == "sqrt":
                    xs, _ = self._operands2(V, items, oidx, unary=True)
                    res = self._sqrt_shared(xs)
                V = self._scatter(V, dsts, res)
        return V

    def _one(self, xs):
        """The public 1 as a share of the batch shape of xs."""
        return self.d.promote_public(self.d.fr.one_mont(leaves(xs)[0].shape[1:]))

    def _compare(self, op, xs, ys):
        """Secret comparisons via the binary domain with circom's signed
        semantics: shift by -(p+1)/2 (val()), then unsigned circuits.
        Parity: rep3/witness_extension_impl.rs:280-340."""
        d = self.d
        fr = d.fr
        p = fr.p
        shift_c = fr._bc(fr.const_mont(p - (p + 1) // 2), leaves(xs)[0])
        one = self._one(xs)
        if op in ("eq", "neq"):
            bit = d.binary.is_zero(d.binary.a2b(d.sub(xs, ys)))
            res = d.binary.bit_inject(bit)
            return res if op == "eq" else d.sub(one, res)
        va = d.add_public(xs, shift_c)
        vb = d.add_public(ys, shift_c)
        if op == "ge":
            return d.binary.bit_inject(d.binary.unsigned_ge(va, vb))
        if op == "le":
            return d.binary.bit_inject(d.binary.unsigned_ge(vb, va))
        if op == "lt":
            ge = d.binary.bit_inject(d.binary.unsigned_ge(va, vb))
            return d.sub(one, ge)
        # gt = !(le)
        le = d.binary.bit_inject(d.binary.unsigned_ge(vb, va))
        return d.sub(one, le)

    def _pow_public(self, xs, e: int):
        """[x]^e, public exponent: square-and-multiply, ~2 log2(e) mul
        rounds (witness_extension_impl.rs:200-222)."""
        d = self.d
        if e == 0:
            return d.promote_public(d.fr.one_mont(leaves(xs)[0].shape[1:]))
        acc = xs
        for bit in bin(e)[3:]:  # MSB already consumed by acc = xs
            acc = d.mul_vec(acc, acc)
            if bit == "1":
                acc = d.mul_vec(acc, xs)
        return acc

    def _sqrt_shared(self, xs):
        """[sqrt(x)] normalized to the root closest to zero: masked-open
        sqrt (rep3.rs:400-447) + sign correction 2*is_pos*s - s
        (witness_extension_impl.rs:229-256)."""
        d = self.d
        s = d.sqrt_many(xs)
        zero = d.promote_public(d.fr.zeros(leaves(s)[0].shape[1:]))
        is_pos = self._compare("ge", s, zero)
        two_ips = d.add(is_pos, is_pos)
        return d.sub(d.mul_vec(two_ips, s), s)

    def _gather_operand(self, V, operands, oidx):
        d = self.d
        fr = d.fr
        idx = []
        consts = []
        for o in operands:
            if o[0] == "c":
                consts.append(o[1])
                idx.append(0)
            else:
                consts.append(None)
                idx.append(oidx(o))
        g = d.gather(V, np.asarray(idx, np.int64))
        if any(v is not None for v in consts):
            cvals = fr.encode([v or 0 for v in consts])
            mask = as_index([1 if v is not None else 0 for v in consts], d.device)
            mask = mask.to(torch.int32)[None, :]
            pub = d.promote_public(cvals * mask)
            keep = 1 - mask
            g = d.add(pmap(lambda x: x * keep, g), pub)
        return g

    def _operands2(self, V, items, oidx, unary=False):
        xs = self._gather_operand(V, [o[0] for _, o in items], oidx)
        ys = None if unary else self._gather_operand(V, [o[1] for _, o in items], oidx)
        return xs, ys

    def _scatter(self, V, idx, values):
        """V[:, idx] = values, in place, each destination written once.  A
        batch padded to a power of two names its last destination several
        times, and under REP3 the repeated lanes differ in their share
        components: the lane kept is the LAST one, as the JAX package's
        scatter keeps on the CPU, so that every party keeps the same lane
        and the sharing stays replicated."""
        idx = np.asarray(idx, np.int64)
        uniq, first_rev = np.unique(idx[::-1], return_index=True)
        dev = leaves(V)[0].device
        dst = as_index(uniq, dev)
        lanes = as_index(len(idx) - 1 - first_rev, dev)
        for base, v in zip(leaves(V), leaves(values)):
            base.index_copy_(1, dst, v.index_select(1, lanes))
        return V
