"""Port vs JAX package: the circom front end and the witness-extension VM
(vm/compiler.py, vm/mpc_vm.py, snark/shared.py).

Inline circom sources only (nothing here reads the reference's test
vectors).  Over BN254 the port's compiled tapes and host witnesses equal the
JAX package's; with every PRF seed pinned its REP3 share components equal
them too (tolerance 0), the opened witness equals `run_host`, and party i's
`b` equals party i-1's `a` at every slot.  The JAX REP3 runs come first.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu.snark.shared as ref_shared
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu.fields.params import BN254 as RBN254
from cocircom_tpu.mpc.driver import PlainDriver as RefPlainDriver
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.vm.compiler import compile_circom as ref_compile
from cocircom_tpu.vm.mpc_vm import WitnessExtension as RefVM
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BLS12_381, BN254
from cocircom_tpu_torch.io.r1cs import multiplier_chain
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.mpc.shamir import ShamirDriver
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.snark.shared import SharedInput, merge_inputs, split_input_rep3
from cocircom_tpu_torch.vm.compiler import compile_circom
from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension
from torch_port_util import pin_rep3_seeds, run_named, same

P = BN254.fr.p

# the inline sources of the JAX package's tests/test_vm.py and
# tests/test_rep3_binary.py, and one each for bit ops, sqrt, pow with
# guarded division and cmux, a binary-resident or/xor chain, and the
# multiplier chain
SOURCES = {
    "acc": """
    pragma circom 2.0.0;
    template Acc(N) {
        signal input in[N];
        signal output out;
        var acc = 0;
        for (var i = 0; i < N; i++) {
            if (i % 2 == 0) { acc += in[i] * in[i]; } else { acc += 2 * in[i]; }
        }
        out <== acc;
    }
    component main = Acc(5);
    """,
    "fib": """
    pragma circom 2.0.0;
    function fib(n) {
        var a = 0; var b = 1;
        for (var i = 0; i < n; i++) { var t = a + b; a = b; b = t; }
        return a;
    }
    template T() {
        signal input x;
        signal output out;
        signal output cmp;
        out <== x * fib(10);
        cmp <-- x > 5 ? 1 : 0;
    }
    component main = T();
    """,
    "cmp": """
    pragma circom 2.0.0;
    template Cmp() {
        signal input a;
        signal input b;
        signal output lt; signal output ge; signal output eq; signal output gt;
        lt <-- a < b;
        ge <-- a >= b;
        eq <-- a == b;
        gt <-- a > b;
    }
    component main = Cmp();
    """,
    "bits": """
    pragma circom 2.0.0;
    template Bits() {
        signal input a;
        signal input b;
        signal output bits[8];
        signal output x;
        signal output sh;
        for (var i = 0; i < 8; i++) { bits[i] <-- (a >> i) & 1; }
        x <-- (a & b) + (a | b) + (a ^ b);
        sh <-- (a << 3) + (b >> 2);
    }
    component main = Bits();
    """,
    "bitchain": """
    pragma circom 2.0.0;
    template BitChain() {
        signal input a;
        signal input b;
        signal output x;
        x <-- ((a & b) ^ (a | b)) ^ 5;
    }
    component main = BitChain();
    """,
    "sqrt": """
    pragma circom 2.0.0;
    function sqrt(n) { return n; }
    template Sqrt() {
        signal input a[3];
        signal output r[3];
        for (var i = 0; i < 3; i++) { r[i] <-- sqrt(a[i]); }
    }
    component main = Sqrt();
    """,
    "arith": """
    pragma circom 2.0.0;
    template Arith() {
        signal input a;
        signal input b;
        signal input c;
        signal output p5;
        signal output q;
        signal output g;
        signal output h;
        p5 <-- a ** 5;
        q <-- a / b;
        g <-- c ? a * b : b - a;
        var t = 1;
        if (c) { t = a / b; }
        h <-- t;
    }
    component main = Arith();
    """,
    "chain": """
    pragma circom 2.0.0;
    template Chain(N) {
        signal input a;
        signal output y;
        signal x[N];
        x[0] <== a;
        for (var i = 1; i < N; i++) { x[i] <== x[i-1] * a; }
        y <== x[N-1] * a;
    }
    component main {public [a]} = Chain(5);
    """,
}

# inputs in the circuit's input order; sqrt's are squares (roots 7, 2 and
# a random one); the arith and cmp cases take a secret zero divisor and the
# value p - 1 (which circom reads as -1)
ROOT = 0x1234567890ABCDEF1234567890ABCDEF
WIDE = (1 << 253) + 12345  # (p - 1) | WIDE >= p
INPUTS = {
    "acc": [{"in": [1, 2, 3, 4, 5]}],
    "fib": [{"x": 7}, {"x": 3}],
    "cmp": [{"a": 3, "b": 5}, {"a": P - 1, "b": 1}, {"a": 7, "b": 7}],
    "bits": [{"a": 0xB7, "b": 77}, {"a": P - 1, "b": WIDE}],
    "bitchain": [{"a": 0xB7, "b": 77}, {"a": P - 1, "b": WIDE}],
    "sqrt": [{"a": [49, 4, ROOT * ROOT % P]}],
    "arith": [{"a": 10, "b": 0, "c": 1}, {"a": P - 1, "b": 3, "c": 0}],
    "chain": [{"a": 3}],
}
REP3_CASES = [(n, i) for n in ("cmp", "bits", "sqrt", "arith") for i in range(len(INPUTS[n]))]
SHAMIR_CASES = [("acc", 0), ("arith", 0), ("arith", 1), ("chain", 0)]


def _flat(circuit, inputs) -> list:
    vals = []
    for name in circuit.input_slots:
        v = inputs[name]
        vals.extend(v if isinstance(v, list) else [v])
    return [x % P for x in vals]


def _decode(f, opened) -> list:
    return [int(v) for v in f.decode(opened)]


@pytest.mark.parametrize("name,case", REP3_CASES)
def test_rep3_run_shared_equals_reference(monkeypatch, name, case):
    """The tape under REP3 on both packages: share components equal party
    by party, the opened witness equal to run_host, and the sharing
    replicated (party i's b is party i-1's a at every slot)."""
    pin_rep3_seeds(monkeypatch, ref_rep3, port_rep3)
    src, inputs = SOURCES[name], INPUTS[name][case]
    rf = ref_get_field(P, "bn254.fr")
    f = get_field(P, "bn254.fr", device="cpu")
    rc, pc = ref_compile(src, RBN254), compile_circom(src, BN254)
    flat = _flat(pc, inputs)
    rsh = ref_rep3.share_field_vec(rf, rf.encode(flat), seed=101 + case)
    psh = port_rep3.share_field_vec(f, f.encode(flat), seed=101 + case)

    def ref_party(i, net):
        d = ref_rep3.Rep3Driver(RBN254, net)
        vm = RefVM(d, rc)
        return vm.run_shared(rsh[i], vm.all_input_slots())

    def port_party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        vm = WitnessExtension(d, pc)
        w = vm.run_shared(psh[i], vm.all_input_slots())
        return w, _decode(f, d.open_many(w))

    ref = run_named(ref_run_parties, ref_party)
    got = run_named(run_parties, port_party)
    host = WitnessExtension(PlainDriver(BN254, device="cpu"), pc).run_host(inputs)
    for i, ((w, opened), rw) in enumerate(zip(got, ref)):
        assert same(w.a, rw.a) and same(w.b, rw.b), f"party {i}"
        assert opened == host
        assert bool((w.b == got[(i - 1) % 3][0].a).all()), f"party {i}: not replicated"


def test_run_shared_input_equals_reference(monkeypatch):
    """split_input_rep3 with `a` public and `b` shared, then
    run_shared_input: publics and witness share components equal to the
    JAX package's, the opened witness equal to run_host."""
    pin_rep3_seeds(monkeypatch, ref_rep3, port_rep3)
    src = """
    pragma circom 2.0.0;
    template M() {
        signal input a;
        signal input b;
        signal output y;
        signal output c;
        y <== a * b;
        c <-- a < b;
    }
    component main {public [a]} = M();
    """
    inputs = {"a": 5, "b": P - 2}
    rc, pc = ref_compile(src, RBN254), compile_circom(src, BN254)
    rsi = ref_shared.split_input_rep3(RBN254, inputs, rc.public_names, seed=7)
    psi = split_input_rep3(BN254, inputs, pc.public_names, seed=7, device="cpu")
    f = get_field(P, "bn254.fr", device="cpu")

    def ref_party(i, net):
        return RefVM(ref_rep3.Rep3Driver(RBN254, net), rc).run_shared_input(rsi[i])

    def port_party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        sw = WitnessExtension(d, pc).run_shared_input(psi[i])
        return sw, _decode(f, d.open_many(sw.witness))

    ref = run_named(ref_run_parties, ref_party)
    got = run_named(run_parties, port_party)
    host = WitnessExtension(PlainDriver(BN254, device="cpu"), pc).run_host(inputs)
    n_pub = len(got[0][0].public_inputs)
    for (sw, opened), rsw in zip(got, ref):
        assert sw.public_inputs == [int(v) for v in rsw.public_inputs] == host[:n_pub]
        assert same(sw.witness.a, rsw.witness.a) and same(sw.witness.b, rsw.witness.b)
        assert opened == host[n_pub:]


def test_merge_inputs_raises_on_the_reference_misuse_cases():
    """The three misuses the reference refuses, by both packages: a shared
    signal twice, a signal both public and shared, public values that
    differ.  A good merge keeps everything."""
    cases = [
        (({}, {"x": 1}), ({}, {"x": 2}), "multiple input shares"),
        (({"x": [1]}, {}), ({}, {"x": 2}), "both shared and public"),
        (({"x": [1]}, {}), ({"x": [2]}, {}), "differs between files"),
    ]
    for (pa, sa), (pb, sb), msg in cases:
        for si, merge in ((SharedInput, merge_inputs),
                          (ref_shared.SharedInput, ref_shared.merge_inputs)):
            with pytest.raises(ValueError, match=msg):
                merge(si(dict(pa), dict(sa)), si(dict(pb), dict(sb)))
    m = merge_inputs(SharedInput({"x": [1]}, {"y": 2}), SharedInput({"x": [1]}, {"z": 3}))
    assert m == SharedInput({"x": [1]}, {"y": 2, "z": 3})


def test_bit_chain_reduces_mod_p_where_the_reference_does_not():
    """((a & b) ^ (a | b)) ^ 5 keeps a | b and the inner xor in the binary
    domain.  circom reduces every bit op mod p, and so does run_host; the
    port reduces such a result before it stays in the domain.  The JAX
    package does not (ROADMAP section 3, fault i): where a | b >= p its
    witness differs from run_host, and the port's does not."""
    rf = ref_get_field(P, "bn254.fr")
    f = get_field(P, "bn254.fr", device="cpu")
    src = SOURCES["bitchain"]
    rc, pc = ref_compile(src, RBN254), compile_circom(src, BN254)
    cases = INPUTS["bitchain"]
    assert ((P - 1) | WIDE) >= P
    flat = [v for c in cases for v in _flat(pc, c)]
    rsh = ref_rep3.share_field_vec(rf, rf.encode(flat), seed=9)
    psh = port_rep3.share_field_vec(f, f.encode(flat), seed=9)

    def ref_party(i, net):
        d = ref_rep3.Rep3Driver(RBN254, net)
        vm = RefVM(d, rc)
        return [[int(v) for v in rf.from_limbs(rf.from_mont(d.open_many(vm.run_shared(
            ref_rep3.Rep3FieldShare(rsh[i].a[:, 2 * j: 2 * j + 2], rsh[i].b[:, 2 * j: 2 * j + 2]),
            vm.all_input_slots()))))] for j in range(len(cases))]

    def port_party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        vm = WitnessExtension(d, pc)
        return [_decode(f, d.open_many(vm.run_shared(d.slice(psh[i], 2 * j, 2 * j + 2),
                                                     vm.all_input_slots())))
                for j in range(len(cases))]

    host = WitnessExtension(PlainDriver(BN254, device="cpu"), pc)
    want = [host.run_host(c) for c in cases]
    assert want[1][1] == ((((P - 1) & WIDE) ^ (((P - 1) | WIDE) % P)) ^ 5) % P
    for got in run_parties(port_party):
        assert got == want
    ref = ref_run_parties(ref_party)[0]
    assert ref[0] == want[0]
    assert ref[1] != want[1] and ref[1][1] == (((P - 1) ^ WIDE) ^ 5) % P


@pytest.mark.parametrize("name,case", SHAMIR_CASES)
def test_shamir_run_shared_equals_host(name, case):
    """The arithmetic tapes under Shamir (t = 1, three parties): pow, guarded
    division by a secret zero, cmux, the chain; the opened witness equal to
    run_host.  A tape that needs the binary domain is refused."""
    src, inputs = SOURCES[name], INPUTS[name][case]
    pc = compile_circom(src, BN254)
    f = get_field(P, "bn254.fr", device="cpu")
    from cocircom_tpu_torch.mpc.shamir import share_field_vec_shamir

    shares = share_field_vec_shamir(f, f.encode(_flat(pc, inputs)), 1, 3, seed=5,
                                    device="cpu")

    def party(i, net):
        d = ShamirDriver(BN254, net, threshold=1, device="cpu")
        vm = WitnessExtension(d, pc)
        return _decode(f, d.open_many(vm.run_shared(shares[i], vm.all_input_slots())))

    host = WitnessExtension(PlainDriver(BN254, device="cpu"), pc).run_host(inputs)
    assert run_parties(party) == [host] * 3
    if case == 0 and name == "acc":
        cmp = compile_circom(SOURCES["cmp"], BN254)
        cmp_shares = share_field_vec_shamir(f, f.encode([3, 5]), 1, 3, seed=6, device="cpu")

        def refused(i, net):
            vm = WitnessExtension(ShamirDriver(BN254, net, threshold=1, device="cpu"), cmp)
            with pytest.raises(NotImplementedError, match="shamir driver"):
                vm.run_shared(cmp_shares[i], vm.all_input_slots())

        run_parties(refused)


def test_bls12_381_comparisons_equal_host():
    """The comparison tape over BLS12-381 Fr under REP3 (9-limb binary
    shares), held to run_host: the JAX package's a2b is wrong over this
    field (ROADMAP section 3, fault h), so it is not the oracle here."""
    p = BLS12_381.fr.p
    pc = compile_circom(SOURCES["cmp"], BLS12_381)
    f = get_field(p, "bls12_381.fr", device="cpu")
    cases = [(3, 5), (p - 1, 1), (7, 7), (0, p - 2)]
    flat = [v for ab in cases for v in ab]
    host = WitnessExtension(PlainDriver(BLS12_381, device="cpu"), pc)
    want = [host.run_host({"a": a, "b": b}) for a, b in cases]
    shares = [port_rep3.share_field_vec(f, f.encode(list(ab)), seed=j) for j, ab in enumerate(cases)]

    def party(i, net):
        d = port_rep3.Rep3Driver(BLS12_381, net, device="cpu")
        vm = WitnessExtension(d, pc)
        return [_decode(f, d.open_many(vm.run_shared(sh[i], vm.all_input_slots())))
                for sh in shares]

    assert len(flat) == 8
    for got in run_parties(party):
        assert got == want


def test_chain_witness_equals_multiplier_chain():
    """Chain(5) at a = 3: the host witness is multiplier_chain's, wire for
    wire, so the shared witness proves against that circuit's zkey; and
    run_shared_input under REP3 opens [1, 3^6, 3] and the same witness."""
    pc = compile_circom(SOURCES["chain"], BN254)
    _, vals = multiplier_chain(BN254, 5, 3)
    assert WitnessExtension(PlainDriver(BN254, device="cpu"), pc).run_host({"a": 3}) == vals
    sis = split_input_rep3(BN254, {"a": 3}, pc.public_names, seed=3, device="cpu")
    f = get_field(P, "bn254.fr", device="cpu")

    def party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        sw = WitnessExtension(d, pc).run_shared_input(sis[i])
        return sw.public_inputs, _decode(f, d.open_many(sw.witness))

    for publics, rest in run_parties(party):
        assert publics == [1, pow(3, 6, P), 3] == vals[:3]
        assert rest == vals[3:]


def test_scatter_keeps_the_last_duplicate_lane_as_the_reference():
    """A batch padded to a power of two repeats its last destination.  The
    JAX package's scatter keeps the LAST of the repeated lanes on the CPU;
    the port writes each destination once, with that lane."""
    idx = np.asarray([2, 0, 2, 2], np.int64)
    vals = np.arange(8, dtype=np.uint32).reshape(2, 4) + 1
    ref = np.asarray(jnp.zeros((2, 4), jnp.uint32).at[:, jnp.asarray(idx)].set(vals))
    vm = WitnessExtension(PlainDriver(BN254, device="cpu"), compile_circom(SOURCES["acc"], BN254))
    import torch

    got = vm._scatter(torch.zeros((2, 4), dtype=torch.int32), idx,
                      torch.from_numpy(vals.astype(np.int32)))
    assert np.array_equal(got.numpy(), ref.astype(np.int32))
    assert ref[0, 2] == vals[0, 3]


@pytest.mark.parametrize("name", list(SOURCES))
def test_compiler_and_host_witness_equal_reference(name):
    """compile_circom's tape and layout, and run_host's witness, equal the
    JAX package's for every source and input; the JAX circuit converted
    with `circuit_from_reference` equals the port's own."""
    rc, pc = ref_compile(SOURCES[name], RBN254), compile_circom(SOURCES[name], BN254)
    for k in ("levels", "input_slots", "output_slots", "public_names", "n_signals",
              "n_temps", "n_outputs"):
        assert getattr(pc, k) == getattr(rc, k), k
    assert convert.circuit_from_reference(rc) == pc
    for inputs in INPUTS[name]:
        want = RefVM(RefPlainDriver(RBN254), rc).run_host(inputs)
        vm = WitnessExtension(PlainDriver(BN254, device="cpu"), pc)
        assert vm.run_host(inputs) == want
        limbs = vm.run_plain_inputs(inputs)
        assert limbs.shape == (8, pc.n_vars) and limbs.dtype == np.uint32
