"""Port vs JAX package: the noir front end and the co-ACVM (noir/acir.py,
noir/solver.py, noir/rep3_driver.py, mpc/lut.py) and the CRS
(honk/crs.py, `driver_msm`).

Circuits built in code (tests/torch_port_util.py).  The JAX REP3 LUT run
comes first; tolerance 0 throughout: share components after the limb
repack, opened witnesses, points by affine value.
"""

import numpy as np
import pytest

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu.fields.params import BN254 as RBN254
from cocircom_tpu.honk import crs as ref_crs
from cocircom_tpu.mpc.lut import Rep3Lut as RefRep3Lut
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.noir.acir import load_program_json as ref_load
from cocircom_tpu.noir.solver import AcvmSolver as RefSolver
from cocircom_tpu.noir.solver import PlainNoirDriver as RefPlainNoirDriver
from cocircom_tpu.noir.solver import bind_toml_inputs as ref_bind
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu_torch.fields.params import BN254
from cocircom_tpu_torch.honk import crs
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.mpc.lut import Rep3Lut
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.noir.acir import (load_program_json, parse_witness_stack,
                                          write_witness_stack)
from cocircom_tpu_torch.noir.rep3_driver import Rep3NoirDriver
from cocircom_tpu_torch.noir.solver import AcvmSolver, PlainNoirDriver, Shared, bind_toml_inputs
from cocircom_tpu_torch.ops.field import get_field
from torch_port_util import (acir_program_json, memory_circuit, pin_rep3_seeds, poseidon_chain,
                             rand_ints, run_named, same, small_msm_engines,
                             squaring_chain)

P = BN254.fr.p
FIXTURES = {
    "chain": lambda: squaring_chain(6, 21),
    "poseidon": lambda: poseidon_chain(2, 22),
    "memory": lambda: memory_circuit(23),
}


def _ref_solve(c, abi, inputs):
    (rc,), _ = ref_load(acir_program_json(c, abi))
    s = RefSolver(RefPlainNoirDriver(RBN254.fr.p), rc)
    s.bind_inputs(inputs)
    out = s.solve()
    return [out.get(i, 0) for i in range(rc.current_witness_index + 1)]


def test_rep3_lut_components_equal_reference(monkeypatch):
    """Rep3Lut over 8 shared values with every PRF seed pinned: a read and a
    write at a shared index, each share component equal to the JAX
    package's, party by party; then, in the port alone, a read of a missing
    key (0) and contains_set; every opened value equal to Python
    integers."""
    pin_rep3_seeds(monkeypatch, ref_rep3, port_rep3)
    rf = ref_get_field(P, "bn254.fr")
    f = get_field(P, "bn254.fr", device="cpu")
    vals = rand_ints(P, 8, 31)
    needles = [5, 2, 11, 7]  # read index, write index, a missing key, write value
    rv = ref_rep3.share_field_vec(rf, rf.encode(vals), seed=32)
    rn = ref_rep3.share_field_vec(rf, rf.encode(needles), seed=33)
    pv = port_rep3.share_field_vec(f, f.encode(vals), seed=32)
    pn = port_rep3.share_field_vec(f, f.encode(needles), seed=33)

    def program(d, lut, v, nd):
        at = lambda i: d.index_share(nd, i)  # noqa: E731
        m = lut.init_map_public_keys(v)
        read = lut.read(at(0), m)
        m2 = lut.write(at(1), at(3), m)
        return m2, [read, m2.values]

    def opened(d, shares):
        return d.open_many(d.concat_shares(*[s if s.a.ndim > 1 else
                                             type(s)(s.a[:, None], s.b[:, None])
                                             for s in shares]))

    def ref_party(i, net):
        d = ref_rep3.Rep3Driver(RBN254, net)
        _, sh = program(d, RefRep3Lut(d), rv[i], rn[i])
        return [(np.asarray(s.a), np.asarray(s.b)) for s in sh], \
            [int(x) for x in rf.from_limbs(rf.from_mont(opened(d, sh)))]

    def port_party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        lut = Rep3Lut(d)
        m2, sh = program(d, lut, pv[i], pn[i])
        extra = [lut.read(d.index_share(pn[i], 2), m2),
                 lut.contains_set(d.index_share(pn[i], 3), m2.values)]
        return [(s.a, s.b) for s in sh], [int(x) for x in f.decode(opened(d, sh))], \
            [int(x) for x in f.decode(opened(d, extra))]

    ref = run_named(ref_run_parties, ref_party)
    got = run_named(run_parties, port_party)
    written = list(vals)
    written[needles[1]] = needles[3]
    for (shares, op, extra), (rshares, rop) in zip(got, ref):
        for (a, b), (ra, rb) in zip(shares, rshares):
            assert same(a, ra) and same(b, rb)
        assert op == rop == [vals[needles[0]]] + written
        assert extra == [0, 1]


def test_rep3_acvm_opens_plain_witness():
    """The port's co-ACVM under REP3 (Rep3NoirDriver: shared multiplies,
    ROM read and RAM write and read at shared indices through Rep3Lut)
    opens to the JAX package's plain solver's witness, on the ROM/RAM
    circuit and the squaring chain."""
    f = get_field(P, "bn254.fr", device="cpu")
    cases = [FIXTURES["memory"](), FIXTURES["chain"]()]
    shares = [port_rep3.share_field_vec(f, f.encode(inputs), seed=40 + k)
              for k, (_c, _abi, _w, inputs) in enumerate(cases)]

    def party(i, net):
        d = Rep3NoirDriver(port_rep3.Rep3Driver(BN254, net, device="cpu"))
        out = []
        for (c, _abi, _w, inputs), sh in zip(cases, shares):
            s = AcvmSolver(d, c)
            s.bind_inputs([Shared(d.d.index_share(sh[i], k)) for k in range(len(inputs))])
            wmap = s.solve()
            n = c.current_witness_index + 1
            vals = [wmap.get(k, 0) for k in range(n)]
            handles = [v.v if isinstance(v, Shared) else d.promote(int(v)) for v in vals]
            out.append(d.open_many(handles))
        return out

    got = run_parties(party, 3)
    for k, (c, abi, w, inputs) in enumerate(cases):
        want = _ref_solve(c, abi, inputs)
        assert want == w
        assert got[0][k] == got[1][k] == got[2][k] == want


def test_filecrs_driver_msm_equals_testcrs(tmp_path, monkeypatch):
    """A 64-point .dat setup (written by the port, read by both packages)
    committed through `driver_msm` (the plain driver's G1 MSM engine) equals
    the known-tau TestCrs commitment of a 64-coefficient polynomial."""
    tc = crs.TestCrs()
    pts = crs.generate_test_setup_g1(64, tc.tau)
    assert pts == ref_crs.generate_test_setup_g1(64, tc.tau)
    g1, g2 = str(tmp_path / "g1.dat"), str(tmp_path / "g2.dat")
    crs.write_g1_dat(g1, pts)
    with open(g2, "wb") as fh:
        for c in (tc.g2_x[0].c0, tc.g2_x[0].c1, tc.g2_x[1].c0, tc.g2_x[1].c1):
            fh.write(int(c.v).to_bytes(32, "big"))
    assert ref_crs.read_g1_dat(g1, 64) == crs.read_g1_dat(g1, 64) == pts
    restore = small_msm_engines(monkeypatch)
    try:
        fc = crs.FileCrs(g1, g2, 64, msm=crs.driver_msm(PlainDriver(BN254, device="cpu")))
        assert fc.g2_x[0].c0.v == tc.g2_x[0].c0.v and fc.g2_x[1].c1.v == tc.g2_x[1].c1.v
        poly = [pow(5, i, P) for i in range(64)]
        got, want = fc.commit(poly), tc.commit(poly)
        assert (got[0].v, got[1].v) == (want[0].v, want[1].v)
    finally:
        restore()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_acvm_and_inputs_equal_reference(name):
    """The plain ACVM's witness, the Prover.toml binding and the witness
    stack's bytes equal the JAX package's."""
    c, abi, w, inputs = FIXTURES[name]()
    s = AcvmSolver(PlainNoirDriver(P), c)
    s.bind_inputs(inputs)
    out = s.solve()
    got = [out.get(i, 0) for i in range(c.current_witness_index + 1)]
    assert got == _ref_solve(c, abi, inputs) == w
    toml = {p["name"]: hex(v) for p, v in zip(abi["parameters"], inputs)}
    assert bind_toml_inputs(abi, toml, P) == ref_bind(abi, toml, P) == [v % P for v in inputs]
    stack = write_witness_stack([(0, dict(enumerate(w)))])
    assert parse_witness_stack(stack) == [(0, dict(enumerate(w)))]
    from cocircom_tpu.noir.acir import write_witness_stack as ref_write

    assert stack == ref_write([(0, dict(enumerate(w)))])
    (pc,), pabi = load_program_json(acir_program_json(c, abi))
    assert pc == c and pabi == abi
