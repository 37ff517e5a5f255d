# Frozen copy of cocircom_tpu_torch/honk/builder.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""UltraCircuitBuilder — ACIR -> Ultra execution trace (host-side, one-time).

Parity: upstream co-noir/ultrahonk/src/parse/builder.rs
(GenericUltraCircuitBuilder :124, gate constructors :303-470, dummy
non-zero gates add_gates_to_ensure_all_polys_are_non_zero :1225,
plookup-accumulator gates :1620, finalize :1732, trace sizing :1845),
parse/acir_format.rs (circuit_serde_to_acir_format :94, gate
serialization :217-360), parse/plookup.rs (HonkDummyMulti :213), and
parse/types.rs (trace blocks :127, plookup tables :795-1014, RomTable
:379, FieldCT :501).

Values are plain ints mod p here; the co- variant stores driver share
handles in `variables` with the same gate layout (builder work is
data-independent except memory index resolution).
"""

from __future__ import annotations

from dataclasses import dataclass, field

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

NUM_WIRES = 4
NUM_SELECTORS = 13

# selector column order within a trace block (parse/types.rs:202-238)
SEL_QM, SEL_QC, SEL_Q1, SEL_Q2, SEL_Q3, SEL_Q4 = range(6)
SEL_QARITH, SEL_QDELTA, SEL_QELLIPTIC, SEL_QAUX = 6, 7, 8, 9
SEL_QLOOKUP, SEL_QPOSEXT, SEL_QPOSINT = 10, 11, 12

DUMMY_TAG = 0
REAL_VARIABLE = 0xFFFFFFFF - 1
FIRST_VARIABLE_IN_CLASS = 0xFFFFFFFF - 2
UNINITIALIZED_MEMORY_RECORD = 0xFFFFFFFF
NUM_RESERVED_GATES = 4

# BasicTableId enum values (plookup.rs:9-79; FixedBase block spans
# 15+14+15+14 ids starting at 44)
HONK_DUMMY_BASIC1 = 102
HONK_DUMMY_BASIC2 = 103


# --------------------------------------------------------------- ACIR side

@dataclass
class PolyTriple:
    a: int = 0
    b: int = 0
    c: int = 0
    q_m: int = 0
    q_l: int = 0
    q_r: int = 0
    q_o: int = 0
    q_c: int = 0

    def is_default(self) -> bool:
        return (self.a, self.b, self.c, self.q_m, self.q_l, self.q_r,
                self.q_o, self.q_c) == (0, 0, 0, 0, 0, 0, 0, 0)


@dataclass
class MulQuad:
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0
    mul_scaling: int = 0
    a_scaling: int = 0
    b_scaling: int = 0
    c_scaling: int = 0
    d_scaling: int = 0
    const_scaling: int = 0


@dataclass
class MemOpC:
    access_type: int
    index: PolyTriple
    value: PolyTriple


@dataclass
class BlockConstraint:
    init: list = field(default_factory=list)  # list[PolyTriple]
    trace: list = field(default_factory=list)  # list[MemOpC]
    type_: str = "ReturnData"  # CallData | ReturnData | ROM | RAM


@dataclass
class AcirFormat:
    varnum: int = 0
    recursive: bool = False
    public_inputs: list = field(default_factory=list)
    poly_triple_constraints: list = field(default_factory=list)
    quad_constraints: list = field(default_factory=list)
    block_constraints: list = field(default_factory=list)
    assert_equalities: list = field(default_factory=list)
    constrained_witness: set = field(default_factory=set)


def _serialize_arithmetic_gate(expr) -> PolyTriple:
    """acir_format.rs:217-278 — width-3 packing or default() on overflow."""
    pt = PolyTriple()
    a_set = b_set = c_set = False
    assert len(expr.mul_terms) <= 1
    if expr.mul_terms:
        c0, wl, wr = expr.mul_terms[0]
        pt.q_m = c0 % P
        pt.a, pt.b = wl, wr
        a_set = b_set = True
    assert len(expr.linear) <= 3
    for q, w in expr.linear:
        q = q % P
        if not a_set or pt.a == w:
            pt.a, pt.q_l, a_set = w, q, True
        elif not b_set or pt.b == w:
            pt.b, pt.q_r, b_set = w, q, True
        elif not c_set or pt.c == w:
            pt.c, pt.q_o, c_set = w, q, True
        else:
            return PolyTriple()
    pt.q_c = expr.q_c % P
    return pt


def _serialize_mul_quad_gate(expr) -> MulQuad:
    quad = MulQuad()
    a_set = b_set = c_set = d_set = False
    assert len(expr.mul_terms) <= 1
    if expr.mul_terms:
        c0, wl, wr = expr.mul_terms[0]
        quad.mul_scaling = c0 % P
        quad.a, quad.b = wl, wr
        a_set = b_set = True
    if len(expr.linear) > 4:
        raise ValueError("Cannot assign linear term to a constraint of width 4")
    for q, w in expr.linear:
        q = q % P
        if not a_set or quad.a == w:
            quad.a, quad.a_scaling, a_set = w, q, True
        elif not b_set or quad.b == w:
            quad.b, quad.b_scaling, b_set = w, q, True
        elif not c_set or quad.c == w:
            quad.c, quad.c_scaling, c_set = w, q, True
        elif not d_set or quad.d == w:
            quad.d, quad.d_scaling, d_set = w, q, True
        else:
            raise ValueError("Cannot assign linear term to a constraint of width 4")
    quad.const_scaling = expr.q_c % P
    return quad


def acir_to_format(circuit) -> AcirFormat:
    """noir.acir.Circuit -> AcirFormat (acir_format.rs:94-166)."""
    af = AcirFormat()
    af.varnum = circuit.current_witness_index + 1
    af.recursive = bool(getattr(circuit, "recursive", False))
    af.public_inputs = list(circuit.public_parameters) + list(circuit.return_values)

    blocks: dict = {}
    for op in circuit.opcodes:
        if op.kind == "assert_zero":
            expr = op.expr
            if len(expr.linear) <= 3:
                pt = _serialize_arithmetic_gate(expr)
                w1, w2 = _is_assert_equal(expr, pt, af)
                if w1 != 0:
                    if w1 != w2:
                        af.assert_equalities.append(pt)
                    # tautology (w1 == w2): dropped
                elif pt.is_default():
                    af.quad_constraints.append(_serialize_mul_quad_gate(expr))
                else:
                    af.poly_triple_constraints.append(pt)
            else:
                af.quad_constraints.append(_serialize_mul_quad_gate(expr))
            for _, w in expr.linear:
                af.constrained_witness.add(w)
            for _, wl, wr in expr.mul_terms:
                af.constrained_witness.add(wl)
                af.constrained_witness.add(wr)
        elif op.kind == "memory_init":
            bc = BlockConstraint()
            for w in op.init:
                bc.init.append(PolyTriple(a=w, q_l=1))
            bc.type_ = "ReturnData"
            blocks[op.block_id] = bc
        elif op.kind == "memory_op":
            bc = blocks[op.block_id]
            mem = op.mem
            is_rom = (not mem.operation.mul_terms and not mem.operation.linear
                      and mem.operation.q_c % P == 0)
            access = 0 if is_rom else 1
            if access == 1:
                assert bc.type_ not in ("CallData", "ReturnData") or True
                bc.type_ = "RAM"
            bc.trace.append(MemOpC(access,
                                   _serialize_arithmetic_gate(mem.index),
                                   _serialize_arithmetic_gate(mem.value)))
        else:
            raise NotImplementedError(f"ACIR opcode {op.kind} in builder")

    for bc in blocks.values():
        if bc.trace or bc.type_ == "ReturnData":
            af.block_constraints.append(bc)
    return af


def _is_assert_equal(expr, pt: PolyTriple, af: AcirFormat):
    if expr.mul_terms or len(expr.linear) != 2:
        return (0, 0)
    if (pt.q_l % P == (-pt.q_r) % P and pt.q_l % P != 0 and pt.q_c % P == 0
            and pt.a in af.constrained_witness and pt.b in af.constrained_witness):
        return (pt.a, pt.b)
    return (0, 0)


# ------------------------------------------------------------ trace blocks

class TraceBlock:
    __slots__ = ("wires", "selectors", "has_ram_rom", "is_pub_inputs")

    def __init__(self):
        self.wires = [[] for _ in range(NUM_WIRES)]
        self.selectors = [[] for _ in range(NUM_SELECTORS)]
        self.has_ram_rom = False
        self.is_pub_inputs = False

    def populate_wires(self, a, b, c, d):
        self.wires[0].append(a)
        self.wires[1].append(b)
        self.wires[2].append(c)
        self.wires[3].append(d)

    def push_selectors(self, **kw):
        """Push one row of selector values; missing names default to 0."""
        names = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_arith",
                 "q_delta_range", "q_elliptic", "q_aux", "q_lookup_type",
                 "q_poseidon2_external", "q_poseidon2_internal")
        for i, n in enumerate(names):
            self.selectors[i].append(kw.get(n, 0) % P)
        extra = set(kw) - set(names)
        if extra:
            raise TypeError(f"unknown selectors {extra}")

    def __len__(self):
        return len(self.selectors[0])


BLOCK_ORDER = ("pub_inputs", "arithmetic", "delta_range", "elliptic", "aux",
               "lookup", "poseidon_external", "poseidon_internal")


# ------------------------------------------------------------- ROM support

class FieldCT:
    """circuit value = mul*var[idx] + add (parse/types.rs:501-676)."""

    IS_CONSTANT = 0xFFFFFFFF

    def __init__(self, add=0, mul=1, idx=IS_CONSTANT):
        self.add = add % P
        self.mul = mul % P
        self.idx = idx

    @classmethod
    def from_witness_index(cls, idx):
        return cls(0, 1, idx)

    def is_constant(self):
        return self.idx == self.IS_CONSTANT

    def get_value(self, builder):
        if self.is_constant():
            return self.add
        m = builder.mpc
        if m is not None and m.is_shared(self.idx):
            from .co_builder import ShVal

            return ShVal(m.affine(m.get(self.idx), self.mul, self.add))
        return (self.mul * builder.get_variable(self.idx) + self.add) % P

    def normalize(self, builder):
        if self.is_constant() or (self.mul == 1 and self.add == 0):
            return self
        out = self.get_value(builder)
        idx = builder.add_variable(out)
        builder.create_add_gate(self.idx, self.idx, idx,
                                self.mul, 0, P - 1, self.add)
        return FieldCT.from_witness_index(idx)

    def assert_equal(self, other, builder):
        if self.is_constant() and other.is_constant():
            assert self.get_value(builder) == other.get_value(builder)
        elif self.is_constant():
            right = other.normalize(builder)
            builder.assert_equal_constant(right.idx, self.get_value(builder))
        elif other.is_constant():
            left = self.normalize(builder)
            builder.assert_equal_constant(left.idx, other.get_value(builder))
        else:
            builder.assert_equal(self.normalize(builder).idx,
                                 other.normalize(builder).idx)


# ---------------------------------------------------------------- builder

class UltraCircuitBuilder:
    def __init__(self, af: AcirFormat, witness: list[int], mpc=None):
        """witness: values for acir witnesses (may be shorter than varnum).

        mpc: optional co_builder.MpcBuilderValues — variable values may
        then live in MPC share space (ShVal); memory ops run obliviously
        and the value-pinning quirk is skipped (see co_builder.py)."""
        self.mpc = mpc
        self.variables: list[int] = []
        self.next_var_index: list[int] = []
        self.prev_var_index: list[int] = []
        self.real_variable_index: list[int] = []
        self.real_variable_tags: list[int] = []
        self.public_inputs: list[int] = list(af.public_inputs)
        self.tau = {DUMMY_TAG: DUMMY_TAG}
        self.constant_variable_indices: dict[int, int] = {}
        self.blocks = {n: TraceBlock() for n in BLOCK_ORDER}
        self.blocks["pub_inputs"].is_pub_inputs = True
        self.blocks["aux"].has_ram_rom = True
        self.num_gates = 0
        self.circuit_finalized = False
        self.failed = False  # bb failure flag: bad witness at construction
        self.failure_msg = ""
        self.current_tag = DUMMY_TAG
        self.rom_arrays: list[dict] = []
        self.ram_arrays: list[dict] = []
        self.range_lists: dict[int, dict] = {}
        self.lookup_tables: list[dict] = []
        self.memory_read_records: list[int] = []
        self.memory_write_records: list[int] = []
        # provider mode: oblivious-sorted RAM rows whose access type is a
        # SHARE (the sort permutation is secret); handles in mpc.mixed_access
        self.memory_mixed_rows: list[int] = []
        self.has_dummy_witnesses = not witness

        # reference init: zero_idx starts at 0 (builder.rs:216) and is only
        # reassigned AFTER the constant-zero variable is created, so the
        # fix_witness gate for it wires its unused slots to variable 0
        self.zero_idx = 0
        self.one_idx = 1  # set properly in add_gates_to_ensure...
        for v in witness[: af.varnum]:
            self.add_variable(v % P)
        for _ in range(len(witness), af.varnum):
            self.add_variable(0)
        self.zero_idx = self.put_constant_variable(0)

        self._build_constraints(af)

    # ----------------------------------------------------------- variables

    def add_variable(self, value) -> int:
        idx = len(self.variables)
        if type(value).__name__ == "ShVal":  # co_builder.ShVal (share space)
            self.variables.append(0)
            self.mpc.register(idx, value.h)
        else:
            self.variables.append(value % P)
        self.real_variable_index.append(idx)
        self.next_var_index.append(REAL_VARIABLE)
        self.prev_var_index.append(FIRST_VARIABLE_IN_CLASS)
        self.real_variable_tags.append(DUMMY_TAG)
        return idx

    def get_variable(self, idx: int) -> int:
        return self.variables[self.real_variable_index[idx]]

    def put_constant_variable(self, value: int) -> int:
        value %= P
        if value in self.constant_variable_indices:
            return self.constant_variable_indices[value]
        idx = self.add_variable(value)
        self.fix_witness(idx, value)
        self.constant_variable_indices[value] = idx
        return idx

    def assert_equal(self, a_idx: int, b_idx: int):
        m = self.mpc
        if m is None or not (m.is_shared(a_idx) or m.is_shared(b_idx)):
            assert self.get_variable(a_idx) == self.get_variable(b_idx)
        a_real = self.real_variable_index[a_idx]
        b_real = self.real_variable_index[b_idx]
        if a_real == b_real:
            return
        b_start = self._first_in_class(b_idx)
        self._update_real_indices(b_start, a_real)
        a_start = self._first_in_class(a_idx)
        self.next_var_index[b_real] = a_start
        self.prev_var_index[a_start] = b_real
        ta, tb = self.real_variable_tags[a_real], self.real_variable_tags[b_real]
        assert ta == DUMMY_TAG or tb == DUMMY_TAG or ta == tb
        if ta == DUMMY_TAG:
            self.real_variable_tags[a_real] = tb

    def assert_equal_constant(self, a_idx: int, b: int):
        m = self.mpc
        if m is None or not m.is_shared(a_idx):
            assert self.variables[a_idx] == b % P
        self.assert_equal(a_idx, self.put_constant_variable(b))

    # ------------------------------------------------- generalized perm tags
    # (bb ultra_circuit_builder: get_new_tag/create_tag/assign_tag — the tau
    # pairs drive the multiset equality between memory records and their
    # sorted duplicates via the id/sigma tag columns, proving_key.py:163-203)

    def get_new_tag(self) -> int:
        self.current_tag += 1
        return self.current_tag

    def create_tag(self, tag: int, tau_tag: int):
        self.tau[tag] = tau_tag

    def assign_tag(self, w_idx: int, tag: int):
        real = self.real_variable_index[w_idx]
        if self.real_variable_tags[real] == DUMMY_TAG:
            self.real_variable_tags[real] = tag

    def _first_in_class(self, idx: int) -> int:
        while self.prev_var_index[idx] != FIRST_VARIABLE_IN_CLASS:
            idx = self.prev_var_index[idx]
        return idx

    def _update_real_indices(self, idx: int, new_real: int):
        while idx != REAL_VARIABLE:
            self.real_variable_index[idx] = new_real
            idx = self.next_var_index[idx]

    # --------------------------------------------------------------- gates

    def create_poly_gate(self, pt: PolyTriple):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(pt.a, pt.b, pt.c, self.zero_idx)
        blk.push_selectors(q_m=pt.q_m, q_1=pt.q_l, q_2=pt.q_r, q_3=pt.q_o,
                           q_c=pt.q_c, q_arith=1)
        self.num_gates += 1

    def create_big_mul_gate(self, q: MulQuad):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(q.a, q.b, q.c, q.d)
        blk.push_selectors(q_m=q.mul_scaling, q_1=q.a_scaling, q_2=q.b_scaling,
                           q_3=q.c_scaling, q_c=q.const_scaling,
                           q_4=q.d_scaling, q_arith=1)
        self.num_gates += 1

    def create_add_gate(self, a, b, c, a_scaling, b_scaling, c_scaling,
                        const_scaling):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(a, b, c, self.zero_idx)
        blk.push_selectors(q_1=a_scaling, q_2=b_scaling, q_3=c_scaling,
                           q_c=const_scaling, q_arith=1)
        self.num_gates += 1

    def create_big_add_gate(self, a, b, c, d, a_s, b_s, c_s, d_s, const_s,
                            include_next_gate_w_4=False):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(a, b, c, d)
        blk.push_selectors(q_1=a_s, q_2=b_s, q_3=c_s, q_4=d_s, q_c=const_s,
                           q_arith=2 if include_next_gate_w_4 else 1)
        self.num_gates += 1

    def fix_witness(self, idx: int, value: int):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(idx, self.zero_idx, self.zero_idx, self.zero_idx)
        blk.push_selectors(q_1=1, q_c=-value, q_arith=1)
        self.num_gates += 1

    def _dummy_gate(self, block_name: str, a, b, c, d):
        blk = self.blocks[block_name]
        blk.populate_wires(a, b, c, d)
        blk.push_selectors()
        self.num_gates += 1

    # ----------------------------------------------------------------- ROM

    def create_rom_array(self, size: int) -> int:
        self.rom_arrays.append({
            "state": [[UNINITIALIZED_MEMORY_RECORD, UNINITIALIZED_MEMORY_RECORD]
                      for _ in range(size)],
            "records": [],
        })
        return len(self.rom_arrays) - 1

    def _create_rom_gate(self, rec: dict):
        rec["record_witness"] = self.add_variable(0)
        blk = self.blocks["aux"]
        # AuxSelectors::RomRead (builder.rs:1163-1186)
        blk.push_selectors(q_1=1, q_m=1, q_aux=1)
        blk.populate_wires(rec["index_witness"], rec["value1"], rec["value2"],
                          rec["record_witness"])
        rec["gate_index"] = len(blk) - 1
        # record the aux-block gate index so the oink prover adds the
        # eta-combination into w_4 at this row (proving_key.rs:145-163 +
        # oink compute_w4). The reference never populates these for its
        # builder (its ROM proving path is todo!) — we do, going beyond it:
        # ROM circuits prove and verify here. NOTE: the sorted-list
        # consistency gates (barretenberg process_ROM_array) are not yet
        # emitted, so adjacent-record checks (aux subrelations r1/r2) are
        # vacuous — same soundness posture as the reference's unreachable
        # path, but complete where the reference panics.
        self.memory_read_records.append(rec["gate_index"])
        self.num_gates += 1

    def set_rom_element(self, rom_id: int, index_value: int, value_witness: int):
        index_witness = (self.zero_idx if index_value == 0
                         else self.put_constant_variable(index_value))
        arr = self.rom_arrays[rom_id]
        assert arr["state"][index_value][0] == UNINITIALIZED_MEMORY_RECORD
        rec = {"index_witness": index_witness, "value1": value_witness,
               "value2": self.zero_idx, "index": index_value}
        arr["state"][index_value] = [value_witness, self.zero_idx]
        self._create_rom_gate(rec)
        arr["records"].append(rec)

    def read_rom_array(self, rom_id: int, index_witness: int) -> int:
        arr = self.rom_arrays[rom_id]
        m = self.mpc
        if m is not None and m.is_shared(index_witness):
            # oblivious read: LUT over the table's value handles; the
            # record keeps the index as a share handle for the oblivious
            # sort in finalize
            from .co_builder import ShVal

            state_w = [s[0] for s in arr["state"]]
            assert all(w != UNINITIALIZED_MEMORY_RECORD for w in state_w)
            vh = m.rom_read(state_w, index_witness, self)
            value_witness = self.add_variable(ShVal(vh))
            rec = {"index_witness": index_witness, "value1": value_witness,
                   "value2": self.zero_idx, "index": None,
                   "index_handle": m.get(index_witness)}
            self._create_rom_gate(rec)
            arr["records"].append(rec)
            return value_witness
        index = int(self.get_variable(index_witness))
        assert arr["state"][index][0] != UNINITIALIZED_MEMORY_RECORD
        value = self.get_variable(arr["state"][index][0])
        value_witness = self.add_variable(value)
        rec = {"index_witness": index_witness, "value1": value_witness,
               "value2": self.zero_idx, "index": index}
        self._create_rom_gate(rec)
        arr["records"].append(rec)
        return value_witness

    def _process_rom_arrays_finalize(self):
        for arr in self.rom_arrays:
            self._process_one_rom_array(arr)

    def _process_one_rom_array(self, arr):
        """barretenberg UltraCircuitBuilder::process_ROM_array: append a
        sorted duplicate of the record set (RomConsistencyCheck gates,
        q_1=q_2=q_aux=1) tied to the originals by a generalized-permutation
        tag pair, closed with a dummy row carrying index = max+1 so the
        final monotonicity check is pinned. This goes BEYOND the reference,
        which todo!()s here (co-noir/ultrahonk builder.rs:1773) — it makes
        the aux adjacency subrelations r1/r2 binding (relations.py:231-233),
        closing the ROM soundness gap both repos previously shared."""
        if not arr["records"]:
            return
        if any(rec["index"] is None for rec in arr["records"]):
            self._process_one_rom_array_mpc(arr)
            return
        read_tag = self.get_new_tag()
        sorted_tag = self.get_new_tag()
        self.create_tag(read_tag, sorted_tag)
        self.create_tag(sorted_tag, read_tag)
        records = sorted(arr["records"], key=lambda r: r["index"])
        blk = self.blocks["aux"]
        max_index = 0
        for rec in records:
            idx_w = self.add_variable(rec["index"])
            v1_w = self.add_variable(self.get_variable(rec["value1"]))
            v2_w = self.add_variable(self.get_variable(rec["value2"]))
            rec_w = self.add_variable(0)
            # AuxSelectors::RomConsistencyCheck
            blk.push_selectors(q_1=1, q_2=1, q_aux=1)
            blk.populate_wires(idx_w, v1_w, v2_w, rec_w)
            self.memory_read_records.append(len(blk) - 1)
            self.num_gates += 1
            self.assign_tag(rec["record_witness"], read_tag)
            self.assign_tag(rec_w, sorted_tag)
            max_index = max(max_index, rec["index"])
        # boundary row (no selectors): index = max+1 makes the last sorted
        # row's index_delta exactly 1, so r1 vanishes and r2 binds the top
        # of the sorted list (ultra_circuit_builder.cpp process_ROM_array)
        max_w = self.add_variable(max_index + 1)
        self._dummy_gate("aux", max_w, self.zero_idx, self.zero_idx,
                         self.zero_idx)

    def _process_one_rom_array_mpc(self, arr):
        """Shared-index variant: the sorted duplicate comes from an
        OBLIVIOUS bitonic sort over the records keyed by
        index * R + creation_rank (distinct keys reproduce the plain
        prover's stable sort exactly), gate/tag structure identical to the
        plain path. Secret-data-independent structure: every party emits
        the same gates. Beyond the reference, which cannot prove memory
        circuits collaboratively at all."""
        from .co_builder import ShVal

        m = self.mpc
        records = arr["records"]
        R = len(records)
        key_cols, idx_cols, v1_w, v2_w = [], [], [], []
        for rank, rec in enumerate(records):
            if rec["index"] is None:
                key_cols.append(m.affine(rec["index_handle"], R, rank))
                idx_cols.append(rec["index_handle"])
            else:
                key_cols.append(m.d.promote_public(
                    m.f.encode([rec["index"] * R + rank])))
                idx_cols.append(m.d.promote_public(
                    m.f.encode([rec["index"]])))
            v1_w.append(rec["value1"])
            v2_w.append(rec["value2"])
        keys = m.d.concat_shares(*key_cols)
        idxs = m.d.concat_shares(*idx_cols)
        v1 = m.value_vec(v1_w, self)
        v2 = m.value_vec(v2_w, self)
        s_idx, s_v1, s_v2 = m.sort_records(keys, [idxs, v1, v2])

        read_tag = self.get_new_tag()
        sorted_tag = self.get_new_tag()
        self.create_tag(read_tag, sorted_tag)
        self.create_tag(sorted_tag, read_tag)
        blk = self.blocks["aux"]
        for i, rec in enumerate(records):
            idx_w = self.add_variable(ShVal(m.d.slice_share(s_idx, i, i + 1)))
            v1w = self.add_variable(ShVal(m.d.slice_share(s_v1, i, i + 1)))
            v2w = self.add_variable(ShVal(m.d.slice_share(s_v2, i, i + 1)))
            rec_w = self.add_variable(0)
            blk.push_selectors(q_1=1, q_2=1, q_aux=1)
            blk.populate_wires(idx_w, v1w, v2w, rec_w)
            self.memory_read_records.append(len(blk) - 1)
            self.num_gates += 1
            self.assign_tag(rec["record_witness"], read_tag)
            self.assign_tag(rec_w, sorted_tag)
        # all table cells are initialized (asserted at read time), so the
        # plain path's max(index) is the public table size - 1
        max_w = self.add_variable(len(arr["state"]))
        self._dummy_gate("aux", max_w, self.zero_idx, self.zero_idx,
                         self.zero_idx)

    # ----------------------------------------------------------------- RAM
    # barretenberg read/write_RAM_array + process_RAM_array. The reference
    # todo!()s its entire RAM path (builder.rs:1772-1788 + the RAM block
    # constraint arm); implementing it makes the noir `write_access` KAT
    # prove and verify.

    def create_ram_array(self, size: int) -> int:
        self.ram_arrays.append({
            "state": [UNINITIALIZED_MEMORY_RECORD] * size,
            "records": [],
            "access_count": 0,
        })
        return len(self.ram_arrays) - 1

    def _create_ram_gate(self, rec: dict):
        rec["record_witness"] = self.add_variable(0)
        blk = self.blocks["aux"]
        # AuxSelectors::RamRead / RamWrite: w_4 = index*eta + ts*eta_2 +
        # value*eta_3 + access_type, with q_c carrying the access type
        # (relations.py memory_record_check) and the oink w_4 pass adding
        # +1 at write rows (prover.py:95-97)
        if rec["access"] == 0:
            blk.push_selectors(q_1=1, q_m=1, q_aux=1)
        else:
            blk.push_selectors(q_1=1, q_m=1, q_c=1, q_aux=1)
        blk.populate_wires(rec["index_witness"], rec["timestamp_witness"],
                          rec["value_witness"], rec["record_witness"])
        rec["gate_index"] = len(blk) - 1
        if rec["access"] == 0:
            self.memory_read_records.append(rec["gate_index"])
        else:
            self.memory_write_records.append(rec["gate_index"])
        self.num_gates += 1

    def init_ram_element(self, ram_id: int, index_value: int,
                         value_witness: int):
        index_witness = (self.zero_idx if index_value == 0
                         else self.put_constant_variable(index_value))
        self.write_ram_array(ram_id, index_witness, value_witness)

    def _ram_shared_mode(self, arr, index_witness: int) -> bool:
        m = self.mpc
        if m is None:
            return False
        if arr.get("shared_state") is None and not m.is_shared(index_witness):
            return False
        if arr.get("shared_state") is None:
            # first secret-index access: materialize the oblivious state
            assert all(w != UNINITIALIZED_MEMORY_RECORD
                       for w in arr["state"])
            arr["shared_state"] = m.ram_state_init(arr["state"], self)
        return True

    def _ram_index_fields(self, index_witness: int):
        m = self.mpc
        if m is not None and m.is_shared(index_witness):
            return None, m.get(index_witness)
        return int(self.get_variable(index_witness)), None

    def read_ram_array(self, ram_id: int, index_witness: int) -> int:
        arr = self.ram_arrays[ram_id]
        ts = arr["access_count"]
        arr["access_count"] += 1
        if self._ram_shared_mode(arr, index_witness):
            from .co_builder import ShVal

            m = self.mpc
            vh = m.ram_read(arr["shared_state"], index_witness, self)
            value_witness = self.add_variable(ShVal(vh))
            index, handle = self._ram_index_fields(index_witness)
            rec = {"index_witness": index_witness,
                   "timestamp_witness": self.put_constant_variable(ts),
                   "value_witness": value_witness,
                   "access": 0, "index": index, "index_handle": handle,
                   "timestamp": ts}
            self._create_ram_gate(rec)
            arr["records"].append(rec)
            return value_witness
        index = 0 if self.has_dummy_witnesses else int(
            self.get_variable(index_witness))
        assert arr["state"][index] != UNINITIALIZED_MEMORY_RECORD
        value = self.get_variable(arr["state"][index])
        value_witness = self.add_variable(value)
        rec = {"index_witness": index_witness,
               "timestamp_witness": self.put_constant_variable(ts),
               "value_witness": value_witness,
               "access": 0, "index": index, "timestamp": ts}
        self._create_ram_gate(rec)
        arr["records"].append(rec)
        return value_witness

    def write_ram_array(self, ram_id: int, index_witness: int,
                        value_witness: int):
        arr = self.ram_arrays[ram_id]
        ts = arr["access_count"]
        arr["access_count"] += 1
        if self._ram_shared_mode(arr, index_witness):
            m = self.mpc
            m.ram_write(arr["shared_state"], index_witness, value_witness,
                        self)
            index, handle = self._ram_index_fields(index_witness)
            rec = {"index_witness": index_witness,
                   "timestamp_witness": self.put_constant_variable(ts),
                   "value_witness": value_witness,
                   "access": 1, "index": index, "index_handle": handle,
                   "timestamp": ts}
            self._create_ram_gate(rec)
            arr["records"].append(rec)
            return
        index = 0 if self.has_dummy_witnesses else int(
            self.get_variable(index_witness))
        rec = {"index_witness": index_witness,
               "timestamp_witness": self.put_constant_variable(ts),
               "value_witness": value_witness,
               "access": 1, "index": index, "timestamp": ts}
        self._create_ram_gate(rec)
        arr["records"].append(rec)
        arr["state"][index] = value_witness

    def _process_ram_arrays_finalize(self):
        for arr in self.ram_arrays:
            self._process_one_ram_array(arr)

    def _process_one_ram_array(self, arr):
        """barretenberg process_RAM_array: sorted duplicate of the access
        trace (RamConsistencyCheck gates, q_arith=q_aux=1 — the arithmetic
        relation is vacuous with all wire selectors zero), a tag pair for
        the record multiset equality, a boundary row replicating the last
        sorted record (keeps the final row's shifted access-boolean and
        adjacency terms benign), timestamp-delta gates (q_1=q_4=q_aux=1)
        and a final-index pin gate."""
        if not arr["records"]:
            return
        if any(rec["index"] is None for rec in arr["records"]):
            self._process_one_ram_array_mpc(arr)
            return
        access_tag = self.get_new_tag()
        sorted_tag = self.get_new_tag()
        self.create_tag(access_tag, sorted_tag)
        self.create_tag(sorted_tag, access_tag)
        records = sorted(arr["records"],
                         key=lambda r: (r["index"], r["timestamp"]))
        blk = self.blocks["aux"]
        rows = []
        for rec in records:
            idx_w = self.add_variable(rec["index"])
            ts_w = self.add_variable(rec["timestamp"])
            val_w = self.add_variable(self.get_variable(rec["value_witness"]))
            rec_w = self.add_variable(0)
            blk.push_selectors(q_arith=1, q_aux=1)  # RamConsistencyCheck
            blk.populate_wires(idx_w, ts_w, val_w, rec_w)
            row = len(blk) - 1
            if rec["access"] == 0:
                self.memory_read_records.append(row)
            else:
                self.memory_write_records.append(row)
            self.num_gates += 1
            self.assign_tag(rec["record_witness"], access_tag)
            self.assign_tag(rec_w, sorted_tag)
            rows.append((idx_w, ts_w, val_w, rec_w, rec))
        # boundary row: replicate the last sorted record so the final
        # consistency row sees index_delta = 0, value_delta = 0 and a
        # boolean shifted access type; registered in the memory records so
        # its w_4 carries the same eta-combination
        li, lt, lv, lr, lrec = rows[-1]
        blk.push_selectors()
        blk.populate_wires(li, lt, lv, lr)
        if lrec["access"] == 0:
            self.memory_read_records.append(len(blk) - 1)
        else:
            self.memory_write_records.append(len(blk) - 1)
        self.num_gates += 1
        # last sorted index must cover the whole array (every cell of an
        # ACIR RAM block is initialized by MemoryInit)
        self.create_big_add_gate(li, self.zero_idx, self.zero_idx,
                                 self.zero_idx, 1, 0, 0, 0,
                                 -(len(arr["state"]) - 1))
        self._ram_timestamp_gates(rows)

    def _process_one_ram_array_mpc(self, arr):
        """Shared-index RAM finalize: oblivious bitonic sort of the access
        trace keyed by index*T + timestamp (T = pow2 bound on timestamps;
        timestamps are globally unique so keys are distinct and reproduce
        the plain stable (index, timestamp) sort). The sorted rows' access
        type is a SHARE (the permutation is secret), so these rows go to
        memory_mixed_rows and the co-prover adds the access share into
        w_4 instead of a public 0/1. Beyond the reference, which cannot
        prove RAM circuits even in the plain prover."""
        from .co_builder import ShVal

        m = self.mpc
        records = arr["records"]
        R = len(records)
        T = 1
        while T < arr["access_count"]:
            T <<= 1
        key_cols, idx_cols, ts_cols, val_w, acc_cols = [], [], [], [], []
        for rec in records:
            ts = rec["timestamp"]
            if rec["index"] is None:
                key_cols.append(m.affine(rec["index_handle"], T, ts))
                idx_cols.append(rec["index_handle"])
            else:
                key_cols.append(m.d.promote_public(
                    m.f.encode([rec["index"] * T + ts])))
                idx_cols.append(m.d.promote_public(
                    m.f.encode([rec["index"]])))
            ts_cols.append(m.d.promote_public(m.f.encode([ts])))
            val_w.append(rec["value_witness"])
            acc_cols.append(m.d.promote_public(m.f.encode([rec["access"]])))
        d = m.d
        keys = d.concat_shares(*key_cols)
        idxs = d.concat_shares(*idx_cols)
        tss = d.concat_shares(*ts_cols)
        vals = m.value_vec(val_w, self)
        accs = d.concat_shares(*acc_cols)
        s_idx, s_ts, s_val, s_acc = m.sort_records(
            keys, [idxs, tss, vals, accs])

        access_tag = self.get_new_tag()
        sorted_tag = self.get_new_tag()
        self.create_tag(access_tag, sorted_tag)
        self.create_tag(sorted_tag, access_tag)
        blk = self.blocks["aux"]
        rows_w = []
        for i, rec in enumerate(records):
            idx_w = self.add_variable(ShVal(d.slice_share(s_idx, i, i + 1)))
            ts_w = self.add_variable(ShVal(d.slice_share(s_ts, i, i + 1)))
            val_wit = self.add_variable(ShVal(d.slice_share(s_val, i, i + 1)))
            rec_w = self.add_variable(0)
            blk.push_selectors(q_arith=1, q_aux=1)  # RamConsistencyCheck
            blk.populate_wires(idx_w, ts_w, val_wit, rec_w)
            self.memory_mixed_rows.append(len(blk) - 1)
            m.mixed_access.append(d.slice_share(s_acc, i, i + 1))
            self.num_gates += 1
            self.assign_tag(rec["record_witness"], access_tag)
            self.assign_tag(rec_w, sorted_tag)
            rows_w.append((idx_w, ts_w, val_wit, rec_w))
        # boundary row: replicate the last sorted record (same handles)
        li, lt, lv, lr = rows_w[-1]
        blk.push_selectors()
        blk.populate_wires(li, lt, lv, lr)
        self.memory_mixed_rows.append(len(blk) - 1)
        m.mixed_access.append(d.slice_share(s_acc, R - 1, R))
        self.num_gates += 1
        # every cell initialized (asserted at the shared-state switch):
        # last sorted index must equal size - 1
        self.create_big_add_gate(li, self.zero_idx, self.zero_idx,
                                 self.zero_idx, 1, 0, 0, 0,
                                 -(len(arr["state"]) - 1))
        # timestamp-delta gates on the sorted handles: delta_i =
        # [idx_i == idx_{i+1}] * (ts_{i+1} - ts_i) — one batched equality
        # round + one batched multiply round
        if R > 1:
            eq = m.same_bits(d.slice_share(s_idx, 0, R - 1),
                             d.slice_share(s_idx, 1, R))
            diff = d.sub(d.slice_share(s_ts, 1, R),
                         d.slice_share(s_ts, 0, R - 1))
            deltas = d.mul_vec(eq, diff)
            delta_ws = []
            for i in range(R - 1):
                idx_w, ts_w, _v, _r = rows_w[i]
                delta_w = self.add_variable(
                    ShVal(d.slice_share(deltas, i, i + 1)))
                blk.push_selectors(q_1=1, q_4=1, q_aux=1)
                blk.populate_wires(idx_w, ts_w, delta_w, self.zero_idx)
                self.num_gates += 1
                delta_ws.append(delta_w)
            for w in delta_ws:
                self.create_new_range_constraint(w, R - 1)
        fi, ft = rows_w[-1][0], rows_w[-1][1]
        self._dummy_gate("aux", fi, ft, self.zero_idx, self.zero_idx)

    def _ram_timestamp_gates(self, rows):
        blk = self.blocks["aux"]
        # timestamp-delta gates: for adjacent same-index accesses, w_3 holds
        # ts_{i+1} - ts_i (AuxSelectors::RamTimestampCheck, consecutive rows)
        delta_ws = []
        for i in range(len(rows) - 1):
            idx_w, ts_w, _v, _r, rec = rows[i]
            nxt = rows[i + 1][4]
            delta = (nxt["timestamp"] - rec["timestamp"]
                     if nxt["index"] == rec["index"] else 0)
            delta_w = self.add_variable(delta)
            blk.push_selectors(q_1=1, q_4=1, q_aux=1)
            blk.populate_wires(idx_w, ts_w, delta_w, self.zero_idx)
            self.num_gates += 1
            delta_ws.append(delta_w)
        # final boundary row for the timestamp chain
        fi, ft = rows[-1][0], rows[-1][1]
        self._dummy_gate("aux", fi, ft, self.zero_idx, self.zero_idx)
        # timestamps are monotone within an index run, so every delta is
        # bounded by the largest timestamp (bb process_RAM_array step 3)
        max_timestamp = len(rows) - 1
        for w in delta_ws:
            self.create_new_range_constraint(w, max_timestamp)

    # ---------------------------------------------------------- range lists
    # Barretenberg-style range constraints (the reference todo!()s these,
    # builder.rs:1782-1786 process_range_lists). One list per target range,
    # seeded with every multiple of DEFAULT_SORT_STEP in [0, target] so the
    # honest sorted list never jumps by more than the step; members carry the
    # list's range tag. At finalize, a sorted duplicate of the members is
    # created (tau tag), padded to gate width, and constrained by
    # q_delta_range gates: adjacent deltas in [0, 3], first element pinned
    # to 0 and last to target. The generalized-permutation tag pair (same
    # sigma machinery as the memory records, proving_key.py:163-205) proves
    # the sorted list is a permutation of the tagged members, so every
    # member lies in [0, target]. Under MPC the member values are shares:
    # the sorted duplicate comes from the oblivious bitonic network
    # (co_builder.sort_records) keyed by the values themselves — duplicate
    # keys are fine here because equal values make every sorted order
    # value-identical, keeping plain-vs-MPC proof bytes equal.

    DEFAULT_SORT_STEP = 3

    def create_range_list(self, target_range: int) -> dict:
        range_tag = self.get_new_tag()
        tau_tag = self.get_new_tag()
        self.create_tag(range_tag, tau_tag)
        self.create_tag(tau_tag, range_tag)
        indices = []
        for i in range(target_range // self.DEFAULT_SORT_STEP + 1):
            idx = self.add_variable(i * self.DEFAULT_SORT_STEP)
            self.assign_tag(idx, range_tag)
            indices.append(idx)
        idx = self.add_variable(target_range)
        self.assign_tag(idx, range_tag)
        indices.append(idx)
        # seeds must occupy a wire slot or their range tag never enters the
        # permutation grand product (bb: "these variables will not appear in
        # the witness otherwise"); bb's create_dummy_constraints packs FOUR
        # seed variables per all-zero-selector gate
        padded = list(indices)
        padded += [self.zero_idx] * ((-len(padded)) % NUM_WIRES)
        for i in range(0, len(padded), NUM_WIRES):
            self._dummy_gate("arithmetic", *padded[i : i + NUM_WIRES])
        return {"target_range": target_range, "range_tag": range_tag,
                "tau_tag": tau_tag, "variable_indices": indices}

    def create_new_range_constraint(self, variable_index: int,
                                    target_range: int):
        if target_range not in self.range_lists:
            self.range_lists[target_range] = self.create_range_list(
                target_range)
        lst = self.range_lists[target_range]
        m = self.mpc
        if (m is None or not m.is_shared(variable_index)) and int(
            self.get_variable(variable_index)
        ) > target_range:
            # bb records a failure flag so a bad witness surfaces at
            # construction (proving still runs; the proof won't verify)
            self.failed = True
            self.failure_msg = (
                f"range constraint violated: value exceeds {target_range}"
            )
        existing = self.real_variable_tags[
            self.real_variable_index[variable_index]]
        if existing not in (DUMMY_TAG, lst["range_tag"]):
            # already tagged by a range list with a SMALLER target: the
            # variable is already more tightly constrained (bb early-return)
            for t2, l2 in self.range_lists.items():
                if l2["range_tag"] == existing and t2 < target_range:
                    return
            # already carries another tag: range-constrain a fresh copy tied
            # by an arithmetic gate (bb create_new_range_constraint)
            if m is not None and m.is_shared(variable_index):
                from .co_builder import ShVal

                copy = self.add_variable(ShVal(m.get(variable_index)))
            else:
                copy = self.add_variable(self.get_variable(variable_index))
            self.create_add_gate(variable_index, copy, self.zero_idx,
                                 1, -1, 0, 0)
            variable_index = copy
        self.assign_tag(variable_index, lst["range_tag"])
        lst["variable_indices"].append(variable_index)

    def _process_range_lists_finalize(self):
        for target in self.range_lists:
            self._process_one_range_list(self.range_lists[target])

    def _process_one_range_list(self, lst):
        # the tag factor is per copy CYCLE: members merged by later
        # assert_equals must count once, so dedup by real variable index
        seen = set()
        idxs = []
        for i in lst["variable_indices"]:
            real = self.real_variable_index[i]
            if real not in seen:
                seen.add(real)
                idxs.append(i)
        m = self.mpc
        sorted_idx = []
        if m is not None and any(m.is_shared(i) for i in idxs):
            from .co_builder import ShVal

            vals = m.value_vec(idxs, self)
            (s_vals,) = m.sort_records(vals, [vals])
            for i in range(len(idxs)):
                w = self.add_variable(
                    ShVal(m.d.slice_share(s_vals, i, i + 1)))
                self.assign_tag(w, lst["tau_tag"])
                sorted_idx.append(w)
        else:
            for v in sorted(self.get_variable(i) for i in idxs):
                w = self.add_variable(v)
                self.assign_tag(w, lst["tau_tag"])
                sorted_idx.append(w)
        gw = NUM_WIRES
        padding = (gw - (len(sorted_idx) % gw)) % gw
        if len(sorted_idx) <= gw:
            padding += gw
        # untagged zero padding sorts to the FRONT (values start at 0)
        sorted_idx = [self.zero_idx] * padding + sorted_idx
        self._create_sort_constraint_with_edges(
            sorted_idx, 0, lst["target_range"])

    def _create_sort_constraint_with_edges(self, idxs, start: int, end: int):
        gw = NUM_WIRES
        assert len(idxs) % gw == 0 and len(idxs) > gw
        blk = self.blocks["delta_range"]
        for i in range(0, len(idxs), gw):
            blk.populate_wires(idxs[i], idxs[i + 1], idxs[i + 2],
                               idxs[i + 3])
            # edge pin fused into the first sort row (bb
            # create_sort_constraint_with_edges): q_arith=1/q_1=1/q_c=-start
            # asserts w_1 == start on the same row the delta chain begins
            if i == 0:
                blk.push_selectors(q_delta_range=1, q_arith=1, q_1=1,
                                   q_c=-start)
            else:
                blk.push_selectors(q_delta_range=1)
            self.num_gates += 1
        # boundary row: the final real row's w_l_shift delta closes at the
        # last element (its own deltas are unchecked, q_delta_range = 0);
        # the end pin rides it as an arithmetic row (bb fuses it the same way)
        blk.populate_wires(idxs[-1], self.zero_idx, self.zero_idx,
                           self.zero_idx)
        blk.push_selectors(q_arith=1, q_1=1, q_c=-end)
        self.num_gates += 1

    # ------------------------------------------------------------- plookup

    def _get_table(self, table_id: int) -> dict:
        for t in self.lookup_tables:
            if t["id"] == table_id:
                return t
        t = _create_basic_table(table_id, len(self.lookup_tables))
        self.lookup_tables.append(t)
        return t

    def _dummy_lookup(self):
        """The HonkDummyMulti 2-lookup (builder.rs:1426-1446 +
        create_gates_from_plookup_accumulators :1620)."""
        left = 3
        right = 3
        left_idx = self.add_variable(left)
        right_idx = self.add_variable(right)
        # multi-table: 2 basic lookups, slice base 2 (plookup.rs:213-236)
        base = 2
        slices_a = [left % base, left // base]
        slices_b = [right % base, right // base]
        vals = [_dummy_table_value(HONK_DUMMY_BASIC1, slices_a[0], slices_b[0]),
                _dummy_table_value(HONK_DUMMY_BASIC2, slices_a[1], slices_b[1])]
        # accumulator columns (C1/C2/C3), MSB-first accumulation
        c1 = [0, 0]
        c2 = [0, 0]
        c3 = [0, 0]
        c1[1], c2[1], c3[1] = slices_a[1], slices_b[1], vals[1]
        c1[0] = (slices_a[0] + c1[1] * base) % P
        c2[0] = (slices_b[0] + c2[1] * base) % P
        c3[0] = (vals[0] + c3[1] * base) % P

        ids = [HONK_DUMMY_BASIC1, HONK_DUMMY_BASIC2]
        step = [1, base]  # column step sizes: [one, repeated_coeff]
        for i in range(2):
            table = self._get_table(ids[i])
            table["lookup_gates"].append(
                ([slices_a[i], slices_b[i]], [vals[i], 0]))
            first = left_idx if i == 0 else self.add_variable(c1[i])
            second = right_idx if i == 0 else self.add_variable(c2[i])
            third = self.add_variable(c3[i])
            blk = self.blocks["lookup"]
            blk.populate_wires(first, second, third, self.zero_idx)
            last = i == 1
            blk.push_selectors(
                q_lookup_type=1, q_3=table["table_index"],
                q_2=0 if last else -step[i + 1],
                q_m=0 if last else -step[i + 1],
                q_c=0 if last else -step[i + 1])
            self.num_gates += 1

    # --------------------------------------------------- non-zero + finalize

    def add_gates_to_ensure_all_polys_are_non_zero(self):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_m=1, q_1=1, q_2=1, q_3=1, q_4=1)
        self.num_gates += 1

        blk = self.blocks["delta_range"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_delta_range=1)
        self.num_gates += 1
        self._dummy_gate("delta_range", self.zero_idx, self.zero_idx,
                         self.zero_idx, self.zero_idx)

        blk = self.blocks["elliptic"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_elliptic=1)
        self.num_gates += 1
        self._dummy_gate("elliptic", self.zero_idx, self.zero_idx,
                         self.zero_idx, self.zero_idx)

        blk = self.blocks["aux"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_aux=1)
        self.num_gates += 1
        self._dummy_gate("aux", self.zero_idx, self.zero_idx, self.zero_idx,
                         self.zero_idx)

        self.one_idx = self.put_constant_variable(1)
        self.create_big_add_gate(self.zero_idx, self.zero_idx, self.zero_idx,
                                 self.one_idx, 0, 0, 0, 1, P - 1)

        self._dummy_lookup()

        blk = self.blocks["poseidon_external"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_poseidon2_external=1)
        self.num_gates += 1
        self._dummy_gate("poseidon_external", self.zero_idx, self.zero_idx,
                         self.zero_idx, self.zero_idx)

        blk = self.blocks["poseidon_internal"]
        blk.populate_wires(self.zero_idx, self.zero_idx, self.zero_idx,
                          self.zero_idx)
        blk.push_selectors(q_poseidon2_internal=1)
        self.num_gates += 1
        self._dummy_gate("poseidon_internal", self.zero_idx, self.zero_idx,
                         self.zero_idx, self.zero_idx)

    def finalize_circuit(self):
        if not self.circuit_finalized:
            # ROM/RAM consistency + range-list processing (the reference
            # todo!()s all three, builder.rs:1772-1788 — implemented here,
            # see the process methods above). RAM timestamp deltas register
            # range constraints, so lists process after the memory arrays.
            self._process_rom_arrays_finalize()
            self._process_ram_arrays_finalize()
            self._process_range_lists_finalize()
            self.circuit_finalized = True

    # ------------------------------------------------------------- sizing

    def get_tables_size(self) -> int:
        return sum(len(t["column_1"]) for t in self.lookup_tables)

    def compute_dyadic_size(self) -> int:
        min_lookups = self.get_tables_size()
        min_trace = len(self.public_inputs) + self.num_gates
        total = 1 + max(min_lookups, min_trace)  # 1 zero row
        n = 1
        while n < total:
            n <<= 1
        return n

    # ------------------------------------------------------ constraint walk

    def _build_constraints(self, af: AcirFormat):
        for pt in af.poly_triple_constraints:
            self.create_poly_gate(pt)
        for q in af.quad_constraints:
            self.create_big_mul_gate(q)
        for bc in af.block_constraints:
            self._create_block_constraints(bc)
        for pt in af.assert_equalities:
            # ACIR assert-equal (detected in acir_to_format: q_l = -q_r,
            # no constant): a pure copy constraint. The reference todo!()s
            # here (builder.rs:700).
            self.assert_equal(pt.a, pt.b)

    def _create_block_constraints(self, bc: BlockConstraint):
        init = [self._poly_to_field_ct(pt) for pt in bc.init]
        if bc.type_ in ("CallData", "ReturnData", "ROM"):
            self._process_rom_operations(bc, init)
        elif bc.type_ == "RAM":
            self._process_ram_operations(bc, init)
        else:
            raise NotImplementedError(f"block type {bc.type_}")

    def _process_ram_operations(self, bc: BlockConstraint, init: list):
        """RamTable: init every cell (MemoryInit), then replay the access
        trace as RAM read/write gates. The reference todo!()s this arm of
        _create_block_constraints; implemented here so the noir
        `write_access` KAT proves and verifies."""
        ram_id = self.create_ram_array(len(init))

        def as_witness(fct: FieldCT) -> int:
            if fct.is_constant():
                return self.put_constant_variable(fct.get_value(self))
            return fct.normalize(self).idx

        for i, e in enumerate(init):
            self.init_ram_element(ram_id, i, as_witness(e))
        for op in bc.trace:
            index = self._poly_to_field_ct(op.index)
            value = self._poly_to_field_ct(op.value)
            index_w = as_witness(index)
            if op.access_type == 0:
                read_w = self.read_ram_array(ram_id, index_w)
                value.assert_equal(FieldCT.from_witness_index(read_w), self)
            else:
                self.write_ram_array(ram_id, index_w, as_witness(value))

    def _poly_to_field_ct(self, pt: PolyTriple) -> FieldCT:
        assert pt.q_m == 0 and pt.q_r == 0 and pt.q_o == 0
        if pt.q_l % P == 0:
            return FieldCT(add=pt.q_c)
        return FieldCT(add=pt.q_c, mul=pt.q_l, idx=pt.a)

    def _process_rom_operations(self, bc: BlockConstraint, init: list):
        if not bc.trace:
            return
        # RomTable (parse/types.rs:387-459)
        entries = []
        for e in init:
            if e.is_constant():
                entries.append(FieldCT.from_witness_index(
                    self.put_constant_variable(e.get_value(self))))
            else:
                entries.append(e.normalize(self))
        rom_id = self.create_rom_array(len(entries))
        for i, e in enumerate(entries):
            self.set_rom_element(rom_id, i, e.idx)

        for op in bc.trace:
            assert op.access_type == 0
            value = self._poly_to_field_ct(op.value)
            index = self._poly_to_field_ct(op.index)
            assert index.mul != 0 and index.idx != FieldCT.IS_CONSTANT
            if self.mpc is not None and self.mpc.is_shared(index.idx):
                # provider mode: SKIP the reference's value-pinning quirk
                # below — with a secret index it would copy the index value
                # into a public constant (q_c selector), leaking it into
                # the verification key (co_builder.py docstring)
                idx_w = self.read_rom_array(rom_id, index.normalize(self).idx)
                value.assert_equal(FieldCT.from_witness_index(idx_w), self)
                continue
            w_value = index.get_value(self) if not self.has_dummy_witnesses else 0
            # reference quirk (WitnessCT::from_field, parse/types.rs:682-697):
            # adds a variable but returns a CONSTANT FieldCT
            self.add_variable(w_value)
            w = FieldCT(add=w_value)
            idx_w = self.read_rom_array(rom_id, index.normalize(self).idx)
            value.assert_equal(FieldCT.from_witness_index(idx_w), self)
            w.assert_equal(index, self)


def _dummy_table_value(table_id: int, k0: int, k1: int) -> int:
    return (k0 * 3 + k1 * 4 + table_id * 0x1337) % P


def _create_basic_table(table_id: int, index: int) -> dict:
    assert table_id in (HONK_DUMMY_BASIC1, HONK_DUMMY_BASIC2)
    c1, c2, c3 = [], [], []
    for i in range(2):
        for j in range(2):
            c1.append(i)
            c2.append(j)
            c3.append(_dummy_table_value(table_id, i, j))
    return {"id": table_id, "table_index": index, "use_twin_keys": True,
            "column_1": c1, "column_2": c2, "column_3": c3,
            "lookup_gates": []}
