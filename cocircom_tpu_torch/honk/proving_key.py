"""ProvingKey / VerifyingKey construction from a finalized builder.

Parity: upstream co-noir/ultrahonk/src/parse/proving_key.rs
(ProvingKey::create :18-66, populate_trace :121, permutation mapping
:168-262, honk-style sigma/id polys :264-311, lookup-table polys :313-346,
read counts :348-371) and parse/types.rs TraceData :1117-1213.

All polynomials are Lagrange-basis lists of ints mod p. Entity order
follows types.rs: 27 precomputed / 8 witness (6 at construction) /
4+5 shifted (derived later).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .builder import BLOCK_ORDER, NUM_SELECTORS, NUM_WIRES, P, UltraCircuitBuilder

# precomputed entity indices (types.rs:569-632)
Q_M, Q_C, Q_L, Q_R, Q_O, Q_4 = range(6)
Q_ARITH, Q_DELTA_RANGE, Q_ELLIPTIC, Q_AUX, Q_LOOKUP = 6, 7, 8, 9, 10
Q_POSEIDON2_EXTERNAL, Q_POSEIDON2_INTERNAL = 11, 12
SIGMA_1, SIGMA_2, SIGMA_3, SIGMA_4 = 13, 14, 15, 16
ID_1, ID_2, ID_3, ID_4 = 17, 18, 19, 20
TABLE_1, TABLE_2, TABLE_3, TABLE_4 = 21, 22, 23, 24
LAGRANGE_FIRST, LAGRANGE_LAST = 25, 26
NUM_PRECOMPUTED = 27

# witness entity indices (types.rs:393-407)
W_L, W_R, W_O, W_4, Z_PERM, LOOKUP_INVERSES = range(6)
LOOKUP_READ_COUNTS, LOOKUP_READ_TAGS = 6, 7
NUM_WITNESS = 8


@dataclass
class ProvingKey:
    crs: object
    circuit_size: int
    public_inputs: list
    num_public_inputs: int
    pub_inputs_offset: int
    precomputed: list  # 27 polys of len circuit_size
    witness: list      # [w_l, w_r, w_o, w_4, read_counts, read_tags]
    memory_read_records: list = field(default_factory=list)
    memory_write_records: list = field(default_factory=list)
    # provider mode: sorted-RAM rows whose access type is a share
    memory_mixed_records: list = field(default_factory=list)


@dataclass
class VerifyingKey:
    g2_x: object  # G2 affine point of the CRS
    circuit_size: int
    num_public_inputs: int
    pub_inputs_offset: int
    commitments: list  # 27 G1 affine commitments to the precomputed polys


def create_proving_key(builder: UltraCircuitBuilder, crs) -> ProvingKey:
    if not builder.circuit_finalized:  # idempotent: pk then vk from one builder
        builder.add_gates_to_ensure_all_polys_are_non_zero()
        builder.finalize_circuit()
    n = builder.compute_dyadic_size()

    precomputed = [[0] * n for _ in range(NUM_PRECOMPUTED)]
    wires = [[0] * n for _ in range(NUM_WIRES)]
    read_counts = [0] * n
    read_tags = [0] * n

    # ---- trace population (TraceData::construct_trace_data) ----
    # (vectorised: the copy cycles are kept as each trace cell's real
    # variable index, in cell order, for _compute_permutation_polys)
    real_index = np.asarray(builder.real_variable_index, np.int64)
    variables = np.asarray(builder.variables, dtype=object)
    cell_real = np.full((NUM_WIRES, n), -1, np.int64)
    ram_rom_offset = 0
    pub_inputs_offset = 0

    # public inputs block (populate_public_inputs_block, builder.rs:1857)
    pub_blk = builder.blocks["pub_inputs"]
    if not pub_blk.wires[0]:
        for idx in builder.public_inputs:
            pub_blk.populate_wires(idx, idx, builder.zero_idx, builder.zero_idx)
            pub_blk.push_selectors()

    offset = 1  # zero row
    for name in BLOCK_ORDER:
        blk = builder.blocks[name]
        size = len(blk)
        if size:
            for w in range(NUM_WIRES):
                real = real_index[np.asarray(blk.wires[w][:size], np.int64)]
                wires[w][offset: offset + size] = variables[real].tolist()
                cell_real[w, offset: offset + size] = real
        for s in range(NUM_SELECTORS):
            col = blk.selectors[s]
            precomputed[s][offset: offset + len(col)] = col
        if blk.has_ram_rom:
            ram_rom_offset = offset
        if blk.is_pub_inputs:
            pub_inputs_offset = offset
        offset += size

    # lagrange first/last
    precomputed[LAGRANGE_FIRST][0] = 1
    precomputed[LAGRANGE_LAST][n - 1] = 1

    # ---- lookup table polys (construct_lookup_table_polynomials) ----
    tables_size = builder.get_tables_size()
    toff = n - tables_size
    off = toff
    for table in builder.lookup_tables:
        tindex = table["table_index"]
        for i in range(len(table["column_1"])):
            precomputed[TABLE_1][off] = table["column_1"][i] % P
            precomputed[TABLE_2][off] = table["column_2"][i] % P
            precomputed[TABLE_3][off] = table["column_3"][i] % P
            precomputed[TABLE_4][off] = tindex
            off += 1

    # ---- read counts/tags (construct_lookup_read_counts) ----
    table_offset = toff
    for table in builder.lookup_tables:
        index_map = {}
        for i in range(len(table["column_1"])):
            key = (table["column_1"][i] % P, table["column_2"][i] % P,
                   table["column_3"][i] % P)
            index_map[key] = i
        for key_pair, value_pair in table["lookup_gates"]:
            if table["use_twin_keys"]:
                entry = (key_pair[0] % P, key_pair[1] % P, value_pair[0] % P)
            else:
                entry = (key_pair[0] % P, value_pair[0] % P, value_pair[1] % P)
            idx = table_offset + index_map[entry]
            read_counts[idx] += 1
            read_tags[idx] = 1
        table_offset += len(table["column_1"])

    # ---- memory records ----
    memory_read_records = [r + ram_rom_offset for r in builder.memory_read_records]
    memory_write_records = [r + ram_rom_offset for r in builder.memory_write_records]
    memory_mixed_records = [r + ram_rom_offset for r in builder.memory_mixed_rows]

    # ---- permutation argument (sigma/id) ----
    _compute_permutation_polys(precomputed, builder, cell_real, n,
                               pub_inputs_offset)

    # ---- public inputs from w_r at offset ----
    public_inputs = [
        wires[1][pub_inputs_offset + i] for i in range(len(builder.public_inputs))
    ]

    return ProvingKey(
        crs=crs,
        circuit_size=n,
        public_inputs=public_inputs,
        num_public_inputs=len(builder.public_inputs),
        pub_inputs_offset=pub_inputs_offset,
        precomputed=precomputed,
        witness=[wires[0], wires[1], wires[2], wires[3], read_counts, read_tags],
        memory_read_records=memory_read_records,
        memory_write_records=memory_write_records,
        memory_mixed_records=memory_mixed_records,
    )


def _compute_permutation_polys(precomputed, builder, cell_real, n,
                               pub_inputs_offset):
    """proving_key.rs:168-311. sigma/id start as identity (row + n*col).

    cell_real[col, row] is the real variable index of a trace cell (-1 for
    an empty one).  A variable's copy cycle is its cells in trace order
    (row, then column); each cell's sigma points at the next cell of its
    cycle, the last wraps to the first.  The first cell of a cycle takes
    the variable's tag in id, the last its tau tag in sigma.  Vectorised
    with numpy; the values are those of the cycle walk upstream."""
    tags = np.asarray(builder.real_variable_tags, np.int64)
    cols = np.repeat(np.arange(NUM_WIRES, dtype=np.int64)[:, None], n, axis=1)
    rows = np.repeat(np.arange(n, dtype=np.int64)[None, :], NUM_WIRES, axis=0)
    sig_r, sig_c = rows.copy(), cols.copy()
    sig_tag = np.zeros((NUM_WIRES, n), bool)
    id_r = rows.copy()
    id_tag = np.zeros((NUM_WIRES, n), bool)

    used = cell_real.T.reshape(-1) >= 0           # cells in (row, col) order
    real = cell_real.T.reshape(-1)[used]
    c_all = cols.T.reshape(-1)[used]
    r_all = rows.T.reshape(-1)[used]
    if real.size:
        order = np.argsort(real, kind="stable")   # cycles, each in trace order
        real, c_all, r_all = real[order], c_all[order], r_all[order]
        first = np.ones(real.size, bool)
        first[1:] = real[1:] != real[:-1]
        last = np.ones(real.size, bool)
        last[:-1] = real[1:] != real[:-1]
        start = np.maximum.accumulate(np.where(first, np.arange(real.size), 0))
        nxt = np.arange(1, real.size + 1)
        nxt[last] = start[last]
        sig_r[c_all, r_all] = r_all[nxt]
        sig_c[c_all, r_all] = c_all[nxt]
        cyc_tags = tags[real]
        lc, lr = c_all[last], r_all[last]
        sig_tag[lc, lr] = True
        sig_r[lc, lr] = [builder.tau[int(t)] for t in cyc_tags[last]]
        fc, fr_ = c_all[first], r_all[first]
        id_tag[fc, fr_] = True
        id_r[fc, fr_] = cyc_tags[first]

    pub_rows = [i + pub_inputs_offset for i in range(len(builder.public_inputs))]
    for col in range(NUM_WIRES):
        sig = np.where(sig_tag[col], n * NUM_WIRES + sig_r[col], sig_r[col] + n * sig_c[col])
        idp = np.where(id_tag[col], n * NUM_WIRES + id_r[col], id_r[col] + n * col)
        sig_poly = sig.tolist()
        if col == 0:
            for idx in pub_rows:
                sig_poly[idx] = (-(idx + 1)) % P
        precomputed[SIGMA_1 + col] = sig_poly
        precomputed[ID_1 + col] = idp.tolist()


def create_keys(builder: UltraCircuitBuilder, crs):
    """(pk, vk) — commitments to all precomputed polys (builder.rs:94-124)."""
    pk = create_proving_key(builder, crs)
    commitments = crs.commit_many(pk.precomputed)
    vk = VerifyingKey(
        g2_x=crs.g2_x,
        circuit_size=pk.circuit_size,
        num_public_inputs=pk.num_public_inputs,
        pub_inputs_offset=pk.pub_inputs_offset,
        commitments=commitments,
    )
    return pk, vk
