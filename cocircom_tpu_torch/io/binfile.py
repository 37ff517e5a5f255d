"""snarkjs/circom binfile container: magic + version + sections.

Format (little-endian) — parity with
co-circom/circom-types/src/binfile.rs:42-105:
    magic: 4 bytes ascii ("zkey", "wtns", "r1cs")
    version: u32
    num_sections: u32
    then per section: id u32, length u64, payload bytes
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass
class BinFile:
    magic: str
    version: int
    sections: dict[int, bytes]


def read_binfile(data: bytes, expect_magic: str | None = None) -> BinFile:
    magic = data[:4].decode("ascii", errors="replace")
    if expect_magic is not None and magic != expect_magic:
        raise ValueError(f"bad magic {magic!r}, expected {expect_magic!r}")
    version, num_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections: dict[int, bytes] = {}
    for _ in range(num_sections):
        sid, slen = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[sid] = data[off : off + slen]
        off += slen
    return BinFile(magic, version, sections)


def write_binfile(magic: str, version: int, sections: list[tuple[int, bytes]]) -> bytes:
    out = [magic.encode("ascii"), struct.pack("<II", version, len(sections))]
    for sid, payload in sections:
        out.append(struct.pack("<IQ", sid, len(payload)))
        out.append(payload)
    return b"".join(out)
