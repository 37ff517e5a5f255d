"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package; it defaults to the card and refuses to fall back."""

import ast
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import cocircom_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cocircom_tpu_torch.__path__,
                                               "cocircom_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "cocircom_tpu" or m.startswith("cocircom_tpu."))
assert len(names) >= 20, names
assert "cocircom_tpu_torch.parallel.sharded" in names and \
    "cocircom_tpu_torch.graft_entry" in names, names
for m in ("mpc.shamir", "mpc.bridges", "ops.keccak", "io.jsonio", "io.plonk_zkey",
          "snark.plonk", "snark.plonk_setup", "snark.plonk_verify", "mpc.rep3_binary",
          "vm.lexer", "vm.parser", "vm.algebra", "vm.compiler", "vm.mpc_vm",
          "cli", "mpc.codec", "mpc.net", "io.shares_io", "vm.fit_layout",
          # co-noir: the 20 modules of its slice
          "honk", "honk.builder", "honk.co_alg", "honk.co_builder", "honk.co_prover",
          "honk.crs", "honk.prover", "honk.proving_key", "honk.relations", "honk.sumcheck",
          "honk.transcript", "honk.verifier", "honk.zeromorph", "noir", "noir.acir",
          "noir.cli", "noir.poseidon2", "noir.rep3_driver", "noir.solver", "mpc.lut"):
    assert "cocircom_tpu_torch." + m in names, m
print("MODULES", len(names))
print("BAD", bad)
"""


def test_port_and_smoke_import_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")
    from cocircom_tpu_torch import convert
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import Rep3Rngs
    from cocircom_tpu_torch.ops.curve import g1_ops
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.utils.chacha import ChaChaStream, seed_to_words

    with pytest.raises(RuntimeError, match="CUDA"):
        get_field(BN254.fr.p, "bn254.fr")
    with pytest.raises(RuntimeError, match="CUDA"):
        g1_ops(BN254)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlainDriver(BN254)
    with pytest.raises(RuntimeError, match="CUDA"):
        seed_to_words(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChaChaStream(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        Rep3Rngs(5, 6)
    limbs16 = np.zeros((16, 2), dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.field_from_reference(limbs16)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.points_from_reference((limbs16, limbs16, limbs16))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.rep3_share_from_reference((limbs16, limbs16))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.zkey_from_reference(None)
    # the sharded path's entry points
    from cocircom_tpu_torch import graft_entry
    from cocircom_tpu_torch.fields.params import BLS12_381
    from cocircom_tpu_torch.parallel import sharded

    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.device_list(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.prover_core_step(BN254, ["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PlainDriver(BLS12_381)
    # the Shamir and PLONK entry points
    from cocircom_tpu_torch.io.plonk_zkey import read_plonk_zkey
    from cocircom_tpu_torch.io.witness import Witness
    from cocircom_tpu_torch.mpc.net import LocalNetwork
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver, share_field_vec_shamir
    from cocircom_tpu_torch.snark.shared import split_witness_shamir

    net = LocalNetwork.create(3)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        ShamirDriver(BN254, net)
    fr_cpu = get_field(BN254.fr.p, "bn254.fr", device="cpu")
    vec = fr_cpu.encode([1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        share_field_vec_shamir(fr_cpu, vec, 1, 3, seed=1)
    wit = Witness(BN254, 4, np.zeros((8, 4), dtype=np.uint32))
    with pytest.raises(RuntimeError, match="CUDA"):
        split_witness_shamir(wit, 1, 1, 3, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        read_plonk_zkey(b"")
    # the witness extension's entry points
    from cocircom_tpu_torch.snark.shared import split_input_rep3

    with pytest.raises(RuntimeError, match="CUDA"):
        split_input_rep3(BN254, {"a": 1, "b": 2}, ["a"], seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.binary_share_from_reference((limbs16, limbs16))
    # the artifacts, the mesh and the command line
    from cocircom_tpu_torch import cli
    from cocircom_tpu_torch.io.shares_io import read_shared_input, shared_witness_to_split
    from cocircom_tpu_torch.mpc.net import TcpNetwork

    with pytest.raises(RuntimeError, match="CUDA"):
        TcpNetwork(0, [("127.0.0.1", 1), ("127.0.0.1", 2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        read_shared_input(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        shared_witness_to_split(b"")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["generate-proof", "groth16", "--zkey", "z", "--witness", "w", "--out", "o"])
    # co-noir: the noir CLI and the co-prover's drivers
    from cocircom_tpu_torch.noir import cli as noir_cli

    for argv in (["split-witness", "--witness", "w", "--circuit", "c", "--out-dir", "o"],
                 ["generate-proof", "--witness", "w", "--circuit", "c", "--net-config", "n",
                  "--out", "o"],
                 ["create-vk", "--circuit", "c", "--out", "o"]):
        with pytest.raises(SystemExit, match="CUDA"):
            noir_cli.main(argv)
    assert split_input_rep3(BN254, {"a": 1, "b": 2}, ["a"], seed=1, device="cpu")[0] \
        .shared_inputs["b"].a.device.type == "cpu"
    assert all(s.device.type == "cpu"
               for s in share_field_vec_shamir(fr_cpu, vec, 1, 3, seed=1, device="cpu"))
    assert split_witness_shamir(wit, 1, 1, 3, seed=1, device="cpu")[0].witness.device.type \
        == "cpu"
    cpu = torch.device("cpu")
    assert sharded.device_list(3, "cpu") == [cpu] * 3
    assert PlainDriver(BN254, devices=["cpu", "cpu"]).devices == (cpu, cpu)
    assert ChaChaStream(5, device="cpu").key.device.type == "cpu"
    assert get_field(BN254.fr.p, "bn254.fr", device="cpu").device.type == "cpu"


def test_kernel_loader_raises_without_a_card_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the loader builds and loads")
    from cocircom_tpu_torch.ops import kernels

    with pytest.raises(RuntimeError, match="no fallback"):
        kernels.load_all()
    a = torch.zeros((8, 4), dtype=torch.int32)
    consts = (ctypes.c_uint32 * 25)()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.mont_mul(a, a, consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ec_add((a, a, a), (a, a, a), consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ntt_butterfly(a, a[:, :2].contiguous(), consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ntt_columns(a[:, :, None], a[:, :2].contiguous(), consts, transpose=True)
    a12 = torch.zeros((12, 4), dtype=torch.int32)
    rows12 = torch.zeros((4, 72), dtype=torch.int32)
    mask = torch.zeros(4, dtype=torch.bool)
    acc12 = torch.zeros((12, 2, 3, 2), dtype=torch.int32)      # (L, nw, K + 1, T)
    idx = torch.zeros((2, 4), dtype=torch.int64)                 # (nw, n)
    bounds = torch.zeros((2, 3), dtype=torch.int64)              # (nw, K + 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ec_wave_add((acc12,) * 3, torch.zeros((4, 36), dtype=torch.int32), idx, idx, idx,
                            bounds, 0, consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ec_madd((acc12,) * 3, torch.zeros((2 * 8, 24), dtype=torch.int32), bounds,
                        bounds, 0, consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ec_wave_add_g2((a12,) * 6, rows12, mask, mask, consts)
    with pytest.raises(ValueError, match="rows must be"):
        kernels.ec_wave_add_g2((a12,) * 6, rows12[:, :36], mask, mask, consts)
    with pytest.raises(ValueError, match="valid must be"):
        kernels.ec_wave_add_g2((a12,) * 6, rows12, mask, mask[:3], consts)
    assert kernels.launch_counts() == {k: 0 for k in kernels.COUNT_KEYS}
    assert len(kernels.COUNT_KEYS) == 2 * len(kernels.KERNELS)
    for k in ("ec_wave_add", "ec_wave_add_g2"):
        assert k in kernels.KERNELS and k in kernels.COUNT_KEYS and f"{k}_l12" in kernels.COUNT_KEYS
    # the G2 wave replaces an XLA composition, as the G2 add does
    assert kernels.REPLACES["ec_wave_add_g2"] is None and kernels.REPLACES["ec_add_g2"] is None


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_sources_are_in_the_tree():
    from cocircom_tpu_torch.ops import kernels

    for k in kernels.KERNELS:
        src = (kernels.CSRC / f"{k}.cu").read_text()
        assert f"cc_{k}(" in src and "__global__" in src
        assert k in kernels._ARGTYPES
        # one template, an instantiation for each limb count
        assert "template <int L>" in src and "<8>(" in src and "<12>(" in src
    assert (kernels.CSRC / "field.cuh").exists() and (kernels.CSRC / "curve.cuh").exists()


def _pallas_entry_points(path: Path) -> set:
    """The public functions of a JAX-package module from which a call of
    `pl.pallas_call` can be reached (through the module's own functions)."""
    tree = ast.parse(path.read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    calls = {name: {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)} & set(funcs)
             for name, fn in funcs.items()}
    reach = {name for name, fn in funcs.items()
             if any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                    for n in ast.walk(fn))}
    assert reach, path
    grew = True
    while grew:
        more = {name for name in funcs if name not in reach and calls[name] & reach}
        grew = bool(more)
        reach |= more
    return {f"{path.stem}.{name}" for name in reach if not name.startswith("_")}


def test_every_tpu_kernel_has_a_counterpart():
    """Every function of cocircom_tpu/ops/pallas_*.py that reaches
    `pl.pallas_call` is named by `kernels.REPLACES`, and every kernel the
    port names has its source, entry point and launch counts."""
    from cocircom_tpu_torch.ops import kernels

    tpu = set()
    for path in sorted((ROOT / "cocircom_tpu" / "ops").glob("pallas_*.py")):
        tpu |= _pallas_entry_points(path)
    assert len(tpu) == 6, tpu
    assert set(kernels.REPLACES) == set(kernels.KERNELS)
    ported = {v for v in kernels.REPLACES.values() if v is not None}
    assert ported == tpu, (sorted(tpu - ported), sorted(ported - tpu))
