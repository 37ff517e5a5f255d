"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package; it defaults to the card and refuses to fall back."""

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
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


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
        src = (kernels.CSRC / f"{kernels._ENTRY_SOURCE.get(k, k)}.cu").read_text()
        assert f"cc_{k}(" in src and "__global__" in src
        assert k in kernels._ARGTYPES
    assert (kernels.CSRC / "field.cuh").exists()
