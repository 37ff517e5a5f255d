"""The `field_add` kernel (csrc/field_add.cu) on the card against its
plain version (ops/field.py).  Nothing here imports JAX, so on the chip
machine: python3 -m pytest --noconftest tests/test_torch_field_add.py -m chip"""

import pytest
import torch


@pytest.mark.chip
def test_field_add_kernel_equals_the_plain_version():
    """On the card: `field_add` (add and sub, 8 and 12 limbs, a size-1
    operand broadcast, the edge values 0, 1, p - 1) equals the plain
    carry-chain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip machine)")
    import random

    from cocircom_tpu_torch.fields.params import BLS12_381, BN254
    from cocircom_tpu_torch.ops.field import get_field

    rng = random.Random(64)
    for p in (BN254.fr.p, BN254.fq.p, BLS12_381.fq.p):
        fc = get_field(p, "k", "cuda")
        fp = get_field(p, "k", "cpu")
        vals = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(4092)]
        a = fp.to_limbs(vals)
        b = fp.to_limbs(vals[::-1])
        one = b[:, :1]
        for x, y in ((a, b), (a, one), (one, a), (a.reshape(fp.L, 64, 64), b[:, None, :64])):
            for op in ("add", "sub"):
                want = getattr(fp, op)(x, y)
                got = getattr(fc, op)(x.cuda(), y.cuda()).cpu()
                assert torch.equal(got, want), (p, op, tuple(x.shape), tuple(y.shape))
