"""The benchmark's own tests.  `chip` marks a test that needs a CUDA card;
each such test decides inside itself whether there is one and skips on a
machine without."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip machine)")
