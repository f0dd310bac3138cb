"""The benchmark's tests: CPU tests at a tiny width, and tests marked
`card` that need a CUDA card and skip without one.

Run them from the repository's root: `python -m pytest benchmark/tests`.
"""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_CHANNELS = [1, 2, 2, 4, 4, 4, 4]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def load_config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """A configuration at the tests' width: channels 1-2-2-4-4-4-4 and
    zdim 4, every other setting as the file has it."""
    config = load_config(name)
    config["model"].update(encoder_channels=TINY_CHANNELS, zdim=4)
    return config
