"""The benchmark's tests: CPU tests at a tiny width, and tests marked
`card` that need a CUDA card and skip without one.

Run them from the repository's root: `python -m pytest benchmark/tests`.

The CPU tests' sizes are data, found by name: `tiny/<config>.json` is
laid over `configs/<config>.json` and `small/<traffic>.json` over
`traffic/<traffic>.json` (nested objects merged key by key, any other
value replaced).
"""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def load(root: str, *parts) -> dict:
    with open(os.path.join(root, "benchmark", *parts)) as f:
        return json.load(f)


def load_config(name: str, root: str = ROOT) -> dict:
    return load(root, "configs", f"{name}.json")


def overlay(base: dict, over: dict) -> dict:
    """`base` with `over` laid on it: nested objects merged key by key,
    any other value replaced."""
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            value = overlay(base[key], value)
        out[key] = value
    return out


def tiny_config(name: str, root: str = ROOT) -> dict:
    """The configuration at the tests' width: tests/tiny/<name>.json laid
    over configs/<name>.json."""
    return overlay(load_config(name, root),
                   load(root, "tests", "tiny", f"{name}.json"))


def small_mix(traffic: str, root: str = ROOT) -> dict:
    """The mix at the tests' size: tests/small/<traffic>.json laid over
    traffic/<traffic>.json."""
    return overlay(load(root, "traffic", f"{traffic}.json"),
                   load(root, "tests", "small", f"{traffic}.json"))
