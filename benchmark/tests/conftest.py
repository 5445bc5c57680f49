"""Fixtures of the benchmark's tests: BENCHMARK.json and the card, for
the tests marked cuda."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.cells import ROOT


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
