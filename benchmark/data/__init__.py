"""Input generators, one module each, found by the name a configuration's
file gives under "generator". Each module has `generate(config, seed,
device) -> numpy (genes x samples) float32 array`: the same seed gives
the same matrix on the same kind of device, drawn on that device in a few
large calls."""

from __future__ import annotations

import importlib

import numpy as np


def generate(config: dict, seed: int, device) -> np.ndarray:
    module = importlib.import_module(f"{__name__}.{config['generator']}")
    return module.generate(config, seed, device)
