"""The plain reference of the benchmark (plain.py) and the comparison that
decides `correct` (check.py). Nothing here imports cogaps_tpu_torch or
JAX."""

from .check import EXACT, Inputs, numbers, verdict  # noqa: F401
