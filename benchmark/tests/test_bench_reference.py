"""The plain reference against a small CPU run of the port's plain path:
it agrees with what the run produced and disagrees where that is
perturbed; its subsets are the port's; it imports nothing of the
program."""

from __future__ import annotations

import ast
import copy

import numpy as np
import pytest
import torch

from benchmark import data, harness, reference
from benchmark.reference import plain
from benchmark.tests.cells import CASES, HISTORY, ROOT, WINDOW_S, small_cell



def small_run(name):
    """(inputs, outputs, cell) of a small run on the CPU."""
    cell = small_cell(name)
    seed = 2**32 + 17
    D = data.generate(cell["config_spec"], seed, "cpu")
    s = harness.Setup(cell, D, seed, "cpu")
    s.burn_in(cell["burn_in"])
    rec = harness.run_window(s, WINDOW_S, False)
    out = harness.program_outputs(s, rec)
    return reference.Inputs(D, seed, cell["config_spec"]), out, cell, name


_RUNS = {}


def run_of(name):
    """small_run(name), once a test session."""
    if name not in _RUNS:
        _RUNS[name] = small_run(name)
    return _RUNS[name]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
@pytest.mark.parametrize("n_total,n_sets", [(80, 4), (203, 4), (50, 3)])
def test_subsets_are_the_ports(seed, n_total, n_sets):
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel.distributed import create_sets
    p = CogapsParams(n_sets=n_sets, seed=seed)
    ours = plain.subsets(n_total, n_sets, seed)
    theirs = create_sets(n_total, p, np.random.default_rng(seed))
    assert [list(s) for s in ours] == [list(s) for s in theirs]


@pytest.mark.parametrize("name", CASES)
def test_reference_agrees_with_the_plain_run(name):
    inp, out, cell, _ = run_of(name)
    values = reference.numbers(inp, out)
    assert len(out["snaps"]) >= 1
    correct, attempted, failed, checks = reference.verdict(
        values, cell["limits"])
    assert correct, checks
    # chi^2's gap where the window has history entries
    assert attempted == (9 if name == HISTORY else 8) and failed == 0


PERTURBED = [("M_a", "atoms_gap_a"), ("M_p", "atoms_gap_p"),
             ("chisq_hist", "chisq_gap"), ("tables_a", "tables_gap"),
             ("tables_p", "tables_gap"), ("snaps", "fit_share"),
             ("a_sum", "stats_gap"), ("p_sum", "stats_gap")]


@pytest.mark.parametrize("name,what,number", [
    (name, what, number) for name in CASES for what, number in PERTURBED
    # a window without a chi^2 history has no entry to perturb
    if number != "chisq_gap" or name == HISTORY])
def test_reference_disagrees_with_a_perturbed_state(name, what, number):
    inp, out, cell, _ = run_of(name)
    bad = copy.deepcopy(out)
    x = bad[what]
    if what == "snaps":  # every chunk end's A, far from the data
        for _, A, _ in x:
            A *= 3.0
    elif what in ("a_sum", "p_sum"):  # the statistics, doubled
        x *= 2.0
    elif number.startswith("atoms_gap"):  # the factor, whole
        x *= 1.001
    else:  # one chain's last row
        if isinstance(x, list):
            x = x[0]
        x.reshape(x.shape[0], -1)[-1, :] *= 1.001
    values = reference.numbers(inp, bad)
    assert values[number] > cell["limits"][number]
    assert not reference.verdict(values, cell["limits"])[0]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0,
                      float("inf")])
    assert plain.tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0,
                                      float("inf")]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue  # the reference's own modules
                names = [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path, names)
