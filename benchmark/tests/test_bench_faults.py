"""The check fails what it should: the control (the reference in TF32 in
the program's place) and each fault a cell can have, planted under the
timed path of a small CPU run that skips the harness's look for a card."""

from __future__ import annotations

import dataclasses
import time

import pytest

from benchmark import faults as planted
from benchmark import harness, reference
from benchmark.tests.cells import CASES, HISTORY, WINDOW_S, small_cell

SEED = 3 * 2**31 + 5


def small(bench, name, **kw):
    return harness.run_cell(bench, name, SEED, WINDOW_S, False, "cpu",
                            time.perf_counter(), cell=small_cell(name), **kw)


@pytest.mark.parametrize("name", CASES)
def test_sound_run_is_correct(bench, name):
    r = small(bench, name)
    assert r["correct"], r["checks"]
    assert list(r)[-3:] == ["checks", "_launches", "_chunk_ms"]


@pytest.mark.parametrize("name", CASES)
def test_control_fails(bench, name):
    r = small(bench, name, control=True)
    limits = small_cell(name)["limits"]
    correct, _, failed, checks = reference.verdict(
        r["control"], {n: limits[n] for n in r["control"]})
    assert not correct and failed >= 1, checks


def chisq_altered(s, monkeypatch):
    """The chi^2 that the history records, scaled by 1 + 1e-3."""
    from cogaps_tpu_torch.models import dense
    orig = dense.chisq_from_state
    monkeypatch.setattr(dense, "chisq_from_state",
                        lambda *a: orig(*a) * (1 + 1e-3))


def tables_altered(s, monkeypatch):
    """The tables' Y, scaled by 1 + 1e-3 where the tables are made."""
    from cogaps_tpu_torch.models import dense
    orig = dense.tables

    def tables(*a):
        cache, ph = orig(*a)
        return dataclasses.replace(cache, Y=cache.Y * (1 + 1e-3)), ph

    monkeypatch.setattr(dense, "tables", tables)


FAULTS = dict(planted.FAULTS,
              chisq_altered=(chisq_altered, "chisq_gap"),
              tables_altered=(tables_altered, "tables_gap"))


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CASES for fault in sorted(FAULTS)
    # a window without a chi^2 history has no entry to alter
    if fault != "chisq_altered" or name == HISTORY])
def test_fault_is_caught(bench, name, fault, monkeypatch):
    plant, number = FAULTS[fault]

    def faults(s):
        if plant in (chisq_altered, tables_altered):
            plant(s, monkeypatch)
        else:
            plant(s)

    r = small(bench, name, faults=faults)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]
