"""Faults planted under the timed path of a run, each breaking what a
regression of the program could break, for the check to catch
(benchmark/tests/test_bench_faults.py on the CPU; calibrate.py --fault
on a card, at a cell's size, for the limits' upper readings). Each takes
the run's harness.Setup before burn-in and wraps its engine's run_phase,
the entry that burn-in and the window drive, so the fault runs from the
first iteration on, whichever route (per-call or fused) run_phase
takes."""

from __future__ import annotations

import dataclasses

import torch


def _after_phase(s, change):
    """run_phase's result passed through change(state, stats, new_state,
    new_stats) -> (state, stats)."""
    run = s.eng.run_phase

    def run_phase(state, stats, *args, **kw):
        new, new_stats = run(state, stats, *args, **kw)
        return change(state, stats, new, new_stats)

    s.eng.run_phase = run_phase


def state_unchanged(s):
    """Every phase returns the state and statistics it was given."""
    s.eng.run_phase = (lambda state, stats, *a, **k: (state, stats))


def half_left_out(s):
    """The second half of the chains keep the state each call started
    from; their statistics still count the iterations."""
    def change(state, stats, new, new_stats):
        h = state.M_a.shape[0] // 2

        def keep(cur, old):
            return torch.cat([cur[:h], old[h:]])

        atoms = {f: dataclasses.replace(
            getattr(new, f), **{g: keep(getattr(getattr(new, f), g),
                                        getattr(getattr(state, f), g))
                                for g in ("mass", "elem", "n")})
                 for f in ("atoms_a", "atoms_p")}
        return dataclasses.replace(new, M_a=keep(new.M_a, state.M_a),
                                   M_p=keep(new.M_p, state.M_p),
                                   **atoms), new_stats

    _after_phase(s, change)


def factor_altered(s):
    """The factors each call leaves, scaled by 1 + 1e-3."""
    _after_phase(s, lambda state, stats, new, new_stats: (
        dataclasses.replace(new, M_a=new.M_a * (1 + 1e-3),
                            M_p=new.M_p * (1 + 1e-3)), new_stats))


def likelihood_dropped(s):
    """The sampler sees every weight 1/S^2 as 0, so its moves follow the
    prior alone; its bookkeeping of atoms, factors and statistics stays
    what it is, and the tables that program_outputs reads are made from
    the true weights."""
    eng = s.eng
    run, data = eng.run_phase, eng.data
    blind = dataclasses.replace(data, invS2=torch.zeros_like(data.invS2),
                                invS2_t=torch.zeros_like(data.invS2_t))

    def run_phase(*args, **kw):
        eng.data = blind
        try:
            return run(*args, **kw)
        finally:
            eng.data = data

    eng.run_phase = run_phase


def stats_doubled(s):
    """The running statistics add each call's terms twice; n_stat still
    counts each iteration once."""
    def change(state, stats, new, new_stats):
        twice = {f: 2 * getattr(new_stats, f) - getattr(stats, f)
                 for f in ("a_sum", "a_sumsq", "p_sum", "p_sumsq")}
        return new, dataclasses.replace(new_stats, **twice)

    _after_phase(s, change)


# each fault, and the number that has to catch it
FAULTS = {"state_unchanged": (state_unchanged, "stats_faults"),
          "half_left_out": (half_left_out, "unmoved_chains"),
          "factor_altered": (factor_altered, "atoms_gap_a"),
          "likelihood_dropped": (likelihood_dropped, "fit_share"),
          "stats_doubled": (stats_doubled, "stats_gap")}
