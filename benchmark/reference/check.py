"""The comparison that decides a run's `correct`: what the timed window
produced, judged against the plain reference (plain.py), each number
against its limit from the cell's file.

Numbers (a gap is the candidate's distance from the float64 reference):

- chisq_gap: the worst |chi^2 - reference| / reference over every chain
  and every chi^2 history entry that falls in the window, each entry's
  reference from the factors the window held at that iteration;
- fit_share: the worst over the chains and the factors the window held
  at each chunk's end (the harness keeps them; the last are those it
  left), of the
  reference's chi^2 of those factors over its chi^2 of the zero model
  (A = P = 0). The sweeps' moves are what fit the factors to the data:
  a sweep that drops or inverts the likelihood leaves the factors far
  from it, whatever its bookkeeping says;
- stats_gap: the worst over the chains and both statistics of
  |mean over the chunk ends' factors - sum / n_stat| / |sum / n_stat|
  (Frobenius norms), each factor normalized as the running statistics
  normalize it (plain.normalized): the statistics have to hold what the
  window's iterations added, of which the chunk ends are a sample;
- atoms_gap_a, atoms_gap_p: on the state the window left, each entry's
  |M - the factor of its atoms| / that factor, over the entries of A (of
  P) that hold atoms: its median, the worst chain's (M is kept by
  float32 increments, whose rounding the entries that many updates
  touched carry; A's median entry is steady from seed to seed, P's, over
  a few hundred entries that span three orders of magnitude, is not, and
  its limit is set apart);
- tables_gap: the worst |table - reference| / (sum of |terms|) over every
  entry of both samplers' update-call tables on that state, as the
  program's tables kernel computes them (Y, SQ, Z);
- atom_table_faults (exact, 0): chains and samplers whose atom table
  breaks its invariants: a live count that is not the number of live
  slots, live atoms not first, a mass not above 0, an element out of
  range;
- stats_faults (exact, 0): chains whose running statistics break what
  their definition fixes: n_stat not the window's sampling iterations,
  a P column sum above n_stat or a sum of squares above its sum (each
  sample is divided by its column's maximum), a negative or not finite
  entry;
- unmoved_chains (exact, 0): chains whose factors at the window's close
  are those at its start.

chisq_gap needs history entries in the window; a cell whose window has
none holds no limit for it. Every number that the cell's file gives a
limit has to be there.

The control puts the reference, in TF32, in the program's place for the
gaps of arithmetic, chisq_gap, atoms_gap_a, atoms_gap_p and tables_gap
(numbers(..., precision="tf32")). fit_share and stats_gap judge the
sampler's moves and sums, which no precision of the reference stands in
for: the faults planted under the timed path (benchmark/faults.py) set
their upper readings. The exact counts' limit is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import plain

EXACT = ("atom_table_faults", "stats_faults", "unmoved_chains")


def _gap(cand: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    err = (cand.to(torch.float64) - ref.to(torch.float64)).abs()
    g = torch.where(scale > 0, err / torch.where(scale > 0, scale, 1.0),
                    torch.where(err > 0, math.inf, 0.0))
    g = torch.where(torch.isnan(err), math.inf, g)
    return float(g.max()) if g.numel() else 0.0


class Inputs:
    """What the benchmark made and handed to both sides: the data matrix,
    the seed and the configuration."""

    def __init__(self, D: np.ndarray, seed: int, config: dict):
        self.D = D
        self.seed = seed
        self.genome_wide = config["distributed"] == "genome-wide"
        self.k = int(config["n_patterns"])
        n_total = D.shape[0] if self.genome_wide else D.shape[1]
        self.sets = plain.subsets(n_total, int(config["n_sets"]), seed)

    def chains(self, shape: tuple):
        """(true shape, padded chain matrix) of each chain."""
        for idx in self.sets:
            mat = plain.chain_matrix(self.D, idx, self.genome_wide, shape)
            true = ((len(idx), self.D.shape[1]) if self.genome_wide
                    else (self.D.shape[0], len(idx)))
            yield true, mat


def numbers(inp: Inputs, out: dict, precision: str = "float64",
            device="cpu") -> dict:
    """The cell's numbers for the program's outputs `out`, or, with
    precision "tf32", the control's three gaps of arithmetic on the same
    state."""
    ref = plain.Arith("float64", device)
    ctl = plain.Arith(precision, device) if precision != "float64" else None
    G, S = out["M_a"].shape[1], out["M_p"].shape[1]
    k = inp.k
    n_hist, freq = out["n_hist"], out["output_frequency"]
    snaps = out["snaps"]
    hist = [x for x in snaps if freq > 0 and x[0] % freq == 0]
    res = {"atoms_gap_a": 0.0, "atoms_gap_p": 0.0, "tables_gap": 0.0}
    if hist:
        res["chisq_gap"] = 0.0
    stats = 0.0
    for c, (true, Dc) in enumerate(inp.chains((G, S))):
        W = plain.dense_weights(Dc, true)

        def chisq(ar, A, P):
            return plain.dense_chisq(ar, Dc, W, A, P)

        # chi^2 history entries of the window
        for it, A, P in hist:
            r = chisq(ref, A[c], P[c])
            cand = (chisq(ctl, A[c], P[c]) if ctl is not None
                    else float(out["chisq_hist"][c, n_hist // 2
                                                 + it // freq - 1]))
            gap = abs(cand - r) / r if r > 0 else math.inf
            res["chisq_gap"] = max(res["chisq_gap"],
                                   gap if math.isfinite(cand) else math.inf)
        if ctl is None:
            zero = float(np.sum(Dc.astype(np.float64) ** 2 * W))
            fit = max([chisq(ref, out["M_a"][c], out["M_p"][c])]
                      + [chisq(ref, A[c], P[c]) for _, A, P in snaps])
            share = fit / zero if zero > 0 else math.inf
            res["fit_share"] = max(res.get("fit_share", 0.0),
                                   share if math.isfinite(share)
                                   else math.inf)
            stats = max(stats, stats_gap(out, c))
        # factors from their atoms
        for side, n_rows in (("a", G), ("p", S)):
            mass, elem, _ = out[f"atoms_{side}"]
            r = plain.factor_from_atoms(ref, mass[c], elem[c], n_rows, k)
            cand = (plain.factor_from_atoms(ctl, mass[c], elem[c], n_rows, k)
                    if ctl is not None
                    else torch.as_tensor(out[f"M_{side}"][c]))
            err = (cand.to(ref.device, torch.float64) - r).abs()
            held = r > 0
            if bool(held.any()):
                name = f"atoms_gap_{side}"
                res[name] = max(res[name],
                                float(torch.median(err[held] / r[held])))
        # the update calls' tables on the final state
        A, P = out["M_a"][c], out["M_p"][c]
        for side in ("a", "p"):
            rows, w = (Dc, W) if side == "a" else (Dc.T, W.T)
            M, O = (A, P) if side == "a" else (P, A)
            r, scales = plain.dense_tables(ref, rows, w, M, O)
            cand = (plain.dense_tables(ctl, rows, w, M, O)[0]
                    if ctl is not None
                    else [torch.as_tensor(t[c]) for t in out[f"tables_{side}"]])
            for x, y, s in zip(cand, r, scales):
                res["tables_gap"] = max(res["tables_gap"],
                                        _gap(x.to(ref.device).reshape(y.shape),
                                             y, s))
    if ctl is None:
        res["stats_gap"] = stats
        res.update(exact_counts(out, G, S, k))
    return res


def stats_gap(out: dict, c: int) -> float:
    """Chain c's running statistics against the mean of its normalized
    factors at the chunk ends (A's and P's, the worse)."""
    n = int(out["n_stat"][c])
    terms = [plain.normalized(A[c], P[c]) for _, A, P in out["snaps"]]
    if not terms:
        return math.inf
    worst = 0.0
    for i, name in enumerate(("a_sum", "p_sum")):
        mean = sum(t[i] for t in terms) / len(terms)
        held = torch.as_tensor(out[name][c], dtype=torch.float64) / max(n, 1)
        den = float(torch.linalg.norm(held))
        num = float(torch.linalg.norm(mean - held))
        g = num / den if den > 0 else math.inf
        worst = max(worst, g if math.isfinite(g) else math.inf)
    return worst


def exact_counts(out: dict, G: int, S: int, k: int) -> dict:
    faults = 0
    for side, n_rows in (("a", G), ("p", S)):
        mass, elem, n = out[f"atoms_{side}"]
        for c in range(mass.shape[0]):
            e, m, nc = elem[c], mass[c], int(n[c])
            live = e >= 0
            ok = (nc == int(live.sum()) and bool(live[:nc].all())
                  and not bool(live[nc:].any()) and bool((m[:nc] > 0).all())
                  and bool((e[:nc] < n_rows * k).all()))
            faults += not ok
    it = out["iterations"]
    stats = 0
    for c in range(out["M_a"].shape[0]):
        n_stat = int(out["n_stat"][c])
        arrays = [out[f][c] for f in ("a_sum", "a_sumsq", "p_sum", "p_sumsq")]
        bad = (n_stat != it
               or not all(np.isfinite(a).all() and (a >= 0).all()
                          for a in arrays)
               or bool((out["p_sum"][c] > n_stat).any())
               or bool((out["p_sumsq"][c] > out["p_sum"][c]).any()))
        stats += bad
    unmoved = sum(
        bool(np.array_equal(out["M_a"][c], out["start_M_a"][c])
             and np.array_equal(out["M_p"][c], out["start_M_p"][c]))
        for c in range(out["M_a"].shape[0]))
    return {"atom_table_faults": faults, "stats_faults": stats,
            "unmoved_chains": unmoved}


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, attempted, failed, checks): each number beside its limit
    (0 for the exact counts); a number without a limit, or not finite,
    fails, and so does a limit without its number (value None)."""
    checks, failed = {}, 0
    values = dict(values)
    for name in limits:
        values.setdefault(name, None)
    for name, value in values.items():
        if value is None:
            failed += 1
            checks[name] = {"value": None, "limit": limits[name]}
            continue
        limit = 0 if name in EXACT else limits.get(name)
        ok = (limit is not None and math.isfinite(value)
              and value <= limit)
        failed += not ok
        checks[name] = {"value": value, "limit": limit}
    return failed == 0, len(values), failed, checks
