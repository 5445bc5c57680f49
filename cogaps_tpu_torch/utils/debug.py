"""Runtime debug checks — the PyTorch counterpart of
cogaps_tpu/utils/debug.py, the analog of the reference's GAPS_DEBUG
assertion layer (src/utils/GapsAssert.h:31-50, and the async sampler's
maximumDrift < 0.01 postcondition, AsynchronousGibbsSampler.h:119-121,
237-270).

Enabled with ``CoGAPS(..., debug_checks=True)``: after every phase the
chain state is pulled to the host once and validated. It costs one
transfer per phase — for debugging, not production.
"""

from __future__ import annotations

from ..ops.atoms import AtomTable, total_mass_per_element


def check_state(state, n_patterns: int, tol: float = 0.01) -> None:
    """Validate the sampler invariants of every chain of an
    engine.ChainState (the dense and the sparse engines' state alike):
    the live count, a compact atom table, positive live masses, a
    non-negative factor, and the factor within `tol` of its atoms' masses
    per element. Raises AssertionError on a violation."""
    for name, atoms, M in (("A", state.atoms_a, state.M_a),
                           ("P", state.atoms_p, state.M_p)):
        atoms = AtomTable(mass=atoms.mass.cpu(), elem=atoms.elem.cpu(),
                          n=atoms.n.cpu())
        M = M.cpu()
        for c in range(M.shape[0]):
            one = atoms.chain(c)
            elem, mass = one.elem, one.mass
            n = int(one.n)
            live = int((elem >= 0).sum())
            assert n == live, f"{name}: live count {n} != live slots {live}"
            assert (elem[:n] >= 0).all() and (elem[n:] == -1).all(), (
                f"{name}: atom table not compact")
            assert (mass[:n] > 0).all(), f"{name}: non-positive live masses"
            Mc = M[c]
            assert (Mc >= 0).all(), f"{name}: negative factor entries"
            per_elem = total_mass_per_element(
                one, Mc.shape[0] * n_patterns).reshape(Mc.shape)
            drift = float((per_elem - Mc).abs().max())
            assert drift < tol, (
                f"{name}: atom-mass drift {drift:.4f} exceeds {tol} "
                f"(reference tolerance, AsynchronousGibbsSampler.h:120)")
