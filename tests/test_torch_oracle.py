"""The port's copy of the sequential oracle (cogaps_tpu_torch/oracle.py)
against cogaps_tpu/oracle.py, and the port's equilibrium against it.

The copy must equal the JAX package's oracle bit for bit (the same numpy
float32 operations on the same numpy Generator draws): chi^2 history,
factors, domain sizes, positions and masses. The band check holds the
port's two routes — the per-call sweep (a one-chain GapsEngine) and the
fused span (a 4-chain MultichainEngine with output_frequency 0), their
plain versions on the CPU — to the oracle's equilibrium on modsim within
the bands of tests/test_oracle.py:68-75 (mean chi^2 within 25%, mean atom
counts within 30%); chip_smoke.py phase 14 runs it with the kernels."""

import numpy as np
import pytest
import torch

from cogaps_tpu.oracle import SequentialOracle as JOracle
from cogaps_tpu_torch import engine
from cogaps_tpu_torch.oracle import SequentialOracle
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                  stack_device_data)

torch.set_num_threads(1)


def test_oracle_copy_equals_jax_packages(modsim):
    D, _, _ = modsim
    ours = SequentialOracle(D, k=3, seed=0).run(60, record_every=20)
    theirs = JOracle(D, k=3, seed=0).run(60, record_every=20)
    assert ours.chisq_hist == theirs.chisq_hist
    assert ours.atom_hist == theirs.atom_hist
    for name in ("M_a", "M_p"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    for side in ("dom_a", "dom_p"):
        a, b = getattr(ours, side), getattr(theirs, side)
        assert a.size() == b.size() > 0
        assert a.pos == b.pos and a.L == b.L
        np.testing.assert_array_equal(np.float32(a.mass), np.float32(b.mass))


def test_oracle_self_consistency(modsim):
    """tests/test_oracle.py::test_oracle_self_consistency on the copy."""
    D, _, _ = modsim
    orc = SequentialOracle(D, k=3, seed=0).run(300, record_every=100)
    hist = np.asarray(orc.chisq_hist)
    zero_model = float(np.sum((D / np.maximum(0.1 * D, 0.1)) ** 2))
    assert hist[-1] < 0.05 * zero_model
    ap = orc.M_a @ orc.M_p.T
    np.testing.assert_allclose(orc.model_a.AP, ap, rtol=1e-3, atol=1e-3)


def _port_equilibria(D, seeds, n_it, device="cpu"):
    """(chi^2, atoms A, atoms P) of each seed after n_it + n_it
    iterations: the per-call route (one GapsEngine a seed) and the fused
    route (one MultichainEngine of a chain a seed)."""
    cfg = CogapsParams(n_patterns=3, n_iterations=n_it,
                       output_frequency=0).engine_config(*D.shape)
    per_call = []
    for s in seeds:
        eng = engine.GapsEngine(D, None, cfg, device)
        rand = engine.PhiloxRandom([s], device)
        st, ss = eng.init_state(), eng.init_stats()
        for ph in (engine.EQUILIBRATION, engine.SAMPLING):
            st, ss = eng.run_phase(st, ss, rand, ph)
        per_call.append((float(eng.chisq(st)[0]), int(st.atoms_a.n[0]),
                         int(st.atoms_p.n[0])))
    eng = MultichainEngine(stack_device_data([D] * len(seeds), None, cfg,
                                             device), cfg, device)
    assert eng._fused_ok()
    rand = engine.PhiloxRandom(seeds, device)
    st, ss = eng.init_state(), eng.init_stats()
    for ph in (engine.EQUILIBRATION, engine.SAMPLING):
        st, ss = eng.run_phase(st, ss, rand, ph)
    fused = list(zip(eng.chisq(st).tolist(), st.atoms_a.n.tolist(),
                     st.atoms_p.n.tolist()))
    return per_call, fused


@pytest.mark.slow
def test_port_matches_sequential_oracle(modsim):
    """tests/test_oracle.py::test_engine_matches_sequential_oracle for
    both of the port's routes (plain versions), seeds 0-3, 600 + 600
    iterations."""
    D, _, _ = modsim
    seeds, n_it = [0, 1, 2, 3], 600
    orc = [SequentialOracle(D, k=3, seed=s).run(n_it) for s in seeds]
    ref = np.mean([(o.chisq(), o.dom_a.size(), o.dom_p.size()) for o in orc],
                  axis=0)
    for route in _port_equilibria(D, seeds, n_it):
        got = np.mean(route, axis=0)
        assert abs(got[0] - ref[0]) < 0.25 * ref[0], (route, ref)
        assert abs(got[1] - ref[1]) < 0.3 * ref[1], (route, ref)
        assert abs(got[2] - ref[2]) < 0.3 * ref[2], (route, ref)
