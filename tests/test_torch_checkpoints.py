"""Checkpoints of the port (cogaps_tpu_torch/utils/checkpoint.py, the
atlas engine's save_checkpoint/load_checkpoint) on the CPU, held to
tests/test_checkpoints.py's contract (tests/testthat/test_checkpoints.R:
4-16): a run resumed from a checkpoint with another seed argument equals
the run it was taken from, and a checkpointed run equals the run without
checkpoints — for CoGAPS() on the dense and the sparse model, for
multichain runs of both engines (the dense one on the fused span, broken
off mid-chunk), and for the atlas engine. Besides: a resume in a fresh
process is accepted (the configuration's digest is the same in every
process), a changed configuration is refused, and a checkpoint of the
same state holds the JAX package's arrays key by key."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cogaps_tpu import engine as jengine
from cogaps_tpu import sparse_engine as jsparse_engine
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu.utils import checkpoint as jckpt
from cogaps_tpu_torch import CoGAPS, convert, engine, sparse_engine
from cogaps_tpu_torch.bench_harness import synthetic_coo
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import atlas_engine, multichain
from cogaps_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sparsified(D):
    return D * (np.random.default_rng(0).random(D.shape) < 0.6)


@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense", "sparse"])
def test_checkpoint_resume_exact(tmp_path, modsim, sparse_model):
    """tests/test_checkpoints.py:13: the file left mid-sampling, resumed
    with another seed argument, gives the checkpointed run's result."""
    D = sparsified(modsim[0]) if sparse_model else modsim[0]
    out = str(tmp_path / "gaps_checkpoint.npz")
    kw = dict(n_patterns=3, n_iterations=60, messages=False,
              sparse_optimization=sparse_model, device="cpu")
    r1 = CoGAPS(D, seed=42, checkpoint_interval=20, checkpoint_out_file=out,
                **kw)
    assert os.path.exists(out) and not os.path.exists(out + ".backup")
    z = np.load(out)
    assert (int(z["phase"]), int(z["iteration"])) == (engine.SAMPLING, 40)
    assert bool(z["sparse"]) == sparse_model
    mid = str(tmp_path / "mid.npz")
    shutil.copy(out, mid)
    r2 = CoGAPS(D, seed=999, checkpoint_in_file=mid, **kw)
    for name in ("Amean", "Pmean", "Asd", "Psd"):
        np.testing.assert_array_equal(getattr(r1, name), getattr(r2, name))
    assert r1.mean_chi_sq == r2.mean_chi_sq
    assert r2.diagnostics["seed"] == 42
    assert r1.diagnostics["totalUpdates"] == r2.diagnostics["totalUpdates"]


@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense", "sparse"])
def test_checkpointed_equals_uninterrupted(tmp_path, modsim, sparse_model):
    """tests/test_checkpoints.py:36: spans of checkpoint_interval
    iterations do not change the run."""
    D = sparsified(modsim[0]) if sparse_model else modsim[0]
    kw = dict(n_patterns=3, n_iterations=45, seed=7, messages=False,
              sparse_optimization=sparse_model, device="cpu")
    r1 = CoGAPS(D, checkpoint_interval=20,
                checkpoint_out_file=str(tmp_path / "ck.npz"), **kw)
    r2 = CoGAPS(D, **kw)
    for name in ("Amean", "Pmean", "Asd", "Psd"):
        np.testing.assert_array_equal(getattr(r1, name), getattr(r2, name))
    assert r1.diagnostics["sweepCounts"] == r2.diagnostics["sweepCounts"]


def test_resume_from_the_end_of_equilibration(tmp_path, modsim):
    """A checkpoint written after the last equilibration iteration
    resumes in the sampling phase (GapsRunner.cpp:453-468)."""
    out = str(tmp_path / "eq.npz")
    kw = dict(n_patterns=3, n_iterations=20, messages=False, device="cpu")
    r1 = CoGAPS(modsim[0], seed=3, checkpoint_interval=20,
                checkpoint_out_file=out, **kw)
    z = np.load(out)
    assert (int(z["phase"]), int(z["iteration"])) == (engine.EQUILIBRATION,
                                                      20)
    r2 = CoGAPS(modsim[0], seed=4, checkpoint_in_file=out, **kw)
    np.testing.assert_array_equal(r1.Amean, r2.Amean)
    np.testing.assert_array_equal(r1.Pmean, r2.Pmean)


def _assert_states_equal(a, b):
    for side in ("atoms_a", "atoms_p"):
        for f in ("mass", "elem", "n"):
            assert torch.equal(getattr(getattr(a[0], side), f),
                               getattr(getattr(b[0], side), f)), (side, f)
    assert torch.equal(a[0].M_a, b[0].M_a) and torch.equal(a[0].M_p, b[0].M_p)
    for f in dataclasses.fields(engine.RunStats):
        assert torch.equal(getattr(a[1], f.name), getattr(b[1], f.name)), f


@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense-fused", "sparse"])
def test_multichain_checkpoint_resume_exact(tmp_path, modsim, sparse_model):
    """tests/test_checkpoints.py:89 on the port's multichain engines: a
    run broken off at iteration 30 (in the middle of the fused span's
    50-iteration chunk, and of PhiloxRandom's block of budget normals)
    and resumed in a new engine from the checkpoint equals the run
    without a break."""
    D = modsim[0]
    seeds = [3, 4, 5]
    cfg = CogapsParams(n_patterns=3, n_iterations=40, seed=3,
                       output_frequency=0).engine_config(*D.shape)
    if sparse_model:
        cfg = dataclasses.replace(cfg, sparse_table_mode="dense")

        def make():
            data, _ = sparse_engine.stack_sparse_device_data(
                [sparsified(D)] * 3, cfg, "cpu")
            return sparse_engine.SparseMultichainEngine(data, cfg, "cpu")
    else:
        def make():
            data = multichain.stack_device_data([D] * 3, None, cfg, "cpu")
            return multichain.MultichainEngine(data, cfg, "cpu")

    eng = make()
    assert sparse_model or eng._fused_ok()
    rand = engine.PhiloxRandom(seeds, "cpu")
    whole = eng.run_phase(eng.init_state(), eng.init_stats(), rand,
                          engine.EQUILIBRATION)
    whole = eng.run_phase(*whole, rand, engine.SAMPLING, 0, 10)

    st, ss = eng.run_phase(eng.init_state(), eng.init_stats(),
                           engine.PhiloxRandom(seeds, "cpu"),
                           engine.EQUILIBRATION, 0, 30)
    path = str(tmp_path / "mc.npz")
    ckpt.save_checkpoint(path, eng, st, ss, engine.EQUILIBRATION, 30, seeds)
    eng2 = make()
    st2, ss2, phase, it = ckpt.load_checkpoint(path, eng2)
    assert (phase, it) == (engine.EQUILIBRATION, 30)
    assert ckpt.checkpoint_seeds(path) == seeds
    rand2 = engine.PhiloxRandom(ckpt.checkpoint_seeds(path), "cpu")
    st2, ss2 = eng2.run_phase(st2, ss2, rand2, phase, it)
    st2, ss2 = eng2.run_phase(st2, ss2, rand2, engine.SAMPLING, 0, 10)
    _assert_states_equal(whole, (st2, ss2))


def test_sparse_checkpoint_resumes_under_another_table_mode(tmp_path,
                                                           modsim):
    """The sparse engines resolve sparse_table_mode from the device's free
    memory, so the fingerprint leaves it out: a checkpoint written under
    one mode loads into an engine of another, state and all, while any
    other change of the configuration is still refused."""
    D = sparsified(modsim[0])
    base = CogapsParams(n_patterns=3, n_iterations=20, seed=3,
                        output_frequency=0).engine_config(*D.shape)

    def make(cfg):
        data, _ = sparse_engine.stack_sparse_device_data([D], cfg, "cpu")
        return sparse_engine.SparseMultichainEngine(data, cfg, "cpu")

    eng = make(dataclasses.replace(base, sparse_table_mode="dense"))
    st, ss = eng.run_phase(eng.init_state(), eng.init_stats(),
                           engine.PhiloxRandom([3], "cpu"),
                           engine.EQUILIBRATION, 0, 5)
    path = str(tmp_path / "mode.npz")
    ckpt.save_checkpoint(path, eng, st, ss, engine.EQUILIBRATION, 5, 3)
    for mode in ("ell", "xla"):
        other = make(dataclasses.replace(base, sparse_table_mode=mode))
        assert ckpt.config_digest(other.config) == ckpt.config_digest(
            eng.config)
        _assert_states_equal((st, ss), ckpt.load_checkpoint(path, other)[:2])
    changed = make(dataclasses.replace(base, sparse_table_mode="ell",
                                       alpha_p=0.5))
    with pytest.raises(ValueError, match="different engine parameters"):
        ckpt.load_checkpoint(path, changed)


def test_atlas_checkpoint_resume_exact(tmp_path):
    """The atlas engine's save_checkpoint/load_checkpoint (the port of
    cogaps_tpu/parallel/atlas_engine.py:363-415, in utils/checkpoint.py's
    format): a resume from a checkpoint with the checkpoint's seed equals
    the run without a break; its budgets need no stored generator state.
    A file of other dimensions or configuration is refused."""
    coo = synthetic_coo(64, 48, 0.3, 3)
    cfg = CogapsParams(n_patterns=3, n_iterations=16, seed=5,
                       sparse_optimization=True,
                       output_frequency=4).engine_config(*coo.shape)

    def make():
        return atlas_engine.AtlasEngine(coo, cfg, batch=64, capacity=1024,
                                        chisq_every=1, device="cpu")

    eng = make()
    rand = atlas_engine.AtlasRandom(5, "cpu")
    whole = eng.run_phase(eng.init_state(), eng.init_stats(), rand,
                          engine.EQUILIBRATION)
    whole = eng.run_phase(*whole, rand, engine.SAMPLING)
    st, ss = eng.run_phase(eng.init_state(), eng.init_stats(),
                           atlas_engine.AtlasRandom(5, "cpu"),
                           engine.EQUILIBRATION)
    st, ss = eng.run_phase(st, ss, atlas_engine.AtlasRandom(5, "cpu"),
                           engine.SAMPLING, 0, 7)
    path = str(tmp_path / "atlas.npz")
    assert atlas_engine.save_checkpoint(path, eng, st, ss, engine.SAMPLING,
                                        7, 5) == path
    st2, ss2, phase, it, seed = atlas_engine.load_checkpoint(path, make())
    assert (phase, it, seed) == (engine.SAMPLING, 7, 5)
    st2, ss2 = eng.run_phase(st2, ss2, atlas_engine.AtlasRandom(seed, "cpu"),
                             phase, it)
    _assert_states_equal(whole, (st2, ss2))
    assert int(whole[1].n_stat[0]) == 16
    assert bool(np.load(path)["sparse"])
    other = atlas_engine.AtlasEngine(synthetic_coo(64, 40, 0.3, 3), cfg,
                                     batch=64, capacity=1024, device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        atlas_engine.load_checkpoint(path, other)
    changed = atlas_engine.AtlasEngine(
        coo, dataclasses.replace(cfg, alpha_a=0.5), batch=64, capacity=1024,
        device="cpu")
    with pytest.raises(ValueError, match="different engine parameters"):
        atlas_engine.load_checkpoint(path, changed)


def test_resume_in_a_fresh_process(tmp_path, modsim):
    """A checkpoint written here resumes in another interpreter, whose
    str hashes are salted otherwise (PYTHONHASHSEED): the fingerprint is a
    digest of the configuration's fields, not hash() (the JAX package's
    fault, ROADMAP.md Queue 3)."""
    D = modsim[0]
    data_path = str(tmp_path / "D.npy")
    np.save(data_path, D)
    out = str(tmp_path / "fresh.npz")
    kw = dict(n_patterns=3, n_iterations=30, messages=False, device="cpu")
    r1 = CoGAPS(D, seed=11, checkpoint_interval=20, checkpoint_out_file=out,
                **kw)
    code = (
        "import sys, numpy as np, torch; torch.set_num_threads(1); "
        "import cogaps_tpu_torch as c; "
        "from cogaps_tpu_torch.utils import checkpoint as k; "
        "from cogaps_tpu_torch.params import CogapsParams as P; "
        f"D = np.load({data_path!r}); "
        f"r = c.CoGAPS(D, seed=5, checkpoint_in_file={out!r}, "
        "n_patterns=3, n_iterations=30, messages=False, device='cpu'); "
        f"np.save({str(tmp_path / 'A.npy')!r}, r.Amean); "
        "print(k.config_digest(P(n_patterns=3, n_iterations=30)"
        ".engine_config(*D.shape)))")
    for hash_seed in ("1", "2"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = hash_seed
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr
        np.testing.assert_array_equal(np.load(tmp_path / "A.npy"), r1.Amean)
        assert int(proc.stdout.split()[-1]) == ckpt.config_digest(
            CogapsParams(n_patterns=3, n_iterations=30).engine_config(
                *D.shape))


def test_changed_config_refused(tmp_path, modsim):
    D = modsim[0]
    out = str(tmp_path / "cfg.npz")
    CoGAPS(D, n_patterns=3, n_iterations=20, seed=1, messages=False,
           checkpoint_interval=10, checkpoint_out_file=out, device="cpu")
    with pytest.raises(ValueError, match="different engine parameters"):
        CoGAPS(D, n_patterns=3, n_iterations=20, messages=False,
               checkpoint_in_file=out, alpha_a=0.5, device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        CoGAPS(D, n_patterns=4, n_iterations=20, messages=False,
               checkpoint_in_file=out, device="cpu")
    cfg = CogapsParams(n_patterns=3, n_iterations=20).engine_config(*D.shape)
    two = multichain.MultichainEngine(
        multichain.stack_device_data([D] * 2, None, cfg, "cpu"), cfg, "cpu")
    with pytest.raises(ValueError, match="chain count"):
        ckpt.load_checkpoint(out, two)
    bad = str(tmp_path / "bad.npz")
    payload = dict(np.load(out))
    payload["magic"] = np.uint32(1)
    np.savez(bad, **payload)
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.load_checkpoint(bad, engine.GapsEngine(D, None, cfg, "cpu"))


@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense", "sparse"])
def test_checkpoint_arrays_equal_jax(tmp_path, modsim, sparse_model):
    """The same state, carried across by convert.py, gives a checkpoint
    whose arrays are the JAX package's key by key (names, dtypes, shapes,
    values); only the fingerprint differs, and the port adds its int64
    update counter. The port also loads it back to the same state."""
    D = sparsified(modsim[0]) if sparse_model else modsim[0]
    prm = dict(n_patterns=3, n_iterations=20, seed=9, output_frequency=5,
               n_snapshots=2, take_pump_samples=True,
               sparse_optimization=sparse_model)
    jcfg = JParams(**prm).engine_config(*D.shape)
    if sparse_model:
        jeng = jsparse_engine.SparseGapsEngine(D, jcfg)
    else:
        jeng = jengine.GapsEngine(D, None, jcfg)
    key = jax.random.PRNGKey(9)
    jstate, jstats = jeng.run_span(jeng.init_state(), jeng.init_stats(), key,
                                   jengine.EQUILIBRATION, 0, 12)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jeng, jstate, jstats, 0, 12, 9)

    cfg = CogapsParams(**prm).engine_config(*D.shape)
    if sparse_model:
        peng = sparse_engine.SparseGapsEngine(D, cfg, "cpu")
    else:
        peng = engine.GapsEngine(D, None, cfg, "cpu")
    pstate = convert.chain_state_from_numpy(jax.device_get(jstate))
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats))
    ppath = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(ppath, peng, pstate, pstats, 0, 12, 9)

    zj, zp = np.load(jpath), np.load(ppath)
    assert set(zp.files) - set(zj.files) == {"upd"}
    assert set(zj.files) <= set(zp.files)
    for name in zj.files:
        if name == "config_hash":
            continue
        a, b = zp[name], zj[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(zp["upd"]) == int(pstats.upd[0])
    st, ss, phase, it = ckpt.load_checkpoint(ppath, peng)
    assert (phase, it) == (0, 12)
    _assert_states_equal((pstate, pstats), (st, ss))
