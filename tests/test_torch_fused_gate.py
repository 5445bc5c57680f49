"""The fused route's gate (parallel/multichain.MultichainEngine._fused_ok)
holds to what K3 can launch (ops/span_cuda.span_fits), on the CPU.

K3 (csrc/span.cu) gives a thread to each group of four table columns,
at most 1024 a block: above k = 88 its launch raises (span_cuda.
block_threads), whatever the rebuild's size. The gate sends such a run
to the per-call route, whose tables kernel takes any k; at 100 x 100
with one chain, k = 88 still takes the span and k = 89 and 90 do not.
At k = 90 the multichain engine's phases are the per-call route's bits,
and CoGAPS() on the same data and seed ends with a finite meanChiSq and
the same factors.

The gate's size rule (multichain.span_size_ok) reads the chain count:
each row that `python -m cogaps_tpu_torch.profile_iter --gate` measured
on an H100 (both routes at 16 and at 4 chains, k = 10 and 20) goes to
the route that was faster there, and a mesh's ranks take the route of
the whole program."""

import numpy as np
import pytest
import torch

import cogaps_tpu_torch
from cogaps_tpu_torch import engine
from cogaps_tpu_torch.ops import span_cuda
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import multichain
from cogaps_tpu_torch.result import finalize_statistics

torch.set_num_threads(1)


def _data(n=100, seed=4):
    return np.random.default_rng(seed).gamma(2.0, 2.0, (n, n)).astype(
        np.float32)


def _engine(k, n_iterations=3, seed=11):
    D = _data()
    params = CogapsParams(n_patterns=k, n_iterations=n_iterations,
                          output_frequency=0, seed=seed)
    cfg = params.engine_config(*D.shape)
    data = multichain.stack_device_data([D], None, cfg, "cpu")
    return D, params, multichain.MultichainEngine(data, cfg, "cpu")


@pytest.mark.parametrize("k,fits", [(88, True), (89, False), (90, False)])
def test_span_fits_what_k3_can_launch(k, fits):
    """span_fits is True exactly where block_threads and every cluster
    size's rebuild_plan take the shape."""
    _, _, eng = _engine(k)
    B_a, B_p = eng.consts_a.batch, eng.consts_p.batch
    assert span_cuda.span_fits(100, 100, k, B_a, B_p) is fits
    if fits:
        threads = span_cuda.block_threads(B_a, B_p, k)
        assert threads == 1024
        for cl in span_cuda.CLUSTER_SIZES:
            span_cuda.rebuild_plan(100, 100, k, threads, cl)
    else:
        with pytest.raises(ValueError, match="column groups"):
            span_cuda.block_threads(B_a, B_p, k)


@pytest.mark.parametrize("k,fused", [(88, True), (89, False), (90, False)])
def test_fused_gate_follows_k3(k, fused):
    """At 100 x 100, one chain, the rebuild (247-258 M operations) is
    under the limit at each k: the launch alone decides."""
    _, _, eng = _engine(k)
    assert (span_cuda.rebuild_ops(100, 100, k)
            <= multichain.max_span_rebuild_ops(1))
    assert eng._fused_ok() is fused


def _spied(monkeypatch):
    calls = []
    real = span_cuda.run_span

    def spy(*args):
        calls.append(args[6:8])
        return real(*args)

    monkeypatch.setattr(span_cuda, "run_span", spy)
    return calls


def test_k90_takes_the_per_call_route(monkeypatch):
    """Both phases of the multichain engine at k = 90 launch no span and
    give the bits of ChainEngine.run_phase on the same seed."""
    calls = _spied(monkeypatch)
    _, params, eng = _engine(90)
    out = []
    for run in (eng.run_phase, lambda *a: engine.ChainEngine.run_phase(
            eng, *a)):
        st, ss = eng.init_state(), eng.init_stats()
        rand = engine.PhiloxRandom([params.seed], "cpu")
        for phase in (engine.EQUILIBRATION, engine.SAMPLING):
            st, ss = run(st, ss, rand, phase)
        out.append((st, ss))
    assert calls == []
    (st, ss), (st2, ss2) = out
    assert torch.equal(st.M_a, st2.M_a) and torch.equal(st.M_p, st2.M_p)
    assert torch.equal(ss.a_sum, ss2.a_sum)
    assert torch.equal(ss.p_sum, ss2.p_sum)
    assert torch.equal(ss.upd, ss2.upd) and int(ss.upd[0]) > 0


def test_k90_cogaps_runs_per_call(monkeypatch):
    """CoGAPS() at k = 90 on 100 x 100 ends with a finite meanChiSq and
    the factors of the multichain engine's per-call phases, seed for
    seed."""
    calls = _spied(monkeypatch)
    D, params, eng = _engine(90)
    res = cogaps_tpu_torch.CoGAPS(D, n_patterns=90, n_iterations=3,
                                  output_frequency=0, seed=params.seed,
                                  messages=False, device="cpu")
    assert np.isfinite(res.mean_chi_sq) and res.mean_chi_sq > 0
    st, ss = eng.init_state(), eng.init_stats()
    rand = engine.PhiloxRandom([params.seed], "cpu")
    for phase in (engine.EQUILIBRATION, engine.SAMPLING):
        st, ss = eng.run_phase(st, ss, rand, phase)
    assert calls == []
    amean, _, pmean, _ = finalize_statistics(
        *(x[0].numpy() for x in (ss.a_sum, ss.a_sumsq, ss.p_sum,
                                 ss.p_sumsq, ss.n_stat)))
    np.testing.assert_array_equal(np.asarray(res.Amean), amean)
    np.testing.assert_array_equal(np.asarray(res.Pmean), pmean)


# profile_iter --gate (NVIDIA H100 80GB HBM3, 700.00 W), wall ms an
# iteration: (genes, samples, k, chains, per-call, fused)
GATE_ROWS = [
    (1363, 9, 10, 16, 1.3977, 0.5657), (1363, 9, 10, 4, 1.8684, 0.4916),
    (1363, 9, 20, 16, 1.4983, 1.0083),
    (2000, 32, 10, 16, 1.9196, 0.7829), (2000, 32, 10, 4, 2.0429, 0.6604),
    (5005, 100, 10, 16, 1.5641, 1.6220), (5005, 100, 10, 4, 1.4443, 0.9498),
    (6000, 100, 10, 16, 1.8258, 1.9176), (6000, 100, 10, 4, 2.1152, 1.0916),
    (6000, 100, 20, 16, 2.1929, 6.2081), (6000, 100, 20, 4, 1.9545, 3.2196),
    (10000, 100, 10, 16, 1.7584, 2.9157),
    (10000, 100, 10, 4, 2.9392, 1.4944),
    (20000, 100, 10, 16, 1.8942, 5.3702),
    (20000, 100, 10, 4, 1.8314, 2.5762),
]


@pytest.mark.parametrize("G,S,k,nch,per_call,fused", GATE_ROWS)
def test_fused_gate_takes_the_faster_route(G, S, k, nch, per_call, fused):
    """Each measured row goes to the route that ran it faster."""
    cfg = CogapsParams(n_patterns=k).engine_config(G, S)
    assert multichain.span_size_ok(G, S, k, nch, cfg.batch_a,
                                   cfg.batch_p) is (fused < per_call)


@pytest.mark.parametrize("nch,limit", [
    (1, 500_000_000), (4, 500_000_000), (5, 200_000_000),
    (16, 200_000_000), (200, 200_000_000)])
def test_fused_gate_limit_by_chain_count(nch, limit):
    assert multichain.max_span_rebuild_ops(nch) == limit


@pytest.mark.parametrize("n_chains,fused", [(8, False), (4, True)])
def test_fused_gate_reads_the_programs_chains(n_chains, fused):
    """2500 x 100 at k=20 (386 M operations) spans at 4 chains and not at
    8; on a mesh, each rank decides by the program's chains, not by the
    ones it holds, so every rank count takes one route."""
    from cogaps_tpu_torch.parallel import multihost
    G, S, k = 2500, 100, 20
    assert 200_000_000 < span_cuda.rebuild_ops(G, S, k) <= 500_000_000
    cfg = CogapsParams(n_patterns=k, n_iterations=2,
                       output_frequency=0).engine_config(G, S)
    data = multichain.stack_device_data(
        [np.ones((G, S), np.float32)] * n_chains, None, cfg, "cpu")
    for size in (1, 2, 4):
        for rank in range(size):
            mesh = multihost.ProcessMesh("chains", None, size, rank, "none")
            eng = multichain.MultichainEngine(data, cfg, "cpu", mesh=mesh)
            assert eng._fused_ok() is fused, (size, rank)
