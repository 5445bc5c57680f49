"""The probe functions of cogaps_tpu_torch/probes (the H100 counterparts
of tools/probe_mosaic*.py and tools/probe_dma*.py) against the TPU probes,
on the CPU, where each wrapper runs its plain PyTorch version.

* The DMA probes' kernels sit at module level: they run here in Pallas
  TPU interpret mode, through a shim of the module's ``pl`` whose
  pallas_call passes ``interpret=pltpu.InterpretParams()`` (the files
  under tools/ stay as they are), and F9 and F11 are held to them bit
  for bit. probe_mosaic.py's main() runs the same way, and its printed
  results are held to F3, F6 and F7.
* The other Mosaic probes' kernels are nested in their main(): each
  plain version is held to the same function written in jax.numpy as
  the probe writes it, and to the probes' own expected values.
* F8: interpret mode gives zeros for pltpu.prng_random_bits (seen in
  probe_mosaic.py's output below), and the TPU's bits cannot be matched
  by any other generator; the plain version is held to ops/rng.philox4x32
  with the probe's mapping, bit for bit, and to the probe's own checks.

Tolerances: integer-valued results (F3, F4, F6, F9, F10, F11) exact; F5
and F8 bit-exact; F1 and F2 (float64 sums rounded once against JAX's
float32 ones) within 1e-5 of the sum of the absolute terms, for T <=
2000; F7's sum within 1e-6 relative. The 512 MiB table of the DMA probes
is never made: their tables are cut to a few thousand rows.
"""

import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cogaps_tpu_torch.ops import rng
from cogaps_tpu_torch.probes import __main__ as suite
from cogaps_tpu_torch.probes import bound_ms, dma, mosaic

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
PREC = jax.lax.Precision.HIGHEST
F32 = np.float32


@functools.cache
def tool(name):
    """tools/<name>.py as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"tools_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Returns a function that gives a tools module a ``pl`` whose
    pallas_call runs in Pallas TPU interpret mode, for this test."""
    def use(name):
        mod = tool(name)
        shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                        if not k.startswith("__")})
        shim.pallas_call = functools.partial(
            pl.pallas_call, interpret=pltpu.InterpretParams())
        monkeypatch.setattr(mod, "pl", shim)
        return mod
    return use


def t(x):
    return torch.tensor(np.asarray(x))


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(F32)


def within_terms(ours, ref, terms, rtol=1e-5):
    diff = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    assert (diff <= rtol * np.asarray(terms, np.float64)).all(), diff.max()


# ----------------------------------------------------------------------
# F9 and F11 against tools/probe_dma.py and probe_dma2.py in interpret mode
# ----------------------------------------------------------------------
def test_gather_rows_matches_probe_dma_gather_kernel(interpret):
    """F9 against _mk_call(64) (_gather_kernel, probe_dma.py:155) on a
    4096-row _table."""
    mod = interpret("probe_dma")
    tbl = mod._table(4096)
    idx = np.random.default_rng(0).integers(0, 4096, (1, 64)).astype(F32)
    want = np.asarray(mod._mk_call(64)(jnp.asarray(idx), tbl))
    got = dma.gather_rows(t(np.asarray(tbl)), t(idx[0])).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(tbl)[idx[0].astype(np.int64)])


def test_gather_block_matches_probe_dma_p1(interpret, monkeypatch, capsys):
    """F9's runtime-offset form against p1 (probe_dma.py:56), whose table
    is cut to 16384 rows: p1 checks rows 12345..12352."""
    mod = interpret("probe_dma")
    table = mod._table
    monkeypatch.setattr(mod, "_table", lambda: table(16384))
    mod.p1()
    assert "P1 dynamic-offset DMA from ANY ref: OK" in capsys.readouterr().out
    tbl = np.asarray(table(16384))
    got = dma.gather_block(t(tbl), torch.tensor([12345], dtype=torch.int32),
                           8).numpy()
    assert np.array_equal(got, tbl[12345:12353])


def test_strided_sum_matches_probe_dma_p2(interpret, capsys):
    """F11 against p2a (probe_dma.py:85, 196) and p2b (:112, 2*31*28 + 8)."""
    mod = interpret("probe_dma")
    mod.p2a()
    mod.p2b()
    out = capsys.readouterr().out
    assert "P2a dynamic scalar read from VMEM ref: OK" in out
    assert "P2b vreg->VMEM->SMEM DMA + scalar reads: OK" in out
    x = t(np.arange(256, dtype=F32)[None])
    assert float(dma.strided_sum(x, 7)) == 196.0
    assert float(dma.strided_sum(x, 31, 2.0, 1.0)) == 2 * 31 * 28 + 8


@pytest.mark.parametrize("n_passes", [1, 3])
def test_gather_passes_match_probe_dma2(interpret, monkeypatch, n_passes):
    """F9's dependent passes against probe_dma2.run (probe_dma2.py:68) on
    a 2048-row table: the sum it returns, and every lane against the
    probe's formula in numpy."""
    mod = interpret("probe_dma2")
    monkeypatch.setattr(mod, "NB", 2048)
    _, want_sum = mod.run(32, n_passes)
    tbl = (np.arange(2048, dtype=F32)[:, None]
           + np.zeros((1, mod.K), F32))
    idx = np.random.default_rng(0).integers(0, 2048, (1, 32)).astype(F32)[0]
    out, buf = dma.gather_passes(t(tbl), t(idx), n_passes)
    assert float(out.numpy()[None].sum()) == want_sum
    cur = idx
    for _ in range(n_passes):
        rows = tbl[cur.astype(np.int64)]
        cur = np.floor(cur * F32(0.5) + rows[:, 0]) % F32(2048)
    assert np.array_equal(out.numpy(), cur + rows[0, 0])
    assert np.array_equal(buf.numpy(), rows)


@pytest.mark.parametrize("n", [1, 16, 80])
def test_dependent_loads_follow_one_lane_of_gather_passes(n):
    """The dependent-load floor's chain is gather_passes' index rule on
    lane 0: its result is that lane's index after n passes."""
    tbl = t(np.arange(2048, dtype=F32)[:, None] + np.zeros((1, 8), F32))
    idx = t(np.float32([1234, 7, 99]))
    got = dma.dependent_loads(tbl, idx, n)
    out, buf = dma.gather_passes(tbl, idx[:1], n)
    assert got.shape == (1,) and torch.equal(got, out - buf[0, 0])


def test_probe_mosaic_main_in_interpret_mode(interpret, capsys):
    """probe_mosaic.py's main() with every kernel in interpret mode: its
    printed results against F6 (9216), F7 (512 and 5.0) and F3 (113 of
    1024 lanes kept); its PRNG probe gets zeros from prng_random_bits
    here, so the seeds do not differ."""
    interpret("probe_mosaic").main()
    out = capsys.readouterr().out
    assert "[FAIL]" not in out
    assert "result=9216.0 (expect 9216)" in out
    assert "r[0,0]=512.0 (expect 512)" in out
    assert "min-reduce over minor axis: ran, r[0,0]=5.0" in out
    assert "kept=113.0/1024" in out
    assert "seeds differ=False, range=[0.000,0.000]" in out
    x = t(np.full((8, 128), 3.0, F32))
    assert float(mosaic.while_sum(x, "count")) == 9216.0
    assert float(mosaic.reduce3d(t(np.full((8, 128, 256), 2.0, F32)),
                                 "sum")[0, 0]) == 512.0
    assert float(mosaic.reduce3d(t(np.full((8, 128, 256), 5.0, F32)),
                                 "min")[0, 0]) == 5.0
    r = t((np.arange(1024, dtype=F32) % 113.0)[None])
    assert int((mosaic.first_wins(r) == 0).sum()) == 113


# ----------------------------------------------------------------------
# F1-F7 against the probes' functions in jax.numpy
# ----------------------------------------------------------------------
def jax_bdot(a, b):
    return jax.lax.dot_general(a, b, (((1,), (1,)), ((0,), (0,))),
                               preferred_element_type=jnp.float32,
                               precision=PREC)


@pytest.mark.parametrize("shape", [(8, 1363, 7, 256), (2, 75, 128, 64),
                                   (1, 1363, 9, 40), (3, 2000, 10, 9)])
def test_bdot_matches_dot_general(shape):
    NCH, T, K, B = shape
    a, b = rand((NCH, T, K), 1), rand((NCH, T, B), 2, 3.0)
    got = mosaic.bdot(t(a), t(b)).numpy()
    want = np.asarray(jax_bdot(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (NCH, K, B)
    within_terms(got, want, np.einsum("cti,ctb->cib", np.abs(a), np.abs(b)))


def test_bdot_on_ones_counts_the_contraction():
    """The probes feed ones: every output is T."""
    got = mosaic.bdot(torch.ones(8, 1363, 7), torch.ones(8, 1363, 256))
    assert bool((got == 1363.0).all())


@pytest.mark.parametrize("shape", [(8, 512), (8, 1024), (3, 77)])
def test_prefix_matches_cumsum_and_tri_matmul(shape):
    x = rand(shape, 3, 10.0) - 5.0
    B = shape[1]
    tri = (jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
           <= jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)).astype(
               jnp.float32)
    got = mosaic.prefix(t(x)).numpy()
    terms = np.cumsum(np.abs(x), 1)
    within_terms(got, np.asarray(jnp.cumsum(jnp.asarray(x), 1)), terms)
    within_terms(got, np.asarray(jnp.dot(jnp.asarray(x), tri,
                                         precision=PREC)), terms)


def jax_match_count(r):
    """probe_mosaic2.py's match_case body (the eye matmul transposes)."""
    B = r.shape[1]
    eye = (jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
           == jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)).astype(
               jnp.float32)
    tri_s = (jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
             < jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)).astype(
                 jnp.float32)
    rcol = jax.lax.dot_general(r, eye, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=PREC)
    m = (rcol[:, :, None] == r[:, None, :]).astype(jnp.float32)
    return jnp.sum(m * tri_s[None], axis=1)


@pytest.mark.parametrize("case", ["mod113-8x512", "mod113-1x1024",
                                  "ints-4x256"])
def test_first_wins_matches_match_matrix(case):
    if case == "ints-4x256":
        r = np.random.default_rng(0).integers(0, 57, (4, 256)).astype(F32)
    else:
        nch, B = (8, 512) if case == "mod113-8x512" else (1, 1024)
        r = np.arange(nch * B, dtype=F32).reshape(nch, B) % F32(113.0)
    got = mosaic.first_wins(t(r)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jax_match_count(jnp.asarray(r))))
    # tools/probe_mosaic5.py's numpy reference
    exp = np.zeros(r.shape, F32)
    for ch in range(r.shape[0]):
        for i in range(r.shape[1]):
            exp[ch, i] = np.sum(r[ch, :i] == r[ch, i])
    assert np.array_equal(got, exp)


def jax_ohmin(r, n_rows, axis):
    """probe_mosaic2.py's ohmin_case (axis 2) / probe_mosaic3.py's
    ohmin_marg (axis 1) body."""
    NCH, B = r.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (NCH, n_rows, B), 1).astype(
        jnp.float32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (NCH, 1, B), 2).astype(
        jnp.float32)
    lf = jnp.where(iota == r[:, None, :], lane, jnp.float32(B))
    return jnp.min(lf, axis=axis)


@pytest.mark.parametrize("form", ["row", "lane"])
@pytest.mark.parametrize("values", ["mod113", "odd"])
def test_claim_min_matches_onehot_min(form, values):
    if values == "mod113":
        r = np.arange(8 * 512, dtype=F32).reshape(8, 512) % F32(113.0)
    else:  # out of range, non-integer and repeated rows
        r = np.random.default_rng(4).integers(-3, 60, (3, 100)).astype(F32)
        r[:, ::7] += F32(0.5)
    n_rows = 1363 if values == "mod113" else 50
    got = mosaic.claim_min(t(r), n_rows, form).numpy()
    want = np.asarray(jax_ohmin(jnp.asarray(r), n_rows,
                                2 if form == "row" else 1))
    assert got.dtype == np.int32
    assert np.array_equal(got, want.astype(np.int32))


def test_elem_chain_is_the_probes_chain_bit_for_bit():
    """Against jax.numpy op by op (compiled XLA on the CPU fuses the
    multiply and add into one rounding) and numpy float32."""
    x = rand((8, 1024), 5, 2.0)
    xj, xn = jnp.asarray(x), x.copy()
    for _ in range(50):
        xj = xj * 1.0001 + 0.001
        xn = xn * F32(1.0001) + F32(0.001)
    got = mosaic.elem_chain(t(x)).numpy()
    assert np.array_equal(got, np.asarray(xj))
    assert np.array_equal(got, xn)


@pytest.mark.parametrize("fill", [3.0, 2.5, -1.0])
def test_while_count_matches_while_loop(fill):
    """probe_mosaic.py:103's loop in jax.lax.while_loop."""
    x = np.full((8, 128), fill, F32)
    x[1:] = np.random.default_rng(6).integers(0, 4, (7, 128))

    def cond(c):
        return c[0] < x[0, 0]

    def body(c):
        return c[0] + 1.0, c[1] + jnp.sum(jnp.asarray(x))

    _, want = jax.lax.while_loop(cond, body, (jnp.float32(0.0),
                                              jnp.float32(0.0)))
    got = mosaic.while_sum(t(x), "count")
    assert got.shape == (1, 1) and float(got) == float(want)


@pytest.mark.parametrize("shape", [(1, 128), (2, 16), (1, 7)])
def test_while_until_matches_while_loop(shape):
    """probe_mosaic2.py:184's array-carry loop in jax.lax.while_loop;
    ones of (1, 128) give 1.0 (one trip)."""
    x = np.ones(shape, F32) if shape == (1, 128) else (
        np.random.default_rng(7).integers(0, 9, shape).astype(F32))

    def cond(c):
        return jnp.sum(c[0]) < 100.0

    def body(c):
        return c[0] + 1.0, c[1] + jnp.asarray(x)

    a0 = jnp.zeros(shape, jnp.float32)
    _, want = jax.lax.while_loop(cond, body, (a0, a0))
    got = mosaic.while_sum(t(x), "until").numpy()
    assert np.array_equal(got, np.asarray(want))
    if shape == (1, 128):
        assert (got == 1.0).all()


def test_reduce3d_matches_sum_and_min():
    x = rand((8, 128, 256), 8, 4.0) - 2.0
    got = mosaic.reduce3d(t(x), "sum").numpy()
    want = np.asarray(jnp.sum(jnp.asarray(x) * jnp.asarray(x), axis=1))
    assert got.shape == (8, 256)
    assert (np.abs(got.astype(np.float64) - want) <= 1e-6 * want).all()
    got = mosaic.reduce3d(t(x), "min").numpy()
    assert np.array_equal(got, np.asarray(jnp.min(jnp.asarray(x), axis=2)))


# ----------------------------------------------------------------------
# F8 against ops/rng.philox4x32
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [42, 43, -7])
def test_uniform_is_philox_word0_with_the_probe_mapping(seed):
    rows, lanes = 8, 128
    lane = np.broadcast_to(np.arange(lanes), (rows, lanes))
    row = np.broadcast_to(np.arange(rows)[:, None], (rows, lanes))
    zero = torch.zeros(rows, lanes, dtype=torch.int64)
    w0 = rng.philox4x32(t(lane.astype(np.int64)), t(row.astype(np.int64)),
                        zero, zero, seed & 0xFFFFFFFF, 0)[0].numpy()
    want = ((w0.astype(np.uint32) >> 9) | np.uint32(0x3F800000)).view(
        F32) - F32(1.0)
    got = mosaic.uniform(torch.tensor([seed], dtype=torch.int32), rows,
                         lanes).numpy()
    assert np.array_equal(got, want)


def test_uniform_passes_the_probes_checks():
    """probe_mosaic.py's try_prng: the same seed gives the same block,
    seeds 42 and 43 differ, values lie in [0, 1)."""
    def draw(s):
        return mosaic.uniform(torch.tensor([s], dtype=torch.int32), 8,
                              128).numpy()

    r1, r2, r3 = draw(42), draw(42), draw(43)
    assert np.array_equal(r1, r2) and (r1 != r3).any()
    assert r1.min() >= 0.0 and r1.max() < 1.0
    big = mosaic.uniform(torch.tensor([7], dtype=torch.int32), 16, 4096)
    assert abs(float(big.mean()) - 0.5) < 0.01


# ----------------------------------------------------------------------
# F9 and F10 against tools/probe_mosaic5.py's numpy references
# ----------------------------------------------------------------------
def mosaic5_inputs():
    """probe_mosaic5.main's arrays, drawn in its order."""
    rng_ = np.random.default_rng(0)
    NCH, B, T, C = 4, 256, 1363, 1024
    r = rng_.integers(0, 57, (NCH, B)).astype(F32)
    tbl = (rng_.standard_normal((NCH, T, 16)) * 100).astype(F32)
    idx = rng_.integers(0, T, (NCH, B)).astype(F32)
    vals = (rng_.standard_normal((NCH, B)) * 37).astype(F32)
    slot = rng_.integers(0, C, (NCH, B)).astype(F32)
    for ch in range(NCH):
        slot[ch] = rng_.permutation(C)[:B].astype(F32)
    flat = (rng_.standard_normal((NCH, C // 128, 128)) * 11).astype(F32)
    return r, tbl, idx, vals, slot, flat.reshape(NCH, C)


def test_gathers_and_scatter_match_probe_mosaic5():
    _, tbl, idx, vals, slot, flat = mosaic5_inputs()
    got = dma.gather_batched(t(tbl), t(idx)).numpy()
    exp = np.stack([tbl[ch, idx[ch].astype(int), :].T for ch in range(4)])
    assert got.shape == (4, 16, 256) and np.array_equal(got, exp)
    got = dma.gather_batched(t(flat[:, :, None]), t(slot)).numpy()
    exp = np.stack([flat[ch, slot[ch].astype(int)] for ch in range(4)])
    assert np.array_equal(got.reshape(4, 256), exp)
    got = dma.scatter_slots(t(vals), t(slot), 1024).numpy()
    exp = np.zeros((4, 1024), F32)
    for ch in range(4):
        exp[ch, slot[ch].astype(int)] = vals[ch]
    assert np.array_equal(got, exp)


# ----------------------------------------------------------------------
# wrappers, counts and the suite's cases
# ----------------------------------------------------------------------
def wrapper_calls():
    """(wrapper, arguments) of every wrapper, on small CPU tensors."""
    r = t(np.arange(64, dtype=F32).reshape(2, 32) % 5)
    tbl = t(rand((50, 8), 9))
    return [
        (mosaic.bdot, (t(rand((2, 9, 3), 1)), t(rand((2, 9, 5), 2)))),
        (mosaic.prefix, (t(rand((2, 40), 3)),)),
        (mosaic.first_wins, (r,)),
        (mosaic.claim_min, (r, 6, "row")),
        (mosaic.elem_chain, (t(rand((3, 5), 4)),)),
        (mosaic.while_sum, (t(np.full((2, 4), 2.0, F32)), "count")),
        (mosaic.reduce3d, (t(rand((2, 3, 4), 5)), "min")),
        (mosaic.uniform, (torch.tensor([3], dtype=torch.int32), 2, 5)),
        (dma.gather_rows, (tbl, t(np.float32([3, 0, 49])))),
        (dma.gather_block, (tbl, torch.tensor([40], dtype=torch.int32), 8)),
        (dma.gather_passes, (tbl, t(np.float32([3, 0, 49])), 2)),
        (dma.dependent_loads, (tbl, t(np.float32([3, 0])), 2)),
        (dma.gather_batched, (t(rand((2, 10, 3), 6)),
                              t(np.float32([[1, 9], [0, 0]])))),
        (dma.scatter_slots, (t(rand((2, 3), 7)),
                             t(np.float32([[0, 5, 2], [1, 2, 3]])), 6)),
        (dma.strided_sum, (t(rand((1, 30), 8)), 3)),
    ]


WRAPPER_NAMES = [w.__name__ for w, _ in wrapper_calls()]


@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_wrapper_takes_the_plain_version_on_cpu(name):
    wrapper, args = next((w, a) for w, a in wrapper_calls()
                         if w.__name__ == name)
    plain = getattr(mosaic, f"{name}_plain", None) or getattr(
        dma, f"{name}_plain")
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    assert wrapper.launches == before
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_wrapper_checks_dtype_shape_and_contiguity(name):
    wrapper, args = next((w, a) for w, a in wrapper_calls()
                         if w.__name__ == name)
    first = args[0]
    with pytest.raises(TypeError, match="dtype"):
        wrapper(first.double() if first.dtype == torch.float32
                else first.float(), *args[1:])
    if first.shape[-1] > 1:  # every other element: not contiguous
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(torch.cat([first, first], dim=-1)[..., ::2], *args[1:])
    others = [i for i, a in enumerate(args)
              if i and isinstance(a, torch.Tensor)]
    if others:  # a second tensor with a dimension too many
        bad = list(args)
        bad[others[0]] = args[others[0]][None]
        with pytest.raises(ValueError, match="shape"):
            wrapper(*bad)
    if wrapper is mosaic.uniform:
        with pytest.raises(ValueError, match="shape"):
            wrapper(torch.tensor([1, 2], dtype=torch.int32), 2, 5)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no probe kernel"):
        mosaic.prefix(torch.ones(2, 4, device="meta"))
    with pytest.raises(ValueError, match="at most 1024"):
        mosaic.first_wins(torch.ones(1, 2048))
    with pytest.raises(ValueError, match="form"):
        mosaic.claim_min(torch.ones(1, 4), 3, "column")


def test_bounds_of_the_contractions():
    """F1's bounds: the probes' (8,1363,7)x(8,1363,256) moves 11.5 MB
    (3.44 us at 3.35 TB/s, against 0.58 us of float32 operations); K3's
    contraction at GIST x16 ~0.42 us; the wide case ~42 us."""
    a, b = torch.empty(8, 1363, 7), torch.empty(8, 1363, 256)
    n_bytes, n_ops = mosaic.bdot_counts(a, b)
    assert abs(n_bytes - 11.53e6) < 0.01e6
    assert bound_ms(n_bytes, n_ops) == pytest.approx((3.44e-3, "bytes"),
                                                     rel=2e-3)
    assert n_ops / 67e12 * 1e3 == pytest.approx(0.58e-3, rel=0.01)
    for shape, us in (((16, 1363, 7, 9), 0.42), ((16, 20000, 10, 100), 42.0)):
        NCH, T, K, B = shape
        ms, by = bound_ms(*mosaic.bdot_counts(torch.empty(NCH, T, K),
                                              torch.empty(NCH, T, B)))
        assert by == "bytes" and ms * 1e3 == pytest.approx(us, rel=0.01)
    ms, by = bound_ms(*mosaic.uniform_counts(None, 16, 16 * 1024))
    assert by == "operations"


def test_gather_bounds_read_each_table_row_once():
    """F9's bounds count the table rows that the indices name once each,
    however often they repeat, beside every output row and index."""
    tbl = torch.arange(100, dtype=torch.float32)[:, None].expand(100, 8)
    idx = torch.tensor([3.0, 3.0, 7.0, 3.0])
    assert dma.gather_rows_counts(tbl, idx) == (4 * (2 * 8 + 4 * 8 + 4), 0)
    # pass 1 reads rows 3 and 7, pass 2 rows floor(1.5 r): 4 and 10
    assert dma.gather_passes_counts(tbl, idx, 2) == (
        4 * (4 * 8 + 4 + 4 * 8 + 4), 4 * 2 * 4)
    # row 1 of both chains is two rows of the (2, 10, 3) table
    idx2 = torch.tensor([[1.0, 1.0, 2.0], [1.0, 5.0, 5.0]])
    assert dma.gather_batched_counts(torch.zeros(2, 10, 3), idx2) == (
        4 * (4 * 3 + 2 * 3 * 3 + 2 * 3), 0)
    # one K4 sweep's 512,000 partner rows of (50000, 50): the table once,
    # ~114 MB, not the 205 MB of a row read per index
    idx3 = torch.as_tensor(np.random.default_rng(61).integers(
        0, 50000, 512000).astype(np.float32))
    n_bytes, _ = dma.gather_rows_counts(torch.zeros(50000, 50), idx3)
    assert abs(n_bytes - 114.4e6) < 0.1e6


def small_cases():
    """The suite's cases with 16384-row stand-ins for the DMA probes'
    512 MiB tables."""
    dev = torch.device("cpu")
    return suite.cases((suite._probe_table(dev, 16384),
                        suite._probe2_table(dev, 16384)))


def test_suite_cases_agree_on_cpu():
    """Every case of `python -m cogaps_tpu_torch.probes` below 16 MB, on
    the CPU: its inputs, wrapper, plain version, tolerance, counts and
    library call."""
    dev = torch.device("cpu")
    seen = set()
    for case in small_cases():
        args = case.make(dev)
        n_bytes, _ = case.counts(*args)
        seen.add(case.f)
        if n_bytes > 16e6:
            continue
        k, p = case.kernel(*args), case.plain(*args)
        assert suite.agrees(case, args, k, p), case.shape
        if case.library is not None and case.f != "F8":
            lib = case.library(*args)()
            assert lib.shape == (k if not isinstance(k, tuple) else k[0]).shape
    assert seen == set(suite.WRAPPERS_OF)


def test_every_probe_site_has_a_function():
    """The 21 pallas_call sites of tools/probe_*.py other than
    probe_rebuild.py, each run by a case of the suite, and the kernels
    line's entries."""
    sites = {f"tools/probe_dma.py:{n}" for n in (56, 85, 112, 155)}
    sites |= {"tools/probe_dma2.py:68", "tools/probe_mosaic4.py:35",
              "tools/probe_mosaic5.py:27", "tools/probe_mosaic3.py:33",
              "tools/probe_mosaic3.py:85"}
    sites |= {f"tools/probe_mosaic.py:{n}"
              for n in (51, 72, 92, 116, 131, 145, 163, 187, 213)}
    sites |= {f"tools/probe_mosaic2.py:{n}" for n in (33, 197, 214)}
    assert len(sites) == 21
    for s in sites:
        path, line = s.split(":")
        text = (TOOLS.parent / path).read_text().splitlines()
        assert "pl.pallas_call(" in text[int(line) - 1], s
    records = [{"f": c.f, "headline": c.headline, "sites": c.sites,
                "max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0,
                "bound_ms": 0.5, "bound_by": "bytes", "library_ms": None,
                "shape": c.shape} for c in small_cases()]
    entries = suite.kernel_entries(records,
                                   {f: 1 for f in suite.WRAPPERS_OF})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert len(entries) == 11 and all(keys <= set(e) for e in entries)
    assert set().union(*(e["replaces"] for e in entries)) == sites
    assert {e["source"] for e in entries} == {
        "cogaps_tpu_torch/csrc/probe_mosaic.cu",
        "cogaps_tpu_torch/csrc/probe_dma.cu"}


# ----------------------------------------------------------------------
# F1's and F9's plans (probes/mosaic.bdot_plan, probes/dma.gather_plan)
# against a model of how csrc/probe_mosaic.cu and probe_dma.cu walk them
# ----------------------------------------------------------------------
CSRC = TOOLS.parent / "cogaps_tpu_torch" / "csrc"
H100_SMS = 132
SUITE_BDOT = [(8, 1363, 7, 256), (8, 1363, 7, 512), (8, 1363, 7, 1024),
              (1, 1363, 7, 256), (8, 1363, 9, 512), (8, 128, 128, 512),
              (8, 128, 128, 256), (1, 128, 128, 256), (8, 75, 128, 512),
              (16, 1363, 7, 9), (16, 20000, 10, 100)]
EDGE_BDOT = [(3, 500, 16, 40), (3, 500, 17, 40), (2, 1, 128, 64),
             (2, 75, 128, 64), (4, 300, 7, 9), (4, 300, 7, 33),
             (4, 300, 7, 100), (2, 40, 20, 33), (1, 1000, 5, 100),
             (1, 130, 128, 256), (1, 3001, 16, 12), (1, 16, 9, 33),
             (1, 1, 1, 1), (5, 7, 1, 1000)]


def test_bdot_plan_regimes_at_the_suite_shapes():
    """K <= 16 is bytes-bound (every 1363 x 7/9 shape and the port's
    two), K = 128 operations-bound; each entry of the suite runs by one."""
    shapes = {(c.make(torch.device("cpu"))[0].shape,
               c.make(torch.device("cpu"))[1].shape[-1])
              for c in small_cases() if c.f == "F1"}
    assert {(*a, b) for a, b in shapes} == set(SUITE_BDOT)
    for NCH, T, K, B in SUITE_BDOT:
        plan = mosaic.bdot_plan(NCH, T, K, B)
        assert plan.regime == ("bytes" if K <= 16 else "operations")
        assert plan.vec == (B % 4 == 0 and (K <= 16 or K % 4 == 0))


@pytest.mark.parametrize("shape", [s for s in SUITE_BDOT if s[0] == 1])
def test_bdot_plan_fills_a_wave_with_one_chain(shape):
    plan = mosaic.bdot_plan(*shape, H100_SMS)
    assert np.prod(plan.grid) >= H100_SMS and plan.splits > 1


def bdot_walk(plan, NCH, T, K, B):
    """How many times the kernel's blocks and threads add each term
    (c, t, i, j) into the output: a count array (NCH, T, K, B)."""
    seen = np.zeros((NCH, T, K, B), np.int64)
    gx, gy, gz = plan.grid
    assert gz == NCH * plan.splits
    for z in range(gz):
        c, p = divmod(z, plan.splits)
        t_lo, t_hi = T * p // plan.splits, T * (p + 1) // plan.splits
        for x in range(gx):
            for y in range(gy):
                if plan.regime == "bytes":
                    V = 4 if plan.vec else 1
                    tx = mosaic.SKINNY_TX
                    assert tx * V == plan.tile_b
                    assert plan.threads == (mosaic.SKINNY_THREADS, 1)
                    # each thread's columns; its t are split among the
                    # block's t rows, together the whole range
                    for ux in range(tx):
                        u = x * tx + ux
                        if u < B // V:
                            seen[c, t_lo:t_hi, :, u * V:u * V + V] += 1
                else:
                    i0, j0 = y * plan.tile_k, x * plan.tile_b
                    seen[c, t_lo:t_hi, i0:i0 + plan.tile_k,
                         j0:j0 + plan.tile_b] += 1
    return seen


@pytest.mark.parametrize("shape", SUITE_BDOT[3:4] + SUITE_BDOT[6:8]
                         + SUITE_BDOT[9:10] + EDGE_BDOT)
def test_bdot_plan_covers_every_term_once(shape):
    """Tiles, strips and T splits cover T, K and B exactly, ragged edges
    included: each term of each output lands once."""
    NCH, T, K, B = shape
    plan = mosaic.bdot_plan(NCH, T, K, B, H100_SMS)
    assert 1 <= plan.splits <= T
    assert (plan.scratch is None) == (plan.splits == 1)
    if plan.scratch is not None:
        assert plan.scratch == (plan.splits, NCH, K, B)
    if plan.regime == "bytes":
        assert plan.tile_k == K and plan.grid[1] == 1
    gx, gy, _ = plan.grid
    assert (gx - 1) * plan.tile_b < B <= gx * plan.tile_b
    assert (gy - 1) * plan.tile_k < K <= gy * plan.tile_k
    assert (bdot_walk(plan, NCH, T, K, B) == 1).all()


@pytest.mark.parametrize("shape", SUITE_BDOT + EDGE_BDOT)
def test_bdot_plan_fits_shared_memory_and_the_grid(shape):
    plan = mosaic.bdot_plan(*shape)
    V = 4 if plan.vec else 1
    if plan.regime == "bytes":  # a_s double buffer and the warps' sums
        want = 4 * (2 * mosaic.SKINNY_CHUNK * shape[2]
                    + mosaic.SKINNY_THREADS // 32 * plan.tile_b * shape[2])
    else:  # As and Bs, `stages` chunks each (the t groups' sums reuse
        #    them)
        tile = mosaic.TILES[plan.tile_k]
        want = 4 * tile.stages * tile.chunk_t * 2 * plan.tile_k
        assert tile.groups * plan.tile_k ** 2 * 4 <= want
    assert plan.smem == want <= 48 * 1024 <= 232_448  # static
    assert plan.grid[2] <= 65535 and np.prod(plan.threads) <= 1024


def test_plan_constants_are_the_kernels():
    mos = (CSRC / "probe_mosaic.cu").read_text()
    for name, value in (("kSkinnyK", mosaic.SKINNY_K),
                        ("kSkinnyThreads", mosaic.SKINNY_THREADS),
                        ("kSkinnyTX", mosaic.SKINNY_TX),
                        ("kSkinnyChunk", mosaic.SKINNY_CHUNK)):
        assert f"constexpr int {name} = {value};" in mos
    for side, (groups, chunk_t, stages) in mosaic.TILES.items():
        for vec in ("true", "false"):
            launch = (f"bdot_tile_kernel<{side}, {groups}, {chunk_t}, "
                      f"{stages}, {vec}><<<grid, "
                      f"{side * side // 16 * groups}, 0, s>>>")
            assert launch in mos, launch
    dm = (CSRC / "probe_dma.cu").read_text()
    assert f"constexpr int kGatherThreads = {dma.GATHER_THREADS};" in dm


def gather_walk(plan, B, K):
    """How often the kernel's threads write each float of the flat (B, K)
    output, from its loop: block g takes tiles g, g + grid, ...; thread x
    of a tile piece it * threads + x, 4 floats. Also the pieces that
    straddle two rows."""
    n = B * K
    written = np.zeros(n, np.int64)
    straddle = 0
    for g in range(plan.grid):
        for tile in range(g, plan.tiles, plan.grid):
            e0 = tile * plan.tile * 4
            e1 = min(n, e0 + plan.tile * 4)
            for it in range(plan.items):
                for x in range(plan.threads):
                    lo = e0 + 4 * (it * plan.threads + x)
                    hi = min(lo + 4, e1)
                    if lo < hi:
                        written[lo:hi] += 1
                        straddle += lo // K != (hi - 1) // K
    return written, straddle


@pytest.mark.parametrize("B,K", [(512, 50), (20000, 50), (1, 50), (9000, 1),
                                 (1001, 3), (1024, 128), (8, 128), (77, 12)])
def test_gather_plan_covers_the_output_in_pieces(B, K):
    """Every float of the (B, K) output in one 16-byte piece (the last one
    partial where B K % 4); at K = 50 half the row ends fall inside a
    piece."""
    plan = dma.gather_plan(B, K, H100_SMS)
    assert plan.pieces == -(-B * K // 4) <= plan.tiles * plan.tile
    assert plan.tile == plan.items * plan.threads
    assert plan.grid == min(plan.tiles, dma.GATHER_BLOCKS_PER_SM * H100_SMS)
    written, straddle = gather_walk(plan, B, K)
    assert (written == 1).all()
    if K == 50:
        assert straddle == sum(1 for j in range(1, B) if (50 * j) % 4)
    if K % 4 == 0:
        assert straddle == 0


def test_gather_plan_at_one_k4_sweep():
    """512,000 rows of 50: 6.4 M pieces, two a thread, in 12,500 tiles
    over 8 blocks an SM; the probes' 1024-row gather a piece a thread."""
    plan = dma.gather_plan(512_000, 50)
    assert plan.pieces == 6_400_000 and plan.items == 2
    assert plan.tiles == 12_500 and plan.grid == 1056
    small = dma.gather_plan(1024, 128)
    assert small.items == 1 and small.grid == small.tiles == 128


def test_gather_row_division_by_magic_numbers():
    """probe_dma.cu's make_div and fast_div (Granlund and Montgomery's
    round-up method), mirrored: n // K for K from 1 to 1100 and a few
    large ones, and n across the 32 bits."""
    src = (CSRC / "probe_dma.cu").read_text()
    assert "(((1ull << l) - d) << 32) / d + 1;" in src
    assert "return (t + ((n - t) >> d.sh1)) >> d.sh2;" in src
    rng = np.random.default_rng(5)
    n = np.concatenate([np.arange(70_000), rng.integers(0, 2**32, 200_000),
                        2**32 - 1 - np.arange(100)]).astype(np.uint64)
    for d in [*range(1, 1101), 4095, 4096, 4097, 65535, 2**31 - 1, 2**31,
              2**32 - 1]:
        lg = (d - 1).bit_length()  # ceil(log2 d)
        m = (((1 << lg) - d) << 32) // d + 1
        assert m < 2**32
        t = (np.uint64(m) * n) >> np.uint64(32)
        q = (t + ((n - t) >> np.uint64(min(lg, 1)))) >> np.uint64(
            max(lg - 1, 0))
        assert (q == n // np.uint64(d)).all(), d
