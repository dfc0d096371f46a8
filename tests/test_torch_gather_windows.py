"""The port's gather_windows (its plain version on the CPU) against the
JAX package's Pallas kernel, run in interpret mode as
tests/test_pallas_gather.py runs it, and the window-scoring bench's
parity at a tiny size."""

import numpy as np
import pytest
import torch

# slab lengths no other test traces, so no cached non-interpret trace of
# the jitted JAX function is reused
P = 3 * 4096 + 1024


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


@pytest.mark.parametrize("ns", [8, 32])
@pytest.mark.parametrize("w", [1024, 2048])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_gather_windows_matches_pallas_interpret(interpret, dtype, w, ns):
    import jax

    from oramacore_tpu.ops import pallas_gather
    from oramacore_tpu_torch.ops import gather_windows as gw

    rng = np.random.default_rng(ns + w)
    if dtype == "int32":
        src = rng.integers(-1000, 1000, P + w).astype(np.int32)
    else:
        src = rng.uniform(-5, 5, P + w).astype(np.float32)
    starts = (rng.integers(0, P // 1024, ns) * 1024).astype(np.int32)
    exp = pallas_gather.gather_windows(
        jax.numpy.asarray(src), jax.numpy.asarray(starts), w=w,
        rows_per_program=8,
    )
    got = gw.gather_windows(torch.from_numpy(src), torch.from_numpy(starts),
                            w=w)
    assert got.dtype == torch.from_numpy(src).dtype
    assert tuple(got.shape) == (ns, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert gw.LAUNCHES == {"gather_windows": 0}  # the plain version ran


def test_align_down_is_the_jax_packages():
    from oramacore_tpu.ops import pallas_gather
    from oramacore_tpu_torch.ops import gather_windows as gw

    assert gw.ALIGN == pallas_gather.ALIGN
    for s in (0, 1, 1023, 1024, 5000, 1 << 30):
        assert gw.align_down(s) == pallas_gather.align_down(s)


def test_window_past_the_slab_end_reads_zero():
    from oramacore_tpu_torch.ops.gather_windows import gather_windows

    src = torch.arange(1, 1501, dtype=torch.int32)
    out = gather_windows(src, torch.tensor([1024, 0], dtype=torch.int32),
                         w=1024)
    assert out[0, :476].tolist() == list(range(1025, 1501))
    assert not out[0, 476:].any()
    assert out[1].tolist() == list(range(1, 1025))
    f = gather_windows(src.float(), torch.tensor([-1024], dtype=torch.int32),
                       w=2048)
    assert not f[0, :1024].any() and f[0, 1024:].tolist() == list(
        map(float, range(1, 1025)))


def test_gather_windows_checks_its_inputs():
    from oramacore_tpu_torch.ops.gather_windows import LAUNCHES, gather_windows

    starts = torch.zeros(2, dtype=torch.int32)
    src = torch.zeros(4096, dtype=torch.int32)
    for w in (0, 512, 1536, -1024):
        with pytest.raises(ValueError):
            gather_windows(src, starts, w=w)
    with pytest.raises(TypeError):
        gather_windows(src.to(torch.int64), starts, w=1024)
    with pytest.raises(TypeError):
        gather_windows(src, starts.to(torch.int64), w=1024)
    with pytest.raises(ValueError):  # not 1-D
        gather_windows(src.view(2, 2048), starts, w=1024)
    assert LAUNCHES == {"gather_windows": 0}


def test_pallas_bench_parity_at_a_tiny_size():
    from oramacore_tpu_torch.benches import pallas_bench
    from oramacore_tpu_torch.ops import gather_windows as gw
    from oramacore_tpu_torch.ops import score_windows as sw

    d = pallas_bench.make_data(16, 1024, 1 << 14, "cpu")
    assert d.p_doc.shape[0] == (1 << 14) + 1024
    assert (d.starts % 1024 == 0).all() and (d.starts < 1 << 14).all()
    outs = pallas_bench.run_arms(d)
    assert set(outs) == set(pallas_bench.ARMS)
    err = pallas_bench.check_parity(outs)
    assert 0.0 <= err <= 1e-6
    assert outs["pallas-gather"].shape == (16, 1024)
    # the plain versions ran: no kernel launch was counted
    assert gw.LAUNCHES["gather_windows"] == sw.LAUNCHES["score_windows"] == 0
    # a broken arm fails the parity
    outs["pallas-gather"] = outs["pallas-gather"].clone()
    outs["pallas-gather"][3, 7] += 1
    with pytest.raises(AssertionError):
        pallas_bench.check_parity(outs)


def test_pallas_bench_data_is_the_jax_benchs():
    """The seeded slab, starts and params follow benches/pallas_bench.py's
    draw order."""
    from oramacore_tpu_torch.benches import pallas_bench

    ns, w, p = 8, 1024, 1 << 13
    d = pallas_bench.make_data(ns, w, p, "cpu")
    rng = np.random.default_rng(0)
    p_doc = rng.integers(0, 1 << 20, p + w).astype(np.int32)
    p_tf = rng.integers(0, 4, p + w).astype(np.float32)
    p_flen = rng.uniform(1, 50, p + w).astype(np.float32)
    starts = (rng.integers(0, p // 1024, ns) * 1024).astype(np.int32)
    b = rng.uniform(0.3, 0.9, ns)
    avg = rng.uniform(5, 40, ns)
    params = np.stack([rng.uniform(0.5, 2.0, ns), 1.0 - b, b / avg,
                       np.zeros(ns)], axis=1).astype(np.float32)
    for got, exp in zip(d[:5], (p_doc, p_tf, p_flen, starts, params)):
        np.testing.assert_array_equal(got.numpy(), exp)
