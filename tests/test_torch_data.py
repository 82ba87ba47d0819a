"""The port's remaining data modules against the JAX package's.

* ``data/filter.py``: ``class_filter_mask`` (enable on and off, with a
  base validity mask) and ``limit_mask`` equal the reference's
  (tests/test_data.py's cases, and seeded label vectors);
* ``data/memory.py``: ``ROMSource`` reads cyclically as the reference's
  does, and ``StreamSource`` wraps an iterator;
* ``OnlineSession.fill_from``: tests/test_serving.py's
  ``test_tm_online_session_buffers_and_learns`` flow on both packages --
  fill from a ROM source, backpressure, drain, four passes -- with equal
  banks, counts and predictions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_runtime as j_init_runtime
from repro.core import init_state as j_init_state
from repro.core.online import OnlineSession as JSession
from repro.data import filter as j_filt
from repro.data import iris
from repro.data import memory as j_mem
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import init_state as t_init_state
from repro_torch.core.online import OnlineSession as TSession
from repro_torch.data import filter as t_filt
from repro_torch.data import memory as t_mem


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_class_filter_mask():
    ys = [0, 1, 2, 1, 0]
    m = t_filt.class_filter_mask(torch.tensor(ys), 1, True)
    assert m.tolist() == [True, False, True, False, True]
    m_off = t_filt.class_filter_mask(torch.tensor(ys), torch.tensor(1),
                                     torch.tensor(False))
    assert bool(m_off.all())
    m_list = t_filt.class_filter_mask(ys, 1, True, device="cpu")
    assert m_list.device.type == "cpu" and m_list.tolist() == m.tolist()


def test_filter_masks_run_on_the_card_unless_told():
    """A host ``ys`` or an int ``limit`` with no device named resolves to
    the card, as every entry point does: on a card the masks land there,
    without one the call raises rather than fall back to the CPU."""
    calls = (lambda: t_filt.limit_mask(30, 20),
             lambda: t_filt.class_filter_mask([0, 1, 2], 1, True))
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA device"):
                call()


@pytest.mark.parametrize("seed", range(3))
def test_class_filter_mask_matches_reference(seed):
    r = np.random.default_rng(seed)
    ys = r.integers(0, 4, 40).astype(np.int32)
    base = r.random(40) > 0.3
    for cls in range(4):
        for enabled in (True, False):
            for b in (None, base):
                want = j_filt.class_filter_mask(
                    jnp.asarray(ys), jnp.int32(cls), jnp.bool_(enabled),
                    None if b is None else jnp.asarray(b))
                got = t_filt.class_filter_mask(
                    torch.from_numpy(ys), cls, enabled,
                    None if b is None else torch.from_numpy(b))
                assert got.dtype == torch.bool
                assert np.array_equal(np.asarray(want), got.numpy())


def test_limit_mask():
    m = t_filt.limit_mask(30, torch.tensor(20, dtype=torch.int32))
    assert int(m.sum()) == 20 and bool(m[19]) and not bool(m[20])
    for n, limit in ((30, 0), (30, 30), (30, 45), (7, 3)):
        assert np.array_equal(t_filt.limit_mask(n, limit, "cpu").numpy(),
                              np.asarray(j_filt.limit_mask(n, limit)))


def test_rom_and_stream_sources_match_reference():
    xs, ys = iris.load()
    rom_j, rom_t = j_mem.ROMSource(xs[:7], ys[:7]), t_mem.ROMSource(xs[:7],
                                                                   ys[:7])
    assert rom_t.n_features == rom_j.n_features == xs.shape[1]
    for _ in range(20):                       # wraps around twice
        (xj, yj), (xt, yt) = rom_j.next_row(), rom_t.next_row()
        assert np.array_equal(xj, xt) and yj == yt and type(yt) is int
    stream = t_mem.StreamSource(iter(zip(xs[:3], ys[:3])), xs.shape[1])
    assert [int(stream.next_row()[1]) for _ in range(3)] == ys[:3].tolist()
    with pytest.raises(StopIteration):
        stream.next_row()


def test_online_session_fill_from_matches_reference():
    """tests/test_serving.py's buffered-learning flow on both packages."""
    xs, ys = iris.load()
    kw = dict(n_features=16, max_classes=3, max_clauses=16, n_states=16)
    jc, tc = JTMConfig(**kw), TTMConfig(**kw)
    js = JSession(jc, j_init_state(jc), j_init_runtime(jc, s=3.0, T=15),
                  buffer_capacity=32)
    ts = TSession(tc, t_init_state(tc, device="cpu"),
                  t_init_runtime(tc, s=3.0, T=15, device="cpu"),
                  buffer_capacity=32, device="cpu")
    src_j, src_t = j_mem.ROMSource(xs, ys), t_mem.ROMSource(xs, ys)
    assert ts.fill_from(src_t, 32) == js.fill_from(src_j, 32) == 32
    assert ts.buffered == 32
    assert not ts.offer(xs[0], int(ys[0]))    # full -> backpressure
    assert not js.offer(xs[0], int(ys[0]))
    assert ts.learn_available(100) == js.learn_available(100) == 32
    assert ts.buffered == 0
    for _ in range(4):
        assert ts.fill_from(src_t, 32) == js.fill_from(src_j, 32)
        assert ts.learn_available(32) == js.learn_available(32)
    assert np.array_equal(ts.ss.tm.ta_state.numpy(),
                          np.asarray(js.ss.tm.ta_state))
    preds = ts.infer(xs)
    assert np.array_equal(preds, js.infer(xs))
    assert float(np.mean(preds == ys)) > 0.5
