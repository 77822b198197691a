"""PyTorch port, the synthetic radar frames against ``repro.sensing.synthetic``.

The port draws from a ``torch.Generator``, the reference from
``jax.random``: their random numbers differ, so the draws are held by their
shapes, ranges and statistics, and the deterministic parts (``_blob``,
``drift_schedule``, ``_paint_tracks`` given the same events and background)
against the reference on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sensing import synthetic as jsyn
from repro_torch.sensing import synthetic as tsyn

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

SMALL = dict(height=32, width=32)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def run_lengths(labels):
    """``(start, length)`` of each run of 1s."""
    runs, i = [], 0
    labels = list(np.asarray(labels))
    while i < len(labels):
        if labels[i]:
            j = i
            while j < len(labels) and labels[j]:
                j += 1
            runs.append((i, j - i))
            i = j
        else:
            i += 1
    return runs


# ---------------------------------------------------------------------------
# deterministic parts, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (128, 128), (24, 40)])
def test_blob_matches_reference(hw):
    cfg_j = jsyn.RadarConfig(height=hw[0], width=hw[1])
    cfg_t = tsyn.RadarConfig(height=hw[0], width=hw[1])
    rng = np.random.default_rng(1)
    for _ in range(4):
        cy, cx = rng.uniform(0, hw[0]), rng.uniform(0, hw[1])
        sy, sx = rng.uniform(2, 6, 2)
        amp = rng.uniform(0.45, 1.0)
        args = [np.float32(v) for v in (cy, cx, sy, sx, amp)]
        want = np.asarray(jsyn._blob(cfg_j, *map(jnp.float32, args)))
        got = tsyn._blob(cfg_t, *(torch.tensor(v) for v in args))
        assert got.shape == hw and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a batch of blobs is each blob alone
    batch = tsyn._blob(cfg_t, *(torch.tensor([v, v]) for v in args))
    assert batch.shape == (2, *hw)
    assert torch.equal(batch[1], got)


@pytest.mark.parametrize("n,span", [(1, (0.0, 0.5)), (160, (0.12, 0.25)),
                                    (7, (0.8, 0.45)), (33, (0.3, 0.3))])
def test_drift_schedule_exact(n, span):
    got = tsyn.drift_schedule(n, span)
    want = jsyn.drift_schedule(n, span)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_paint_tracks_matches_reference():
    cfg_j, cfg_t = jsyn.RadarConfig(**SMALL), tsyn.RadarConfig(**SMALL)
    n = 30
    rng = np.random.default_rng(2)
    bg = rng.uniform(0.0, 0.4, (n, 32, 32)).astype(np.float32)
    amps = rng.uniform(0.4, 0.9, n).astype(np.float32)
    # (start, len, cy, cx, vy, vx): tracks that run into the clip margins,
    # one of a single frame, one that ends the stream
    events = [(0, 5, 10.3, 20.7, 2.9, -2.5), (8, 1, 16.0, 16.0, 0.0, 0.0),
              (12, 10, 25.1, 6.2, 1.7, -0.4), (26, 4, 7.5, 29.9, -2.2, 2.8)]
    before = bg.copy()
    want = jsyn._paint_tracks(bg.copy(), events, cfg_j, amps)
    got = tsyn._paint_tracks(torch.from_numpy(bg), events, cfg_t, amps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # frames without an event are untouched, and the input is not changed
    assert torch.equal(got[5:8], torch.from_numpy(before[5:8]))
    np.testing.assert_array_equal(bg, before)
    assert torch.equal(tsyn._paint_tracks(torch.from_numpy(bg), [], cfg_t,
                                          amps), torch.from_numpy(before))


def test_configs_match_reference():
    for cls in ("RadarConfig", "DriftConfig"):
        assert (vars(getattr(jsyn, cls)()) == vars(getattr(tsyn, cls)()))


# ---------------------------------------------------------------------------
# the generators: shapes, ranges, statistics
# ---------------------------------------------------------------------------

def test_render_frame():
    cfg = tsyn.RadarConfig(**SMALL)
    frame, mask = tsyn.render_frame(gen(0), cfg, True, device="cpu")
    assert frame.shape == mask.shape == (32, 32)
    assert frame.dtype == mask.dtype == torch.float32
    assert 0.0 <= float(frame.min()) and float(frame.max()) <= 1.5
    assert float(mask.sum()) > 0 and set(mask.unique().tolist()) <= {0., 1.}
    empty, no_mask = tsyn.render_frame(gen(0), cfg, False, device="cpu")
    assert float(no_mask.sum()) == 0
    # objects raise the frame where the mask is
    assert float(frame[mask > 0].mean()) > float(empty.mean()) + 0.2


@pytest.mark.parametrize("n,p", [(60, 0.5), (31, 0.3), (12, 1.0)])
def test_make_dataset(n, p):
    cfg = tsyn.RadarConfig(**SMALL)
    frames, masks, labels = tsyn.make_dataset(gen(4), n, cfg, p,
                                              device="cpu")
    assert frames.shape == masks.shape == (n, 32, 32)
    assert frames.dtype == torch.float32 and labels.dtype == torch.int32
    assert 0.0 <= float(frames.min()) and float(frames.max()) <= 1.5
    # exactly int(n * p) positives, in random order
    assert int(labels.sum()) == int(n * p)
    # masks exactly on the positive frames
    has = (masks.reshape(n, -1).sum(-1) > 0).to(torch.int32)
    assert torch.equal(has, labels)
    if 0 < p < 1:
        assert not torch.equal(labels, labels.sort(descending=True).values)
        # positives are brighter at their masks than negatives on average
        pos = frames[labels == 1][masks[labels == 1] > 0].mean()
        assert float(pos) > float(frames[labels == 0].mean()) + 0.2


def test_make_dataset_statistics_match_reference():
    """Background and object statistics of the two packages agree (their
    random numbers differ)."""
    n = 200
    jf, jm, jl = jsyn.make_dataset(jax.random.PRNGKey(0), n,
                                   jsyn.RadarConfig(**SMALL))
    tf, tm, tl = tsyn.make_dataset(gen(0), n, tsyn.RadarConfig(**SMALL),
                                   device="cpu")
    jf, jm, jl = np.asarray(jf), np.asarray(jm), np.asarray(jl)
    tf, tm, tl = tf.numpy(), tm.numpy(), tl.numpy()
    for a, b, tol in ((jf[jl == 0].mean(), tf[tl == 0].mean(), 0.01),
                      (jf[jl == 0].std(), tf[tl == 0].std(), 0.01),
                      (jf[jl == 1].mean(), tf[tl == 1].mean(), 0.02),
                      (jm[jl == 1].mean(), tm[tl == 1].mean(), 0.02)):
        assert abs(a - b) < tol, (a, b)


@pytest.mark.parametrize("event_len", [10, 5])
def test_make_stream(event_len):
    cfg = tsyn.RadarConfig(**SMALL)
    frames, labels = tsyn.make_stream(gen(5), 300, cfg, event_prob=0.08,
                                      event_len=event_len, device="cpu")
    assert frames.shape == (300, 32, 32) and frames.dtype == torch.float32
    assert labels.shape == (300,) and labels.dtype == torch.int32
    assert 0.0 <= float(frames.min()) and float(frames.max()) <= 1.5
    runs = run_lengths(labels.numpy())
    assert len(runs) >= 3
    # bursts of event_len frames (back-to-back bursts merge; the last may
    # be cut by the end of the stream)
    for start, length in runs:
        assert length % event_len == 0 or start + length == 300
    # the event frames carry the tracked blob
    assert float(frames[labels == 1].amax((1, 2)).mean()) > \
        float(frames[labels == 0].amax((1, 2)).mean()) + 0.2


def test_make_stream_statistics_match_reference():
    cfg_j, cfg_t = jsyn.RadarConfig(**SMALL), tsyn.RadarConfig(**SMALL)
    jf, jl = jsyn.make_stream(jax.random.PRNGKey(1), 400, cfg_j,
                              event_prob=0.08, event_len=10)
    tf, tl = tsyn.make_stream(gen(1), 400, cfg_t, event_prob=0.08,
                              event_len=10, device="cpu")
    jf, jl, tf, tl = (np.asarray(a) for a in (jf, jl, tf.numpy(),
                                              tl.numpy()))
    assert abs(jf[jl == 0].mean() - tf[tl == 0].mean()) < 0.01
    assert abs(jf[jl == 1].max((1, 2)).mean()
               - tf[tl == 1].max((1, 2)).mean()) < 0.1
    # the event share: a burst every ~(1/p + len) frames
    assert 0.2 < tl.mean() < 0.7 and 0.2 < jl.mean() < 0.7


def test_make_drift_stream_direction():
    cfg = tsyn.RadarConfig(**SMALL)
    drift = tsyn.DriftConfig(background_gain=(0.0, 0.5),
                             noise_sigma=(0.12, 0.25),
                             object_intensity=(0.8, 0.45))
    frames, labels = tsyn.make_drift_stream(gen(6), 160, cfg, drift,
                                            event_prob=0.08, event_len=10,
                                            device="cpu")
    assert frames.shape == (160, 32, 32) and labels.dtype == torch.int32
    assert 0.0 <= float(frames.min()) and float(frames.max()) <= 1.5
    bg = frames[labels == 0]
    half = len(bg) // 2
    # the background gain and the speckle scale ramp up
    assert float(bg[half:].mean()) > float(bg[:half].mean()) + 0.15
    assert float(bg[half:].std((1, 2)).mean()) > \
        float(bg[:half].std((1, 2)).mean())
    # the object stands out less at the end than at the start
    contrast = frames.amax((1, 2)) - frames.mean((1, 2))
    ev = np.flatnonzero(labels.numpy())
    early, late = ev[: len(ev) // 2], ev[len(ev) // 2:]
    assert float(contrast[early].mean()) > float(contrast[late].mean())


def test_default_drift_is_make_stream():
    """The reference's promise: a default DriftConfig reproduces
    make_stream's statistics. In the port, from the same generator state and
    with the same track margins (frames of at least 48x48), bit for bit."""
    cfg = tsyn.RadarConfig(height=64, width=64)
    a = tsyn.make_stream(gen(7), 120, cfg, event_prob=0.1, event_len=6,
                         device="cpu")
    b = tsyn.make_drift_stream(gen(7), 120, cfg, None, event_prob=0.1,
                               event_len=6, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # small frames: the drift stream's margins shrink; the statistics stay
    small = tsyn.RadarConfig(**SMALL)
    a = tsyn.make_stream(gen(8), 400, small, event_prob=0.08, event_len=10,
                         device="cpu")
    b = tsyn.make_drift_stream(gen(8), 400, small, tsyn.DriftConfig(),
                               event_prob=0.08, event_len=10, device="cpu")
    assert torch.equal(a[1], b[1])
    assert abs(float(a[0][a[1] == 0].mean())
               - float(b[0][b[1] == 0].mean())) < 0.005


# ---------------------------------------------------------------------------
# generators and devices
# ---------------------------------------------------------------------------

GENERATORS = {
    "dataset": lambda g, **kw: tsyn.make_dataset(
        g, 20, tsyn.RadarConfig(**SMALL), **kw),
    "stream": lambda g, **kw: tsyn.make_stream(
        g, 40, tsyn.RadarConfig(**SMALL), 0.1, 5, **kw),
    "drift": lambda g, **kw: tsyn.make_drift_stream(
        g, 40, tsyn.RadarConfig(**SMALL),
        tsyn.DriftConfig(background_gain=(0.0, 0.3)), 0.1, 5, **kw),
    "frame": lambda g, **kw: tsyn.render_frame(
        g, tsyn.RadarConfig(**SMALL), True, **kw),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_bitwise_from_one_seed_and_different_for_another(name):
    make = GENERATORS[name]
    a = make(gen(11), device="cpu")
    b = make(gen(11), device="cpu")
    c = make(gen(12), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("name", list(GENERATORS))
def test_device_argument(name):
    out = GENERATORS[name](gen(13), device="cpu")
    assert all(x.device == torch.device("cpu") for x in out)
    if not torch.cuda.is_available():
        # None means the card, and there is none: no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            GENERATORS[name](gen(13))
        with pytest.raises(RuntimeError, match="CUDA"):
            GENERATORS[name](gen(13), device=None)
