"""PyTorch port, the stream gate (``core/gate.py``) and the paper's config
(``configs/hypersense.py``) against the JAX package.

The same numpy frames and model go through ``repro.core.gate`` (per-frame
jitted ``detect``) and the port's gate (one ``detect_batch`` a call, then
the controller in stream order): kept indices, stats and the backend
account must be equal exactly, on frames whose deciding scores all sit more
than ``DECISION_MARGIN`` from ``t_score``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_margin, frames, models, pick_threshold, t
from repro.configs import PAPER_CONFIG_ID as J_PAPER_ID
from repro.configs import hypersense as jcfg
from repro.core import gate as jgate
from repro.core import hypersense as jhs
from repro.core.sensor_control import ControllerConfig as JController
from repro_torch.configs import PAPER_CONFIG_ID as T_PAPER_ID
from repro_torch.configs import hypersense as tcfg
from repro_torch.core import gate as tgate
from repro_torch.core import hypersense as ths
from repro_torch.core.sensor_control import ControllerConfig as TController

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

D = 256


def gated_models(seed: int, t_detection: int, fr):
    """Both packages' model at a ``t_score`` every frame keeps the margin
    from."""
    jm, tm = models(seed, D, t_detection=t_detection)
    scores = ths.frame_scores_batch(tm, t(fr)).numpy()
    t_score = pick_threshold(scores)
    assert_margin(scores, t_score)
    assert_margin(np.asarray(jhs.frame_scores_batch(jm, jnp.asarray(fr))),
                  t_score)
    return (jm._replace(t_score=t_score),
            dataclasses.replace(tm, t_score=t_score))


@pytest.mark.parametrize("hold,t_detection", [(0, 0), (3, 1), (1, 0)])
def test_select_matches_reference(hold, t_detection):
    fr, _ = frames(31, 40)
    jm, tm = gated_models(32, t_detection, fr)
    jg = jgate.HyperSenseGate(jm, JController(hold_frames=hold))
    tg = tgate.HyperSenseGate(tm, TController(hold_frames=hold))
    # two calls: the controller's hold carries across them
    for part in (fr[:23], fr[23:]):
        want = jg.select(part)
        got = tg.select(part)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert (tg.stats.n_seen, tg.stats.n_passed) == (jg.stats.n_seen,
                                                    jg.stats.n_passed)
    assert tg.stats.duty_cycle == jg.stats.duty_cycle
    assert 0 < tg.stats.n_passed < tg.stats.n_seen
    # the decisions before the controller are the reference's detect
    fired = tg.decide(fr)
    want = np.array([bool(jhs.detect(jm, jnp.asarray(f))) for f in fr])
    np.testing.assert_array_equal(fired, want)


def test_filter_matches_reference():
    fr, _ = frames(33, 30)
    jm, tm = gated_models(34, 0, fr)
    hp = np.random.default_rng(35).standard_normal((30, 4)).astype(
        np.float32)
    jg = jgate.HyperSenseGate(jm, JController(hold_frames=2))
    tg = tgate.HyperSenseGate(tm, TController(hold_frames=2))
    jk, ji = jg.filter(fr, payloads=hp)
    tk, ti = tg.filter(fr, payloads=hp)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tk, jk)
    # frames themselves by default; a tensor stays a tensor
    tg2 = tgate.HyperSenseGate(tm, TController(hold_frames=2))
    kept, idx = tg2.filter(t(fr))
    assert isinstance(kept, torch.Tensor)
    np.testing.assert_array_equal(idx, ji)
    assert torch.equal(kept, t(fr)[torch.from_numpy(ji)])
    jg2 = jgate.HyperSenseGate(jm, JController(hold_frames=2))
    np.testing.assert_array_equal(jg2.filter(fr)[0], fr[ji])


def test_backend_flops_saved_matches_reference():
    for seen, passed in ((0, 0), (256, 97), (10, 10)):
        js = jgate.GateStats(n_seen=seen, n_passed=passed)
        ts = tgate.GateStats(n_seen=seen, n_passed=passed)
        assert ts.duty_cycle == js.duty_cycle
        for flops in (1e12, 499_662_192_640.0):
            assert (tgate.backend_flops_saved(ts, flops)
                    == jgate.backend_flops_saved(js, flops))


def test_gate_on_an_idle_stream_passes_nothing():
    fr, _ = frames(36, 12)
    _, tm = models(37, D, t_detection=0)
    tm = dataclasses.replace(tm, t_score=2.0)   # above every cosine score
    tg = tgate.HyperSenseGate(tm, TController(hold_frames=3))
    assert tg.select(fr).shape == (0,)
    acct = tgate.backend_flops_saved(tg.stats, 1e12)
    assert acct["duty_cycle"] == 0.0 and acct["backend_saving"] == 1.0


# ---------------------------------------------------------------------------
# configs/hypersense.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
def test_paper_config_matches_reference(which):
    got = getattr(tcfg, which)()
    want = getattr(jcfg, which)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.dim = 1


def test_paper_config_id_and_operating_point():
    assert T_PAPER_ID == J_PAPER_ID == "hypersense"
    c = tcfg.config()
    assert (c.frame_h, c.frame_w, c.fragment, c.stride, c.dim) == (
        128, 128, 96, 8, 5000)
    assert (c.adc_low_bits, c.adc_high_bits, c.base_kind,
            c.nonlinearity) == (4, 12, "perm", "rff")
