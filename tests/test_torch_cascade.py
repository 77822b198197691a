"""PyTorch port, the gated cascade: ``repro_torch.launch.steps``'s detector
cell and ``repro_torch.launch.cascade.CascadeService`` against
``repro.launch.steps`` and ``repro.launch.cascade`` on the CPU, at smoke
widths (``get_smoke("hubert-xlarge")``), 16x16 frames, patch 8, batch 4,
with the reference's ``init_detector_params`` carried across by
``detector_params_from_arrays``.

Tolerances: float32 logits within ``F32_RTOL`` of the largest |logit| of
the reference (the two packages sum in another order), bf16 within
``BF16_NET_RTOL`` (bf16 products rounded in another order feed the
attention's near-one-hot softmax). Within the port: batched logits equal
``eager`` bitwise, and ``rebuild_count()`` stays 1 across ragged drains.
``backbone_cost`` equals the hand count of the step's products at every
depth and batch tested (the reference's XLA count charges a loop body
once; ``ROADMAP.md`` §3)."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import models
from repro import configs as jconfigs
from repro.launch import cascade as jcascade
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.convert import detector_params_from_arrays
from repro_torch.core import energy
from repro_torch.core.sensor_control import CaptureConfig, ControllerConfig
from repro_torch.launch import steps
from repro_torch.launch.cascade import CascadeService
from repro_torch.launch.serve import FleetService
from repro_torch.sensing.fleet import FleetRunner
from repro_torch.sensing.stream import StreamRunner

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

HW, PATCH, BATCH = (16, 16), 8, 4
F32_RTOL = 1e-5
BF16_NET_RTOL = 5e-2
ARCH = "hubert-xlarge"


def frames_of(n, seed, hw=HW):
    return np.random.default_rng(seed).normal(size=(n, *hw)).astype(
        np.float32)


def assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale, rtol)


@pytest.fixture(scope="module")
def ref_params():
    return jsteps.init_detector_params(
        jax.random.PRNGKey(7), jconfigs.get_smoke(ARCH), frame_hw=HW,
        patch=PATCH)


def port_params(ref, device="cpu"):
    return detector_params_from_arrays(jax.tree.map(np.asarray, ref),
                                       device=device)


def cascade(ref, cfg=None, **kw):
    kw = dict(dict(batch_size=BATCH, frame_hw=HW, patch=PATCH,
                   device="cpu"), **kw)
    return CascadeService(port_params(ref), cfg or configs.get_smoke(ARCH),
                          **kw)


# ---------------------------------------------------------------------------
# the detector cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_step_matches_the_reference(ref_params, dtype):
    jcfg = jconfigs.get_smoke(ARCH).replace(compute_dtype=dtype)
    cfg = configs.get_smoke(ARCH).replace(compute_dtype=dtype)
    fr = frames_of(BATCH, 1)
    jcell = jsteps.build_detector_cell(jcfg, batch=BATCH, frame_hw=HW,
                                       patch=PATCH)
    want = np.asarray(jax.jit(jcell.step_fn)(ref_params, fr))
    cell = steps.build_detector_cell(cfg, batch=BATCH, frame_hw=HW,
                                     patch=PATCH)
    got = cell.step_fn(cell.prepare(port_params(ref_params)),
                       torch.from_numpy(fr))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 2)
    assert_close(got.numpy(), want,
                 F32_RTOL if dtype == "float32" else BF16_NET_RTOL)


def test_detector_step_is_batch_position_invariant(ref_params):
    """The reference's ``lax.map`` contract: a row's logits do not depend
    on its position or its neighbours, bitwise."""
    cell = steps.build_detector_cell(configs.get_smoke(ARCH), batch=3,
                                     frame_hw=HW, patch=PATCH)
    w = cell.prepare(port_params(ref_params))
    batch = torch.from_numpy(frames_of(3, 5))
    out = cell.step_fn(w, batch)
    perm = [2, 0, 1]
    assert torch.equal(cell.step_fn(w, batch[perm]), out[perm])
    alone = torch.stack([batch[1], torch.zeros(HW), torch.zeros(HW)])
    assert torch.equal(cell.step_fn(w, alone)[0], out[1])


def test_prepare_casts_once_to_the_compute_dtype(ref_params):
    cfg = configs.get_smoke(ARCH).replace(compute_dtype="bfloat16")
    cell = steps.build_detector_cell(cfg, batch=1, frame_hw=HW, patch=PATCH)
    params = port_params(ref_params)
    w = cell.prepare(params)
    wq = params["backbone"]["layers"]["attn"]["wq"]
    assert w["backbone"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(w["backbone"]["layers"]["attn"]["wq"],
                       wq.to(torch.bfloat16))
    assert w["embedder"]["proj"].dtype == torch.float32


def test_init_detector_params_matches_the_reference_tree(ref_params):
    got = steps.init_detector_params(torch.Generator().manual_seed(0),
                                     configs.get_smoke(ARCH), frame_hw=HW,
                                     patch=PATCH)
    want = jax.tree.map(np.asarray, ref_params)
    got_shapes = jax.tree.map(lambda a: tuple(a.shape), got)
    assert got_shapes == jax.tree.map(lambda a: a.shape, want)
    assert float(got["embedder"]["proj"].std()) == pytest.approx(
        1.0 / PATCH, rel=0.2)


def test_detector_seq_len():
    assert steps.detector_seq_len((128, 128), 8) == 256 == \
        jsteps.detector_seq_len((128, 128), 8)
    for bad in ((15, 16), (16, 12)):
        with pytest.raises(ValueError, match="divide"):
            steps.detector_seq_len(bad, 8)


@pytest.mark.parametrize("case", ["patch", "n_out", "batch", "embeds_in"])
def test_build_detector_cell_validates(case):
    cfg = configs.get_smoke(ARCH)
    kw = dict(batch=2, frame_hw=HW, patch=PATCH)
    match = {"patch": "divide", "n_out": "n_out", "batch": "batch",
             "embeds_in": "embeds-in"}[case]
    if case == "patch":
        kw["frame_hw"] = (15, 16)
    elif case == "n_out":
        kw["n_out"] = cfg.vocab + 1
    elif case == "batch":
        kw["batch"] = 0
    else:
        cfg = cfg.replace(embeds_in=False)
    with pytest.raises(ValueError, match=match):
        steps.build_detector_cell(cfg, **kw)


# ---------------------------------------------------------------------------
# CascadeService against the reference's
# ---------------------------------------------------------------------------

RAGGED = [("a", np.arange(2)), ("a", np.arange(0)), ("b", np.arange(3)),
          ("a", 2 + np.arange(4))]


def feed(casc, frames):
    lo = 0
    for sid, idx in RAGGED:
        casc.submit(sid, idx, frames[lo:lo + len(idx)])
        lo += len(idx)
    return casc.flush()


def test_cascade_matches_the_reference_on_ragged_drains(ref_params):
    frames = frames_of(9, 6)
    want = feed(jcascade.CascadeService(ref_params, jconfigs.get_smoke(ARCH),
                                        batch_size=BATCH, frame_hw=HW),
                frames)
    casc = cascade(ref_params)
    got = feed(casc, frames)
    assert casc.queued == 0
    assert [b.seq for b in got] == [b.seq for b in want]
    for g, w in zip(got, want):
        assert g.sids == w.sids
        np.testing.assert_array_equal(g.frame_idx, w.frame_idx)
        assert g.n_padded == w.n_padded
        assert_close(g.logits, w.logits, F32_RTOL)
    assert sum(b.n_padded for b in got) == 3
    assert (casc.frames_in, casc.frames_padded, casc.batches) == (9, 3, 3)


def test_cascade_batched_equals_eager_bitwise(ref_params):
    casc = cascade(ref_params)
    frames = frames_of(9, 6)
    served = np.concatenate([b.logits for b in feed(casc, frames)])
    assert served.shape == (9, casc.n_out)
    np.testing.assert_array_equal(served, casc.eager(frames))
    assert casc.rebuild_count() == 1
    # more ragged drains, and eager in between: nothing rebuilt
    casc.submit("c", [7], frames[:1])
    casc.eager(frames[:2])
    casc.submit("c", [8, 9, 10, 11], frames[1:5])
    got = casc.flush()
    assert [b.n_padded for b in got] == [0, 3]
    np.testing.assert_array_equal(
        np.concatenate([b.logits for b in got]), casc.eager(frames[:5]))
    assert casc.rebuild_count() == 1


@pytest.mark.parametrize("max_inflight", [1, 2, 3])
def test_cascade_collect_is_fifo_and_depth_invariant(ref_params,
                                                     max_inflight):
    casc = cascade(ref_params, max_inflight=max_inflight)
    frames = frames_of(4 * BATCH + 1, 9)
    casc.submit(0, np.arange(len(frames)), frames)
    first = casc.collect()
    rest = casc.flush()
    assert [b.seq for b in [first] + rest] == list(range(5))
    assert casc.collect() is None
    got = np.concatenate([b.logits for b in [first] + rest])
    np.testing.assert_array_equal(got, casc.eager(frames))


def test_cascade_rejects_mismatched_frames(ref_params):
    casc = cascade(ref_params, batch_size=2)
    with pytest.raises(ValueError, match="cascade"):
        casc.submit(0, [0], np.zeros((1, 8, 8), np.float32))
    with pytest.raises(ValueError, match="disagree"):
        casc.submit(0, [0, 1], np.zeros((1, *HW), np.float32))
    with pytest.raises(ValueError, match="max_inflight"):
        cascade(ref_params, max_inflight=0)


def test_cascade_takes_tensor_drains(ref_params):
    casc = cascade(ref_params)
    frames = frames_of(5, 3)
    casc.submit(0, torch.arange(5), torch.from_numpy(frames))
    got = np.concatenate([b.logits for b in casc.flush()])
    np.testing.assert_array_equal(got, casc.eager(frames))


def test_cascade_defaults_to_the_card(ref_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken there")
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeService(port_params(ref_params), configs.get_smoke(ARCH),
                       batch_size=BATCH, frame_hw=HW)
    with pytest.raises(RuntimeError, match="CUDA"):
        detector_params_from_arrays(jax.tree.map(np.asarray, ref_params))


def test_detector_params_from_arrays_checks_the_tree(ref_params):
    tree = port_params(ref_params)
    assert tree["backbone"]["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    with pytest.raises(ValueError, match="backbone"):
        detector_params_from_arrays({"embedder": {}}, device="cpu")


# ---------------------------------------------------------------------------
# pump: the port's gate runners feed the cascade
# ---------------------------------------------------------------------------

C = 4
GATE_CFG = ControllerConfig(hold_frames=2, base_rate_hz=10.0,
                            active_rate_hz=30.0)
CTL = CaptureConfig(hp_bits=12)


def run_gate(kind, trace):
    """``trace (S, n, 32, 32)`` through a port gate that always fires;
    returns the gate (drains untaken) and its drains as {(sid, idx):
    frame}, taken from an identical second gate."""
    _, model = models(0, 128, t_score=-1e9)
    kw = dict(chunk_size=C, block_d=128, control=CTL, device="cpu")

    def build():
        if kind == "stream":
            g = StreamRunner(model, GATE_CFG, **kw)
            g.process(trace[0])
        elif kind == "fleet":
            g = FleetRunner(model, GATE_CFG, **kw)
            g.process(trace)
        else:
            g = FleetService(model, GATE_CFG, n_slots=len(trace), **kw)
            for s in range(len(trace)):
                g.attach(f"s{s}")
            for lo in range(0, trace.shape[1], C):
                g.dispatch({f"s{s}": trace[s, lo:lo + C]
                            for s in range(len(trace))})
            g.flush()
        return g

    twin = build()
    if kind == "stream":
        drains = {0: twin.drain_hp()}
    elif kind == "fleet":
        drains = dict(enumerate(twin.drain_hp()))
    else:
        drains = {sid: twin.drain_hp(sid) for sid in twin.attached}
    want = {(sid, int(i)): f for sid, (idx, frs) in drains.items()
            for i, f in zip(idx, frs)}
    return build(), want


def gate_cascade(**kw):
    """A smoke-width cascade for the gate's 32x32 frames (seq 16)."""
    cfg = configs.get_smoke(ARCH)
    params = steps.init_detector_params(torch.Generator().manual_seed(2),
                                        cfg, frame_hw=(32, 32), patch=PATCH)
    return CascadeService(params, cfg, batch_size=BATCH, frame_hw=(32, 32),
                          patch=PATCH, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["stream", "fleet", "service"])
def test_pump_closes_the_loop(kind):
    trace = np.random.default_rng(11).uniform(
        0.0, 1.0, (2, 2 * C, 32, 32)).astype(np.float32)
    gate, want = run_gate(kind, trace)
    assert len(want) > BATCH
    casc = gate_cascade()
    assert casc.pump(gate) == len(want)
    assert casc.pump(gate) == 0                  # drained: empty drains
    batches = casc.flush()
    rows = [(sid, int(i)) for b in batches
            for sid, i in zip(b.sids, b.frame_idx)]
    assert sorted(rows, key=str) == sorted(want, key=str)
    got = np.concatenate([b.logits for b in batches])
    np.testing.assert_array_equal(
        got, casc.eager(np.stack([want[r] for r in rows])))
    assert casc.rebuild_count() == 1


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def matmul_flops(cfg, seq, patch, n_layers):
    """Hand count of one frame's products (the ``ROADMAP.md`` §3 table):
    q, k, v, o, the scores and P·V, and the MLP per layer; the patch
    embedder and the unembedding of every position."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    layer = (2 * seq * d * 3 * h * hd + 2 * seq * h * hd * d
             + 2 * 2 * seq * seq * h * hd + 2 * 2 * seq * d * f)
    return n_layers * layer + 2 * seq * patch * patch * d + \
        2 * seq * d * cfg.vocab


@pytest.mark.parametrize("n_layers,batch,want", [
    (2, 1, 598_016), (4, 1, 1_130_496), (2, 4, 598_016), (4, 4, 1_130_496)])
def test_backbone_cost_is_the_hand_count(n_layers, batch, want):
    cfg = configs.get_smoke(ARCH).replace(n_layers=n_layers)
    params = steps.init_detector_params(torch.Generator().manual_seed(1),
                                        cfg, frame_hw=HW, patch=PATCH)
    casc = CascadeService(params, cfg, batch_size=batch, frame_hw=HW,
                          patch=PATCH, device="cpu")
    cost = casc.backbone_cost()
    seq = steps.detector_seq_len(HW, PATCH)
    assert cost.flops == want == matmul_flops(cfg, seq, PATCH, n_layers)
    weight_bytes = 4 * (sum(a.numel() for a in jax.tree.leaves(params)))
    assert cost.bytes == weight_bytes + 4 * (HW[0] * HW[1] + 2)
    assert cost.joules == pytest.approx(want * energy.EDGE_J_PER_FLOP)


def test_backbone_cost_counts_compute_dtype_bytes():
    """bf16 weights are read at two bytes; the float32 embedder at four."""
    cfg = configs.get_smoke(ARCH).replace(compute_dtype="bfloat16")
    params = steps.init_detector_params(torch.Generator().manual_seed(1),
                                        cfg, frame_hw=HW, patch=PATCH)
    cost = CascadeService(params, cfg, batch_size=2, frame_hw=HW,
                          patch=PATCH, device="cpu").backbone_cost()
    backbone = sum(a.numel() for a in jax.tree.leaves(params["backbone"]))
    embedder = sum(a.numel() for a in jax.tree.leaves(params["embedder"]))
    assert cost.bytes == 2 * backbone + 4 * embedder + 4 * (HW[0] * HW[1]
                                                            + 2)


def test_system_energy_bills_duty_times_backbone():
    trace = np.random.default_rng(12).uniform(
        0.0, 1.0, (1, 3 * C, 32, 32)).astype(np.float32)
    gate, _ = run_gate("stream", trace)
    casc = gate_cascade()
    bill = casc.system_energy(gate.capture_log)
    cost = casc.backbone_cost()
    duty = float(gate.capture_log.gated.mean())
    assert bill["cascade"] == energy.cascade_system(gate.capture_log, cost)
    assert bill["cascade"].cloud == pytest.approx(duty * cost.joules)
    assert bill["always_on"] == energy.always_on_backbone(cost)
    assert bill["always_on"].cloud == cost.joules
