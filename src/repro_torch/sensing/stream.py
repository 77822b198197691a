"""Batched streaming runtime on PyTorch: chunked scoring + gating + online
learning. Twin of ``repro.sensing.stream``.

Frames are consumed in fixed-size chunks and each chunk runs

  ADC capture -> fused encode+score (ONE kernel launch for the chunk)
  -> (T+1)-th order statistic -> threshold
  -> hysteresis (:func:`gate_scan`) or the closed capture loop
     (:func:`control_scan`, + :func:`hp_capture` of the gated frames)
  -> (optionally) the online perceptron fold over each frame's
     top-scoring fragment

in :func:`super_chunk_fn`, the composition of two halves. The device half
(:func:`chunk_device_half`) scores the chunk and, where the fold does not
read the tick's scan, runs the online fold; it returns device tensors and
never waits for the card. The host half (:func:`chunk_host_half`) runs the
gate scans, whose state is a pair of small integers per stream, as Python
loops on the host, where the runner needs the decisions anyway. Between
them is the one device->host copy of the chunk's scores: the runners make
it at once, the serving layer (``repro_torch.launch.serve``) later, so the
host prepares the next tick while the card scores this one.

The :class:`StreamState` — class hypervectors, per-stream gate holds and
ADC phases, the absolute frame index — carries across chunks and
``process`` calls, so chunking is invisible: slicing a stream differently
gives bitwise-identical outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import online
from repro_torch.core.encoding import encode_fragments, flat_perm_base
from repro_torch.core.hypersense import HyperSenseModel, frame_detection_score
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import (CaptureConfig, CaptureLog,
                                             ControllerConfig, StreamStats,
                                             assemble_capture_log,
                                             decimation, stats_from)
from repro_torch.distributed.sharding import all_gather_cat, local_range
from repro_torch.kernels import ops
from repro_torch.sensing import adc as adc_sim


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Mutable stream state threaded through every chunk step.

    ``class_hvs`` is ``(2, D)`` (one stream or a shared fleet classifier)
    or ``(S, 2, D)`` (per-stream), on the model's device. ``holds`` and
    ``phases`` are the ``(S,)`` int32 gate and closed-loop ADC states, on
    the host where the scans run; ``frame_idx`` the absolute index of the
    next frame.
    """
    class_hvs: torch.Tensor
    holds: torch.Tensor
    phases: torch.Tensor
    frame_idx: int


def init_stream_state(class_hvs: torch.Tensor, n_streams: int,
                      per_stream: bool = False) -> StreamState:
    """Fresh state: the model's classifier, zero holds/phases, frame 0."""
    if per_stream and class_hvs.ndim == 2:
        class_hvs = class_hvs.expand(n_streams, *class_hvs.shape).clone()
    return StreamState(class_hvs=class_hvs,
                       holds=torch.zeros(n_streams, dtype=torch.int32),
                       phases=torch.zeros(n_streams, dtype=torch.int32),
                       frame_idx=0)


def validate_runner_args(chunk_size: int, adc_bits: int | None,
                         adc_sigma: float, precision: str) -> None:
    """The (chunk, ADC, precision) consistency rules of every front-end."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if adc_sigma > 0.0 and adc_bits is None:
        raise ValueError("adc_sigma > 0 without adc_bits: the ADC is "
                         "only in the loop when adc_bits is set")
    if precision not in adc_sim.PRECISIONS:
        raise ValueError(f"precision must be one of "
                         f"{adc_sim.PRECISIONS}, got {precision!r}")
    if precision in adc_sim.INT_PRECISIONS and adc_bits is None:
        raise ValueError(f'precision="{precision}" consumes ADC codes: '
                         "set adc_bits (the simulated converter's depth)")
    if precision == "int4" and adc_bits is not None and adc_bits > 4:
        raise ValueError(f'precision="int4" packs two codes per byte, '
                         f"so adc_bits must be <= 4 (got {adc_bits})")


_MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """The splitmix64 finalizer: a bijection of 64-bit integers that
    spreads every input bit over every output bit."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _frame_seed(seed: int, index: int) -> int:
    """The generator seed of frame ``index`` of a stream seeded ``seed``:
    the two 32-bit halves mixed by :func:`mix64`. A CPU generator keeps
    only the low 32 bits of its seed, so both must reach them."""
    return mix64(((seed & 0xFFFFFFFF) << 32) | (index & 0xFFFFFFFF))


def _noisy_capture(frames: torch.Tensor, sigma: float, seed: int | None,
                   start_index: int) -> torch.Tensor:
    """Pre-conversion thermal noise keyed by *absolute frame index*: frame
    ``i`` draws from a generator seeded with ``(seed, start_index + i)``,
    so re-slicing a stream into other ``process`` calls gives identical
    captures. The one implementation both ADC views share."""
    if sigma <= 0.0:
        return frames
    if seed is None:
        raise ValueError("adc noise (sigma > 0) requires a seed")
    g = torch.Generator(device=frames.device)
    out = []
    for i in range(frames.shape[0]):
        g.manual_seed(_frame_seed(seed, start_index + i))
        out.append(adc_sim.adc_noise(frames[i], sigma, g))
    return torch.stack(out)


def adc_view(frames: torch.Tensor, bits: int, *, sigma: float = 0.0,
             seed: int | None = None, start_index: int = 0) -> torch.Tensor:
    """Low-precision ADC capture of ``(N, H, W)`` frames: the float
    reconstruction ``codes * LSB`` (paper Fig. 3)."""
    return adc_sim.quantize(_noisy_capture(frames, sigma, seed, start_index),
                            bits)


def adc_view_codes(frames: torch.Tensor, bits: int, *, sigma: float = 0.0,
                   seed: int | None = None, start_index: int = 0
                   ) -> torch.Tensor:
    """Raw integer ADC codes of ``(N, H, W)`` frames, packed to the wire
    dtype — the integer datapath's input. Integer input is taken as
    already-converted codes (range-checked, then repacked)."""
    if not frames.is_floating_point():
        if sigma > 0.0:
            raise ValueError("adc noise applies before conversion; input "
                             "is already integer ADC codes")
        adc_sim.check_codes_range(frames, bits)
        return adc_sim.pack_codes(frames.to(torch.int32), bits)
    frames = _noisy_capture(frames, sigma, seed, start_index)
    return adc_sim.pack_codes(adc_sim.quantize_codes(frames, bits), bits)


def gate_scan(decisions: torch.Tensor, hold_frames: int,
              init_hold: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``SensorController`` as a scan: ``(gated (N,) bool, holds (N,)
    int32)``; ``holds[i]`` is the state after frame ``i``."""
    hold = int(init_hold)
    gated, holds = [], []
    for fired in decisions.tolist():
        gated.append(bool(fired) or hold > 0)
        hold = hold_frames if fired else max(hold - 1, 0)
        holds.append(hold)
    return (torch.tensor(gated, dtype=torch.bool),
            torch.tensor(holds, dtype=torch.int32))


def control_scan(decisions: torch.Tensor, hold_frames: int, decim: int,
                 init_hold: int = 0, init_phase: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The ``RateController`` as a scan: ``(sampled, gated, holds,
    phases)``, each ``(N,)``. A frame the idle ADC skips can never fire;
    with ``decim == 1`` ``gated``/``holds`` equal :func:`gate_scan`'s."""
    hold, phase = int(init_hold), int(init_phase)
    out = []
    for f in decisions.tolist():
        sampled = phase == 0 or hold > 0
        fired = bool(f) and sampled
        gated = fired or hold > 0
        hold = hold_frames if fired else max(hold - 1, 0)
        phase = decim - 1 if sampled else phase - 1
        out.append((sampled, gated, hold, phase))
    sampled, gated, holds, phases = zip(*out) if out else ((),) * 4
    return (torch.tensor(sampled, dtype=torch.bool),
            torch.tensor(gated, dtype=torch.bool),
            torch.tensor(holds, dtype=torch.int32),
            torch.tensor(phases, dtype=torch.int32))


def hp_capture(raw: torch.Tensor, gated: torch.Tensor, n_valid: int, k: int,
               bits: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bounded gather buffer: the first ``k`` gated frames of a ``(C, H,
    W)`` raw chunk, converted at the high-precision depth. Returns ``(buf
    (k, H, W) float32, idx (k,) int32 in-chunk positions (-1 = empty),
    count)``; ``count > k`` means ``count - k`` frames were dropped."""
    C = raw.shape[0]
    dev = raw.device
    pos = torch.arange(C, device=dev)
    take = gated.to(dev, torch.bool) & (pos < n_valid)
    rank = torch.cumsum(take.to(torch.int64), 0) - 1
    slot = torch.where(take & (rank < k), rank, k)        # k = spill slot
    q = adc_sim.quantize_per_frame(
        raw, torch.where(take, bits, 0).to(torch.int32))
    buf = torch.zeros((k + 1, *raw.shape[1:]), dtype=torch.float32,
                      device=dev)
    buf[slot[take]] = q[take]
    idx = torch.full((k + 1,), -1, dtype=torch.int32, device=dev)
    idx[slot[take]] = pos[take].to(torch.int32)
    return buf[:k], idx[:k], take.sum()


def resolve_hp_buffer(control: CaptureConfig | None, chunk_size: int,
                      frames_dtype: torch.dtype) -> int:
    """Per-chunk HP buffer size (0 = no materialization). Integer-code
    input has no raw frames to HP-capture from."""
    if control is None:
        return 0
    k = chunk_size if control.hp_buffer is None else control.hp_buffer
    if k > 0 and not frames_dtype.is_floating_point:
        raise ValueError(
            "high-precision materialization needs the raw frames; the "
            "input is already low-precision ADC codes — pass "
            "control=CaptureConfig(hp_buffer=0) to run the closed loop "
            "log-only")
    return k


def collect_hp(raw_chunk: torch.Tensor, gated, n_valid: int, k: int,
               bits: int, base) -> tuple[list[list], int]:
    """Drain one chunk's bounded HP buffers to the host: one ``[(absolute
    frame index, hp frame), ...]`` list per stream of the ``(S, C, H, W)``
    chunk, and the number of burst frames dropped to full buffers.

    :func:`hp_capture` per stream, with the buffer filled on the host's
    side: ``gated`` (``(S, C)``, on the host where the scans ran) picks the
    first ``k`` valid gated frames of each stream, those frames alone are
    gathered and converted at ``bits`` on the chunk's device, and one copy
    brings them back. The conversion is per frame, so a frame's HP capture
    does not depend on which other frames were gathered with it."""
    S, C = raw_chunk.shape[:2]
    base = np.broadcast_to(np.asarray(base, np.int64), (S,))
    take = np.array(gated, bool).reshape(S, C)
    take[:, n_valid:] = False
    rank = np.cumsum(take, axis=1) - 1
    si, fi = np.nonzero(take & (rank < k))
    dropped = int(np.maximum(take.sum(axis=1) - k, 0).sum())
    out = [[] for _ in range(S)]
    if si.size:
        dev = raw_chunk.device
        picked = raw_chunk[to_device(torch.from_numpy(si), dev),
                           to_device(torch.from_numpy(fi), dev)]
        hp = adc_sim.quantize_per_frame(
            picked, torch.full((si.size,), bits, dtype=torch.int32,
                               device=dev)).cpu().numpy()
        for s_, f_, frame in zip(si.tolist(), fi.tolist(), hp):
            out[s_].append((int(base[s_]) + f_, frame))
    return out, dropped


def hp_drain_arrays(entries, frame_hw: tuple[int, int] | None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One stream's ``[(abs_idx, frame), ...]`` buffer -> ``(indices (M,)
    int64, frames (M, H, W) float32)``; an empty drain keeps the real frame
    shape ``(0, H, W)`` (``(0, 0, 0)`` before any frame fixed it)."""
    idx = np.asarray([i for i, _ in entries], np.int64)
    if entries:
        frames = np.stack([np.asarray(f, np.float32) for _, f in entries])
    else:
        hw = (0, 0) if frame_hw is None else tuple(frame_hw)
        frames = np.zeros((0, *hw), np.float32)
    return idx, frames


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``. A host tensor bound for the card goes through
    pinned memory with ``non_blocking=True``: a copy from pageable memory
    would wait for the stream."""
    device = torch.device(device)
    if device.type != "cuda" or x.device.type == "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _top_fragment_hvs(frames: torch.Tensor, maps: torch.Tensor,
                      B0: torch.Tensor, b: torch.Tensor, *, h: int, w: int,
                      stride: int, mx: int, nonlinearity
                      ) -> list[torch.Tensor]:
    """Re-encode each frame's top-scoring fragment: one ``(C, D)`` tensor
    per stream, the online update's sample stream. Each stream is encoded
    on its own, so its hypervectors have the bits a one-stream runner gets
    (a matmul's or a norm's order may depend on how many rows it takes)."""
    S, C, H, W = frames.shape
    dev = frames.device
    top = torch.argmax(maps.reshape(S, C, -1), dim=-1)           # (S, C)
    rows = ((top // mx) * stride)[..., None] + torch.arange(h, device=dev)
    cols = ((top % mx) * stride)[..., None] + torch.arange(w, device=dev)
    ci = torch.arange(C, device=dev)[:, None, None]
    base = flat_perm_base(B0, w)
    return [encode_fragments(
                frames[s][ci, rows[s][:, :, None], cols[s][:, None, :]],
                base, b, nonlinearity=nonlinearity, normalize=True)
            for s in range(S)]


def fold_chunk(frames: torch.Tensor, maps: torch.Tensor,
               class_hvs: torch.Tensor, B0: torch.Tensor, b: torch.Tensor,
               labels: torch.Tensor, mask2d: torch.Tensor, *, h: int,
               w: int, stride: int, nonlinearity, adapt: AdaptConfig,
               precision: str = "float32", adc_lsb: float = 1.0,
               sensor_group=None) -> torch.Tensor:
    """The online perceptron fold of one ``(S, C)`` chunk: each frame's
    top fragment re-encoded and folded where ``mask2d`` is set. Per-stream
    classifiers ``(S, 2, D)`` fold stream by stream; one shared ``(2, D)``
    classifier folds the streams' samples in time order, the stream index
    breaking ties. ``labels`` and ``mask2d`` may lie on the host.

    With ``sensor_group`` the ``S`` streams are this rank's contiguous
    slots of the group's: a shared fold gathers every rank's samples,
    labels and masks in global stream order and replays the whole
    sequential fold on every rank (masked samples leave the classifier
    bitwise untouched, so masked pad slots change nothing); a per-stream
    fold stays local."""
    S, C = frames.shape[:2]
    mx = maps.shape[-1]
    dev = class_hvs.device
    # the int path re-encodes from the dequantized crop; the fragment
    # normalization cancels the LSB
    obs = (frames.to(torch.float32) * adc_lsb
           if precision in adc_sim.INT_PRECISIONS else frames)
    hvs = _top_fragment_hvs(obs, maps, B0, b, h=h, w=w, stride=stride,
                            mx=mx, nonlinearity=nonlinearity)  # S x (C, D)
    labels = to_device(labels, dev).to(torch.int64)
    mask2d = to_device(mask2d, dev)
    if adapt.scope == "per-stream":
        # each stream folds from a copy of its row: its own allocation, as
        # a one-stream runner's classifier is
        return torch.stack([
            online.apply_chunk(adapt, class_hvs[s].clone(), hvs[s],
                               labels[s], mask2d[s])[0]
            for s in range(S)])
    hv = torch.stack(hvs, 1)                                   # (C, S, D)
    if sensor_group is not None:
        hv = all_gather_cat(hv, sensor_group, dim=1)
        labels = all_gather_cat(labels, sensor_group)
        mask2d = all_gather_cat(mask2d.to(torch.uint8),
                                sensor_group).to(torch.bool)
    n = hv.shape[0] * hv.shape[1]
    return online.apply_chunk(adapt, class_hvs, hv.reshape(n, hv.shape[-1]),
                              labels.T.reshape(n), mask2d.T.reshape(n))[0]


def park_classes(class_hvs: torch.Tensor, before: torch.Tensor,
                 slot_mask: torch.Tensor) -> torch.Tensor:
    """Per-stream classifiers of the masked slots kept as ``before``."""
    if class_hvs.ndim != 3:
        return class_hvs
    keep = to_device(slot_mask, class_hvs.device)[:, None, None]
    return torch.where(keep, class_hvs, before)


def chunk_device_half(frames: torch.Tensor, class_hvs: torch.Tensor,
                      B0: torch.Tensor, b: torch.Tensor, tiles,
                      n_valid: int, labels: torch.Tensor,
                      slot_mask: torch.Tensor | None = None, *, h: int,
                      w: int, stride: int, nonlinearity, t_detection: int,
                      adapt: AdaptConfig | None = None,
                      precision: str = "float32", adc_lsb: float = 1.0,
                      decim: int | None = None, park_masked: bool = False,
                      sensor_group=None, hyperdim_group=None
                      ) -> tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor | None]:
    """The device half of :func:`super_chunk_fn`: the scorer call and the
    frame scores, and, in the open loop, the online fold (its mask is the
    valid frames of the unmasked slots, which the card can build).

    ``hyperdim_group`` splits the scorer's D at its tile fold (``tiles``
    hold this rank's D-tiles); ``sensor_group`` makes a shared-scope fold
    gather the samples of every rank's slots (:func:`fold_chunk`).

    Returns ``(maps (S, C, my, mx), scores (S, C), class_hvs)``, all on the
    model's device; ``class_hvs`` is the folded (and, with
    ``park_masked``, parked) classifier, or None without ``adapt`` or in
    the closed loop, whose fold reads the host half's ``sampled``
    (:func:`fold_chunk` after :func:`chunk_host_half`). Nothing here
    waits for the card: ``labels`` and ``slot_mask`` may lie on the host
    and go through pinned memory (:func:`to_device`).
    """
    S, C, H, W = frames.shape
    per_stream = adapt is not None and adapt.scope == "per-stream"

    if precision in adc_sim.INT_PRECISIONS:
        if adapt is None:
            ktiles = tiles
        elif per_stream:
            ktiles = ops.retile_classes_int_fleet(tiles, class_hvs)
        else:
            ktiles = ops.retile_classes_int(tiles, class_hvs)
        packed = precision == "int4"
        kframes = adc_sim.pack_nibbles(frames) if packed else frames
        maps = ops.fragment_score_map_fleet_int(
            kframes, class_hvs, B0, b, h=h, w=w, stride=stride,
            nonlinearity=nonlinearity, tiles=ktiles, packed=packed,
            hyperdim_group=hyperdim_group)
    else:
        if adapt is None:
            ktiles = tiles
        elif per_stream:
            ktiles = ops.retile_classes_fleet(tiles, class_hvs)
        else:
            ktiles = ops.retile_classes(tiles, class_hvs)
        maps = ops.fragment_score_map_fleet(
            frames, class_hvs, B0, b, h=h, w=w, stride=stride,
            nonlinearity=nonlinearity, tiles=ktiles,
            hyperdim_group=hyperdim_group)                   # (S, C, my, mx)
    scores = frame_detection_score(maps, t_detection)            # (S, C)

    folded = None
    if adapt is not None and decim is None:
        dev = class_hvs.device
        mask2d = (torch.arange(C, device=dev) < n_valid)[None, :].expand(S, C)
        if slot_mask is not None:
            mask2d = mask2d & to_device(slot_mask, dev)[:, None]
        folded = fold_chunk(frames, maps, class_hvs, B0, b, labels, mask2d,
                            h=h, w=w, stride=stride,
                            nonlinearity=nonlinearity, adapt=adapt,
                            precision=precision, adc_lsb=adc_lsb,
                            sensor_group=sensor_group)
        if park_masked and slot_mask is not None:
            folded = park_classes(folded, class_hvs, slot_mask)
    return maps, scores, folded


def chunk_host_half(scores: torch.Tensor, holds: torch.Tensor,
                    phases: torch.Tensor, n_valid: int,
                    slot_mask: torch.Tensor | None = None, *, t_score: float,
                    can_fire: bool, hold_frames: int,
                    decim: int | None = None, park_masked: bool = False):
    """The host half of :func:`super_chunk_fn`: the threshold, the gate
    (:func:`gate_scan`) or capture-loop (:func:`control_scan`) scan of each
    stream, and the carried holds and phases (a masked slot's parked in
    place with ``park_masked``). ``scores`` ``(S, C)``, ``holds``,
    ``phases`` and ``slot_mask`` lie on the host; ``can_fire`` is False
    when ``t_detection`` reaches the windows per frame.

    Returns ``(fired, gated, sampled, holds, phases)`` host tensors.
    """
    S, C = scores.shape
    # count(s_i > t) > T  <=>  (T+1)-th largest > t, provided T < my*mx;
    # with T >= my*mx the count can never exceed T -> never fires.
    valid = torch.arange(C) < n_valid
    if can_fire:
        fired = (scores > t_score) & valid[None, :]
    else:
        fired = torch.zeros((S, C), dtype=torch.bool)
    if slot_mask is not None:
        fired = fired & slot_mask[:, None]

    last = max(n_valid - 1, 0)
    if decim is None:
        sampled = valid[None, :].expand(S, C)
        if slot_mask is not None:
            sampled = sampled & slot_mask[:, None]
        scans = [gate_scan(fired[s], hold_frames, holds[s])
                 for s in range(S)]
        gated = torch.stack([g for g, _ in scans])
        holds_seq = torch.stack([hs for _, hs in scans])
        phase_out = phases
    else:
        scans = [control_scan(fired[s], hold_frames, decim, holds[s],
                              phases[s]) for s in range(S)]
        sampled, gated, holds_seq, phases_seq = (
            torch.stack(x) for x in zip(*scans))
        fired = fired & sampled
        if slot_mask is not None:
            sampled = sampled & slot_mask[:, None]
        phase_out = phases_seq[:, last] if n_valid > 0 else phases
    hold_out = holds_seq[:, last] if n_valid > 0 else holds
    if park_masked and slot_mask is not None:
        # a masked slot's carried state is parked in place
        hold_out = torch.where(slot_mask, hold_out, holds)
        phase_out = torch.where(slot_mask, phase_out, phases)
    return fired, gated, sampled, hold_out, phase_out


def super_chunk_fn(frames: torch.Tensor, state: StreamState,
                   B0: torch.Tensor, b: torch.Tensor, tiles, t_score: float,
                   n_valid: int, labels: torch.Tensor,
                   slot_mask: torch.Tensor | None = None, *, h: int, w: int,
                   stride: int, nonlinearity, t_detection: int,
                   hold_frames: int, adapt: AdaptConfig | None = None,
                   precision: str = "float32", adc_lsb: float = 1.0,
                   decim: int | None = None, park_masked: bool = False,
                   sensor_group=None, hyperdim_group=None):
    """One streaming step over an ``(S, C, H, W)`` super-chunk: the device
    half, the copy of the scores to the host, the host half, and the
    closed loop's fold (which reads the scan).

    ``StreamRunner`` calls it with ``S = 1``; the ``S*C`` axis is scored in
    ONE kernel launch. ``tiles`` is the full tile precompute when frozen
    (``adapt=None``), or the class-independent geometry when adapting (the
    current classifier is re-tiled here by one gather). With an integer
    precision ``frames`` are the integer ADC codes (``"int4"`` is
    nibble-packed here at the kernel boundary) and ``adc_lsb`` dequantizes
    the top fragment crop for the online re-encode.

    ``n_valid`` masks a padded tail chunk (pad frames never fire, never
    update, and the carried state is read at the last valid frame).
    ``labels`` is ``(S, C)``, read only in ``adapt.mode == "label"``.
    ``decim`` switches on the closed capture loop (:func:`control_scan`);
    ``decim == 1`` reproduces the open loop. ``slot_mask`` (``(S,)`` bool)
    marks real sensor slots; ``park_masked`` freezes the masked slots'
    carried state in place.

    On a mesh, ``frames``, ``labels``, ``slot_mask``, ``tiles`` and a
    per-stream ``state.class_hvs`` are this rank's: its contiguous slots of
    ``sensor_group``'s and its D-tiles of ``hyperdim_group``'s (the scorer
    folds the gathered tile partials). The frame scores and slot masks are
    gathered over ``sensor_group`` on the card, and the host half runs over
    every slot of the group, so ``state.holds`` and ``state.phases`` and
    the returned scores and decisions cover all of them, on every rank.

    Returns ``(scores (S, C), fired, gated, sampled, new_state)``; scores
    on the host as float32, the decisions as host bool tensors.
    """
    C = frames.shape[1]
    kw = dict(h=h, w=w, stride=stride, nonlinearity=nonlinearity)
    groups = dict(sensor_group=sensor_group, hyperdim_group=hyperdim_group)
    maps, scores, class_hvs = chunk_device_half(
        frames, state.class_hvs, B0, b, tiles, n_valid, labels, slot_mask,
        t_detection=t_detection, adapt=adapt, precision=precision,
        adc_lsb=adc_lsb, decim=decim, park_masked=park_masked, **groups,
        **kw)
    local = slice(None)
    host_mask = None if slot_mask is None else slot_mask.cpu()
    if sensor_group is not None:
        lo, hi = local_range(scores.shape[0] * dist.get_world_size(
            sensor_group), sensor_group)
        local = slice(lo, hi)
        mask = (torch.ones(frames.shape[0], dtype=torch.bool)
                if slot_mask is None else slot_mask)
        # the slot mask rides the scores' gather as one more column
        both = all_gather_cat(torch.cat([scores, to_device(
            mask, scores.device).to(scores.dtype)[:, None]], 1),
            sensor_group).cpu()
        scores, host_mask = both[:, :-1].contiguous(), both[:, -1] > 0
    scores = scores.cpu()
    fired, gated, sampled, holds, phases = chunk_host_half(
        scores, state.holds, state.phases, n_valid, host_mask,
        t_score=t_score, can_fire=t_detection < maps.shape[-2] *
        maps.shape[-1], hold_frames=hold_frames, decim=decim,
        park_masked=park_masked)
    if adapt is None:
        class_hvs = state.class_hvs
    elif class_hvs is None:
        # a frame the LP ADC skipped was never scored: it must not feed the
        # online update either (sampled carries the slot mask)
        class_hvs = fold_chunk(
            frames, maps, state.class_hvs, B0, b, labels,
            sampled[local] & (torch.arange(C) < n_valid)[None, :],
            adapt=adapt, precision=precision, adc_lsb=adc_lsb,
            sensor_group=sensor_group, **kw)
        if park_masked and host_mask is not None:
            class_hvs = park_classes(class_hvs, state.class_hvs,
                                     host_mask[local])
    new_state = StreamState(class_hvs=class_hvs, holds=holds, phases=phases,
                            frame_idx=state.frame_idx + n_valid)
    return scores, fired, gated, sampled, new_state


def model_geometry(model: HyperSenseModel, W: int, block_d: int,
                   precision: str = "float32"):
    """Class-independent geometry for ``model`` on width-``W`` frames (the
    int twin, +-1 slabs under ``"binary"``, for the integer precisions)."""
    if precision in adc_sim.INT_PRECISIONS:
        return ops.precompute_geometry_int(
            model.B0, model.b, W=W, w=model.w, stride=model.stride,
            block_d=block_d,
            mode="binary" if precision == "binary" else "int8")
    return ops.precompute_geometry(model.B0, model.b, W=W, w=model.w,
                                   stride=model.stride, block_d=block_d)


def model_tiles(model: HyperSenseModel, W: int, block_d: int,
                precision: str = "float32"):
    """Tile precompute for ``model`` on width-``W`` frames (per precision)."""
    geom = model_geometry(model, W, block_d, precision)
    fn = (ops.retile_classes_int if precision in adc_sim.INT_PRECISIONS
          else ops.retile_classes)
    return fn(geom, model.class_hvs)


class StreamRunner:
    """Stateful chunked scorer + gate (+ learner): ``process(frames)``
    freely; state carries across calls.

    Runs on ``device`` (``None`` -> ``"cuda"``, raising without CUDA; pass
    ``"cpu"`` for the plain versions). ``adapt`` switches on online
    learning (labels to ``process`` in ``"label"`` mode); ``control`` (a
    :class:`~repro_torch.core.sensor_control.CaptureConfig`) closes the
    capture loop, subsampling idle frames and materializing gated frames at
    ``control.hp_bits`` for :meth:`drain_hp`. Every runner keeps a
    :attr:`capture_log`. ADC noise (``adc_sigma > 0``) is drawn per frame
    from generators seeded by ``(adc_seed, absolute frame index)``.
    """

    def __init__(self, model: HyperSenseModel,
                 config: ControllerConfig | None = None, *,
                 chunk_size: int = 32, t_detection: int | None = None,
                 block_d: int = 512, adc_bits: int | None = None,
                 adc_sigma: float = 0.0, adc_seed: int = 0,
                 adapt: AdaptConfig | None = None,
                 precision: str = "float32",
                 control: CaptureConfig | None = None,
                 device: str | torch.device | None = None):
        validate_runner_args(chunk_size, adc_bits, adc_sigma, precision)
        if adapt is not None and adapt.scope == "per-stream":
            raise ValueError('scope="per-stream" is a fleet mode; a '
                             "StreamRunner has exactly one stream — "
                             'use scope="shared"')
        self.device = resolve_device(device)
        self.precision = precision
        self.model = model.to(self.device)
        self.config = config or ControllerConfig()
        self.chunk_size = chunk_size
        self.block_d = block_d
        self.t_detection = (model.t_detection if t_detection is None
                            else t_detection)
        self.adc_bits = adc_bits
        self.adc_sigma = adc_sigma
        self.adc_seed = adc_seed
        self.adapt = adapt
        self.control = control
        self._decim = (None if control is None
                       else (decimation(self.config) if control.subsample
                             else 1))
        self._geom = None       # (W, geometry) — class-independent
        self.reset()

    def reset(self) -> None:
        self._state = init_stream_state(self.model.class_hvs, 1)
        self._n_seen = 0
        self._tiles = None      # (W, class_hvs ref, tiles) — frozen path
        self._log_sampled: list[np.ndarray] = []
        self._log_gated: list[np.ndarray] = []
        self._frame_pixels = 0
        self._frame_hw: tuple[int, int] | None = None
        self._hp_idx: list[int] = []
        self._hp_frames: list[np.ndarray] = []
        self.hp_dropped = 0     # burst frames lost to a full HP buffer

    @property
    def class_hvs(self) -> torch.Tensor:
        """The live classifier (updates under ``adapt``)."""
        return self._state.class_hvs

    def set_class_hvs(self, class_hvs) -> None:
        """Install an externally updated classifier mid-stream; the next
        chunk re-tiles it (the tile cache is keyed on tensor identity)."""
        class_hvs = torch.as_tensor(class_hvs, dtype=torch.float32,
                                    device=self.device)
        self.model = dataclasses.replace(self.model, class_hvs=class_hvs)
        self._state = dataclasses.replace(self._state, class_hvs=class_hvs)

    def _ensure_geom(self, W: int):
        if self._geom is None or self._geom[0] != W:
            self._geom = (W, model_geometry(self.model, W, self.block_d,
                                            self.precision))
        return self._geom[1]

    def _ensure_tiles(self, W: int):
        """Frozen-path tile cache, keyed on (width, class-hv identity)."""
        retile = (ops.retile_classes_int
                  if self.precision in adc_sim.INT_PRECISIONS
                  else ops.retile_classes)
        chvs = self._state.class_hvs
        if (self._tiles is None or self._tiles[0] != W
                or self._tiles[1] is not chvs):
            self._tiles = (W, chvs, retile(self._ensure_geom(W), chvs))
        return self._tiles[2]

    @property
    def _adc_lsb(self) -> float:
        return (adc_sim.lsb(self.adc_bits)
                if self.precision in adc_sim.INT_PRECISIONS else 1.0)

    @property
    def capture_log(self) -> CaptureLog:
        """What the ADC actually converted so far (cleared by reset)."""
        return assemble_capture_log(self._log_sampled, self._log_gated,
                                    lp_bits=self.adc_bits,
                                    control=self.control,
                                    frame_pixels=self._frame_pixels)

    def drain_hp(self) -> tuple[np.ndarray, np.ndarray]:
        """Take the high-precision burst frames captured so far: ``(absolute
        indices (M,), frames (M, H, W) at control.hp_bits)``."""
        idx, frames = hp_drain_arrays(
            list(zip(self._hp_idx, self._hp_frames)), self._frame_hw)
        self._hp_idx, self._hp_frames = [], []
        return idx, frames

    def process(self, frames, labels=None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(n, H, W) frames -> (scores (n,), fired (n,), gated (n,)).

        With ``adc_bits`` the scorer sees the low-precision ADC capture;
        with an integer precision the capture stays integer codes end to
        end (integer input is taken as already-converted codes).
        ``labels`` (``(n,)`` ints) feed ``adapt.mode == "label"``.
        """
        frames = torch.as_tensor(frames, device=self.device)
        if frames.is_floating_point():
            frames = frames.to(torch.float32)
        raw = frames
        H, W = int(frames.shape[-2]), int(frames.shape[-1])
        self._frame_pixels = H * W
        self._frame_hw = (H, W)
        hp_k = resolve_hp_buffer(self.control, self.chunk_size, frames.dtype)
        base = self._n_seen
        if self.adapt is not None and self.adapt.mode == "label":
            if labels is None:
                raise ValueError('adapt.mode == "label" needs per-frame '
                                 "labels passed to process()")
            labels = torch.as_tensor(labels, dtype=torch.int32)
            if labels.shape != frames.shape[:1]:
                raise ValueError(f"labels shape {tuple(labels.shape)} != "
                                 f"(n,) = {tuple(frames.shape[:1])}")
        if self.precision in adc_sim.INT_PRECISIONS:
            ops.assert_int_datapath_fits(self.adc_bits, H, W, self.model.h,
                                         self.model.w,
                                         stride=self.model.stride)
            frames = adc_view_codes(frames, self.adc_bits,
                                    sigma=self.adc_sigma, seed=self.adc_seed,
                                    start_index=self._n_seen)
        elif self.adc_bits is not None:
            frames = adc_view(frames, self.adc_bits, sigma=self.adc_sigma,
                              seed=self.adc_seed, start_index=self._n_seen)
        n = frames.shape[0]
        self._n_seen += n
        m = self.model
        tiles = (self._ensure_geom(W) if self.adapt is not None
                 else self._ensure_tiles(W))
        scores = np.empty(n, np.float32)
        fired = np.empty(n, bool)
        gated = np.empty(n, bool)
        for start in range(0, n, self.chunk_size):
            chunk = frames[start:start + self.chunk_size]
            lab = (labels[start:start + self.chunk_size]
                   if labels is not None
                   else torch.zeros(chunk.shape[0], dtype=torch.int32))
            n_valid = chunk.shape[0]
            if n_valid < self.chunk_size:
                chunk = pad_frames(chunk, self.chunk_size)
                lab = torch.cat([lab, torch.zeros(self.chunk_size - n_valid,
                                                  dtype=lab.dtype)])
            s, f, g, smp, self._state = super_chunk_fn(
                chunk[None], self._state, m.B0, m.b, tiles, m.t_score,
                n_valid, lab[None], h=m.h, w=m.w, stride=m.stride,
                nonlinearity=m.nonlinearity, t_detection=self.t_detection,
                hold_frames=self.config.hold_frames, adapt=self.adapt,
                precision=self.precision, adc_lsb=self._adc_lsb,
                decim=self._decim)
            sl = slice(start, start + n_valid)
            scores[sl] = s[0, :n_valid].numpy()
            fired[sl] = f[0, :n_valid].numpy()
            gated[sl] = g[0, :n_valid].numpy()
            self._log_sampled.append(smp[0, :n_valid].numpy().copy())
            self._log_gated.append(gated[sl].copy())
            if hp_k > 0:
                raw_chunk = pad_frames(raw[start:start + self.chunk_size],
                                       self.chunk_size)
                entries, dropped = collect_hp(
                    raw_chunk[None], g, n_valid, hp_k, self.control.hp_bits,
                    base + start)
                self._hp_idx.extend(i for i, _ in entries[0])
                self._hp_frames.extend(fr for _, fr in entries[0])
                self.hp_dropped += dropped
        return scores, fired, gated


def pad_frames(chunk: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad a tail chunk ``(..., n, H, W)`` to ``size`` frames along
    its frame axis (fixed chunk shapes)."""
    n = chunk.shape[-3]
    if n == size:
        return chunk
    pad = torch.zeros((*chunk.shape[:-3], size - n, *chunk.shape[-2:]),
                      dtype=chunk.dtype, device=chunk.device)
    return torch.cat([chunk, pad], dim=-3)


def simulate_stream_batched(model: HyperSenseModel, frames, labels,
                            config: ControllerConfig | None = None, *,
                            chunk_size: int = 32,
                            t_detection: int | None = None,
                            block_d: int = 512, adc_bits: int | None = None,
                            adc_sigma: float = 0.0, adc_seed: int = 0,
                            adapt: AdaptConfig | None = None,
                            precision: str = "float32",
                            control: CaptureConfig | None = None,
                            device: str | torch.device | None = None
                            ) -> StreamStats:
    """Run a whole labeled stream through a :class:`StreamRunner` and
    return its :class:`StreamStats` (in ``"label"`` adapt mode the labels
    double as the feedback signal)."""
    runner = StreamRunner(model, config, chunk_size=chunk_size,
                          t_detection=t_detection, block_d=block_d,
                          adc_bits=adc_bits, adc_sigma=adc_sigma,
                          adc_seed=adc_seed, adapt=adapt,
                          precision=precision, control=control,
                          device=device)
    feed = (labels if adapt is not None and adapt.mode == "label"
            else None)
    _, fired, gated = runner.process(frames, labels=feed)
    return stats_from(fired, gated, labels)
