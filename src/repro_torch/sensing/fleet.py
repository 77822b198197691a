"""Multi-sensor fleet streaming runtime on PyTorch (paper §I: escalating
sensor counts). Twin of ``repro.sensing.fleet`` on one device.

The single-stream chunked runtime (:mod:`repro_torch.sensing.stream`)
multiplied along a sensor axis without multiplying kernel launches:

* ``(S, C, H, W)`` **super-chunks** — S concurrent streams, C frames each —
  go through ONE :func:`~repro_torch.sensing.stream.super_chunk_fn` call,
  which scores the ``S*C`` frames in ONE scorer call against shared class
  tiles, or, with per-stream classifiers, against stream-indexed class
  tiles (:func:`repro_torch.kernels.ops.fragment_score_map_fleet`);
* S independent hold (and closed-loop phase) states carry across
  super-chunks, so every stream sees exactly the gating an independent
  :class:`~repro_torch.sensing.stream.StreamRunner` gives;
* the optional low-precision **ADC** sits in front of the gate; stream
  ``s`` draws its noise from :func:`stream_seed` ``(adc_seed, s)``, so it
  equals a ``StreamRunner(adc_seed=stream_seed(adc_seed, s))`` bitwise.

The reference also shards the step over a device mesh ("sensors" x
"hyperdim"); that half is not ported. Without a mesh the reference's
sensor extent is 1, so no slot is ever padded, and neither is one here.

:func:`fleet_report` turns the per-stream gate decisions into per-stream
:class:`~repro_torch.core.sensor_control.StreamStats` plus a fleet-aggregate
energy account built on :mod:`repro_torch.core.energy`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy
from repro_torch.core.hypersense import HyperSenseModel
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import (CaptureConfig, CaptureLog,
                                             ControllerConfig, StreamStats,
                                             assemble_capture_log,
                                             decimation, stats_from_batch)
from repro_torch.kernels import ops
from repro_torch.sensing import adc as adc_sim
from repro_torch.sensing import stream as stream_mod
from repro_torch.sensing.stream import (adc_view, adc_view_codes,
                                        init_stream_state, mix64,
                                        model_geometry, pad_frames,
                                        super_chunk_fn)


def stream_seed(adc_seed: int, stream: int) -> int:
    """The 32-bit ADC noise seed of stream ``stream`` of a fleet seeded
    ``adc_seed``: ``mix64(mix64(adc_seed) ^ stream)``, low 32 bits.

    A runner keeps only 32 bits of its seed (its per-frame generators are
    seeded with ``(seed, absolute frame index)``), so the stream seeds are
    32 bits wide and mix both arguments: ``adc_seed + stream`` would give
    fleet 0's stream 1 the noise of fleet 1's stream 0. Negative and wide
    integers are taken modulo 2**64.
    """
    mask = (1 << 64) - 1
    return mix64(mix64(adc_seed & mask) ^ (stream & mask)) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Per-stream stats + fleet-aggregate energy accounting."""
    stats: list[StreamStats]              # one per sensor stream
    n_frames: int                         # frames per stream
    duty_cycle: float                     # fleet-mean fraction gated on
    energy_per_frame: energy.EnergyBreakdown  # fleet-mean, HyperSense path
    energy_total_j: float                 # fleet total over all frames
    baseline_total_j: float               # always-on conventional fleet

    @property
    def n_sensors(self) -> int:
        return len(self.stats)

    @property
    def total_saving(self) -> float:
        return 1.0 - self.energy_total_j / self.baseline_total_j


def fleet_report(fired, gated, labels,
                 params: energy.EnergyParams | None = None,
                 precision: str = "float32",
                 capture: CaptureLog | None = None) -> FleetReport:
    """(S, N) gate decisions -> per-stream stats + fleet energy account.

    With a ``capture`` log (the runners maintain one) the fleet is billed
    from what the ADCs *actually* converted and transmitted
    (:func:`repro_torch.core.energy.from_capture_log`) — the primary
    account: closed-loop idle subsampling shows up as real Joules saved,
    which the duty-fraction approximation structurally cannot see. Without
    one, each stream is billed at its own *measured* duty cycle
    (:func:`repro_torch.core.energy.hypersense_measured`, every frame
    assumed LP-converted — exactly what the capture log degenerates to in
    open-loop mode). The baseline is the conventional always-on pipeline
    on every stream. ``precision`` is the datapath the gate actually ran
    on — the integer precisions bill the always-on HDC work at their
    reduced per-precision cost (``EnergyParams.hdc_*_factor``).
    """
    params = params or energy.EnergyParams()
    stats = stats_from_batch(fired, gated, labels)
    n = int(np.asarray(fired).shape[1])
    duty = float(np.mean([s.duty_cycle for s in stats]))
    if capture is not None:
        mean = energy.from_capture_log(capture, params, precision)
        total = mean.total * len(stats) * n
    else:
        per_stream = [energy.hypersense_measured(s.duty_cycle, params,
                                                 precision)
                      for s in stats]
        total = sum(b.total for b in per_stream) * n
        mean = energy.hypersense_measured(duty, params, precision)
    base = energy.conventional(params).total * len(stats) * n
    return FleetReport(stats=stats, n_frames=n, duty_cycle=duty,
                       energy_per_frame=mean, energy_total_j=float(total),
                       baseline_total_j=float(base))


class FleetRunner:
    """Stateful fleet scorer + gate (+ learner): ``process((S, n, H, W))``
    incrementally.

    Semantically S independent
    :class:`~repro_torch.sensing.stream.StreamRunner` instances, executed
    as one batched pipeline: each ``(S, chunk_size)`` super-chunk is one
    :func:`~repro_torch.sensing.stream.super_chunk_fn` call (one scorer
    wrapper call) and the ``(S,)`` hold and phase vectors carry across
    ``process`` calls. Runs on ``device`` (``None`` -> ``"cuda"``, raising
    without CUDA; pass ``"cpu"`` for the plain versions).

    ``adc_bits`` puts the simulated low-precision ADC in front of the
    gate; noise (``adc_sigma > 0``) of stream ``s`` is drawn per frame from
    generators seeded by ``(stream_seed(adc_seed, s), absolute frame
    index)``, so stream slicing stays invisible.

    ``adapt`` switches on online learning
    (:class:`~repro_torch.core.online.AdaptConfig`): ``scope="shared"``
    folds every stream's samples (in time order, the stream index breaking
    ties) into ONE fleet classifier; ``scope="per-stream"`` gives each
    sensor its own ``(S, 2, D)`` classifier, folded stream by stream and
    scored in one call through stream-indexed class tiles.

    ``control=`` (:class:`~repro_torch.core.sensor_control.CaptureConfig`)
    closes each stream's capture loop independently: idle frames are
    subsampled to ``base_rate_hz`` and gated bursts are HP-captured into
    per-stream bounded buffers (:meth:`drain_hp`). The fleet's
    :attr:`capture_log` is the ``(S, N)`` billing ground truth
    :func:`fleet_report` prefers over the duty-cycle approximation.
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
        stream_mod.validate_runner_args(chunk_size, adc_bits, adc_sigma,
                                        precision)
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
        self._frame_pixels = 0
        self._frame_hw: tuple[int, int] | None = None
        self.reset()

    def reset(self) -> None:
        self._state = None      # StreamState, allocated on first process()
        self._n_seen = 0
        self._tiles = None      # (W, class_hvs ref, tiles) — frozen path
        self._log_sampled: list[np.ndarray] = []   # (S, chunk) blocks
        self._log_gated: list[np.ndarray] = []
        self._hp: list[list] = []   # per stream: [(abs_idx, frame), ...]
        self.hp_dropped = 0

    @property
    def holds(self) -> torch.Tensor | None:
        """(S,) controller hold state after the last processed frame."""
        return None if self._state is None else self._state.holds

    @property
    def class_hvs(self) -> torch.Tensor:
        """The live classifier: ``(2, D)`` shared, ``(S, 2, D)`` per-stream
        (before the first ``process`` call: the model's)."""
        return (self.model.class_hvs if self._state is None
                else self._state.class_hvs)

    def set_class_hvs(self, class_hvs) -> None:
        """Install an externally updated classifier mid-stream.

        Accepts ``(2, D)`` (broadcast to every stream in per-stream scope)
        or ``(S, 2, D)`` in per-stream scope. The next chunk re-tiles it
        (the tile cache is keyed on tensor identity).
        """
        class_hvs = torch.as_tensor(class_hvs, dtype=torch.float32,
                                    device=self.device)
        if class_hvs.ndim == 3 and not self._per_stream():
            raise ValueError("(S, 2, D) classifiers need "
                             'adapt scope="per-stream"')
        if class_hvs.ndim == 2:
            self.model = dataclasses.replace(self.model, class_hvs=class_hvs)
        if self._state is None:
            if class_hvs.ndim == 3:
                # the stack fixes the fleet size; allocate the state now so
                # the per-stream classifiers are not silently dropped
                self._state = init_stream_state(
                    class_hvs, class_hvs.shape[0], per_stream=True)
            return  # ndim == 2: the first process() starts from the model
        carried = self._state.class_hvs.shape
        if class_hvs.ndim == 2 and len(carried) == 3:
            class_hvs = class_hvs.expand(carried).clone()
        if class_hvs.shape != carried:
            raise ValueError(f"class_hvs shape {tuple(class_hvs.shape)} != "
                             f"carried state {tuple(carried)}")
        self._state = dataclasses.replace(self._state, class_hvs=class_hvs)

    def _per_stream(self) -> bool:
        return self.adapt is not None and self.adapt.scope == "per-stream"

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
        """(S, N) record of what each stream's ADC actually converted —
        the billing ground truth :func:`fleet_report` prefers."""
        return assemble_capture_log(self._log_sampled, self._log_gated,
                                    lp_bits=self.adc_bits,
                                    control=self.control,
                                    frame_pixels=self._frame_pixels,
                                    axis=1)

    def drain_hp(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-stream HP burst deliverables captured so far.

        Returns one ``(indices (M_s,), frames (M_s, H, W))`` pair per
        stream (absolute frame indices; frames at ``control.hp_bits``)
        and empties the buffers. Per-chunk buffer overflows are counted
        fleet-wide in ``hp_dropped``. Empty drains keep the real
        ``(0, H, W)`` frame shape.
        """
        out = [stream_mod.hp_drain_arrays(entries, self._frame_hw)
               for entries in self._hp]
        self._hp = [[] for _ in self._hp]
        return out

    def _adc(self, frames: torch.Tensor) -> torch.Tensor:
        """The ADC view each stream's scorer sees: integer codes for the
        integer precisions, the float reconstruction with ``adc_bits``,
        else the frames; stream ``s`` keyed by ``stream_seed(adc_seed,
        s)``."""
        if self.precision in adc_sim.INT_PRECISIONS:
            view = adc_view_codes
        elif self.adc_bits is not None:
            view = adc_view
        else:
            return frames
        return torch.stack([
            view(frames[s], self.adc_bits, sigma=self.adc_sigma,
                 seed=stream_seed(self.adc_seed, s),
                 start_index=self._n_seen)
            for s in range(frames.shape[0])])

    def process(self, frames, labels=None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(S, n, H, W) super-stream -> ((S, n) scores, fired, gated).

        ``labels`` (``(S, n)`` ints) feed ``adapt.mode == "label"``
        updates.
        """
        frames = torch.as_tensor(frames, device=self.device)
        if frames.ndim != 4:
            raise ValueError(f"expected (S, n, H, W) frames, "
                             f"got shape {tuple(frames.shape)}")
        if frames.is_floating_point():
            frames = frames.to(torch.float32)
        S, n, H, W = frames.shape
        raw = frames
        self._frame_pixels = H * W
        self._frame_hw = (H, W)
        hp_k = stream_mod.resolve_hp_buffer(self.control, self.chunk_size,
                                            frames.dtype)
        if not self._hp:
            self._hp = [[] for _ in range(S)]
        base = self._n_seen
        if labels is not None:
            labels = torch.as_tensor(labels, dtype=torch.int32)
        if self.adapt is not None and self.adapt.mode == "label":
            if labels is None:
                raise ValueError('adapt.mode == "label" needs per-frame '
                                 "labels passed to process()")
            if labels.shape != (S, n):
                raise ValueError(f"labels shape {tuple(labels.shape)} != "
                                 f"(S, n) = {(S, n)}")
        if self._state is None:
            self._state = init_stream_state(self.model.class_hvs, S,
                                            per_stream=self._per_stream())
        elif self._state.holds.shape[0] != S:
            raise ValueError(f"fleet size changed: carried state has "
                             f"{self._state.holds.shape[0]} streams, "
                             f"got {S}")
        if self.precision in adc_sim.INT_PRECISIONS:
            ops.assert_int_datapath_fits(self.adc_bits, H, W, self.model.h,
                                         self.model.w,
                                         stride=self.model.stride)
        frames = self._adc(frames)
        self._n_seen += n

        m = self.model
        tiles = (self._ensure_geom(W) if self.adapt is not None
                 else self._ensure_tiles(W))
        scores = np.empty((S, n), np.float32)
        fired = np.empty((S, n), bool)
        gated = np.empty((S, n), bool)
        for start in range(0, n, self.chunk_size):
            chunk = frames[:, start:start + self.chunk_size]
            lab = (labels[:, start:start + self.chunk_size]
                   if labels is not None
                   else torch.zeros(chunk.shape[:2], dtype=torch.int32))
            n_valid = chunk.shape[1]
            if n_valid < self.chunk_size:
                chunk = pad_frames(chunk, self.chunk_size)
                lab = torch.cat([lab, torch.zeros(
                    (S, self.chunk_size - n_valid), dtype=lab.dtype)], 1)
            s, f, g, smp, self._state = super_chunk_fn(
                chunk, self._state, m.B0, m.b, tiles, m.t_score, n_valid,
                lab, h=m.h, w=m.w, stride=m.stride,
                nonlinearity=m.nonlinearity, t_detection=self.t_detection,
                hold_frames=self.config.hold_frames, adapt=self.adapt,
                precision=self.precision, adc_lsb=self._adc_lsb,
                decim=self._decim)
            sl = slice(start, start + n_valid)
            scores[:, sl] = s[:, :n_valid].numpy()
            fired[:, sl] = f[:, :n_valid].numpy()
            gated[:, sl] = g[:, :n_valid].numpy()
            self._log_sampled.append(smp[:, :n_valid].numpy().copy())
            self._log_gated.append(gated[:, sl].copy())
            if hp_k > 0:
                raw_chunk = pad_frames(raw[:, start:start + self.chunk_size],
                                       self.chunk_size)
                entries, dropped = stream_mod.collect_hp(
                    raw_chunk, g, n_valid, hp_k, self.control.hp_bits,
                    base + start)
                for si in range(S):
                    self._hp[si].extend(entries[si])
                self.hp_dropped += dropped
        return scores, fired, gated


def simulate_fleet(model: HyperSenseModel, frames, labels,
                   config: ControllerConfig | None = None, *,
                   chunk_size: int = 32, t_detection: int | None = None,
                   block_d: int = 512, adc_bits: int | None = None,
                   adc_sigma: float = 0.0, adc_seed: int = 0,
                   adapt: AdaptConfig | None = None,
                   energy_params: energy.EnergyParams | None = None,
                   precision: str = "float32",
                   control: CaptureConfig | None = None,
                   device: str | torch.device | None = None) -> FleetReport:
    """Run a whole ``(S, N, H, W)`` fleet recording end-to-end.

    One :class:`FleetRunner` pass followed by :func:`fleet_report`:
    per-stream :class:`StreamStats` (identical to S independent
    single-stream simulations) plus the fleet energy account, billed
    from the runner's capture log (the per-frame conversions actually
    made — with ``control=`` the closed loop's savings are real Joules
    here, not a duty-cycle estimate). ``adapt`` switches on online
    learning; in ``"label"`` mode the ground-truth ``labels`` double as
    the feedback signal.
    """
    runner = FleetRunner(model, config, chunk_size=chunk_size,
                         t_detection=t_detection, block_d=block_d,
                         adc_bits=adc_bits, adc_sigma=adc_sigma,
                         adc_seed=adc_seed, adapt=adapt,
                         precision=precision, control=control,
                         device=device)
    feed = (labels if adapt is not None and adapt.mode == "label"
            else None)
    _, fired, gated = runner.process(frames, labels=feed)
    return fleet_report(fired, gated, labels, energy_params, precision,
                        capture=runner.capture_log)
