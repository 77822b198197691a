"""Intelligent Sensor Control (paper §III-B, Fig. 3-4).

NumPy-only copy of ``repro.core.sensor_control`` kept inside the port, so
that ``repro_torch`` imports nothing of the JAX package.

The control loop: a low-precision always-on path feeds the HDC HyperSense
model; its frame-level decision gates the high-precision ADC (and everything
downstream — transmission + cloud model). Generalized here to *compute
gating*: the "high-precision ADC + cloud model" can be any expensive
backend, including the LM backbones in ``repro.models``.

``SensorController`` is a small state machine with hysteresis:

* idle: sample at ``base_rate`` (e.g. 1 fps) through the low-precision path
* when HDC fires: switch the high-precision path on for ``hold`` frames
  (re-armed on every positive), i.e. the 60 fps burst the paper describes.

``simulate_stream`` replays a recorded/synthetic frame stream through the
controller and returns per-frame gate decisions + accounting used by the
energy model (Fig. 17 / Table III).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class ControllerConfig:
    base_rate_hz: float = 1.0     # low-precision always-on sampling
    active_rate_hz: float = 60.0  # high-precision burst rate when triggered
    hold_frames: int = 3          # keep HP path on for this many frames
                                  # after the last positive (hysteresis)


def decimation(config: ControllerConfig) -> int:
    """Idle-phase LP sampling period, in frames of the ``active_rate_hz``
    frame clock: the closed-loop ADC converts 1 of every ``decimation``
    frames while idle, every frame while the gate holds the burst on.
    ``base == active`` gives 1 (no subsampling — the open-loop behavior).
    """
    if config.base_rate_hz <= 0 or config.active_rate_hz <= 0:
        raise ValueError(f"rates must be positive, got "
                         f"base={config.base_rate_hz}, "
                         f"active={config.active_rate_hz}")
    if config.active_rate_hz < config.base_rate_hz:
        raise ValueError(f"active_rate_hz {config.active_rate_hz} < "
                         f"base_rate_hz {config.base_rate_hz}: the burst "
                         "rate is the stream's frame clock and cannot be "
                         "slower than the idle trickle")
    return max(1, int(round(config.active_rate_hz / config.base_rate_hz)))


@dataclass(frozen=True)
class CaptureConfig:
    """Closed-loop ADC capture policy — the runners' ``control=`` argument.

    With a ``CaptureConfig`` the gate decision at frame ``t`` modulates
    *capture* at frame ``t+1``: idle frames are temporally subsampled to
    ``ControllerConfig.base_rate_hz`` (the low-precision ADC converts one
    frame per :func:`decimation` period; skipped frames are never scored
    and can never fire), and gated frames burst at ``active_rate_hz``
    with the high-precision ADC on — HP frames are materialized into a
    bounded gather buffer as the runtime's deliverable.

    ``subsample=False`` keeps the closed-loop machinery on but converts
    every frame (bitwise-identical outputs to ``control=None``; same for
    ``base_rate_hz == active_rate_hz``). ``hp_bits`` is the burst bit
    depth (the energy model's ``adc_hp_bits``). ``hp_buffer`` bounds how
    many HP frames one chunk step can materialize (``None`` → the
    runner's ``chunk_size``; ``0`` → log-only, no frames kept).
    """
    subsample: bool = True
    hp_bits: int = 12
    hp_buffer: int | None = None


@dataclass
class CaptureLog:
    """Per-frame record of what the ADC *actually* converted.

    ``sampled``/``gated`` are ``(N,)`` (single stream) or ``(S, N)``
    (fleet) bools: ``sampled[i]`` — the low-precision ADC converted frame
    ``i`` (so the HDC gate scored it); ``gated[i]`` — the high-precision
    ADC converted it and the frame was transmitted downstream. Bit
    depths of ``None`` fall back to the billing-time
    :class:`~repro.core.energy.EnergyParams` defaults.

    This is the ground truth :func:`repro.core.energy.from_capture_log`
    bills from — Joules per conversion actually made and frame actually
    sent, replacing the duty-fraction approximation.
    """
    sampled: np.ndarray
    gated: np.ndarray
    lp_bits: int | None = None    # always-on conversion depth
    hp_bits: int | None = None    # gated burst depth
    frame_pixels: int = 0         # samples (pixel conversions) per frame

    def samples_converted(self) -> int:
        """Total ADC conversions made: LP frames + HP frames, at
        ``frame_pixels`` conversions each."""
        return int((np.asarray(self.sampled, bool).sum()
                    + np.asarray(self.gated, bool).sum())
                   * self.frame_pixels)


def assemble_capture_log(sampled_blocks, gated_blocks, *,
                         lp_bits: int | None,
                         control: CaptureConfig | None,
                         frame_pixels: int, axis: int = 0) -> CaptureLog:
    """Build a :class:`CaptureLog` from a runner's per-chunk blocks.

    The ONE place every stream front-end (``StreamRunner``,
    ``FleetRunner``, ``FleetService``) assembles its billing log, so the
    ``hp_bits`` convention cannot drift between them: ``control=None``
    (open loop) records ``hp_bits=None`` — billing-time code decides what
    that means (see :func:`repro.core.energy.from_capture_log`); a
    closed-loop runner records ``control.hp_bits``, the depth its HP
    bursts were actually converted at.

    ``axis`` is the frame axis blocks concatenate along: 0 for ``(n,)``
    single-stream blocks, 1 for ``(S, n)`` fleet blocks. With no blocks
    yet the arrays are empty with the right rank (``(0,)`` / ``(0, 0)``).
    """
    def cat(blocks):
        if blocks:
            return np.concatenate([np.asarray(b, bool) for b in blocks],
                                  axis=axis)
        return np.zeros((0,) * (axis + 1), bool)

    return CaptureLog(sampled=cat(sampled_blocks), gated=cat(gated_blocks),
                      lp_bits=lp_bits,
                      hp_bits=None if control is None else control.hp_bits,
                      frame_pixels=frame_pixels)


@dataclass
class StreamStats:
    """Per-stream gate accounting.

    ``missed_positive`` / ``false_active`` are class-conditional rates:
    on a stream with *no* frames of the conditioning class (no object
    frames / no empty frames) the rate is undefined and reported as
    ``float("nan")`` — never clamped to a perfect 0.0 score. NaN
    propagates through :func:`stats_from_batch` and
    :func:`repro.sensing.fleet.fleet_report` untouched (energy billing
    only consumes ``duty_cycle``, which is always defined).
    """
    decisions: np.ndarray         # bool (N,)  HDC fired per frame
    gated_on: np.ndarray          # bool (N,)  HP path enabled per frame
    duty_cycle: float             # fraction of frames HP path was on
    missed_positive: float        # fraction of object frames with HP off
    false_active: float           # fraction of empty frames with HP on


class SensorController:
    """Stateful gate. ``step(fired) -> bool`` (is the HP path on?)."""

    def __init__(self, config: ControllerConfig | None = None):
        self.config = config or ControllerConfig()
        self._hold = 0

    def reset(self) -> None:
        self._hold = 0

    def step(self, fired: bool) -> bool:
        if fired:
            self._hold = self.config.hold_frames
            return True
        if self._hold > 0:
            self._hold -= 1
            return True
        return False


class RateController:
    """Rate-aware stateful gate: ``step(fired) -> (sampled, gated)``.

    The closed-loop twin of :class:`SensorController`: besides the HP
    hysteresis it decides whether the low-precision ADC converts each
    frame at all. Idle, it samples one frame per :func:`decimation`
    period (``base_rate_hz`` out of the ``active_rate_hz`` frame clock);
    a skipped frame is never scored, so its ``fired`` input is ignored.
    While the gate holds a burst on, every frame is sampled. With
    ``decimation == 1`` (``base == active``, or ``subsample=False``) the
    ``gated`` output is bit-identical to :class:`SensorController`.

    :func:`repro_torch.sensing.stream.control_scan` is the jittable scan twin
    (property-tested equivalent in ``tests/test_control_loop.py``).
    """

    def __init__(self, config: ControllerConfig | None = None, *,
                 subsample: bool = True):
        self.config = config or ControllerConfig()
        self.decim = decimation(self.config) if subsample else 1
        self._hold = 0
        self._phase = 0           # frames until the next idle LP sample

    def reset(self) -> None:
        self._hold = 0
        self._phase = 0

    def step(self, fired: bool) -> tuple[bool, bool]:
        sampled = self._phase == 0 or self._hold > 0
        fired = bool(fired) and sampled
        gated = fired or self._hold > 0
        self._hold = (self.config.hold_frames if fired
                      else max(self._hold - 1, 0))
        self._phase = self.decim - 1 if sampled else self._phase - 1
        return sampled, gated


def stats_from(decisions: np.ndarray, gated: np.ndarray,
               labels: np.ndarray) -> StreamStats:
    """Accounting shared by every stream driver (frame-at-a-time and the
    chunked-batched runtime must produce identical StreamStats).

    Class-conditional rates over an empty class are undefined — reported
    as NaN, not clamped to a perfect score (see :class:`StreamStats`).
    """
    labels = np.asarray(labels).astype(bool)
    pos = int(labels.sum())
    neg = int((~labels).sum())
    return StreamStats(
        decisions=decisions,
        gated_on=gated,
        duty_cycle=float(gated.mean()),
        missed_positive=(float((labels & ~gated).sum() / pos) if pos
                         else float("nan")),
        false_active=(float((~labels & gated).sum() / neg) if neg
                      else float("nan")),
    )


def stats_from_batch(decisions: np.ndarray, gated: np.ndarray,
                     labels: np.ndarray) -> list[StreamStats]:
    """Per-stream accounting for a sensor fleet.

    ``decisions``/``gated``/``labels`` are ``(S, N)`` stacks — one row per
    sensor stream; row ``s`` gets exactly the :class:`StreamStats` an
    independent single-stream driver would have produced.
    """
    decisions = np.asarray(decisions)
    gated = np.asarray(gated)
    labels = np.asarray(labels)
    assert decisions.shape == gated.shape == labels.shape, (
        decisions.shape, gated.shape, labels.shape)
    return [stats_from(decisions[s], gated[s], labels[s])
            for s in range(decisions.shape[0])]


def simulate_stream(decide: Callable[[np.ndarray], bool],
                    frames: np.ndarray, labels: np.ndarray,
                    config: ControllerConfig | None = None) -> StreamStats:
    """Run the controller over a frame stream.

    Args:
      decide: frame -> bool, the HyperSense detection (low-precision path).
      frames: (N, H, W) low-precision frames.
      labels: (N,) bool, ground-truth object presence.
    """
    ctrl = SensorController(config)
    n = len(frames)
    decisions = np.zeros(n, dtype=bool)
    gated = np.zeros(n, dtype=bool)
    for i in range(n):
        decisions[i] = bool(decide(frames[i]))
        gated[i] = ctrl.step(decisions[i])
    return stats_from(decisions, gated, labels)
