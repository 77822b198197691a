"""Synthetic radar-like frames on PyTorch (the CRUW stand-in).

The port's twin of ``repro.sensing.synthetic``: frames with the geometry of
128x128 range-azimuth maps and the statistics the paper's claims rest on:

* background: speckle (Rayleigh magnitude, as in coherent radar) plus a
  range-dependent gain ramp;
* objects: Gaussian blobs (point-target responses smeared by the antenna
  pattern) of random intensity and anisotropic width, with azimuth
  sidelobe streaks;
* streams: objects appear in bursts and move on linear tracks; drifted
  streams ramp the background gain, the speckle scale and the object
  intensity across the stream.

Randomness comes from an explicit ``torch.Generator`` and is drawn on its
device, a whole batch of frames at a time (the reference renders under
``vmap``). Its numbers are not ``jax.random``'s, so the tests hold the draws
by their statistics, and the parts that take no randomness (:func:`_blob`,
:func:`drift_schedule`, :func:`_paint_tracks` given the same events)
against the reference. Results are moved to ``device`` (``None`` -> the
card, raising without one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class RadarConfig:
    height: int = 128
    width: int = 128
    noise_sigma: float = 0.12       # Rayleigh scale of speckle background
    min_objects: int = 1
    max_objects: int = 3
    blob_sigma_lo: float = 2.0      # point-target response width (pixels)
    blob_sigma_hi: float = 6.0
    intensity_lo: float = 0.45
    intensity_hi: float = 1.0
    sidelobe_gain: float = 0.15     # azimuth streak amplitude
    range_ramp: float = 0.08        # range-dependent background gain


def _speckle_drift(generator: torch.Generator, cfg: RadarConfig,
                   sigma: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """``(n, H, W)`` parametric speckle on the generator's device: frame
    ``i`` at noise scale ``sigma[i]`` plus the range ramp and an additive
    background ``gain[i]``."""
    n, dev = sigma.shape[0], generator.device
    shape = (n, cfg.height, cfg.width)
    re = torch.randn(shape, generator=generator, device=dev)
    im = torch.randn(shape, generator=generator, device=dev)
    mag = sigma[:, None, None] * torch.sqrt(re * re + im * im)
    ramp = cfg.range_ramp * (1.0 - torch.linspace(0, 1, cfg.height,
                                                  device=dev))[:, None]
    return mag + ramp + gain[:, None, None]


def _speckle(generator: torch.Generator, n: int, cfg: RadarConfig
             ) -> torch.Tensor:
    """``(n, H, W)`` Rayleigh background at ``cfg.noise_sigma`` plus the
    range ramp (:func:`_speckle_drift` at a constant scale and no gain)."""
    dev = generator.device
    return _speckle_drift(generator, cfg,
                          torch.full((n,), cfg.noise_sigma, device=dev),
                          torch.zeros(n, device=dev))


def _blob(cfg: RadarConfig, cy: torch.Tensor, cx: torch.Tensor,
          sy: torch.Tensor, sx: torch.Tensor, amp: torch.Tensor
          ) -> torch.Tensor:
    """Blobs with their azimuth streaks: per-blob ``(...)`` centres, widths
    and amplitudes (float32) -> ``(..., H, W)``."""
    dev = cy.device
    yy = torch.arange(cfg.height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(cfg.width, dtype=torch.float32, device=dev)[None, :]
    cy, cx, sy, sx, amp = (v[..., None, None] for v in (cy, cx, sy, sx, amp))
    g = torch.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2) / 2.0)
    # azimuth sidelobe streak (radar antenna pattern artifact)
    streak = torch.exp(-(((yy - cy) / sy) ** 2) / 2.0) * cfg.sidelobe_gain \
        * torch.exp(-torch.abs(xx - cx) / (6.0 * sx))
    return amp * (g + streak)


def _render(generator: torch.Generator, objects: torch.Tensor,
            cfg: RadarConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``(n, H, W)`` frames and object masks on the generator's device;
    frame ``i`` carries ``min_objects..max_objects`` blobs where
    ``objects[i]``, none elsewhere. The mask marks the blob centres (for
    positive-fragment sampling)."""
    n, dev = objects.shape[0], generator.device
    frames = _speckle(generator, n, cfg)
    k = cfg.max_objects
    count = torch.randint(cfg.min_objects, k + 1, (n,), generator=generator,
                          device=dev)
    u = torch.rand((5, k, n), generator=generator, device=dev)
    yy = torch.arange(cfg.height, device=dev)[:, None]
    xx = torch.arange(cfg.width, device=dev)[None, :]
    masks = torch.zeros((n, cfg.height, cfg.width), device=dev)
    for i in range(k):
        cy = 8 + (cfg.height - 16) * u[0, i]
        cx = 8 + (cfg.width - 16) * u[1, i]
        sy, sx = (cfg.blob_sigma_lo
                  + (cfg.blob_sigma_hi - cfg.blob_sigma_lo) * u[j, i]
                  for j in (2, 3))
        amp = cfg.intensity_lo + (cfg.intensity_hi - cfg.intensity_lo) \
            * u[4, i]
        on = ((i < count) & objects).to(torch.float32)[:, None, None]
        frames = frames + on * _blob(cfg, cy, cx, sy, sx, amp)
        hit = ((torch.abs(yy - cy[:, None, None]) < 2 * sy[:, None, None])
               & (torch.abs(xx - cx[:, None, None]) < 2 * sx[:, None, None]))
        masks = torch.maximum(masks, on * hit.to(torch.float32))
    return torch.clamp(frames, 0.0, 1.5), masks


def render_frame(generator: torch.Generator, cfg: RadarConfig,
                 with_object: bool, *,
                 device: str | torch.device | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame and its object mask ``(H, W)`` (empty without an
    object)."""
    out = resolve_device(device)
    objects = torch.tensor([with_object], device=generator.device)
    frames, masks = _render(generator, objects, cfg)
    return frames[0].to(out), masks[0].to(out)


def make_dataset(generator: torch.Generator, n_frames: int,
                 cfg: RadarConfig | None = None, p_object: float = 0.5, *,
                 device: str | torch.device | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Balanced frame dataset ``(frames, masks, labels)``: exactly
    ``int(n_frames * p_object)`` frames, in random order, carry objects
    (``labels[i] = 1``, int32)."""
    cfg = cfg or RadarConfig()
    out = resolve_device(device)
    dev = generator.device
    labels = torch.arange(n_frames, device=dev) < int(n_frames * p_object)
    labels = labels[torch.randperm(n_frames, generator=generator, device=dev)]
    frames, masks = _render(generator, labels, cfg)
    return frames.to(out), masks.to(out), labels.to(torch.int32).to(out)


def _event_tracks(generator: torch.Generator, n_frames: int,
                  cfg: RadarConfig, event_prob: float, event_len: int,
                  margin_y: int, margin_x: int) -> tuple[np.ndarray, list]:
    """Shared event machinery: bursts of ``event_len`` frames on linear
    tracks. Returns ``(labels (N,) int32, events [(start, len, cy, cx, vy,
    vx)])``. Frame ``i``'s five uniforms (one copy to the host) decide
    whether an event starts there and, if so, its start and velocity."""
    u = torch.rand((n_frames, 5), generator=generator, dtype=torch.float64,
                   device=generator.device).cpu().numpy()
    labels = np.zeros(n_frames, dtype=np.int32)
    events = []
    i = 0
    while i < n_frames:
        if u[i, 0] < event_prob:
            length = min(event_len, n_frames - i)
            labels[i:i + length] = 1
            events.append((i, length,
                           margin_y + (cfg.height - 2 * margin_y) * u[i, 1],
                           margin_x + (cfg.width - 2 * margin_x) * u[i, 2],
                           -3 + 6 * u[i, 3], -3 + 6 * u[i, 4]))
            i += length
        else:
            i += 1
    return labels, events


def _paint_tracks(frames: torch.Tensor, events: list, cfg: RadarConfig,
                  amps) -> torch.Tensor:
    """``frames`` with the tracked object blobs added (amplitude ``amps[i]``
    at absolute frame ``i``), all blobs rendered at once. Events never
    overlap, so each frame gets at most one blob, in one add."""
    idx, fy, fx = [], [], []
    for (start, length, cy, cx, vy, vx) in events:
        for t in range(length):
            idx.append(start + t)
            fy.append(min(max(cy + vy * t, 6), cfg.height - 6))
            fx.append(min(max(cx + vx * t, 6), cfg.width - 6))
    if not idx:
        return frames
    dev = frames.device
    idx_t = torch.tensor(idx, device=dev)
    amp = torch.as_tensor(amps, dtype=torch.float32).to(dev)[idx_t]
    three = torch.full((len(idx),), 3.0, device=dev)
    blobs = _blob(cfg, torch.tensor(fy, dtype=torch.float64).to(dev).float(),
                  torch.tensor(fx, dtype=torch.float64).to(dev).float(),
                  three, three, amp)
    out = frames.clone()
    out[idx_t] = out[idx_t] + blobs
    return out


def make_stream(generator: torch.Generator, n_frames: int,
                cfg: RadarConfig | None = None, event_prob: float = 0.05,
                event_len: int = 12, *,
                device: str | torch.device | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporal stream with object *tracks*: objects appear in bursts of
    ``event_len`` frames and move on a linear track, the regime where
    activity of interest is infrequent. Returns ``(frames (N, H, W),
    labels (N,) int32)``."""
    cfg = cfg or RadarConfig()
    out = resolve_device(device)
    labels, events = _event_tracks(generator, n_frames, cfg, event_prob,
                                   event_len, 16, 16)
    frames = _paint_tracks(_speckle(generator, n_frames, cfg), events, cfg,
                           np.full(n_frames, 0.8, np.float32))
    return (torch.clamp(frames, 0.0, 1.5).to(out),
            torch.from_numpy(labels).to(out))


# ---------------------------------------------------------------------------
# Distribution drift (online-learning scenarios)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DriftConfig:
    """Linear distribution drift across a stream (start -> end values):

    * ``background_gain`` — an additive DC background offset ramping up
      (sensor bias, changing ambient return);
    * ``noise_sigma`` — the speckle scale drifting (weather, RF
      interference);
    * ``object_intensity`` — the object blob amplitude drifting (target
      distance, RCS).

    Each is ``(start, end)``, linearly interpolated over the stream.
    ``None`` spans keep the un-drifted value (``cfg.noise_sigma``,
    :func:`make_stream`'s 0.8 blob amplitude), so the default config gives
    :func:`make_stream`'s statistics for any ``RadarConfig``.
    """
    background_gain: tuple[float, float] = (0.0, 0.0)
    noise_sigma: tuple[float, float] | None = None
    object_intensity: tuple[float, float] | None = None


def drift_schedule(n_frames: int, span: tuple[float, float]) -> np.ndarray:
    """Per-frame linearly interpolated drift values ``(n_frames,)``
    float32."""
    return np.linspace(span[0], span[1], n_frames).astype(np.float32)


def make_drift_stream(generator: torch.Generator, n_frames: int,
                      cfg: RadarConfig | None = None,
                      drift: DriftConfig | None = None,
                      event_prob: float = 0.05, event_len: int = 12, *,
                      device: str | torch.device | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`make_stream` under distribution drift: the same bursts on
    linear tracks, with the background gain, speckle scale and object
    intensity following ``drift``'s linear schedules. A model trained on
    the early (clean) statistics degrades toward the end of the stream.
    From the same generator state and at frames of at least 48x48 (where
    the track margins agree), a default ``drift`` gives
    :func:`make_stream`'s frames and labels bit for bit.

    Returns ``(frames (N, H, W), labels (N,) int32)``.
    """
    cfg = cfg or RadarConfig()
    drift = drift or DriftConfig()
    out = resolve_device(device)
    dev = generator.device
    sigma_span = (drift.noise_sigma if drift.noise_sigma is not None
                  else (cfg.noise_sigma, cfg.noise_sigma))
    amp_span = (drift.object_intensity
                if drift.object_intensity is not None else (0.8, 0.8))
    # track-start margin: make_stream's 16 px, shrunk for small frames
    labels, events = _event_tracks(generator, n_frames, cfg, event_prob,
                                   event_len, min(16, cfg.height // 3),
                                   min(16, cfg.width // 3))
    gains = torch.from_numpy(drift_schedule(n_frames,
                                            drift.background_gain)).to(dev)
    sigmas = torch.from_numpy(drift_schedule(n_frames, sigma_span)).to(dev)
    bg = _speckle_drift(generator, cfg, sigmas, gains)
    frames = _paint_tracks(bg, events, cfg,
                           drift_schedule(n_frames, amp_span))
    return (torch.clamp(frames, 0.0, 1.5).to(out),
            torch.from_numpy(labels).to(out))
