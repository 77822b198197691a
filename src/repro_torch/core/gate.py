"""HyperSenseGate: the paper's technique as a compute front end, on PyTorch.

The port's twin of ``repro.core.gate``. It generalizes Intelligent Sensor
Control (paper §III-B) from gating an ADC to gating any expensive backend:
frames that the HDC model rejects never enter the backend's batch, so the
backend's FLOPs scale with the duty cycle exactly as the paper's
high-precision ADC energy does.

The reference decides frame by frame. The port decides all the frames of
a call with one :func:`~repro_torch.core.hypersense.detect_batch` (one
scoring launch on the card; the scorers give a frame the same bits at any
batch position) and one copy of the decisions to the host, then steps the
controller over them in stream order: the same decisions, the same
hysteresis, the same indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hypersense
from repro_torch.core.sensor_control import ControllerConfig, SensorController
from repro_torch.kernels import ops


@dataclass
class GateStats:
    n_seen: int = 0
    n_passed: int = 0

    @property
    def duty_cycle(self) -> float:
        return self.n_passed / max(self.n_seen, 1)


class HyperSenseGate:
    """Stateful stream gate: ``select(frames) -> indices`` of the frames the
    backend should process (controller hysteresis included). Frames are
    scored on the model's device: the kernels on the card, their plain
    versions on the CPU."""

    def __init__(self, model: hypersense.HyperSenseModel,
                 controller: ControllerConfig | None = None):
        self.model = model
        self.controller = SensorController(controller)
        self.stats = GateStats()
        self._tiles: dict[int, ops.ScoreTiles] = {}

    def decide(self, frames) -> np.ndarray:
        """``(N,)`` bool: the HDC detection of each of ``(N, H, W)`` frames,
        before the controller. One scoring launch; the float tiles are made
        once per frame width."""
        W = frames.shape[-1]
        if W not in self._tiles:
            m = self.model
            self._tiles[W] = ops.precompute_tiles(m.B0, m.b, m.class_hvs,
                                                  W=W, w=m.w,
                                                  stride=m.stride)
        fired = hypersense.detect_batch(self.model, frames,
                                        tiles=self._tiles[W])
        return fired.cpu().numpy()

    def select(self, frames) -> np.ndarray:
        """Indices of gated-on frames, in stream order."""
        return self.select_fired(self.decide(frames))

    def select_fired(self, fired: np.ndarray) -> np.ndarray:
        """The controller's half of :meth:`select`: indices of the gated-on
        frames of a call whose HDC decisions are ``fired``, stepping the
        controller in stream order."""
        keep = []
        for i, f in enumerate(fired):
            on = self.controller.step(bool(f))
            self.stats.n_seen += 1
            if on:
                self.stats.n_passed += 1
                keep.append(i)
        return np.asarray(keep, dtype=np.int64)

    def filter(self, frames, payloads=None):
        """Gate a stream; returns ``(kept_payloads, kept_indices)``.

        ``payloads`` default to the frames themselves: pass the
        high-precision captures (or token batches) the backend consumes. A
        tensor stays a tensor on its device; anything else is indexed as a
        numpy array.
        """
        idx = self.select(frames)
        src = frames if payloads is None else payloads
        if isinstance(src, torch.Tensor):
            return src[torch.from_numpy(idx).to(src.device)], idx
        return np.asarray(src)[idx], idx


def backend_flops_saved(stats: GateStats, flops_per_item: float) -> dict:
    """Backend-compute accounting mirroring the paper's energy table."""
    full = stats.n_seen * flops_per_item
    used = stats.n_passed * flops_per_item
    return {"duty_cycle": stats.duty_cycle,
            "backend_flops_full": full,
            "backend_flops_gated": used,
            "backend_saving": 1.0 - used / max(full, 1.0)}
