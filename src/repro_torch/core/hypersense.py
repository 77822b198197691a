"""The *HyperSense model* — frame-level detection (paper §III-C b, Fig. 5b).

Twin of ``repro.core.hypersense``. Given class hypervectors, the
permutation generators ``B0`` and three hyperparameters (``stride``,
``t_score``, ``t_detection``): score every sliding-window fragment, and
call the frame positive iff more than ``t_detection`` fragment scores
exceed ``t_score``. For a fixed ``T = t_detection`` that is equivalent to
``kth_largest(scores, T+1) > t_score``, so the frame detection score is
the (T+1)-th order statistic and standard ROC analysis applies.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hdc
from repro_torch.core.encoding import (NonLin, encode_frame_naive,
                                       encode_frame_reuse, num_windows)
from repro_torch.core.fragment_model import FragmentModel
from repro_torch.kernels import ops
from repro_torch.sensing import adc as adc_sim


@dataclasses.dataclass(frozen=True)
class HyperSenseModel:
    """Frame detector = class hypervectors + base + (h, w, stride, t_score,
    t_detection). ``B0`` is the ``(h, D)`` permutation-generator base."""
    class_hvs: torch.Tensor   # (2, D)
    B0: torch.Tensor          # (h, D)
    b: torch.Tensor           # (D,)
    h: int
    w: int
    stride: int
    t_score: float
    t_detection: int
    nonlinearity: NonLin = "rff"

    @property
    def device(self) -> torch.device:
        return self.B0.device

    def to(self, device: str | torch.device) -> "HyperSenseModel":
        """The same model with its tensors on ``device``."""
        return dataclasses.replace(self, class_hvs=self.class_hvs.to(device),
                                   B0=self.B0.to(device), b=self.b.to(device))


def from_fragment_model(model: FragmentModel, B0: torch.Tensor, *, h: int,
                        w: int, stride: int, t_score: float = 0.0,
                        t_detection: int = 0, nonlinearity: NonLin = "rff"
                        ) -> HyperSenseModel:
    """Assemble a HyperSense model from a trained Fragment model and its
    ``(h, D)`` permutation generators (no further training, paper
    §III-C)."""
    return HyperSenseModel(model.class_hvs, B0, model.b, h, w, stride,
                           t_score, t_detection, nonlinearity)


def fragment_score_map(frame: torch.Tensor, class_hvs: torch.Tensor,
                       B0: torch.Tensor, b: torch.Tensor, *, h: int, w: int,
                       stride: int, nonlinearity: NonLin = "rff",
                       reuse: bool = True) -> torch.Tensor:
    """Score every sliding-window fragment of one frame -> ``(my, mx)``
    through the oracle encoders (reuse or naive) and the cosine classifier.
    The batched hot path is :func:`frame_scores_batch` (the kernels)."""
    enc = encode_frame_reuse if reuse else encode_frame_naive
    hv = enc(frame, B0, b, h=h, w=w, stride=stride,
             nonlinearity=nonlinearity)                      # (my, mx, D)
    my, mx, dim = hv.shape
    s = hdc.class_scores(hv.reshape(my * mx, dim), class_hvs)
    return (s[:, 1] - s[:, 0]).reshape(my, mx)


def score_frame(model: HyperSenseModel, frame: torch.Tensor, *,
                reuse: bool = True) -> torch.Tensor:
    return fragment_score_map(
        frame, model.class_hvs, model.B0, model.b, h=model.h, w=model.w,
        stride=model.stride, nonlinearity=model.nonlinearity, reuse=reuse)


def detect(model: HyperSenseModel, frame: torch.Tensor) -> torch.Tensor:
    """Boolean frame-level decision (paper steps 8-9)."""
    s = score_frame(model, frame)
    return torch.sum(s > model.t_score) > model.t_detection


def frame_detection_score(scores: torch.Tensor,
                          t_detection: int | torch.Tensor) -> torch.Tensor:
    """The (t_detection+1)-th largest fragment score of each ``(my, mx)``
    map: ``scores (..., my, mx) -> (...)``.

    ``torch.topk`` of ``T+1`` for an integer ``t_detection``; a tensor
    ``t_detection`` falls back to a full descending sort.
    """
    flat = scores.reshape(*scores.shape[:-2], -1)
    n = flat.shape[-1]
    if isinstance(t_detection, torch.Tensor):
        k = torch.clamp(t_detection, max=n - 1).to(torch.int64)
        ordered = torch.sort(flat, dim=-1, descending=True).values
        return ordered.index_select(-1, k.reshape(1)).squeeze(-1)
    k = min(int(t_detection), n - 1)
    return torch.topk(flat, k + 1, dim=-1).values[..., k]


def _as_frames(frames, device: torch.device) -> torch.Tensor:
    """Frames (numpy or tensor) on ``device``: floats as float32, integer
    codes kept in their own dtype."""
    frames = torch.as_tensor(frames, device=device)
    return frames.to(torch.float32) if frames.is_floating_point() else frames


def frame_scores_batch(model: HyperSenseModel, frames,
                       t_detection: int | None = None, *, tiles=None,
                       precision: str = "float32",
                       adc_bits: int = 8) -> torch.Tensor:
    """Frame-level ROC scores for ``(N, H, W)`` frames -> ``(N,)``, on the
    model's device, in ONE scoring launch.

    The integer precisions (``"int8"``, ``"int4"``, ``"binary"``) run the
    integer-code datapath: ``frames`` may be raw integer ADC codes or
    floats (quantized to ``adc_bits`` codes first). ``tiles`` must then
    come from :func:`repro_torch.kernels.ops.precompute_tiles_int` with the
    matching ``mode``. ``"int4"`` needs ``adc_bits <= 4`` and an even frame
    width; its codes are nibble-packed at the kernel boundary.
    """
    td = model.t_detection if t_detection is None else t_detection
    frames = _as_frames(frames, model.device)
    if precision not in adc_sim.PRECISIONS:
        raise ValueError(f"precision must be one of {adc_sim.PRECISIONS}, "
                         f"got {precision!r}")
    if precision in adc_sim.INT_PRECISIONS:
        if precision == "int4" and adc_bits > 4:
            raise ValueError(
                f"precision='int4' packs two codes per byte, so adc_bits "
                f"must be <= 4 (got {adc_bits})")
        if frames.is_floating_point():
            codes = adc_sim.pack_codes(
                adc_sim.quantize_codes(frames, adc_bits), adc_bits)
        else:
            adc_sim.check_codes_range(frames, adc_bits)
            codes = frames
        packed = precision == "int4"
        ops.assert_int_datapath_fits(adc_bits, *codes.shape[-2:], model.h,
                                     model.w, stride=model.stride)
        if tiles is None:
            tiles = ops.precompute_tiles_int(
                model.B0, model.b, model.class_hvs, W=codes.shape[-1],
                w=model.w, stride=model.stride,
                mode="binary" if precision == "binary" else "int8")
        if packed:
            codes = adc_sim.pack_nibbles(codes)
        maps = ops.fragment_score_map_batch_int(
            codes, model.class_hvs, model.B0, model.b, h=model.h, w=model.w,
            stride=model.stride, nonlinearity=model.nonlinearity,
            tiles=tiles, packed=packed)
    else:
        maps = ops.fragment_score_map_batch(
            frames, model.class_hvs, model.B0, model.b, h=model.h,
            w=model.w, stride=model.stride, nonlinearity=model.nonlinearity,
            tiles=tiles)
    return frame_detection_score(maps, td)


def detect_batch(model: HyperSenseModel, frames, *, tiles=None
                 ) -> torch.Tensor:
    """Vectorized detection over ``(N, H, W)`` frames -> ``(N,)`` bool,
    through :func:`frame_scores_batch`. With ``T >= my*mx`` the count can
    never exceed ``T``, so nothing fires."""
    frames = _as_frames(frames, model.device)
    N, H, W = frames.shape
    my = num_windows(H, model.h, model.stride)
    mx = num_windows(W, model.w, model.stride)
    if model.t_detection >= my * mx:
        return torch.zeros(N, dtype=torch.bool, device=frames.device)
    return frame_scores_batch(model, frames, tiles=tiles) > model.t_score
