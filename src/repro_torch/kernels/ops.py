"""Public kernel dispatch and precompute re-exports, twin of
``repro.kernels.ops``.

Each entry point runs where its tensors live: on the card through the
hand-written kernels, on the CPU through their plain versions. The
fragment encoder (:func:`hdc_encode`, ``csrc/hdc_encode.cu``) and the
cosine classifier (:func:`similarity`, ``csrc/similarity.cu``) serve the
training path; the scorers (``csrc/sliding_scores*.cu``) the stream.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import NonLin, normalize_flat
from repro_torch.kernels import hdc_encode as _enc
from repro_torch.kernels import similarity as _sim
from repro_torch.kernels import sliding_scores as _ss
from repro_torch.kernels import sliding_scores_int as _ssi


def hdc_encode(x: torch.Tensor, B: torch.Tensor, b: torch.Tensor, *,
               nonlinearity: NonLin = "rff", normalize: bool = True,
               block_n: int = 128, block_d: int = 512,
               block_k: int = 512) -> torch.Tensor:
    """Normalize + project + nonlinearity through the encode kernel:
    ``(N, h, w)`` or ``(N, K)`` fragments -> ``(N, D)``. Rows are
    L2-normalized (``max(norm, 1e-8)``) before the kernel."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if normalize:
        x = normalize_flat(x)
    return _enc.hdc_encode(x, B, b, nonlinearity=nonlinearity,
                           block_n=block_n, block_d=block_d,
                           block_k=block_k)


def similarity(queries: torch.Tensor, class_hvs: torch.Tensor, *,
               block_n: int = 256, block_d: int = 1024) -> torch.Tensor:
    """Cosine class scores ``(N, D), (C, D) -> (N, C)`` through the
    similarity kernel."""
    return _sim.similarity(queries, class_hvs, block_n=block_n,
                           block_d=block_d)


precompute_tiles = _ss.precompute_tiles
precompute_geometry = _ss.precompute_geometry
retile_classes = _ss.retile_classes
retile_classes_fleet = _ss.retile_classes_fleet
ScoreTiles = _ss.ScoreTiles
ScoreGeometry = _ss.ScoreGeometry

precompute_tiles_int = _ssi.precompute_tiles_int
precompute_geometry_int = _ssi.precompute_geometry_int
retile_classes_int = _ssi.retile_classes_int
retile_classes_int_fleet = _ssi.retile_classes_int_fleet
IntScoreTiles = _ssi.IntScoreTiles
IntScoreGeometry = _ssi.IntScoreGeometry
assert_int_datapath_fits = _ssi.assert_int_datapath_fits
int_datapath_bounds = _ssi.int_datapath_bounds


def fragment_score_map(frame: torch.Tensor, class_hvs: torch.Tensor,
                       B0: torch.Tensor, b: torch.Tensor, *, h: int, w: int,
                       stride: int, nonlinearity: NonLin = "rff",
                       tiles: _ss.ScoreTiles | None = None,
                       block_d: int = 512) -> torch.Tensor:
    """Frame -> (my, mx) detection-score map via the reuse kernel."""
    if tiles is None:
        tiles = _ss.precompute_tiles(B0, b, class_hvs, W=frame.shape[-1],
                                     w=w, stride=stride, block_d=block_d)
    return _ss.fragment_scores(frame, tiles, h=h, w=w, stride=stride,
                               nonlinearity=nonlinearity)


def fragment_score_map_batch(frames: torch.Tensor, class_hvs: torch.Tensor,
                             B0: torch.Tensor, b: torch.Tensor, *, h: int,
                             w: int, stride: int,
                             nonlinearity: NonLin = "rff",
                             tiles: _ss.ScoreTiles | None = None,
                             block_d: int = 512) -> torch.Tensor:
    """(N, H, W) frames -> (N, my, mx) score maps in ONE kernel launch.
    Pass ``tiles`` to pay the precompute once across chunks."""
    if tiles is None:
        tiles = _ss.precompute_tiles(B0, b, class_hvs, W=frames.shape[-1],
                                     w=w, stride=stride, block_d=block_d)
    return _ss.fragment_scores_batch(frames, tiles, h=h, w=w, stride=stride,
                                     nonlinearity=nonlinearity)


def fragment_score_map_batch_int(codes: torch.Tensor,
                                 class_hvs: torch.Tensor, B0: torch.Tensor,
                                 b: torch.Tensor, *, h: int, w: int,
                                 stride: int, nonlinearity: NonLin = "rff",
                                 tiles: _ssi.IntScoreTiles | None = None,
                                 block_d: int = 512, packed: bool = False,
                                 mode: str = "int8") -> torch.Tensor:
    """(N, H, W) integer ADC codes -> (N, my, mx) score maps, ONE launch.
    ``packed`` marks int4 wire codes ``(N, H, W/2)``; ``mode`` picks the
    quantization when ``tiles`` is built here."""
    if tiles is None:
        W = codes.shape[-1] * (2 if packed else 1)
        tiles = _ssi.precompute_tiles_int(B0, b, class_hvs, W=W, w=w,
                                          stride=stride, block_d=block_d,
                                          mode=mode)
    return _ssi.fragment_scores_batch_int(codes, tiles, h=h, w=w,
                                          stride=stride,
                                          nonlinearity=nonlinearity,
                                          packed=packed)


def fragment_score_map_fleet(frames: torch.Tensor, class_hvs: torch.Tensor,
                             B0: torch.Tensor, b: torch.Tensor, *, h: int,
                             w: int, stride: int,
                             nonlinearity: NonLin = "rff",
                             tiles: _ss.ScoreTiles | None = None,
                             block_d: int = 512,
                             hyperdim_group=None) -> torch.Tensor:
    """(S, C, H, W) super-chunk -> (S, C, my, mx) score maps, ONE launch;
    per-stream class tiles (``cpos_t.ndim == 4``) score stream ``s``'s
    frames against its own classifier. ``hyperdim_group`` splits D at the
    tile fold (``tiles`` hold this rank's D-tiles;
    :func:`~repro_torch.kernels.sliding_scores.fragment_scores_batch`)."""
    S, C, H, W = frames.shape
    flat = frames.reshape(S * C, H, W)
    if tiles is None:
        tiles = _ss.precompute_tiles(B0, b, class_hvs, W=W, w=w,
                                     stride=stride, block_d=block_d)
    maps = _ss.fragment_scores_batch(
        flat, tiles, h=h, w=w, stride=stride, nonlinearity=nonlinearity,
        frames_per_stream=C if tiles.cpos_t.ndim == 4 else None,
        hyperdim_group=hyperdim_group)
    return maps.reshape(S, C, *maps.shape[1:])


def fragment_score_map_fleet_int(codes: torch.Tensor,
                                 class_hvs: torch.Tensor, B0: torch.Tensor,
                                 b: torch.Tensor, *, h: int, w: int,
                                 stride: int, nonlinearity: NonLin = "rff",
                                 tiles: _ssi.IntScoreTiles | None = None,
                                 block_d: int = 512, packed: bool = False,
                                 mode: str = "int8",
                                 hyperdim_group=None) -> torch.Tensor:
    """(S, C, H, W[/2]) code super-chunk -> (S, C, my, mx), ONE launch;
    ``hyperdim_group`` as in :func:`fragment_score_map_fleet`."""
    S, C, H, Wc = codes.shape
    flat = codes.reshape(S * C, H, Wc)
    if tiles is None:
        tiles = _ssi.precompute_tiles_int(
            B0, b, class_hvs, W=Wc * (2 if packed else 1), w=w,
            stride=stride, block_d=block_d, mode=mode)
    maps = _ssi.fragment_scores_batch_int(
        flat, tiles, h=h, w=w, stride=stride, nonlinearity=nonlinearity,
        frames_per_stream=C if tiles.cpos_t.ndim == 4 else None,
        packed=packed, hyperdim_group=hyperdim_group)
    return maps.reshape(S, C, *maps.shape[1:])
