"""Fused computation-reuse HyperSense frame scoring (float32) on PyTorch.

Twin of ``repro.kernels.sliding_scores``: one call maps a chunk of sensor
frames ``(N, H, W)`` to fragment score maps ``(N, my, mx)``, fusing the
paper's computation reuse (each input element multiplied with base
material once per base row, a running prefix sum, window differences
``P[kx*s + w] - P[kx*s]``), normalization, the RFF nonlinearity in the
unrolled orientation (bias and class tiles pre-rotated once per model) and
the classifier dot products.

:func:`fragment_scores_batch` is the wrapper: on a CUDA tensor it launches
the hand-written kernel ``csrc/sliding_scores.cu``, the same reuse as GEMMs
on the TF32 tensor cores in 3xTF32; on a CPU tensor it runs
the plain version :func:`fragment_scores_batch_plain`, which the tests hold
against the JAX package. Precompute follows the model's mutability split:
:class:`ScoreGeometry` (class-independent: slabs, bias tiles, the rotation
gather) and :func:`retile_classes` (the cheap per-classifier gather).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import pin_fp32_matmul
from repro_torch.core.encoding import SHIFT, NonLin, apply_nonlinearity
from repro_torch.kernels import _build

#: calls of the C entry (three kernel launches: window norms, scoring, the
#: fold) made by :func:`fragment_scores_batch`, one per call on a CUDA
#: tensor
LAUNCHES = 0

#: the kernel's block (``csrc/sliding_scores.cu``): hypervector columns
#: (``kBN``, the fixed partition of a D-tile into the partials that
#: ``fold_epilogue`` folds), rows (n, ky) (``kBM``) and consecutive windows
#: (``kKX``) per block
COL_TILE, ROW_TILE, WINDOWS_PER_BLOCK = 128, 64, 5

#: its K step (``kBK``) and cp.async ring depth (``kStages``)
STEP_K, _STAGES = 32, 3

#: floats a stage holds for the Hankel windows of a step's base rows
#: (``kBSlots``): 32 rows of 132 floats at ``gcd(stride, w) = 1``, the most
_B_SLOTS = STEP_K * 132

#: dynamic shared memory one H100 block may use
SMEM_LIMIT_BYTES = 232_448

NONLINEARITIES = {"rff": 0, "linear": 1, "sign": 2}


@dataclasses.dataclass(frozen=True)
class ScoreGeometry:
    """Class-independent precompute: depends only on ``(B0, b)`` and the
    frame geometry, so it survives every online classifier update."""
    slabs: torch.Tensor   # (n_dt, h, TD + W - 1) circularly padded base rows
    bias_t: torch.Tensor  # (n_dt, mx, TD) pre-rotated RFF bias tiles
    idx: torch.Tensor     # (n_dt, mx, TD) int64 rotation gather into (D,)
    block_d: int
    w: int
    stride: int


@dataclasses.dataclass(frozen=True)
class ScoreTiles:
    """Geometry + class tiles. ``cpos_t``/``cneg_t`` are ``(n_dt, mx, TD)``
    for one shared classifier, or ``(S, n_dt, mx, TD)`` with ``(S,)`` norms
    for per-stream classifiers."""
    geom: ScoreGeometry
    cpos_t: torch.Tensor
    cneg_t: torch.Tensor
    cpos_norm: torch.Tensor
    cneg_norm: torch.Tensor

    @property
    def slabs(self) -> torch.Tensor:
        return self.geom.slabs

    @property
    def bias_t(self) -> torch.Tensor:
        return self.geom.bias_t

    @property
    def block_d(self) -> int:
        return self.geom.block_d

    @property
    def w(self) -> int:
        return self.geom.w

    @property
    def stride(self) -> int:
        return self.geom.stride


def precompute_geometry(B0: torch.Tensor, b: torch.Tensor, *, W: int, w: int,
                        stride: int, block_d: int = 512) -> ScoreGeometry:
    """Once per (model geometry, frame width): slabs + bias tiles + idx.

    ``TD = block_d`` when it divides ``D``, else one ``D``-wide tile.
    """
    h, dim = B0.shape
    assert SHIFT == -1, "precompute assumes the paper's left-shift"
    td = block_d if dim % block_d == 0 else dim
    n_dt = dim // td
    mx = (W - w) // stride + 1
    pad = td + W - 1
    B0P = torch.cat([B0, B0[:, :pad]], dim=1)
    slabs = torch.stack([B0P[:, dt * td: dt * td + pad]
                         for dt in range(n_dt)])            # (n_dt,h,TD+W-1)
    dev = B0.device
    # idx[dt, kx, j] = (dt*TD + j + kx*stride) % D  (rotation by fragment col)
    idx = (torch.arange(n_dt, device=dev)[:, None, None] * td
           + torch.arange(td, device=dev)[None, None, :]
           + torch.arange(mx, device=dev)[None, :, None] * stride) % dim
    return ScoreGeometry(slabs=slabs.to(torch.float32).contiguous(),
                         bias_t=b[idx].to(torch.float32).contiguous(),
                         idx=idx, block_d=td, w=w, stride=stride)


def class_norms(c: torch.Tensor) -> torch.Tensor:
    """L2 norms of ``(..., D)`` class vectors, each taken alone on a fresh
    copy of its ``(D,)`` row: a reduction's order may depend on its
    operand's alignment and on how many norms one call takes, so this
    gives a classifier's norm the same bits alone or in a stack of
    per-stream classifiers."""
    rows = c.to(torch.float32).reshape(-1, c.shape[-1])
    return torch.stack([torch.linalg.vector_norm(r.clone())
                        for r in rows]).reshape(c.shape[:-1])


def retile_classes(geom: ScoreGeometry, class_hvs: torch.Tensor
                   ) -> ScoreTiles:
    """Install a ``(2, D)`` classifier: one gather per class + two norms."""
    cpos = class_hvs[1].to(torch.float32)
    cneg = class_hvs[0].to(torch.float32)
    return ScoreTiles(geom=geom, cpos_t=cpos[geom.idx], cneg_t=cneg[geom.idx],
                      cpos_norm=class_norms(cpos),
                      cneg_norm=class_norms(cneg))


def retile_classes_fleet(geom: ScoreGeometry, class_hvs: torch.Tensor
                         ) -> ScoreTiles:
    """Per-stream classifiers ``(S, 2, D)`` -> stacked ``(S, n_dt, mx, TD)``
    tiles with ``(S,)`` norms; the geometry stays shared. Stream ``s``'s
    tiles and norms have the bits :func:`retile_classes` gives its
    classifier."""
    cpos = class_hvs[:, 1].to(torch.float32)
    cneg = class_hvs[:, 0].to(torch.float32)
    return ScoreTiles(geom=geom, cpos_t=cpos[:, geom.idx],
                      cneg_t=cneg[:, geom.idx],
                      cpos_norm=class_norms(cpos),
                      cneg_norm=class_norms(cneg))


def precompute_tiles(B0: torch.Tensor, b: torch.Tensor,
                     class_hvs: torch.Tensor, *, W: int, w: int, stride: int,
                     block_d: int = 512) -> ScoreTiles:
    """``retile_classes(precompute_geometry(...), class_hvs)``."""
    return retile_classes(precompute_geometry(B0, b, W=W, w=w, stride=stride,
                                              block_d=block_d), class_hvs)


def window_norms_batch(frames: torch.Tensor, h: int, w: int, stride: int
                       ) -> torch.Tensor:
    """(N, my, mx) sliding-window L2 norms via a summed-area table."""
    N, H, W = frames.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    f = frames.to(torch.float32)
    sq = torch.cumsum(torch.cumsum(f * f, dim=1), dim=2)
    sq = torch.nn.functional.pad(sq, (1, 0, 1, 0))
    ky = torch.arange(my, device=frames.device)[:, None] * stride
    kx = torch.arange(mx, device=frames.device)[None, :] * stride
    win = (sq[:, ky + h, kx + w] - sq[:, ky + h, kx]
           - sq[:, ky, kx + w] + sq[:, ky, kx])
    return torch.sqrt(torch.clamp(win, min=1e-16))


def window_norms(frame: torch.Tensor, h: int, w: int, stride: int
                 ) -> torch.Tensor:
    """(my, mx) L2 norms of every sliding window of one frame."""
    return window_norms_batch(frame[None], h, w, stride)[0]


def _ordered_tile_fold(parts: torch.Tensor) -> torch.Tensor:
    """Reduce a leading tile axis with a FIXED left-to-right fold (a plain
    ``sum`` may reassociate; this keeps results bitwise run to run)."""
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def _cosine_epilogue(dpos, dneg, qq, cpos_norm, cneg_norm, per_stream: bool,
                     C: int) -> torch.Tensor:
    qn = torch.clamp(torch.sqrt(qq), min=1e-9)
    if per_stream:
        def rep(v):
            return torch.repeat_interleave(v, C)[:, None, None]
        cpos_norm, cneg_norm = rep(cpos_norm), rep(cneg_norm)
    return (dpos / (qn * torch.clamp(cpos_norm, min=1e-9))
            - dneg / (qn * torch.clamp(cneg_norm, min=1e-9)))


def _check_tiles(tiles, frames: torch.Tensor, h: int, w: int,
                 stride: int) -> None:
    W = frames.shape[-1]
    h_b, slab_len = tiles.slabs.shape[1:]
    if h_b != h or slab_len != tiles.block_d + W - 1 or tiles.w != w \
            or tiles.stride != stride:
        raise ValueError(f"tiles {tuple(tiles.slabs.shape)} (w={tiles.w}, "
                         f"stride={tiles.stride}) do not fit frames "
                         f"{tuple(frames.shape)} with h={h}, w={w}, "
                         f"stride={stride}")


def _class_layout(tiles, N: int, frames_per_stream: int | None
                  ) -> tuple[bool, int]:
    """``(per_stream, C)``: C frames per stream, ``C = N`` when shared."""
    if tiles.cpos_t.ndim != 4:
        return False, N
    if frames_per_stream is None:
        raise ValueError("per-stream class tiles need frames_per_stream")
    S = tiles.cpos_t.shape[0]
    if S * frames_per_stream != N:
        raise ValueError(f"per-stream tiles: S={S} streams x "
                         f"C={frames_per_stream} frames != batch N={N}")
    return True, frames_per_stream


def _per_frame_classes(t: torch.Tensor, per_stream: bool, C: int
                       ) -> torch.Tensor:
    """Class tiles as ``(N | 1, mx, n_dt*TD)`` rows for the plain version."""
    t = t if per_stream else t[None]
    S, n_dt, mx, td = t.shape
    t = t.permute(0, 2, 1, 3).reshape(S, mx, n_dt * td)
    return torch.repeat_interleave(t, C, dim=0) if per_stream else t


def _prefix_window_acc(x_rows, slab_rows, lo_mask, hi_mask):
    """``(N, my, mx, n_dt*TD)`` window projections of one base row as the
    difference of prefix sums ``P[kx*s + w] - P[kx*s]``; each prefix sum is
    a masked matmul over the row's ``W`` pixels."""
    n_dt, L = slab_rows.shape
    W = x_rows.shape[-1]
    S = slab_rows.unfold(-1, L - W + 1, 1)                 # (n_dt, W, TD)
    S = S.permute(1, 0, 2).reshape(W, -1)                  # (W, n_dt*TD)
    lo = (x_rows[:, :, None, :] * lo_mask) @ S
    hi = (x_rows[:, :, None, :] * hi_mask) @ S
    return hi, lo


def _window_masks(W: int, w: int, stride: int, mx: int, device, dtype):
    i = torch.arange(W, device=device)[None, :]
    k = torch.arange(mx, device=device)[:, None] * stride
    return (i < k).to(dtype), (i < k + w).to(dtype)


def fragment_scores_batch_plain(frames: torch.Tensor, tiles: ScoreTiles, *,
                                h: int, w: int, stride: int,
                                nonlinearity: NonLin = "rff",
                                frames_per_stream: int | None = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of the float kernel: ``(N, H, W)`` ->
    ``(N, my, mx)``.

    The same arithmetic form (difference of prefix sums, ``max(norm,
    1e-8)``, per-tile partials folded left to right, the ``1e-9`` cosine
    clamps), looping over the ``h`` base rows so its memory stays
    ``O(N * my * mx * D)`` at the paper's shape.
    """
    N, H, W = frames.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt = tiles.slabs.shape[0]
    td = tiles.block_d
    _check_tiles(tiles, frames, h, w, stride)
    per_stream, C = _class_layout(tiles, N, frames_per_stream)
    frames = frames.to(torch.float32)
    norms = window_norms_batch(frames, h, w, stride)           # (N, my, mx)
    lo_mask, hi_mask = _window_masks(W, w, stride, mx, frames.device,
                                     torch.float32)
    ky = torch.arange(my, device=frames.device) * stride
    acc = torch.zeros((N, my, mx, n_dt * td), device=frames.device)
    with pin_fp32_matmul():
        for r in range(h):
            hi, lo = _prefix_window_acc(frames[:, ky + r, :],
                                        tiles.slabs[:, r, :], lo_mask,
                                        hi_mask)
            acc = acc + hi - lo
    s_n = acc / torch.clamp(norms, min=1e-8)[..., None]
    bias = tiles.bias_t.permute(1, 0, 2).reshape(mx, n_dt * td)
    phi = apply_nonlinearity(s_n, bias, nonlinearity)          # (N,my,mx,D)
    cpos = _per_frame_classes(tiles.cpos_t, per_stream, C)[:, None]
    cneg = _per_frame_classes(tiles.cneg_t, per_stream, C)[:, None]

    def fold(x):  # per-tile partials, then the fixed-order tile fold
        return _ordered_tile_fold(
            x.reshape(N, my, mx, n_dt, td).sum(-1).permute(3, 0, 1, 2))

    return _cosine_epilogue(fold(phi * cpos), fold(phi * cneg),
                            fold(phi * phi), tiles.cpos_norm,
                            tiles.cneg_norm, per_stream, C)


def smem_bytes() -> int:
    """Dynamic shared memory of one scoring block (``kSmemBytes`` in
    ``csrc/sliding_scores.cu``): a ring of ``_STAGES`` K steps, each
    ``ROW_TILE`` frame rows padded to ``STEP_K + 4`` floats, the Hankel
    windows of its base rows over ``COL_TILE`` columns (``_B_SLOTS``) with
    a zero row, and its ``STEP_K`` row offsets; the running sums kept where
    windows open (``WINDOWS_PER_BLOCK - 1`` slots of 32 floats for each of
    256 threads); the epilogue's warp partials. No frame, window or tile
    width sizes it."""
    stage = ROW_TILE * (STEP_K + 4) + _B_SLOTS + COL_TILE + STEP_K
    return 4 * (_STAGES * stage + (WINDOWS_PER_BLOCK - 1) * 32 * 256
                + 4 * ROW_TILE * 3)


def _flat_norms(tiles) -> tuple[torch.Tensor, torch.Tensor]:
    def flat(v):
        return v.to(torch.float32).reshape(-1).contiguous()
    return flat(tiles.cpos_norm), flat(tiles.cneg_norm)


def _launch(frames: torch.Tensor, tiles: ScoreTiles, *, h: int, w: int,
            stride: int, nonlinearity: NonLin, C: int) -> torch.Tensor:
    """One call of the C entry: the window norms, the scoring kernel, then
    the fold."""
    N, H, W = frames.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt = tiles.slabs.shape[0]
    td = tiles.block_d
    lib = _build.load("sliding_scores")
    dev = frames.device
    frames = frames.to(torch.float32).contiguous()
    slabs = tiles.slabs if tiles.slabs.data_ptr() % 16 == 0 else \
        tiles.slabs.clone()  # the kernel copies slab rows in 16-byte chunks
    norms = torch.empty((N, my, mx), device=dev)
    cpos_norm, cneg_norm = _flat_norms(tiles)
    cpos_t = tiles.cpos_t.to(torch.float32).contiguous()
    cneg_t = tiles.cneg_t.to(torch.float32).contiguous()
    n_col_tiles = n_dt * -(-td // COL_TILE)
    partials = torch.empty((n_col_tiles, N * my * mx, 3), device=dev)
    out = torch.empty((N, my, mx), device=dev)
    args = (frames, slabs, tiles.bias_t, cpos_t, cneg_t, norms, cpos_norm,
            cneg_norm, partials, out)
    err = lib.sliding_scores_f32(
        *(a.data_ptr() for a in args), N, H, W, h, w, stride, td, n_dt, C,
        NONLINEARITIES[nonlinearity], _build.stream_ptr())
    _build.check(err, "sliding_scores_f32")
    return out


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scoring takes a CPU or CUDA tensor, got one on "
                         f"{x.device}")


def fragment_scores_batch(frames: torch.Tensor, tiles: ScoreTiles, *,
                          h: int, w: int, stride: int,
                          nonlinearity: NonLin = "rff",
                          frames_per_stream: int | None = None
                          ) -> torch.Tensor:
    """(N, H, W) frames -> (N, my, mx) score maps in one call of the C
    entry (the window norms, the scoring kernel and the fold);
    :data:`LAUNCHES` counts the calls.

    A CUDA tensor launches ``csrc/sliding_scores.cu``, a 3xTF32
    tensor-core GEMM in the paper's reuse form (or raises); a CPU
    tensor runs :func:`fragment_scores_batch_plain`. With per-stream class
    tiles (``(S, n_dt, mx, TD)``) the batch is S streams of
    ``frames_per_stream`` frames each: frame ``n`` is scored against stream
    ``n // C``'s classifier, still in one launch.
    """
    global LAUNCHES
    _check_device(frames)
    if frames.device.type == "cpu":
        return fragment_scores_batch_plain(
            frames, tiles, h=h, w=w, stride=stride,
            nonlinearity=nonlinearity, frames_per_stream=frames_per_stream)
    _check_tiles(tiles, frames, h, w, stride)
    _, C = _class_layout(tiles, frames.shape[0], frames_per_stream)
    out = _launch(frames, tiles, h=h, w=w, stride=stride,
                  nonlinearity=nonlinearity, C=C)
    LAUNCHES += 1
    return out


def fragment_scores(frame: torch.Tensor, tiles: ScoreTiles, *, h: int,
                    w: int, stride: int, nonlinearity: NonLin = "rff"
                    ) -> torch.Tensor:
    """Frame -> (my, mx) fragment score map (sim(pos) - sim(neg))."""
    return fragment_scores_batch(frame[None], tiles, h=h, w=w, stride=stride,
                                 nonlinearity=nonlinearity)[0]
