"""Low-precision integer HyperSense frame scoring on PyTorch.

Twin of ``repro.kernels.sliding_scores_int``: raw integer ADC codes flow
into the scoring kernel untouched, every fragment projection accumulates
exactly in int32, and floats appear only in the similarity epilogue. Base
slabs are int8-quantized at one shared scale (``mode="int8"``) or
sign-quantized to +-1 at ``scale = mean |slab|`` (``mode="binary"``); the
ADC LSB cancels in the window normalization and the per-class scale in the
cosine, so int scores live on the float path's scale. ``packed=True``
consumes the int4 wire format (two codes per byte, low nibble first).

:func:`fragment_scores_batch_int` is the wrapper: a CUDA tensor launches
``csrc/sliding_scores_int.cu``, an int8 tensor-core GEMM (u8 codes times
s8 slabs into exact int32 sums); a CPU tensor runs
:func:`fragment_scores_batch_int_plain`. :func:`int_window_acc` exposes the
exact int32 window accumulators of either, for bitwise checks against
``repro.kernels.sliding_scores_int._int_window_acc``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import pin_fp32_matmul
from repro_torch.core.encoding import NonLin, apply_nonlinearity
from repro_torch.kernels import _build
from repro_torch.kernels import sliding_scores as _ss
from repro_torch.sensing.adc import unpack_nibbles

#: calls of the C entry (four kernel launches each) made by
#: :func:`fragment_scores_batch_int`
LAUNCHES = 0

INT32_MAX = 2**31 - 1

#: int8 symmetric quantization range (-128 is never produced)
_QMAX = 127

#: geometry quantization modes
INT_MODES = ("int8", "binary")

#: codes layouts the kernel reads (``CodesLayout`` in the CUDA source)
_LAYOUT_U8, _LAYOUT_NIBBLES, _LAYOUT_I32, _LAYOUT_U16 = 0, 1, 2, 3

#: codes the kernel reads as they are; uint16 and int32 codes run one K
#: loop per byte (Horner), the others one
_LAYOUTS = {torch.uint8: _LAYOUT_U8, torch.uint16: _LAYOUT_U16,
            torch.int32: _LAYOUT_I32}
_PASSES = {_LAYOUT_U8: 1, _LAYOUT_NIBBLES: 1, _LAYOUT_U16: 2, _LAYOUT_I32: 4}

#: hypervector columns per CUDA block (``kBN``): the fixed partition of a
#: D-tile into the partials that ``fold_epilogue`` folds
COL_TILE = 128

#: the kernel's row tile (``kBM``), cp.async ring depth (``kStages``) and
#: k per step (``kBK``)
ROW_TILE, _STAGES, _STEP_K = 64, 4, 64

#: device bytes one call of the C entry may take for its ``im2col``
#: scratch: 1 GiB, 1.3% of the H100's 80 GB
IM2COL_BUDGET_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class IntScoreGeometry:
    """Class-independent int precompute: quantized base slabs in the float
    geometry's ``(n_dt, h, TD + W - 1)`` layout, the window indicator, the
    bias tiles, the rotation gather and the slab scale."""
    slabs_q: torch.Tensor     # (n_dt, h, TD + W - 1) int8
    win_mask: torch.Tensor    # (mx, W) int8 window membership
    bias_t: torch.Tensor      # (n_dt, mx, TD) f32
    idx: torch.Tensor         # (n_dt, mx, TD) int64
    slab_scale: torch.Tensor  # () f32: slab ~= slabs_q * slab_scale
    block_d: int
    w: int
    stride: int
    mode: str = "int8"


@dataclasses.dataclass(frozen=True)
class IntScoreTiles:
    """Geometry + quantized class tiles (``([S,] n_dt, mx, TD)`` int8) and
    the L2 norms of the quantized class vectors."""
    geom: IntScoreGeometry
    cpos_t: torch.Tensor
    cneg_t: torch.Tensor
    cpos_norm: torch.Tensor
    cneg_norm: torch.Tensor


# ---------------------------------------------------------------------------
# Bounds: exact int32 accumulation; the block's shared memory
# ---------------------------------------------------------------------------

def smem_bytes() -> int:
    """Shared memory of one int scoring block (``kSmemBytes`` in
    ``csrc/sliding_scores_int.cu``, dynamic): a ring of 4 stages, each
    ``ROW_TILE`` code rows of one ``_STEP_K``-deep K step padded by 16
    bytes, the slab windows of its groups of 4 k over ``COL_TILE``
    columns from their 16-byte-aligned starts (40 words each) and the
    groups' byte shifts."""
    groups = _STEP_K // 4
    return _STAGES * (ROW_TILE * (_STEP_K + 16) + 4 * groups * 40
                      + 4 * groups)


def _passes(adc_bits: int) -> int:
    """Byte passes of the codes ``adc.codes_dtype(adc_bits)`` gives: 1 up
    to 8 bits (uint8, or packed int4), 2 up to 16 (uint16), 4 beyond."""
    return 1 if adc_bits <= 8 else (2 if adc_bits <= 16 else 4)


def im2col_bytes_per_frame(H: int, W: int, h: int, w: int, stride: int,
                           passes: int = 1) -> int:
    """Bytes of the kernel's ``im2col`` scratch per frame: ``passes * mx *
    my * Kp`` (``Kp``: ``h * w`` with ``w`` rounded up to 4, rounded up to
    the ``_STEP_K``-deep K step)."""
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    kp = -(-h * (-(-w // 4) * 4) // _STEP_K) * _STEP_K
    return passes * mx * my * kp


def frame_runs(N: int, per_frame_bytes: int, frames_per_stream: int,
               budget: int = IM2COL_BUDGET_BYTES) -> list[tuple[int, int]]:
    """``(lo, hi)`` runs of frames that cover ``0 .. N`` in order, one call
    of the C entry each, so no call's ``im2col`` scratch exceeds
    ``budget``: at most ``max(1, budget // per_frame_bytes)`` frames a run.
    A run either starts on a stream boundary and holds whole streams of
    ``frames_per_stream`` frames, or lies inside one stream, so each call
    reads its classes from one run of streams."""
    k = max(1, budget // max(per_frame_bytes, 1))
    C = frames_per_stream
    runs = []
    if k >= C:
        k -= k % C
        for lo in range(0, N, k):
            runs.append((lo, min(N, lo + k)))
    else:
        for s0 in range(0, N, C):
            for lo in range(s0, min(N, s0 + C), k):
                runs.append((lo, min(N, s0 + C, lo + k)))
    return runs


def int_datapath_bounds(adc_bits: int, H: int, W: int, h: int, w: int,
                        stride: int = 1) -> dict:
    """Worst-case int32 accumulators, the kernel's shared memory and its
    ``im2col`` scratch.

    ``sumsq`` (the summed-area table of squared codes over a frame) and
    ``acc`` (one fragment projection, ``h*w`` products of a max code with a
    max slab entry) must stay below ``INT32_MAX``. ``smem_bytes`` is the
    CUDA kernel's shared memory per block: ``ROW_TILE`` code rows by
    ``COL_TILE`` columns through a 4-stage ring of K steps. No
    frame, window or tile width sizes it (any W, mx and D-tile, 5000 wide
    at the paper's D, runs in the same block), so it always fits the
    H100's 227 KB. ``im2col_bytes_per_frame`` is the device scratch the
    kernel's A operand takes per frame, for the byte passes of the codes'
    layout (1 for codes of up to 8 bits, 2 for uint16, 4 for int32); a
    call cuts its chunk into runs of frames whose scratch stays within
    ``IM2COL_BUDGET_BYTES``, so one frame must fit it. ``stride=1`` (the
    most windows) is the conservative default.
    """
    cmax = (1 << adc_bits) - 1
    sumsq = H * W * cmax * cmax
    acc = h * w * cmax * _QMAX
    smem = smem_bytes()
    scratch = im2col_bytes_per_frame(H, W, h, w, stride, _passes(adc_bits))
    return {"sumsq": sumsq, "acc": acc, "int32_max": INT32_MAX,
            "smem_bytes": smem, "smem_limit_bytes": _ss.SMEM_LIMIT_BYTES,
            "im2col_bytes_per_frame": scratch,
            "im2col_budget_bytes": IM2COL_BUDGET_BYTES,
            "fits": (max(sumsq, acc) <= INT32_MAX
                     and smem <= _ss.SMEM_LIMIT_BYTES
                     and scratch <= IM2COL_BUDGET_BYTES)}


def assert_int_datapath_fits(adc_bits: int, H: int, W: int, h: int, w: int,
                             stride: int = 1) -> None:
    """Raise unless the int datapath is exact and one frame's ``im2col``
    scratch fits the budget (its block fits any size)."""
    b = int_datapath_bounds(adc_bits, H, W, h, w, stride=stride)
    if max(b["sumsq"], b["acc"]) > INT32_MAX:
        raise ValueError(
            f"int datapath would overflow int32 at adc_bits={adc_bits}, "
            f"frame {H}x{W}, window {h}x{w}: worst-case accumulators "
            f"sumsq={b['sumsq']}, acc={b['acc']} exceed {INT32_MAX}; "
            f"use fewer ADC bits / smaller frames or precision='float32'")
    _check_im2col(b["im2col_bytes_per_frame"], H, W, h, w, stride)


def _check_im2col(per_frame: int, H, W, h, w, stride) -> None:
    if per_frame > IM2COL_BUDGET_BYTES:
        raise ValueError(
            f"int scorer's im2col scratch needs {per_frame} B per frame at "
            f"frame {H}x{W}, window {h}x{w}, stride {stride}: over the "
            f"{IM2COL_BUDGET_BYTES} B budget of one call; use a larger "
            f"stride or precision='float32'")


# ---------------------------------------------------------------------------
# Precompute: geometry (once per model geometry) + class tiles
# ---------------------------------------------------------------------------

def _div_qmax(x: torch.Tensor) -> torch.Tensor:
    # a true division: by a Python scalar the card multiplies by 1/127
    return x / torch.tensor(_QMAX, dtype=x.dtype, device=x.device)


def _quantize_sym(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization at a given positive scale."""
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)


def precompute_geometry_int(B0: torch.Tensor, b: torch.Tensor, *, W: int,
                            w: int, stride: int, block_d: int = 512,
                            mode: str = "int8") -> IntScoreGeometry:
    """The float geometry with its slabs quantized: int8 at the shared
    max-abs scale, or +-1 at ``mean |slab|`` (``mode="binary"``)."""
    if mode not in INT_MODES:
        raise ValueError(f"mode must be one of {INT_MODES}, got {mode!r}")
    geom = _ss.precompute_geometry(B0, b, W=W, w=w, stride=stride,
                                   block_d=block_d)
    if mode == "binary":
        scale = torch.clamp(torch.mean(torch.abs(geom.slabs)), min=1e-12)
        slabs_q = torch.where(geom.slabs >= 0, 1, -1).to(torch.int8)
    else:
        scale = _div_qmax(torch.clamp(torch.max(torch.abs(geom.slabs)),
                                      min=1e-12))
        slabs_q = _quantize_sym(geom.slabs, scale)
    mx = (W - w) // stride + 1
    i = torch.arange(W, device=B0.device)[None, :]
    kx = torch.arange(mx, device=B0.device)[:, None] * stride
    win_mask = ((i >= kx) & (i < kx + w)).to(torch.int8)
    return IntScoreGeometry(slabs_q=slabs_q.contiguous(), win_mask=win_mask,
                            bias_t=geom.bias_t, idx=geom.idx,
                            slab_scale=scale.to(torch.float32),
                            block_d=geom.block_d, w=w, stride=stride,
                            mode=mode)


def _quantize_class(c: torch.Tensor, mode: str = "int8"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class quantization ``(codes (..., D) int8, ||codes|| f32)``; the
    scale cancels in the cosine epilogue and is not returned."""
    if mode == "binary":
        q = torch.where(c >= 0, 1, -1).to(torch.int8)
    else:
        scale = _div_qmax(torch.clamp(
            torch.amax(torch.abs(c), dim=-1, keepdim=True), min=1e-12))
        q = _quantize_sym(c, scale)
    return q, _ss.class_norms(q)


def retile_classes_int(geom: IntScoreGeometry, class_hvs: torch.Tensor
                       ) -> IntScoreTiles:
    """Install a ``(2, D)`` classifier: one gather + quantize per class."""
    qpos, npos = _quantize_class(class_hvs[1].to(torch.float32), geom.mode)
    qneg, nneg = _quantize_class(class_hvs[0].to(torch.float32), geom.mode)
    return IntScoreTiles(geom=geom, cpos_t=qpos[geom.idx],
                         cneg_t=qneg[geom.idx], cpos_norm=npos,
                         cneg_norm=nneg)


def retile_classes_int_fleet(geom: IntScoreGeometry, class_hvs: torch.Tensor
                             ) -> IntScoreTiles:
    """Per-stream classifiers ``(S, 2, D)`` -> stacked int8 tiles; stream
    ``s``'s have the bits :func:`retile_classes_int` gives its
    classifier."""
    qpos, npos = _quantize_class(class_hvs[:, 1].to(torch.float32),
                                 geom.mode)
    qneg, nneg = _quantize_class(class_hvs[:, 0].to(torch.float32),
                                 geom.mode)
    return IntScoreTiles(geom=geom, cpos_t=qpos[:, geom.idx],
                         cneg_t=qneg[:, geom.idx], cpos_norm=npos,
                         cneg_norm=nneg)


def precompute_tiles_int(B0: torch.Tensor, b: torch.Tensor,
                         class_hvs: torch.Tensor, *, W: int, w: int,
                         stride: int, block_d: int = 512,
                         mode: str = "int8") -> IntScoreTiles:
    """Geometry + quantized class tiles in one call."""
    return retile_classes_int(
        precompute_geometry_int(B0, b, W=W, w=w, stride=stride,
                                block_d=block_d, mode=mode), class_hvs)


# ---------------------------------------------------------------------------
# Window norms from raw codes (exact int32 summed-area table)
# ---------------------------------------------------------------------------

def window_sumsq_codes(codes: torch.Tensor, h: int, w: int, stride: int
                       ) -> torch.Tensor:
    """``([N,] my, mx)`` exact int32 sliding-window sums of squared codes."""
    H, W = codes.shape[-2:]
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    c = codes.to(torch.int32)
    sq = torch.cumsum(torch.cumsum(c * c, dim=-2, dtype=torch.int32),
                      dim=-1, dtype=torch.int32)
    sq = torch.nn.functional.pad(sq, (1, 0, 1, 0))
    ky = torch.arange(my, device=codes.device)[:, None] * stride
    kx = torch.arange(mx, device=codes.device)[None, :] * stride
    return (sq[..., ky + h, kx + w] - sq[..., ky + h, kx]
            - sq[..., ky, kx + w] + sq[..., ky, kx])


def window_norms_codes_batch(codes: torch.Tensor, h: int, w: int,
                             stride: int) -> torch.Tensor:
    """(N, my, mx) L2 norms of sliding code windows (float only at sqrt)."""
    return torch.sqrt(window_sumsq_codes(codes, h, w, stride)
                      .to(torch.float32))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _int_window_acc_plain(codes: torch.Tensor, geom: IntScoreGeometry, *,
                          h: int, stride: int) -> torch.Tensor:
    """Exact ``(N, my, mx, n_dt*TD)`` int32 window sums from plain codes.

    One base row at a time: the codes of every row band, masked per window,
    times the ``W`` shifted slab views. The matmul runs in float64, where
    every partial sum of these integers (below 2^31) is exact, so the
    result does not depend on the order of summation.
    """
    N, H, W = codes.shape
    mx = geom.win_mask.shape[0]
    my = (H - h) // stride + 1
    n_dt, _, L = geom.slabs_q.shape
    dev = codes.device
    ky = torch.arange(my, device=dev) * stride
    mask = geom.win_mask.to(torch.float64)                    # (mx, W)
    x = codes.to(torch.float64)
    acc = torch.zeros((N, my, mx, n_dt * (L - W + 1)), dtype=torch.float64,
                      device=dev)
    for r in range(h):
        S = geom.slabs_q[:, r, :].to(torch.float64).unfold(-1, L - W + 1, 1)
        S = S.permute(1, 0, 2).reshape(W, -1)                 # (W, n_dt*TD)
        acc = acc + (x[:, ky + r, None, :] * mask) @ S
    return acc.to(torch.int32)


def fragment_scores_batch_int_plain(codes: torch.Tensor,
                                    tiles: IntScoreTiles, *, h: int, w: int,
                                    stride: int, nonlinearity: NonLin = "rff",
                                    frames_per_stream: int | None = None,
                                    packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the int kernel: integer codes ``(N, H, W)``
    (or ``(N, H, W/2)`` packed) -> ``(N, my, mx)``. The same quantized
    operands and exact int32 accumulation as the kernel and the JAX twin;
    only the float epilogue may round differently."""
    _check_codes_integer(codes)
    if packed:
        codes = unpack_nibbles(codes)
    geom = tiles.geom
    N, H, W = codes.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt = geom.slabs_q.shape[0]
    td = geom.block_d
    _check_geometry(geom, h, w, stride, W, mx)
    per_stream, C = _ss._class_layout(tiles, N, frames_per_stream)
    with pin_fp32_matmul():
        acc = _int_window_acc_plain(codes, geom, h=h, stride=stride)
    return scores_from_window_acc(acc, codes, tiles, h=h, w=w,
                                  stride=stride, nonlinearity=nonlinearity,
                                  per_stream=per_stream, C=C)


def scores_from_window_acc(acc: torch.Tensor, codes: torch.Tensor,
                           tiles: IntScoreTiles, *, h: int, w: int,
                           stride: int, nonlinearity: NonLin,
                           per_stream: bool, C: int) -> torch.Tensor:
    """The plain float epilogue of the int scorers: exact ``(N, my, mx,
    n_dt*TD)`` int32 window sums of ``codes`` -> ``(N, my, mx)`` scores
    (normalization with the slab scale folded in, the nonlinearity, the
    per-tile classifier partials, their fixed-order fold and the cosine)."""
    geom = tiles.geom
    N, my, mx = acc.shape[:3]
    n_dt = geom.slabs_q.shape[0]
    td = geom.block_d
    norms = _scaled_norms(codes, geom, h, w, stride)
    s_n = acc.to(torch.float32) / norms[..., None]
    bias = geom.bias_t.permute(1, 0, 2).reshape(mx, n_dt * td)
    phi = apply_nonlinearity(s_n, bias, nonlinearity)
    cpos = _ss._per_frame_classes(tiles.cpos_t.to(torch.float32), per_stream,
                                  C)[:, None]
    cneg = _ss._per_frame_classes(tiles.cneg_t.to(torch.float32), per_stream,
                                  C)[:, None]

    def fold(x):
        return _ss._ordered_tile_fold(
            x.reshape(N, my, mx, n_dt, td).sum(-1).permute(3, 0, 1, 2))

    return _ss._cosine_epilogue(fold(phi * cpos), fold(phi * cneg),
                                fold(phi * phi), tiles.cpos_norm,
                                tiles.cneg_norm, per_stream, C)


def _scaled_norms(codes, geom, h, w, stride):
    """LSB-free normalization with the slab scale folded in:
    ``s_n = acc * scale / ||codes|| = acc / (||codes|| / scale)``."""
    norms = window_norms_codes_batch(codes, h, w, stride)
    return torch.clamp(norms, min=1e-8) / geom.slab_scale


def _check_codes_integer(codes: torch.Tensor) -> None:
    if codes.is_floating_point() or codes.is_complex():
        raise TypeError(f"int datapath consumes integer ADC codes, got "
                        f"{codes.dtype} — use adc.quantize_codes/pack_codes"
                        f" (or precision='float32')")


def _check_geometry(geom, h, w, stride, W, mx):
    n_dt, gh, slab_len = geom.slabs_q.shape
    if (gh != h or slab_len != geom.block_d + W - 1
            or tuple(geom.win_mask.shape) != (mx, W)
            or geom.w != w or geom.stride != stride):
        raise ValueError(f"int geometry {tuple(geom.slabs_q.shape)} (w="
                         f"{geom.w}, stride={geom.stride}) does not fit "
                         f"{W}-wide codes with h={h}, w={w}, "
                         f"stride={stride}")


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def _launch(codes: torch.Tensor, tiles: IntScoreTiles, *, h: int, w: int,
            stride: int, nonlinearity: NonLin, C: int, packed: bool,
            acc_out: torch.Tensor | None = None) -> torch.Tensor:
    """Calls of the C entry, four kernel launches each (window norms,
    im2col, the GEMM with its scoring epilogue, the fold): one per run of
    frames whose ``im2col`` scratch fits ``IM2COL_BUDGET_BYTES``
    (:func:`frame_runs`; one run at the paper's chunk). Frames are
    independent and the column partition depends on ``td`` alone, so the
    runs give the bits of one call."""
    geom = tiles.geom
    N, H, Wc = codes.shape
    W = Wc * 2 if packed else Wc
    mx = (W - w) // stride + 1
    my = (H - h) // stride + 1
    n_dt = geom.slabs_q.shape[0]
    td = geom.block_d
    if packed:
        layout = _LAYOUT_NIBBLES
    elif codes.dtype in _LAYOUTS:
        layout = _LAYOUTS[codes.dtype]
    else:  # other integer codes: widened at the kernel boundary only
        layout = _LAYOUT_I32
        codes = codes.to(torch.int32)
    per_frame = im2col_bytes_per_frame(H, W, h, w, stride, _PASSES[layout])
    _check_im2col(per_frame, H, W, h, w, stride)
    lib = _build.load("sliding_scores_int")
    dev = codes.device
    codes = codes.contiguous()
    cpos_norm, cneg_norm = _ss._flat_norms(tiles)
    cpos_t, cneg_t = tiles.cpos_t.contiguous(), tiles.cneg_t.contiguous()
    class_tile = n_dt * mx * td  # int8 class entries per stream
    n_col_tiles = n_dt * -(-td // COL_TILE)
    runs = frame_runs(N, per_frame, C)
    longest = max(hi - lo for lo, hi in runs)
    # the kernel's scratch, sized for the longest run: window norms, A as
    # (passes, mx, n*my, Kp) bytes, partials
    norms = torch.empty((longest, my, mx), device=dev)
    acol = torch.empty((longest * per_frame,), dtype=torch.uint8, device=dev)
    partials = torch.empty((n_col_tiles, longest * my * mx, 3), device=dev)
    out = torch.empty((N, my, mx), device=dev)
    for lo, hi in runs:
        s0 = lo // C  # the run's first stream
        args = (codes[lo:hi], geom.slabs_q, geom.bias_t,
                cpos_t.reshape(-1)[s0 * class_tile:],
                cneg_t.reshape(-1)[s0 * class_tile:], geom.slab_scale,
                norms, acol, cpos_norm[s0:], cneg_norm[s0:], partials,
                out[lo:hi])
        err = lib.sliding_scores_int(
            *(a.data_ptr() for a in args),
            None if acc_out is None else acc_out[lo:hi].data_ptr(),
            hi - lo, H, W, h, w, stride, td, n_dt, min(C, hi - lo),
            _ss.NONLINEARITIES[nonlinearity], layout, _build.stream_ptr())
        _build.check(err, "sliding_scores_int")
    return out


def fragment_scores_batch_int(codes: torch.Tensor, tiles: IntScoreTiles, *,
                              h: int, w: int, stride: int,
                              nonlinearity: NonLin = "rff",
                              frames_per_stream: int | None = None,
                              packed: bool = False) -> torch.Tensor:
    """(N, H, W) integer ADC codes -> (N, my, mx) score maps in one call
    of the C entry, which launches its four kernels; :data:`LAUNCHES` counts
    the calls.

    A CUDA tensor launches ``csrc/sliding_scores_int.cu`` (or raises); a
    CPU tensor runs :func:`fragment_scores_batch_int_plain`. ``packed``
    marks int4 wire codes ``(N, H, W/2)``; per-stream class tiles work as
    in the float wrapper (``frames_per_stream``).
    """
    global LAUNCHES
    _ss._check_device(codes)
    if codes.device.type == "cpu":
        return fragment_scores_batch_int_plain(
            codes, tiles, h=h, w=w, stride=stride, nonlinearity=nonlinearity,
            frames_per_stream=frames_per_stream, packed=packed)
    _check_codes_integer(codes)
    N, H, Wc = codes.shape
    W = Wc * 2 if packed else Wc
    _check_geometry(tiles.geom, h, w, stride, W, (W - w) // stride + 1)
    _, C = _ss._class_layout(tiles, N, frames_per_stream)
    out = _launch(codes, tiles, h=h, w=w, stride=stride,
                  nonlinearity=nonlinearity, C=C, packed=packed)
    LAUNCHES += 1
    return out


def int_window_acc(codes: torch.Tensor, geom: IntScoreGeometry, *, h: int,
                   w: int, stride: int, packed: bool = False
                   ) -> torch.Tensor:
    """The exact int32 window sums ``(N, my, n_dt, mx, TD)`` — the layout of
    ``_int_window_acc`` per (frame, row band, tile) in the JAX package.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel with
    its accumulator output switched on. A check, not part of scoring: it
    does not count in :data:`LAUNCHES`.
    """
    _ss._check_device(codes)
    _check_codes_integer(codes)
    N, H, Wc = codes.shape
    W = Wc * 2 if packed else Wc
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt = geom.slabs_q.shape[0]
    td = geom.block_d
    _check_geometry(geom, h, w, stride, W, mx)
    if codes.device.type == "cpu":
        full = unpack_nibbles(codes) if packed else codes
        acc = _int_window_acc_plain(full, geom, h=h, stride=stride)
        return acc.reshape(N, my, mx, n_dt, td).permute(0, 1, 3, 2, 4)
    zeros = torch.zeros(geom.bias_t.shape[1:], dtype=torch.int8,
                        device=codes.device)[None].expand(n_dt, -1, -1)
    tiles = IntScoreTiles(geom=geom, cpos_t=zeros, cneg_t=zeros,
                          cpos_norm=torch.ones((), device=codes.device),
                          cneg_norm=torch.ones((), device=codes.device))
    acc = torch.empty((N, my, n_dt, mx, td), dtype=torch.int32,
                      device=codes.device)
    _launch(codes, tiles, h=h, w=w, stride=stride, nonlinearity="linear",
            C=N, packed=packed, acc_out=acc)
    return acc
