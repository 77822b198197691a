#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card (built for
sm_90a: an H100). It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds all five kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all at once, and counts ``similarity``'s
   launches per call at 2, 9, 17 and 33 classes from the profiler's
   events (one each; first, before any other profile of the process);
3. makes a HyperSense model at the paper's operating point (128x128
   frames, 96x96 fragments, stride 8, D=5000, RFF) from a seeded
   ``torch.Generator`` on the card: ``B0 ~ N(0, 1)``, ``b ~ U(0, 2 pi)``,
   class hypervectors bundled from encoded crops of synthetic object
   frames (Gaussian blobs on noise) and background frames;
4. holds each kernel against its plain PyTorch version on the same inputs
   at the main path's shape (a 32-frame chunk) — scores within 5e-5, the
   int kernel's int32 window sums bitwise, two runs bitwise equal, frames
   scored inside a 7-frame call bitwise as in the 32-frame one — and
   times kernel, plain version, a library matmul of the same projection
   and the card's bounds; the float kernel (3xTF32 tensor cores, the
   reuse form) also at ragged shapes for each nonlinearity (odd strides,
   ragged depths and widths, two D-tiles, per-stream classes, and a
   1024-wide frame); the int kernel (int8 tensor cores) also at 10-bit
   uint16 codes and at ragged shapes (odd stride, W not a multiple of 4,
   K steps that straddle base rows, M and td off the tiles, two D-tiles,
   per-stream classes);
5. drives the main path, ``StreamRunner.process``, over 256 frames six
   times (float32, int8, int4, binary, the closed capture loop, online
   adaptation): each chunk must launch its kernel exactly once, the frame
   scores must equal the plain version's within 5e-5, and the run must be
   bitwise the same when fed in 32-frame slices;
6. profiles one float32 and one int8 run (device busy share, top
   kernels);
7. drives the training path (paper Fig. 5a) at the same width: samples
   balanced fragments from 256 synthetic training frames and 128 held-out
   frames (``sensing.fragments``), trains the Fragment model on the
   permutation base (``train_fragment_model``, 20 epochs), scores the
   held-out fragments (fragment AUC and partial AUC) and the held-out
   frames through ``from_fragment_model`` (frame AUC); the whole path runs
   twice and must be bitwise the same. It then holds the three training
   kernels (``hdc_encode_perm``, ``hdc_encode``, ``similarity``) against
   their plain versions at the path's shapes — hypervectors within 1e-4,
   scores within 5e-5, two runs bitwise equal, ``hdc_encode_perm``
   bitwise equal to ``hdc_encode`` on the expanded base — and times them;
   holds ``similarity`` also at 9, 17 and 33 classes, across batch
   positions, class subsets and a misaligned view (bitwise), and times
   it at N = 512 and at a 16,384-row split past the L2; holds
   both encoders the same way at ragged shapes (N, K and D off the tiles,
   K steps that straddle generator rows) for each nonlinearity, and
   reports their tiles, blocks and waves;
8. prints one JSON line per phase, a ``kernels`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero as well without a CUDA device, or outside a checkout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import pin_fp32_matmul  # noqa: E402
from repro_torch.convert import model_from_arrays  # noqa: E402
from repro_torch.core import (encoding, fragment_model,  # noqa: E402
                              hypersense, metrics)
from repro_torch.core.hypersense import frame_detection_score  # noqa: E402
from repro_torch.core.online import AdaptConfig  # noqa: E402
from repro_torch.core.sensor_control import (  # noqa: E402
    CaptureConfig, ControllerConfig)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import hdc_encode as enc  # noqa: E402
from repro_torch.kernels import hdc_encode_perm as enc_perm  # noqa: E402
from repro_torch.kernels import similarity as sim  # noqa: E402
from repro_torch.kernels import sliding_scores as ss  # noqa: E402
from repro_torch.kernels import sliding_scores_int as ssi  # noqa: E402
from repro_torch.sensing import adc, fragments, stream  # noqa: E402

# the paper's operating point (configs/hypersense.py)
FRAME, FRAG, STRIDE, DIM, BLOCK_D = 128, 96, 8, 5000, 512
CHUNK, N_STREAM = 32, 256
SCORE_ATOL = 5e-5
# the training path: frames sampled for training and held out, fragments
# per frame of each, retraining epochs; hypervector tolerance
N_TRAIN, N_HELD_OUT, EPOCHS = 256, 128, 20
HV_ATOL = 1e-4
SEED = 0
DEVICE = "cuda"

# D at which the Python and CUDA similarity chunk plans are compared:
# ranks with empty chunks, D % 4 != 0, the paper's D, several D tiles
SIM_PLAN_DS = (1, 16, 129, 130, 300, 1000, 4999, 5000, 8192, 8193, 20001)

# ragged encoder shapes (N, h, w, D): N, K = h*w and D off the 128 x 160
# (128 x 128) tiles and the 32-deep K steps, which w = 7 and w = 40 straddle
RAGGED = ((7, 5, 7, 131), (200, 6, 40, 1000))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, float32 (CUDA cores),
# TF32 and int8 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
TF32_OPS_S = 495e12
INT8_OPS_S = 1979e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def synthetic_frames(g, labels):
    """Noise frames in [0, 1.5]; frames labeled 1 carry a Gaussian blob.
    Returns the frames and each blob's (row, col) centre."""
    n = labels.shape[0]
    dev = g.device
    frames = 0.3 + 0.1 * torch.randn((n, FRAME, FRAME), generator=g,
                                     device=dev)
    centres = 24 + torch.rand((n, 2), generator=g, device=dev) * (FRAME - 48)
    frames = frames + 0.9 * labels[:, None, None].to(torch.float32) * blobs(
        centres)
    return frames.clamp(0.0, 1.5), centres


def blobs(centres):
    """``(n, FRAME, FRAME)`` Gaussian blobs (sigma 12 pixels, peak 1) at
    each ``(row, col)`` centre."""
    yy = torch.arange(FRAME, device=centres.device, dtype=torch.float32)
    dy = (yy[None, :] - centres[:, :1]) ** 2
    dx = (yy[None, :] - centres[:, 1:]) ** 2
    return torch.exp(-(dy[:, :, None] + dx[:, None, :]) / (2 * 12.0 ** 2))


def make_model(g):
    """Paper-shape model: class hypervectors bundled
    (``fragment_model.bundle_init``) from 64 object and 64 background
    crops, without retraining; the stream phases drive this model and the
    train phase trains its own. Also returns 64 held-out calibration
    frames and their labels."""
    B0, b = encoding.make_perm_base_rows(g, FRAG, DIM)
    labels = torch.arange(128, device=g.device) % 2
    frames, centres = synthetic_frames(g, labels)
    top = (centres - FRAG / 2).round().long().clamp(0, FRAME - FRAG)
    rand = torch.randint(0, FRAME - FRAG + 1, (128, 2), generator=g,
                         device=g.device)
    top = torch.where(labels[:, None] == 1, top, rand)
    crops = torch.stack([f[y:y + FRAG, x:x + FRAG] for f, (y, x)
                         in zip(frames, top.tolist())])
    hvs = encoding.encode_fragments(crops, encoding.flat_perm_base(B0, FRAG),
                                    b)
    class_hvs = fragment_model.bundle_init(hvs, labels)      # (2, D)
    model = model_from_arrays(class_hvs.cpu().numpy(), B0.cpu().numpy(),
                              b.cpu().numpy(), h=FRAG, w=FRAG, stride=STRIDE,
                              t_score=0.0, t_detection=0, device=DEVICE)
    cal_labels = torch.arange(64, device=g.device) % 2
    cal, _ = synthetic_frames(g, cal_labels)
    return model, cal, cal_labels


def calibrated(model, cal, cal_labels, precision: str, bits: int):
    """The model with ``t_score`` halfway between the median frame scores
    of the object and the background calibration frames, as this
    precision's ADC view scores them."""
    view = stream.adc_view(cal, bits) if precision == "float32" else cal
    s = hypersense.frame_scores_batch(model, view, precision=precision,
                                      adc_bits=bits)
    t_score = float((s[cal_labels == 1].median()
                     + s[cal_labels == 0].median()) / 2)
    return dataclasses.replace(model, t_score=t_score)


def kernel_phase(model, raw):
    """Kernel against plain version, run-to-run bitwise, and timings, at
    the main path's chunk shape. Returns the two kernels' records."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    N = raw.shape[0]
    my = mx = (FRAME - FRAG) // STRIDE + 1
    chunk_f = stream.adc_view(raw, 4)
    tiles = stream.model_tiles(model, FRAME, BLOCK_D, "float32")
    td, n_dt = tiles.block_d, tiles.slabs.shape[0]
    lib = _build.load("sliding_scores")
    check(ss.smem_bytes() == lib.sliding_scores_f32_smem_bytes()
          and ss.COL_TILE == lib.sliding_scores_f32_col_tile()
          and ss.WINDOWS_PER_BLOCK == lib.sliding_scores_f32_windows(),
          "python and CUDA float block sizes differ")

    # the projection as one library call: windows (N*my*mx, h*w) against
    # the expanded base (h*w, D); the port never calls it
    base = encoding.flat_perm_base(model.B0, FRAG)

    def windows(x):
        return x.unfold(1, FRAG, STRIDE).unfold(2, FRAG, STRIDE).reshape(
            N * my * mx, FRAG * FRAG).to(torch.float32)

    last = (mx - 1) * STRIDE + FRAG    # frame columns the windows cover
    macs = N * my * n_dt * td * FRAG * last   # h*last per (n, ky, column)
    records = []

    # --- float32 kernel
    got = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    again = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    seven = ss.fragment_scores_batch(chunk_f[20:27], tiles, **kw)
    plain = ss.fragment_scores_batch_plain(chunk_f, tiles, **kw)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err <= SCORE_ATOL, f"float kernel vs plain: {err}")
    check(torch.equal(got, again), "float kernel differs run to run")
    check(torch.equal(seven, got[20:27]),
          "float: a 7-frame call differs from the 32-frame one")
    check(bool(torch.isfinite(got).all()) and got.shape == (N, my, mx),
          "float kernel scores not finite or of the wrong shape")
    oracle = torch.stack([ref.fragment_scores(
        f, model.class_hvs, model.B0, model.b, **kw) for f in chunk_f[:2]])
    oerr = float((got[:2] - oracle).abs().max())
    check(oerr <= SCORE_ATOL, f"float kernel vs naive oracle: {oerr}")
    win = windows(chunk_f)
    f_bytes = 4 * (chunk_f.numel() + tiles.slabs.numel()
                   + 3 * tiles.bias_t.numel() + 2 * N * my * mx)
    tc = bound(f_bytes, 3 * 2 * macs, TF32_OPS_S)
    device_ms, device_by_kernel = kernel_device_ms(
        lambda: ss.fragment_scores_batch(chunk_f, tiles, **kw),
        ("window_norms", "score_f32", "fold_epilogue"))
    records.append(dict(
        name="sliding_scores_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores.cu",
        replaces="src/repro/kernels/sliding_scores.py:244",
        max_abs_err=err, oracle_max_abs_err=oerr, run_to_run_bitwise=True,
        batch_position_bitwise=True,
        ms=time_ms(lambda: ss.fragment_scores_batch(chunk_f, tiles,
                                                           **kw)),
        kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=device_by_kernel,
        plain_ms=time_ms(lambda: ss.fragment_scores_batch_plain(
            chunk_f, tiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[N * my, FRAG * last, n_dt * td],
        **scorer_occupancy(lib.sliding_scores_f32_occupancy, N * my, mx,
                           n_dt * -(-td // ss.COL_TILE),
                           (ss.COL_TILE, ss.WINDOWS_PER_BLOCK)),
        **bound(f_bytes, 2 * macs, F32_OPS_S),
        bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"],
        ragged_max_abs_err=ragged_f32_checks()))
    records[-1]["beats_library"] = records[-1]["ms"] < records[-1][
        "library_ms"]

    records.append(int_kernel_record(model, raw, windows(
        stream.adc_view_codes(raw, 8)), base))
    return records


# the int kernel's precisions: (geometry mode, ADC bits, packed int4)
INT_CASES = {"int8": ("int8", 8, False), "int4": ("int8", 4, True),
             "binary": ("binary", 8, False), "u10": ("int8", 10, False)}

# ragged int shapes (N, S, H, W, h, w, stride, D, block_d): an odd stride,
# W not a multiple of 4, w % 32 != 0 (K steps straddle base rows; w = 7
# puts 8 rows in one 64-deep step), M and td off the 64 x 128 tile, n_dt = 2,
# S streams of N / S frames with their own class tiles
RAGGED_INT = ((6, 2, 45, 46, 21, 21, 3, 600, 300),
              (5, 1, 22, 30, 5, 7, 5, 131, 512))


def int_kernel_record(model, raw, win, base):
    """The int kernel at the main path's chunk, per precision (int8, packed
    int4, binary and 10-bit uint16 codes): int32 window sums bitwise equal
    to the plain version's, scores within SCORE_ATOL, bitwise run to run
    and for frames scored inside a 7-frame call; then its timings, occupancy and bounds, and the RAGGED_INT
    shapes."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    lib = _build.load("sliding_scores_int")
    check(ssi.COL_TILE == lib.sliding_scores_int_col_tile()
          and ssi.smem_bytes() == lib.sliding_scores_int_smem_bytes(),
          "python and CUDA int block sizes differ")
    N = raw.shape[0]
    my = mx = (FRAME - FRAG) // STRIDE + 1
    ms_by_precision, errs = {}, {}
    for precision, (mode, bits, packed) in INT_CASES.items():
        codes = stream.adc_view_codes(raw, bits)
        kcodes = adc.pack_nibbles(codes) if packed else codes
        itiles = stream.model_tiles(model, FRAME, BLOCK_D,
                                    "binary" if mode == "binary" else "int8")
        pkw = dict(packed=packed, **kw)
        got = ssi.fragment_scores_batch_int(kcodes, itiles, **pkw)
        again = ssi.fragment_scores_batch_int(kcodes, itiles, **pkw)
        seven = ssi.fragment_scores_batch_int(kcodes[20:27], itiles, **pkw)
        plain = ssi.fragment_scores_batch_int_plain(kcodes, itiles, **pkw)
        acc = ssi.int_window_acc(kcodes, itiles.geom, **pkw)
        acc_plain = ssi.int_window_acc(
            kcodes.cpu(), _geometry_to(itiles.geom, "cpu"), **pkw)
        torch.cuda.synchronize()
        errs[precision] = float((got - plain).abs().max())
        check(errs[precision] <= SCORE_ATOL,
              f"{precision} kernel vs plain: {errs[precision]}")
        check(torch.equal(got, again), f"{precision} kernel run to run")
        check(torch.equal(seven, got[20:27]),
              f"{precision}: a 7-frame call differs from the 32-frame one")
        check(torch.equal(acc.cpu(), acc_plain),
              f"{precision} int32 window sums differ from the plain ones")
        check(bool(torch.isfinite(got).all()) and got.shape == (N, my, mx),
              f"{precision} scores not finite or of the wrong shape")
        ms_by_precision[precision] = time_ms(
            lambda: ssi.fragment_scores_batch_int(kcodes, itiles, **pkw))
        if precision == "int8":
            int8 = dict(codes=codes, tiles=itiles)
    codes, itiles = int8["codes"], int8["tiles"]
    n_dt, td = itiles.geom.slabs_q.shape[0], itiles.geom.block_d
    M, n_ct = N * my * mx, n_dt * -(-td // ssi.COL_TILE)
    i_bytes = (codes.numel() + itiles.geom.slabs_q.numel()
               + 4 * itiles.geom.bias_t.numel() + 2 * itiles.cpos_t.numel()
               + 4 * 2 * M)
    # the reuse form's h*W multiply-adds per (n, ky, column); this GEMM's
    # h*w per window
    macs = N * my * n_dt * td * FRAG * FRAME
    tc = bound(i_bytes, 2 * M * FRAG * FRAG * n_dt * td, INT8_OPS_S)
    device_ms, device_by_kernel = kernel_device_ms(
        lambda: ssi.fragment_scores_batch_int(codes, itiles, **kw),
        ("window_norms", "im2col", "score_int", "fold_epilogue"))
    return dict(
        name="sliding_scores_int", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores_int.cu",
        replaces="src/repro/kernels/sliding_scores_int.py:463",
        max_abs_err=max(errs.values()), max_abs_err_by_precision=errs,
        acc_bitwise=True, run_to_run_bitwise=True, batch_position_bitwise=True,
        ms=ms_by_precision["int8"], ms_by_precision=ms_by_precision,
        kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=device_by_kernel,
        plain_ms=time_ms(lambda: ssi.fragment_scores_batch_int_plain(
            codes, itiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[M, FRAG * FRAG, n_dt * td],
        **scorer_occupancy(lib.sliding_scores_int_occupancy, N * my, mx, n_ct,
                           (ssi.COL_TILE,)),
        **bound(i_bytes, 2 * macs, INT8_OPS_S),
        bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"],
        ragged_max_abs_err=ragged_int_checks())


def scorer_occupancy(entry, R: int, mx: int, n_ct: int, tile) -> dict:
    """A scorer's launch for R = N*my rows, mx window columns and n_ct
    column tiles, from its C ``entry``: its tile (the row tile, then
    ``tile``), blocks, resident blocks per SM, shared memory per block,
    waves on this card and the share of the waves' block slots the blocks
    fill."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check(entry(R, mx, n_ct, *map(ctypes.byref, vals)), entry.__name__)
    tile_m, blocks, per_sm, smem = (v.value for v in vals)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(blocks / slots)
    return dict(tile=[tile_m, *tile], blocks=blocks, blocks_per_sm=per_sm,
                smem_bytes=smem, waves=waves,
                wave_efficiency=blocks / (waves * slots))


# ragged float shapes (N, S, H, W, h, w, stride, D, block_d): g = gcd(stride,
# w) = 3 with a depth of 63 (two K steps, the second padded) and W = 46, g = 1
# with a depth of 5 and td = 131 (a column tile of 3), two D-tiles, S
# streams of N / S frames with their own class tiles; and a 1024-wide frame
# (w = 8, stride 8, mx = 128: 26 window groups) that the CUDA-core kernel's
# block refused
RAGGED_F32 = ((6, 2, 45, 46, 21, 21, 3, 600, 300),
              (5, 1, 22, 30, 5, 7, 5, 131, 512),
              (2, 1, 8, 1024, 8, 8, 8, 5000, 512))


def window_projections_plain(frames, tiles, h, w, stride):
    """``(N, my, mx, D)`` normalized window projections ``acc / max(norm,
    1e-8)`` as the plain version computes them, to find where ``sign``
    sits within rounding of 0."""
    N, H, W = frames.shape
    mx = (W - w) // stride + 1
    lo, hi = ss._window_masks(W, w, stride, mx, frames.device, torch.float32)
    ky = torch.arange((H - h) // stride + 1, device=frames.device) * stride
    acc = 0
    for r in range(h):
        p_hi, p_lo = ss._prefix_window_acc(frames[:, ky + r, :],
                                           tiles.slabs[:, r, :], lo, hi)
        acc = acc + p_hi - p_lo
    norms = ss.window_norms_batch(frames, h, w, stride)
    return acc / torch.clamp(norms, min=1e-8)[..., None]


def ragged_f32_checks() -> float:
    """The float kernel at the RAGGED_F32 shapes, for each nonlinearity:
    scores within SCORE_ATOL of the plain version with per-stream class
    tiles, bitwise run to run. ``sign`` is held on the windows whose
    projections all sit clear of 0 by more than 1e-5 (elsewhere float32
    rounding may flip one). Returns the largest score error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 4)
    worst = 0.0
    for N, S, H, W, h, w, stride, D, block_d in RAGGED_F32:
        kw = dict(h=h, w=w, stride=stride, frames_per_stream=N // S)
        frames = 1.5 * torch.rand((N, H, W), generator=g, device=DEVICE)
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        chvs = torch.randn((S, 2, D), generator=g, device=DEVICE)
        geom = ss.precompute_geometry(B0, b, W=W, w=w, stride=stride,
                                      block_d=block_d)
        tiles = ss.retile_classes_fleet(geom, chvs)
        s_n = window_projections_plain(frames, tiles, h, w, stride)
        clear = (s_n.abs() > 1e-5).all(-1)                  # (N, my, mx)
        for nl in ("rff", "linear", "sign"):
            what = f"{nl} at {(N, S, H, W, h, w, stride, D)}"
            got = ss.fragment_scores_batch(frames, tiles, nonlinearity=nl,
                                           **kw)
            again = ss.fragment_scores_batch(frames, tiles, nonlinearity=nl,
                                             **kw)
            plain = ss.fragment_scores_batch_plain(frames, tiles,
                                                   nonlinearity=nl, **kw)
            torch.cuda.synchronize()
            keep = clear if nl == "sign" else torch.ones_like(clear)
            check(keep.float().mean() > 0.9, f"{what}: projections near 0")
            err = float((got - plain)[keep].abs().max())
            check(err <= SCORE_ATOL, f"{what}: kernel vs plain {err}")
            check(torch.equal(got, again), f"{what}: kernel run to run")
            check(bool(torch.isfinite(got).all()), f"{what}: not finite")
            worst = max(worst, err)
    return worst


def ragged_int_checks() -> float:
    """The int kernel at the RAGGED_INT shapes, per precision: int32 window
    sums bitwise equal to the plain version's, scores within SCORE_ATOL
    with per-stream class tiles, bitwise run to run. Returns the largest
    score error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 3)
    worst = 0.0
    for N, S, H, W, h, w, stride, D, block_d in RAGGED_INT:
        kw = dict(h=h, w=w, stride=stride)
        frames = 1.5 * torch.rand((N, H, W), generator=g, device=DEVICE)
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        chvs = torch.randn((S, 2, D), generator=g, device=DEVICE)
        for precision, (mode, bits, packed) in INT_CASES.items():
            what = f"{precision} at {(N, S, H, W, h, w, stride, D)}"
            geom = ssi.precompute_geometry_int(B0, b, W=W, w=w, stride=stride,
                                               block_d=block_d, mode=mode)
            tiles = ssi.retile_classes_int_fleet(geom, chvs)
            codes = stream.adc_view_codes(frames, bits)
            kcodes = adc.pack_nibbles(codes) if packed else codes
            pkw = dict(packed=packed, frames_per_stream=N // S, **kw)
            got = ssi.fragment_scores_batch_int(kcodes, tiles, **pkw)
            again = ssi.fragment_scores_batch_int(kcodes, tiles, **pkw)
            plain = ssi.fragment_scores_batch_int_plain(kcodes, tiles, **pkw)
            acc = ssi.int_window_acc(kcodes, geom, packed=packed, **kw)
            acc_plain = ssi.int_window_acc(kcodes.cpu(),
                                           _geometry_to(geom, "cpu"),
                                           packed=packed, **kw)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            check(err <= SCORE_ATOL, f"{what}: kernel vs plain {err}")
            check(torch.equal(acc.cpu(), acc_plain),
                  f"{what}: int32 window sums differ from the plain ones")
            check(torch.equal(got, again), f"{what}: kernel run to run")
            worst = max(worst, err)
    return worst


def bound(n_bytes: int, n_ops: int, ops_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / ops_s * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def _geometry_to(geom, device):
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name).to(device)
        for f in dataclasses.fields(geom)
        if isinstance(getattr(geom, f.name), torch.Tensor)})


RUNS = {
    # name: (precision, adc_bits, closed loop, adapt)
    "float32": ("float32", 4, False, False),
    "int8": ("int8", 8, False, False),
    "int4": ("int4", 4, False, False),
    "binary": ("binary", 8, False, False),
    "closed_loop_float32": ("float32", 4, True, False),
    "adapt_int8": ("int8", 8, False, True),
}


def stream_phase(base_model, cal, raw, labels):
    """The main path: six StreamRunner runs over the same 256 frames.
    Returns each run's record and the launches it made per kernel."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    n_chunks = math.ceil(N_STREAM / CHUNK)
    labels_np = labels.cpu().numpy()
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed, adapt) in RUNS.items():
        ctrl = ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                                active_rate_hz=30.0)
        model = calibrated(base_model, *cal, precision, bits)

        def runner():
            return stream.StreamRunner(
                model, ctrl, chunk_size=CHUNK, block_d=BLOCK_D,
                adc_bits=bits, precision=precision,
                control=CaptureConfig(hp_bits=12) if closed else None,
                adapt=AdaptConfig(mode="label", lr=0.5) if adapt else None,
                device=DEVICE)

        feed = labels_np if adapt else None
        geom = stream.model_geometry(model, FRAME, BLOCK_D, precision)
        # (a) 32-frame slices, each held against the plain version with the
        #     classifier the runner holds at the slice's start
        ra, out_a, err = runner(), [], 0.0
        for lo in range(0, N_STREAM, CHUNK):
            chvs = ra.class_hvs
            sl = raw[lo:lo + CHUNK]
            out_a.append(ra.process(sl, labels=None if feed is None
                                    else feed[lo:lo + CHUNK]))
            if precision in adc.INT_PRECISIONS:
                packed = precision == "int4"
                codes = stream.adc_view_codes(sl, bits)
                maps = ssi.fragment_scores_batch_int_plain(
                    adc.pack_nibbles(codes) if packed else codes,
                    ops.retile_classes_int(geom, chvs), packed=packed, **kw)
            else:
                maps = ss.fragment_scores_batch_plain(
                    stream.adc_view(sl, bits), ops.retile_classes(geom, chvs),
                    **kw)
            want = frame_detection_score(maps, 0).cpu().numpy()
            err = max(err, float(abs(out_a[-1][0] - want).max()))
        check(err <= SCORE_ATOL, f"{name}: runner vs plain {err}")
        # (b) the main-path run: counts zeroed right before, read right after
        rb = runner()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        t0 = time.perf_counter()
        scores, fired, gated = rb.process(raw, labels=feed)
        wall = time.perf_counter() - t0
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")
        check(counts[kernel] == n_chunks,
              f"{name}: {counts[kernel]} launches for {n_chunks} chunks")
        check(sum(counts.values()) == n_chunks,
              f"{name}: the other kernel launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
        for got, want in zip((scores, fired, gated),
                             (np.concatenate(x) for x in zip(*out_a))):
            check(np.array_equal(got, want),
                  f"{name}: slicing or a rerun changed the output")
        check(np.isfinite(scores).all() and scores.shape == (N_STREAM,),
              f"{name}: scores not finite or of the wrong shape")
        log = rb.capture_log
        hp_idx, hp = rb.drain_hp()
        if closed:
            check(len(hp_idx) == int(gated.sum()) and
                  hp.shape == (len(hp_idx), FRAME, FRAME),
                  f"{name}: HP drain does not match the gated frames")
        rec = dict(run=name, precision=precision, adc_bits=bits,
                   frames=N_STREAM, chunk=CHUNK, chunks=n_chunks,
                   launches=counts, fps=N_STREAM / wall, wall_s=wall,
                   fired=int(fired.sum()), gated=int(gated.sum()),
                   sampled=int(log.sampled.sum()), hp_frames=len(hp_idx),
                   max_abs_err_vs_plain=err, sliced_run_bitwise=True,
                   duty_cycle=float(gated.mean()),
                   missed_positive=float((labels_np.astype(bool)
                                          & ~gated).sum()
                                         / max(labels_np.sum(), 1)),
                   t_score=model.t_score)
        if adapt:
            rec["class_hvs_moved"] = float(
                (rb.class_hvs - model.class_hvs).abs().max())
        emit(rec)
        records.append(rec)
    return records, launches


def profile_phase(base_model, cal, raw):
    """Where a run's time goes: one float32 and one int8 run of the 256
    frames under ``torch.profiler`` — device busy share of the wall time
    and the device time of the top kernels. Outside the main-path counts;
    the profiler's own overhead lengthens the wall time it is shared of."""
    out = {}
    for precision, bits in (("float32", 4), ("int8", 8)):
        r = stream.StreamRunner(calibrated(base_model, *cal, precision, bits),
                                chunk_size=CHUNK, block_d=BLOCK_D,
                                adc_bits=bits, precision=precision,
                                device=DEVICE)
        r.process(raw[:CHUNK])
        out[precision] = device_profile(lambda: r.process(raw))
    return out


def device_profile(fn, top: int = 6) -> dict:
    """``fn`` once under ``torch.profiler``: the device busy share of its
    wall time and the device time of its top kernels. The profiler's own
    overhead lengthens the wall time the share is taken of. A window's
    first kernel went unrecorded on the H100, so each window opens with a
    one-element fill before ``fn``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events only: an operator's row repeats the time of the
    # kernels it launched
    rows = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    device_us = sum(us for _, us in rows)
    return dict(wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
                device_busy_share=(device_us / wall_us if device_us > 0
                                   else "not measured"),
                top_kernels_ms={k[:80]: us / 1e3 for k, us in rows[:top]})


TRAIN_KERNELS = {"hdc_encode_perm": enc_perm, "hdc_encode": enc,
                 "similarity": sim, "sliding_scores_f32": ss}


def fragment_sets(g):
    """Training and held-out sets: half the frames carry a blob; balanced
    fragments sampled from each (2 and 3 per frame, seeds 0 and 1)."""
    sets = []
    for n, per_frame, seed in ((N_TRAIN, 2, 0), (N_HELD_OUT, 3, 1)):
        labels = torch.arange(n, device=g.device) % 2
        frames, centres = synthetic_frames(g, labels)
        # object mask: where a labelled frame's blob is above half its peak
        masks = (blobs(centres) > 0.5) & (labels[:, None, None] == 1)
        frags, flabels = fragments.sample_fragments(
            frames.cpu().numpy(), masks.cpu().numpy(), h=FRAG, w=FRAG,
            per_frame=per_frame, seed=seed)
        sets.append((frames, labels.cpu().numpy(), frags, flabels))
    return sets


def generators(B):
    """The ``(h, D)`` permutation generators of a flat ``(h*w, D)`` base:
    row ``r*w`` is ``roll(B0[r], 0)``."""
    return B.reshape(FRAG, FRAG, DIM)[:, 0, :].contiguous()


def train_path(frags, flabels, test):
    """The training path once: train, score the held-out fragments and
    frames. Returns the model, its outputs and each step's wall seconds."""
    test_frames, test_labels, tfrags, tflabels = test
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    wall = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    model, info = step("train_s", lambda: fragment_model.train_fragment_model(
        gen, frags, flabels, dim=DIM, epochs=EPOCHS, base_kind="perm",
        device=DEVICE))
    hv_te = step("encode_held_out_s", lambda: fragment_model.encode(
        model, torch.as_tensor(tfrags, device=DEVICE)))
    scores = step("positive_score_s", lambda: fragment_model.positive_score(
        model.class_hvs, hv_te)).cpu().numpy()
    fpr, tpr, _ = metrics.roc_curve(scores, tflabels)
    B0 = generators(model.B)
    hs = hypersense.from_fragment_model(model, B0, h=FRAG, w=FRAG,
                                        stride=STRIDE)
    frame_scores = step("frame_scores_s", lambda: hypersense.frame_scores_batch(
        hs, test_frames)).cpu().numpy()
    ffpr, ftpr, _ = metrics.roc_curve(frame_scores, test_labels)
    out = dict(val_accuracy=info["val_accuracy"], best=info["best"],
               fragment_auc=metrics.auc(fpr, tpr),
               fragment_partial_auc=metrics.partial_auc_above_tpr(fpr, tpr),
               frame_auc=metrics.auc(ffpr, ftpr))
    return model, hv_te, scores, frame_scores, out, wall


def train_phase(g):
    """The training path at the paper's width, counted, then again for a
    bitwise comparison; then its three kernels against their plain
    versions at the path's shapes. Returns the path's record, its
    launches per kernel and the kernels' records."""
    t0 = time.perf_counter()
    (_, _, frags, flabels), test = fragment_sets(g)
    sample_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for mod in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    model, hv_te, scores, frame_scores, out, wall = train_path(
        frags, flabels, test)
    launches = {k: mod.LAUNCHES for k, mod in TRAIN_KERNELS.items()}
    again = train_path(frags, flabels, test)
    check(torch.equal(model.class_hvs, again[0].class_hvs)
          and np.array_equal(scores, again[2])
          and np.array_equal(frame_scores, again[3]) and out == again[4],
          "the training path differs run to run")
    check(np.isfinite(scores).all() and scores.shape == (len(test[2]),)
          and np.isfinite(frame_scores).all()
          and frame_scores.shape == (N_HELD_OUT,),
          "held-out scores not finite or of the wrong shape")
    check(out["fragment_auc"] > 0.6 and out["frame_auc"] > 0.6,
          f"the fragment model did not learn the blobs: {out}")

    # the retraining loop alone: one epoch of per-sample updates
    x_tr = encoding.normalize_flat(torch.as_tensor(
        frags, device=DEVICE).reshape(len(frags), -1))
    B0 = generators(model.B)
    hv_tr = enc_perm.hdc_encode_perm(x_tr, B0, model.b, h=FRAG, w=FRAG)
    labels_t = torch.as_tensor(flabels, device=DEVICE).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fragment_model.retrain_epoch(model.class_hvs, hv_tr, labels_t)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_profile = device_profile(lambda: fragment_model.retrain_epoch(
        model.class_hvs, hv_tr, labels_t))

    record = dict(
        frames=N_TRAIN, held_out_frames=N_HELD_OUT,
        fragments=len(frags), positives=int(flabels.sum()),
        held_out_fragments=len(test[2]), epochs=EPOCHS, sample_s=sample_s,
        **wall, retrain_epoch_s=epoch_s,
        update_us=epoch_s / len(frags) * 1e6,
        retrain_epoch_profile=epoch_profile, launches=launches,
        run_to_run_bitwise=True, **out)
    x_te = encoding.normalize_flat(torch.as_tensor(
        test[2], device=DEVICE).reshape(len(test[2]), -1))
    return record, launches, train_kernel_checks(model, B0, x_tr, x_te,
                                                 hv_te)


def train_kernel_checks(model, B0, x_tr, x_te, hv_te):
    """Each training kernel against its plain version, a second run
    bitwise, and timings, on the training path's own inputs: the training
    fragments through ``hdc_encode_perm``, the held-out ones through
    ``hdc_encode`` against the expanded base, and the held-out
    hypervectors through ``similarity`` (``similarity_checks`` for its
    other shapes); then both encoders at the RAGGED shapes
    (``ragged_encode_checks``)."""
    B, b = model.B, model.b
    lib = _build.load("similarity")
    check(all(sim.chunk(D) == lib.similarity_chunk(D) for D in SIM_PLAN_DS),
          "python and CUDA similarity chunk plans differ")
    pin_fp32_matmul()
    records = []
    K = FRAG * FRAG

    def hold(name, got, again, plain, atol):
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(err <= atol, f"{name} kernel vs plain: {err}")
        check(torch.equal(got, again), f"{name} kernel differs run to run")
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        return err

    # --- hdc_encode_perm: the training encode
    N = x_tr.shape[0]
    got = enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG, w=FRAG)
    err = hold("hdc_encode_perm", got,
               enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG, w=FRAG),
               enc_perm.hdc_encode_perm_plain(x_tr, B0, b, w=FRAG),
               HV_ATOL)
    hv_tr = got
    dense = enc.hdc_encode(x_tr, B, b)
    torch.cuda.synchronize()
    check(torch.equal(got, dense),
          "hdc_encode_perm differs from hdc_encode on the expanded base")
    records.append(dict(
        name="hdc_encode_perm", route="cuda",
        source="src/repro_torch/kernels/csrc/hdc_encode_perm.cu",
        replaces="src/repro/kernels/hdc_encode_perm.py:36",
        max_abs_err=err, vs_dense_bitwise=True, run_to_run_bitwise=True,
        shape=[N, K, DIM], **occupancy("hdc_encode_perm", N, DIM),
        ms=time_ms(lambda: enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG,
                                                    w=FRAG)),
        plain_ms=time_ms(lambda: enc_perm.hdc_encode_perm_plain(
            x_tr, B0, b, w=FRAG)),
        library_ms=time_ms(lambda: torch.matmul(x_tr, B)),
        **encode_bounds(4 * (N * K + FRAG * DIM + DIM + N * DIM), N, K)))

    # --- hdc_encode: the held-out encode against the expanded base
    N = x_te.shape[0]
    got = enc.hdc_encode(x_te, B, b)
    err = hold("hdc_encode", got, enc.hdc_encode(x_te, B, b),
               enc.hdc_encode_plain(x_te, B, b), HV_ATOL)
    records.append(dict(
        name="hdc_encode", route="cuda",
        source="src/repro_torch/kernels/csrc/hdc_encode.cu",
        replaces="src/repro/kernels/hdc_encode.py:27",
        max_abs_err=err, run_to_run_bitwise=True, shape=[N, K, DIM],
        **occupancy("hdc_encode", N, DIM),
        ms=time_ms(lambda: enc.hdc_encode(x_te, B, b)),
        plain_ms=time_ms(lambda: enc.hdc_encode_plain(x_te, B, b)),
        library_ms=time_ms(lambda: torch.matmul(x_te, B)),
        **encode_bounds(4 * (N * K + K * DIM + DIM + N * DIM), N, K)))

    # --- similarity: the held-out hypervectors against the two classes
    C = model.class_hvs
    got = sim.similarity(hv_te, C)
    err = hold("similarity", got, sim.similarity(hv_te, C),
               sim.similarity_plain(hv_te, C), SCORE_ATOL)
    nc = C.shape[0]
    records.append(dict(
        name="similarity", route="cuda",
        source="src/repro_torch/kernels/csrc/similarity.cu",
        replaces="src/repro/kernels/similarity.py:26",
        max_abs_err=err, run_to_run_bitwise=True, shape=[N, DIM, nc],
        ms=time_ms(lambda: sim.similarity(hv_te, C)),
        plain_ms=time_ms(lambda: sim.similarity_plain(hv_te, C)),
        library_ms=time_ms(lambda: torch.nn.functional.cosine_similarity(
            hv_te[:, None], C[None], dim=-1)),
        **sim_bound(N, nc), **similarity_checks(hv_te, hv_tr, C)))
    # each kernel's device time alone, from the profiler: ``ms`` above is a
    # whole wrapper call, which includes the host's enqueue
    calls = {"hdc_encode_perm": (lambda: enc_perm.hdc_encode_perm(
                 x_tr, B0, b, h=FRAG, w=FRAG), ("encode_kernel",)),
             "hdc_encode": (lambda: enc.hdc_encode(x_te, B, b),
                            ("encode_kernel",)),
             "similarity": (lambda: sim.similarity(hv_te, C),
                            ("sim_cluster",))}
    for r in records:
        r["kernel_device_ms"], r["kernel_device_by_kernel_ms"] = \
            kernel_device_ms(*calls[r["name"]])
    ragged = ragged_encode_checks()
    for r in records:
        if r["name"] in ragged:
            r["ragged_max_abs_err"] = ragged[r["name"]]
            r["beats_library"] = r["ms"] <= r["library_ms"]
    return records


def sim_bound(N: int, C: int) -> dict:
    """``similarity``'s bound at (N, DIM, C): each input read once, the
    scores written once; 2 (C + 1) float32 operations per query element
    (the dots and q.q) and 2 per class element."""
    return bound(4 * (N * DIM + C * DIM + N * C),
                 2 * N * DIM * (C + 1) + 2 * C * DIM, F32_OPS_S)


def kernel_counts(fn, calls: int) -> dict:
    """Device kernels of ``calls`` calls of ``fn`` under the profiler, by
    name, between one-element fills on either side (not counted): the
    profiler has lost a window's edge launches on the H100."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU \
                and e.self_device_time_total > 0 \
                and "FillFunctor" not in e.key:
            counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
    return counts


def one_launch_per_call(fn, name: str, calls: int = 3,
                        windows: int = 3) -> int:
    """Check from the profiler's events that each call of ``fn`` launches
    kernel ``name`` once and no other kernel. A window that recorded
    fewer launches than the calls made (the profiler has lost events
    right after a large profile) is taken again, up to ``windows`` times;
    more launches, or another kernel, fails at once. Returns the windows
    taken."""
    for taken in range(1, windows + 1):
        counts = kernel_counts(fn, calls)
        check(len(counts) <= 1 and all(name in k for k in counts)
              and sum(counts.values()) <= calls,
              f"{name}: more than one launch per call: {counts}")
        if sum(counts.values()) == calls:
            return taken
    raise AssertionError(f"{name}: {counts} in {calls} calls, "
                         f"{windows} windows")


def similarity_launches() -> dict:
    """``similarity`` at the held-out call's shape (384 x DIM, seeded
    random rows) for C = 2, 9, 17 and 33 classes: one ``sim_cluster``
    launch per call at every C, counted from the profiler's events. Run
    before any other profile of the process: after the training epoch's
    profile the H100's profiler lost one launch in every window."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 6)
    q = torch.randn((384, DIM), generator=g, device=DEVICE)
    windows = {}
    for nc in (2, 9, 17, 33):
        c = torch.randn((nc, DIM), generator=g, device=DEVICE)
        sim.similarity(q, c)
        windows[nc] = one_launch_per_call(lambda: sim.similarity(q, c),
                                          "sim_cluster")
    return dict(launches_per_call={nc: 1 for nc in windows},
                profile_windows=windows)


def similarity_checks(q, hv_tr, C) -> dict:
    """``similarity`` beyond the held-out call, each result within
    SCORE_ATOL of the plain version and bitwise the same run to run:
    C = 9, 17 and 33 classes; a row bitwise the same in a 7-row call and
    inside the held-out call; the two classes' columns bitwise the same
    inside a 17-class call; a misaligned view (storage offset 1) bitwise
    equal to its aligned copy; and, timed, the training path's N = 512
    (``accuracy``) and a held-out split of 16,384 hypervectors (327.9 MB,
    past the 50 MB L2)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 5)
    D = q.shape[1]
    out = dict(many_classes_max_abs_err={})

    def hold(what, got, again, plain):
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(err <= SCORE_ATOL, f"similarity {what}: {err}")
        check(torch.equal(got, again), f"similarity {what} run to run")
        check(bool(torch.isfinite(got).all()), f"similarity {what}: not "
              f"finite")
        return err

    for nc in (9, 17, 33):
        c = torch.randn((nc, D), generator=g, device=DEVICE)
        out["many_classes_max_abs_err"][nc] = hold(
            f"at C={nc}", sim.similarity(q, c), sim.similarity(q, c),
            sim.similarity_plain(q, c))
    full = sim.similarity(q, C)
    seven = sim.similarity(q[13:20].clone(), C)
    wide = sim.similarity(q, torch.cat([C, torch.randn(
        (15, D), generator=g, device=DEVICE)]))
    storage = torch.empty(q.numel() + 1, device=DEVICE)
    view = storage[1:].view(q.shape)
    view.copy_(q)
    check(view.data_ptr() % 16 != 0, "the view is not misaligned")
    torch.cuda.synchronize()
    check(torch.equal(seven, full[13:20]),
          "similarity: a 7-row call differs from the held-out call")
    check(torch.equal(wide[:, :2], full),
          "similarity: the two classes differ inside a 17-class call")
    check(torch.equal(sim.similarity(view, C), full),
          "similarity: a misaligned view differs from its aligned copy")
    out.update(rows_bitwise=True, classes_bitwise=True,
               misaligned_bitwise=True)

    big = torch.randn((16384, D), generator=g, device=DEVICE)
    out["shapes"] = {}
    for x in (hv_tr, big):
        N = x.shape[0]
        err = hold(f"at N={N}", sim.similarity(x, C), sim.similarity(x, C),
                   sim.similarity_plain(x, C))
        dev, _ = kernel_device_ms(lambda: sim.similarity(x, C),
                                  ("sim_cluster",))
        rec = dict(max_abs_err=err, ms=time_ms(lambda: sim.similarity(x, C)),
                   kernel_device_ms=dev,
                   plain_ms=time_ms(lambda: sim.similarity_plain(x, C)),
                   library_ms=time_ms(
                       lambda: torch.nn.functional.cosine_similarity(
                           x[:, None], C[None], dim=-1)),
                   **sim_bound(N, C.shape[0]))
        if isinstance(dev, float):
            rec["share_of_bound"] = rec["bound_ms"] / dev
        out["shapes"][N] = rec
    return out


def encode_bounds(n_bytes: int, N: int, K: int) -> dict:
    """An encoder's two bounds: 2*N*K*D float32 operations on the CUDA
    cores (``bound_ms``), and the 3*2*N*K*D TF32 operations of the 3xTF32
    split on the tensor cores (``bound_tc_ms``)."""
    tc = bound(n_bytes, 3 * 2 * N * K * DIM, TF32_OPS_S)
    return dict(**bound(n_bytes, 2 * N * K * DIM, F32_OPS_S),
                bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"])


def occupancy(name: str, N: int, D: int) -> dict:
    """The encoder's launch at (N, D): its output tile, blocks, resident
    blocks per SM, dynamic shared memory per block, waves on this card and
    the share of the waves' block slots the blocks fill."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check(getattr(_build.load(name), f"{name}_occupancy")(
        N, D, *map(ctypes.byref, vals)), f"{name}_occupancy")
    tile_n, blocks, per_sm, smem = (v.value for v in vals)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(blocks / slots)
    return dict(tile=[128, tile_n], blocks=blocks, blocks_per_sm=per_sm,
                smem_bytes=smem, waves=waves,
                wave_efficiency=blocks / (waves * slots))


def ragged_encode_checks() -> dict:
    """Both encoders at the RAGGED shapes, for each nonlinearity: within
    HV_ATOL of the plain version, bitwise equal run to run, and
    ``hdc_encode_perm`` bitwise equal to ``hdc_encode`` on the expanded
    base. ``sign`` is held where the projection is clear of 0 by more than
    HV_ATOL (elsewhere float32 rounding may flip it). Returns each
    encoder's largest error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 2)
    worst = {"hdc_encode_perm": 0.0, "hdc_encode": 0.0}
    for N, h, w, D in RAGGED:
        x = encoding.normalize_flat(torch.rand((N, h * w), generator=g,
                                               device=DEVICE))
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        B = encoding.flat_perm_base(B0, w)
        proj = enc.hdc_encode_plain(x, B, b, nonlinearity="linear")
        for nl in ("rff", "linear", "sign"):
            keep = proj.abs() > HV_ATOL if nl == "sign" else \
                torch.ones_like(proj, dtype=torch.bool)
            plain = enc.hdc_encode_plain(x, B, b, nonlinearity=nl)
            outs = {"hdc_encode_perm": [enc_perm.hdc_encode_perm(
                        x, B0, b, h=h, w=w, nonlinearity=nl)
                        for _ in range(2)],
                    "hdc_encode": [enc.hdc_encode(x, B, b, nonlinearity=nl)
                                   for _ in range(2)]}
            torch.cuda.synchronize()
            what = f"(N, h, w, D) = {(N, h, w, D)}, {nl}"
            check(keep.float().mean() > 0.99, f"{what}: projections near 0")
            for name, (got, again) in outs.items():
                err = float((got - plain)[keep].abs().max())
                check(err <= HV_ATOL, f"{name} vs plain at {what}: {err}")
                check(torch.equal(got, again),
                      f"{name} differs run to run at {what}")
                worst[name] = max(worst[name], err)
            check(torch.equal(outs["hdc_encode_perm"][0],
                              outs["hdc_encode"][0]),
                  f"hdc_encode_perm differs from hdc_encode at {what}")
    return worst


def kernel_device_ms(fn, names, calls: int = 5):
    """Device time of one call of ``fn`` spent in the kernels whose names
    contain one of ``names``: ``calls`` calls under ``torch.profiler``, each
    kernel's mean over the launches the profiler recorded (it has dropped
    single launches on the H100, so the window opens with a one-element
    fill), summed over the kernels. "not measured" if a kernel was never
    recorded. Returns the sum and the means."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    means = {n: e.self_device_time_total / e.count / 1e3
             for e in prof.key_averages()
             if e.device_type != torch.autograd.DeviceType.CPU
             and e.self_device_time_total > 0
             for n in names if n in e.key}
    total = sum(means.values()) if len(means) == len(names) else \
        "not measured"
    return total, means


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = _build.build()
    emit({"build_s": time.perf_counter() - t0, "ptxas": {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "entry" in ln]
        for name, log in logs.items()}})

    sim_launches = similarity_launches()
    emit({"similarity_launches": sim_launches})

    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    model, *cal = make_model(g)
    labels = ((torch.arange(N_STREAM, device=DEVICE) // 16) % 3 == 2).long()
    raw, _ = synthetic_frames(g, labels)
    emit({"model": {"frame": FRAME, "fragment": FRAG, "stride": STRIDE,
                    "D": DIM, "nonlinearity": "rff", "t_detection": 0,
                    "seed": SEED, "setup_s": time.perf_counter() - t0}})

    records = kernel_phase(calibrated(model, *cal, "float32", 4),
                           raw[:CHUNK])
    for r in records:
        emit({"kernel_check": r})
    runs, launches = stream_phase(model, cal, raw, labels)
    emit({"profile": profile_phase(model, cal, raw)})
    train, train_launches, train_records = train_phase(g)
    emit({"train": train})
    for r in train_records:
        if r["name"] == "similarity":
            r.update(sim_launches)
        emit({"kernel_check": r})
    records += train_records
    # launches: the six stream runs' and the training path's, each counted
    # from zero right before its run
    for r in records:
        r["launches"] = launches.get(r["name"], 0) + train_launches.get(
            r["name"], 0)
        check(r["launches"] > 0, f"{r['name']} never ran on a main path")
    for name, n in train_launches.items():
        check(n > 0, f"{name} never ran on the training path")
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_tc_ms") if k in r} for r in records]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
