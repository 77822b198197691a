#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card (built for
sm_90a: an H100). It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds all six kernels from ``src/repro_torch/kernels/csrc`` with
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
7. drives the fleet, ``FleetRunner.process``, over 8 streams of 256
   frames (each stream its own frames and object schedule) six times
   (float32, int8, the closed capture loop, int8 with per-stream and with
   shared adaptation, float32 with ADC noise): each ``(8, 32)``
   super-chunk must make exactly one scorer call; each stream must be
   bitwise what an independent ``StreamRunner`` gives it (but under the
   shared classifier); the run fed as two ``process`` calls bitwise the
   whole run; super-chunk scores within 5e-5 of the plain version; each
   run billed by ``fleet_report`` (finite, a saving between 0 and 1, the
   open-loop capture bill exactly the duty bill); it prints each run's
   fps beside that of 8 looped ``StreamRunner``s, profiles the float32
   and int8 runs, and records how many streams' bits a class norm or a
   re-encode taken over the whole stack would change;
8. serves the fleet's frames through ``FleetService`` (dispatch/collect
   pipelined on the card, a slot pool under churn, checkpoints): the
   float32, int8 and closed-loop services bitwise ``FleetRunner`` on the
   same trace (scores, decisions, capture logs, HP drains), their tick-0
   scores within 5e-5 of the plain version, one scorer call per tick;
   ``max_inflight`` 1, 2, 4 and 8 bitwise the same; an int8 and a noisy
   float32 run under a seeded churn schedule (attach, detach, ragged
   arrival, a silent tick, a sensor reattached through another tenant of
   its slot) with per-stream pseudo adaptation, each sensor bitwise its
   own ``StreamRunner``, and no rebuild after the warm-up tick; a
   checkpoint at tick 4 resumed bitwise by a fresh service; warm frozen
   dispatches free of host syncs (``torch.cuda.set_sync_debug_mode``);
   it prints the fps of the service and of ``FleetRunner``, their
   device busy shares and the dispatch->collect latency;
9. serves the gated cascade (paper §V-E): the closed-loop float32
   ``FleetService`` (8 slots, 8 ticks, HP at 12 bits) feeds its HP drains
   to a ``CascadeService`` over the full-width ``hubert-xlarge`` detector
   (48 layers, bf16, random weights from a seeded generator; 128x128
   frames at patch 8, batches of 8, 2 in flight, one CUDA graph), pumped
   after every collect, then flushed: every HP frame returns once with
   its (sensor, index), the logits are finite, batched logits equal
   ``eager`` bitwise at every batch position and in a padded tail, the
   graph is built once, warm submits are free of host syncs, and the card
   agrees with the CPU at full width on 2 layers (bf16) and at the smoke
   config (float32); ``backbone_cost`` must equal the hand count of the
   products. It prints the backbone's frames/s and ms per batch against
   the batch's bounds, its device busy share, the site's frames/s against
   the gate's alone, and the energy bill against an always-on backbone;
10. drives the training path (paper Fig. 5a) at the same width: samples
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
11. drives the int-datapath path (``benchmarks/int_datapath.py``'s
   claims): the float32 kernel, the live int8 kernel and the expanded-slab
   kernel (the int scorer's retired layout, ``csrc/int_expanded.cu``) race
   on one ADC capture at the reference's shape (32x32 frames, 8x8
   fragments, stride 4, D 256, chunk 16) and at the paper's operating
   point (``configs/hypersense.py``, chunk 32): one launch a call, the
   expanded window sums bitwise the live kernel's, its scores within 1e-6
   of the live kernel's and within 5e-5 of its plain version, both int
   paths bitwise run to run and across a fresh precompute, ms per chunk,
   fps and speedups; the live int kernel at 4x the reference's frame
   width against its plain version, and the expanded operand's bytes at
   the deployment geometry beside the live block's; frame-score AUC of a
   gate trained on ``sensing/synthetic`` frames, float vs int8 and float at
   4 bits vs packed int4, on a synthetic and a drifted stream (gaps within
   0.01), also at the paper's operating point (reported); the binary
   gate's D-vs-AUC curve (each map within 5e-5 of the plain version; the
   reference's 0.85 claim on its best point reported); and the stream gate
   (``core/gate.py``) over 256 frames at the paper's point, its decisions
   equal to the same gate's on the CPU wherever the deciding score sits
   more than 2.5e-4 from ``t_score``, its frames/s, duty cycle and the
   detector FLOPs it saves;
12. runs Table I and Fig. 16's model comparison (``baselines`` phase):
   ``benchmarks/common.py``'s noisy 4-bit data made with
   ``sensing.synthetic`` (training noise 0.20; held-out noise 0.30 with
   3% impulse spikes), balanced fragments, at the paper's operating point
   (256 and 128 frames) and at the reference's scale (64x64 frames,
   16x16 fragments, D 8192, 60 and 100 frames); trains the HDC Fragment
   model (its kernels counted) and the MLP2, MLP4 and TinyConv baselines
   (``sensing/baselines.py``, AdamW from ``train/optim.py``) and prints
   each row's AUC, partial AUC above TPR 0.8, train seconds and the
   paper's value, on the held-out fragments and on the same windows of a
   ``low_precision_view`` (4 bits, sigma 0.01); checks that training
   lowered each baseline's cross-entropy, that the card's logits, the
   gradients of one step and its AdamW update equal the CPU's within
   1e-5, and that the MLPs train bitwise run to run (TinyConv reported);
   then times, per frame of a 32-frame chunk, the float32 HDC scorer
   against MLP2 on all 25 windows (beside the paper's 2.4x) and
   ``encode_frames`` with and without reuse;
13. prints one JSON line per phase, a ``kernels`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero as well without a CUDA device, or outside a checkout.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import math
import pathlib
import shutil
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
from repro_torch.core import (encoding, energy,  # noqa: E402
                              fragment_model, hypersense, metrics)
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
from repro_torch import configs  # noqa: E402
from repro_torch.configs import hypersense as paper_config  # noqa: E402
from repro_torch.core import gate as hs_gate  # noqa: E402
from repro_torch.kernels import int_expanded as ie  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.cascade import CascadeService  # noqa: E402
from repro_torch.launch.serve import FleetService  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.sensing import (adc, baselines, fleet,  # noqa: E402
                                 fragments, stream, synthetic)
from repro_torch.train import optim  # noqa: E402

# the paper's operating point (configs/hypersense.py)
FRAME, FRAG, STRIDE, DIM, BLOCK_D = 128, 96, 8, 5000, 512
CHUNK, N_STREAM = 32, 256
# the fleet: streams, and where a run is cut into two process calls (on
# the chunk grid, 96, when it adapts: each chunk is scored with the
# classifier of its start)
FLEET_S, FLEET_CUT = 8, 100
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
# TF32, bf16 and int8 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
TF32_OPS_S = 495e12
BF16_OPS_S = 989e12
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


FLEET_RUNS = {
    # name: (precision, adc_bits, closed loop, adapt scope, adc_sigma)
    "fleet_float32": ("float32", 4, False, None, 0.0),
    "fleet_int8": ("int8", 8, False, None, 0.0),
    "fleet_closed_loop_float32": ("float32", 4, True, None, 0.0),
    "fleet_adapt_int8_per_stream": ("int8", 8, False, "per-stream", 0.0),
    "fleet_adapt_int8_shared": ("int8", 8, False, "shared", 0.0),
    "fleet_noisy_float32": ("float32", 4, False, None, 0.02),
}


def fleet_data(g):
    """``(FLEET_S, N_STREAM, FRAME, FRAME)`` frames and their labels: each
    stream its own draw of synthetic frames, with the stream phase's
    object schedule (one run of 16 in every 48 frames) shifted by 6 frames
    per stream."""
    idx = torch.arange(N_STREAM, device=g.device)
    labels = torch.stack([((idx + 6 * s) // 16) % 3 == 2
                          for s in range(FLEET_S)]).long()
    raw = torch.stack([synthetic_frames(g, lab)[0] for lab in labels])
    return raw, labels


def fleet_views(raw, precision, bits, sigma, start):
    """What each stream's scorer sees of ``raw (S, c, H, W)`` from its
    absolute frame ``start``: stream s's ADC noise keyed by
    ``fleet.stream_seed(SEED, s)``, as ``FleetRunner`` keys it."""
    view = (stream.adc_view_codes if precision in adc.INT_PRECISIONS
            else stream.adc_view)
    return torch.stack([view(raw[s], bits, sigma=sigma,
                             seed=fleet.stream_seed(SEED, s),
                             start_index=start)
                        for s in range(raw.shape[0])])


def fleet_plain_err(raw, scores, model, precision, bits, sigma, chvs, lo):
    """Largest difference between the fleet's scores of the super-chunk
    at frame ``lo`` and the plain version's, scored with the classifiers
    ``chvs`` (``(2, D)`` shared or ``(S, 2, D)`` per stream) the runner
    held at that super-chunk's start."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    views = fleet_views(raw[:, lo:lo + CHUNK], precision, bits, sigma, lo)
    S, C = views.shape[:2]
    flat = views.reshape(S * C, FRAME, FRAME)
    geom = stream.model_geometry(model, FRAME, BLOCK_D, precision)
    per_stream = dict(frames_per_stream=C) if chvs.ndim == 3 else {}
    if precision in adc.INT_PRECISIONS:
        retile = (ops.retile_classes_int_fleet if chvs.ndim == 3
                  else ops.retile_classes_int)
        maps = ssi.fragment_scores_batch_int_plain(
            flat, retile(geom, chvs), **kw, **per_stream)
    else:
        retile = (ops.retile_classes_fleet if chvs.ndim == 3
                  else ops.retile_classes)
        maps = ss.fragment_scores_batch_plain(flat, retile(geom, chvs),
                                              **kw, **per_stream)
    want = frame_detection_score(maps, 0).reshape(S, C).cpu().numpy()
    return float(abs(scores[:, lo:lo + C] - want).max())


def stacked_forms(g) -> dict:
    """Why the fleet takes some things stream by stream, measured at its
    shapes (no check): the streams of FLEET_S whose bits change when the
    positive class norms of an ``(S, 2, D)`` stack are taken in one call
    over its ``[:, 1]`` view instead of each alone (``ss.class_norms``),
    and when the online fold's top fragments are encoded as one
    ``S*CHUNK``-row matmul instead of ``CHUNK`` rows per stream
    (``stream._top_fragment_hvs``)."""
    x = torch.randn((FLEET_S, 2, DIM), generator=g, device=DEVICE)[:, 1]
    one_call = torch.linalg.vector_norm(x, dim=-1)
    frags = torch.rand((FLEET_S, CHUNK, FRAG, FRAG), generator=g,
                       device=DEVICE)
    base = encoding.flat_perm_base(torch.randn((FRAG, DIM), generator=g,
                                               device=DEVICE), FRAG)
    b = 2 * math.pi * torch.rand(DIM, generator=g, device=DEVICE)
    stacked = encoding.encode_fragments(
        frags.reshape(FLEET_S * CHUNK, FRAG, FRAG), base, b).reshape(
            FLEET_S, CHUNK, DIM)
    per_stream = torch.stack([encoding.encode_fragments(f, base, b)
                              for f in frags])
    return dict(norm_streams_differ=int((ss.class_norms(x) != one_call)
                                        .sum()),
                encode_streams_differ=int((stacked != per_stream)
                                          .flatten(1).any(1).sum()),
                encode_max_abs_diff=float((stacked - per_stream).abs()
                                          .max()))


def fleet_phase(base_model, cal, raw, labels):
    """The fleet: ``FleetRunner`` over FLEET_S streams of N_STREAM frames,
    once per FLEET_RUNS entry. Each run makes one scorer wrapper call per
    super-chunk; each stream is bitwise what an independent StreamRunner
    gives it (but under a shared classifier, which no single stream has);
    the run fed as two process calls is bitwise the whole run; the scores
    of super-chunk 0 (and, adapting, of the super-chunk at the cut) are
    within SCORE_ATOL of the plain version; each run is billed by
    ``fleet_report``. One float32 and one int8 run are profiled. Returns
    the runs' records and the launches they made per kernel."""
    S, n = raw.shape[:2]
    n_chunks = math.ceil(n / CHUNK)
    labels_np = labels.cpu().numpy()
    ctrl = ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                            active_rate_hz=30.0)
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed, scope, sigma) in FLEET_RUNS.items():
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      adc_sigma=sigma, precision=precision,
                      control=CaptureConfig(hp_bits=12) if closed else None,
                      device=DEVICE)
        adapt = None if scope is None else AdaptConfig(
            mode="label", lr=0.5, scope=scope)
        feed = None if adapt is None else labels_np
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")

        def runner():
            return fleet.FleetRunner(model, ctrl, adc_seed=SEED, adapt=adapt,
                                     **common)

        def part(lo, hi):
            return None if feed is None else feed[:, lo:hi]

        runner().process(raw[:, :CHUNK], labels=part(0, CHUNK))  # warm-up
        # (a) the main-path run: counts zeroed right before, read right after
        rf = runner()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        t0 = time.perf_counter()
        scores, fired, gated = rf.process(raw, labels=feed)
        wall = time.perf_counter() - t0
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        check(counts[kernel] == n_chunks,
              f"{name}: {counts[kernel]} scorer calls for {n_chunks} "
              f"super-chunks of {S} streams")
        check(sum(counts.values()) == n_chunks,
              f"{name}: the other kernel launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
        check(np.isfinite(scores).all() and scores.shape == (S, n),
              f"{name}: scores not finite or of the wrong shape")
        log, drains = rf.capture_log, rf.drain_hp()

        # (b) the same frames through S looped StreamRunners, each held
        #     bitwise against its stream of the fleet
        rkw = dict(common, adapt=None if adapt is None else AdaptConfig(
            mode="label", lr=0.5))
        loop = [stream.StreamRunner(model, ctrl,
                                    adc_seed=fleet.stream_seed(SEED, s),
                                    **rkw) for s in range(S)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [r.process(raw[s], labels=None if feed is None else feed[s])
                for s, r in enumerate(loop)]
        looped_wall = time.perf_counter() - t0
        independent = scope != "shared"
        if independent:
            for s, (r, out) in enumerate(zip(loop, outs)):
                what = f"{name}: stream {s} differs from its StreamRunner"
                for got, want in zip((scores, fired, gated), out):
                    check(np.array_equal(got[s], want), f"{what} (gate)")
                rlog = r.capture_log
                check(np.array_equal(log.sampled[s], rlog.sampled)
                      and np.array_equal(log.gated[s], rlog.gated),
                      f"{what} (capture log)")
                idx, hp = r.drain_hp()
                check(np.array_equal(drains[s][0], idx)
                      and np.array_equal(drains[s][1], hp),
                      f"{what} (HP drain)")
                if adapt is not None:
                    check(torch.equal(rf.class_hvs[s], r.class_hvs),
                          f"{what} (classifier)")

        # (c) the run fed as two process calls
        cut = FLEET_CUT if adapt is None else FLEET_CUT // CHUNK * CHUNK
        rs = runner()
        first = rs.process(raw[:, :cut], labels=part(0, cut))
        chvs_cut = rs.class_hvs.clone()
        second = rs.process(raw[:, cut:], labels=part(cut, n))
        slog, sdrains = rs.capture_log, rs.drain_hp()
        for got, a, b in zip((scores, fired, gated), first, second):
            check(np.array_equal(got, np.concatenate([a, b], axis=1)),
                  f"{name}: slicing or a rerun changed the output")
        check(np.array_equal(log.sampled, slog.sampled)
              and np.array_equal(log.gated, slog.gated)
              and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                      for x, y in zip(drains, sdrains))
              and torch.equal(rf.class_hvs, rs.class_hvs),
              f"{name}: slicing changed the log, drains or classifier")

        # (d) against the plain version
        err = fleet_plain_err(raw, scores, model, precision, bits, sigma,
                              model.class_hvs if scope != "per-stream" else
                              model.class_hvs.expand(S, 2, DIM), 0)
        if adapt is not None:
            err = max(err, fleet_plain_err(raw, scores, model, precision,
                                           bits, sigma, chvs_cut, cut))
        check(err <= SCORE_ATOL, f"{name}: fleet vs plain {err}")

        # (e) the energy account, at the run's LP depth
        params = energy.EnergyParams(adc_lp_bits=bits)
        rep = fleet.fleet_report(fired, gated, labels_np, params, precision,
                                 capture=log)
        by_duty = fleet.fleet_report(fired, gated, labels_np, params,
                                     precision)
        check(math.isfinite(rep.energy_total_j)
              and math.isfinite(rep.baseline_total_j)
              and 0.0 < rep.total_saving < 1.0,
              f"{name}: energy report out of range: {rep}")
        if closed:
            check(not log.sampled.all()
                  and rep.energy_total_j < by_duty.energy_total_j,
                  f"{name}: the closed loop saved no LP conversion")
        else:
            check(energy.from_capture_log(log, params, precision)
                  == energy.hypersense_measured(float(log.gated.mean()),
                                                params, precision),
                  f"{name}: the open-loop capture bill is not the duty "
                  f"bill")
        rec = dict(
            run=name, precision=precision, adc_bits=bits, closed_loop=closed,
            adapt=scope, adc_sigma=sigma, streams=S, frames_per_stream=n,
            chunk=CHUNK, super_chunks=n_chunks, launches=counts,
            fps=S * n / wall, wall_s=wall, looped_fps=S * n / looped_wall,
            looped_wall_s=looped_wall,
            streams_bitwise_vs_runners=(True if independent
                                        else "shared classifier"),
            sliced_run_bitwise=True, cut=cut, max_abs_err_vs_plain=err,
            fired=int(fired.sum()), gated=int(gated.sum()),
            sampled=int(log.sampled.sum()),
            hp_frames=sum(len(i) for i, _ in drains),
            duty_cycle=rep.duty_cycle,
            energy_per_frame_j=rep.energy_per_frame.total,
            energy_total_j=rep.energy_total_j,
            baseline_total_j=rep.baseline_total_j,
            total_saving=rep.total_saving,
            duty_bill_total_j=by_duty.energy_total_j, t_score=model.t_score)
        if name in ("fleet_float32", "fleet_int8"):
            rp = runner()
            rp.process(raw[:, :CHUNK])
            rec["profile"] = device_profile(lambda: rp.process(raw))
        emit(rec)
        records.append(rec)
    return records, launches


SERVICE_RUNS = {
    # name: (precision, adc_bits, closed loop)
    "service_float32": ("float32", 4, False),
    "service_int8": ("int8", 8, False),
    "service_closed_loop_float32": ("float32", 4, True),
}
SERVICE_INFLIGHT = 2
# the churn runs: 10 sensors on the fleet's 8 slots, sensor i reading
# stream i % 8 of the fleet's frames from frame N_STREAM // 4 * (i // 8); a
# checkpoint at tick CKPT_TICK
CKPT_TICK = 4


def service_ctrl():
    return ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                            active_rate_hz=30.0)


def serve(svc, frames, sync_free: bool = False):
    """Every sensor 0..S-1 delivers its frames of ``frames`` (S, n, H, W),
    one ``CHUNK`` a tick; returns the collected ticks. With ``sync_free``
    the dispatches after the first run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises."""
    for k, lo in enumerate(range(0, frames.shape[1], CHUNK)):
        arrivals = {s: frames[s, lo:lo + CHUNK] for s in range(len(frames))}
        if sync_free and k > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            svc.dispatch(arrivals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return svc.flush()


def served_arrays(chunks, S: int):
    """``(S, n)`` scores, fired and gated from ticks where every sensor
    0..S-1 delivered."""
    return tuple(np.stack([np.concatenate([ch.outputs[s][j]
                                           for ch in chunks])
                           for s in range(S)]) for j in range(3))


def churn_schedule(n_ticks: int):
    """(detach, attach, arrivals) per tick on 8 slots: sensors 0-7 attach;
    3 leaves for 8; tick 2 is silent; 8 and 5 leave, 3 comes back to its
    slot through tenant 8, 9 joins; 0 leaves for 8, reattached; the other
    ticks ragged (each attached sensor delivers with probability 0.75,
    from a seeded generator), the last full."""
    g = torch.Generator().manual_seed(SEED + 8)
    churn = {0: ((), tuple(range(FLEET_S))), 1: ((3,), (8,)),
             3: ((8, 5), (3, 9)), 5: ((0,), (8,))}
    attached, out = set(), []
    for k in range(n_ticks):
        det, att = churn.get(k, ((), ()))
        attached = (attached - set(det)) | set(att)
        if k == 2:
            arrive = ()
        elif k in (0, n_ticks - 1):
            arrive = tuple(sorted(attached))
        else:
            arrive = tuple(sid for sid in sorted(attached)
                           if float(torch.rand((), generator=g)) < 0.75)
        out.append((det, att, arrive))
    return out


def play_churn(svc, frames_of, schedule, fed=None):
    """Run ``schedule`` on ``svc`` (sensor ``sid`` reads ``frames_of(sid)``
    from where it stopped); returns ``{sid: [(s, f, g), ...]}`` and the
    frames fed per sensor."""
    fed = {} if fed is None else fed
    for det, att, arrive in schedule:
        for sid in det:
            svc.detach(sid)
        for sid in att:
            svc.attach(sid)
        arrivals = {}
        for sid in arrive:
            n0 = fed.get(sid, 0)
            arrivals[sid] = frames_of(sid)[n0:n0 + CHUNK]
            fed[sid] = n0 + CHUNK
        svc.dispatch(arrivals)
    got = {}
    for ch in svc.flush():
        for sid, out in ch.outputs.items():
            got.setdefault(sid, []).append(out)
    return got, fed


def service_phase(base_model, cal, raw):
    """``FleetService`` over the fleet's FLEET_S streams of N_STREAM frames:
    (1) the float32, int8 and closed-loop services bitwise the
    ``FleetRunner`` of the same trace, one scorer call per tick, tick 0
    within SCORE_ATOL of the plain version, and (frozen, open loop) every
    dispatch after the first free of host syncs; (2) an int8 and a noisy
    float32 run under ``churn_schedule`` with per-stream pseudo adaptation,
    each sensor bitwise its own ``StreamRunner``, (4) no rebuild after the
    warm-up tick; (3) ``max_inflight`` 1, 4 and 8 (closed loop; 8 ticks
    in flight with no back-pressure, so every dispatch after the first is
    checked free of syncs) bitwise as 2; (5) a checkpoint at CKPT_TICK
    resumed bitwise by a fresh service. It times the services (host and
    card arrivals) and ``FleetRunner`` in turns, profiles float32 and
    int8, and takes the median dispatch->collect latency. Returns the
    records and the launches of (1)."""
    S, n = raw.shape[:2]
    n_ticks = n // CHUNK
    raw_np = raw.cpu().numpy()
    ctrl = service_ctrl()
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed) in SERVICE_RUNS.items():
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      precision=precision, adc_seed=SEED, device=DEVICE,
                      control=CaptureConfig(hp_bits=12) if closed else None)
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")

        def service(inflight=SERVICE_INFLIGHT):
            svc = FleetService(model, ctrl, n_slots=S, max_inflight=inflight,
                               **common)
            for s in range(S):
                svc.attach(s)
            return svc

        rf = fleet.FleetRunner(model, ctrl, **common)
        want = rf.process(raw)
        want_log, want_hp = rf.capture_log, rf.drain_hp()

        def same_as_runner(svc, chunks, what):
            check([ch.seq for ch in chunks] == list(range(n_ticks)),
                  f"{what}: ticks not collected in order")
            for got, ref_out in zip(served_arrays(chunks, S), want):
                check(np.array_equal(got, ref_out),
                      f"{what}: differs from FleetRunner (gate)")
            for s in range(S):
                log = svc.capture_log(s)
                check(np.array_equal(log.sampled, want_log.sampled[s])
                      and np.array_equal(log.gated, want_log.gated[s]),
                      f"{what}: sensor {s} capture log")
                idx, hp = svc.drain_hp(s)
                check(np.array_equal(idx, want_hp[s][0])
                      and np.array_equal(hp, want_hp[s][1]),
                      f"{what}: sensor {s} HP drain")
            check(svc.hp_dropped == rf.hp_dropped, f"{what}: hp_dropped")

        # (1) the main-path run: host arrivals, counts zeroed right before
        svc = service()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        chunks = serve(svc, raw_np, sync_free=not closed)
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        check(counts[kernel] == n_ticks and sum(counts.values()) == n_ticks,
              f"{name}: {counts} scorer calls for {n_ticks} ticks")
        for k, v in counts.items():
            launches[k] += v
        same_as_runner(svc, chunks, name)
        scores = served_arrays(chunks, S)[0]
        check(np.isfinite(scores).all() and scores.shape == (S, n),
              f"{name}: scores not finite or of the wrong shape")
        err = fleet_plain_err(raw, scores, model, precision, bits, 0.0,
                              model.class_hvs, 0)
        check(err <= SCORE_ATOL, f"{name}: tick 0 vs plain {err}")
        rec = dict(run=name, precision=precision, adc_bits=bits,
                   closed_loop=closed, slots=S, ticks=n_ticks, chunk=CHUNK,
                   max_inflight=SERVICE_INFLIGHT, launches=counts,
                   bitwise_vs_fleet_runner=True,
                   warm_dispatch_sync_free=not closed,
                   max_abs_err_vs_plain=err, fired=int(want[1].sum()),
                   hp_frames=sum(len(i) for i, _ in want_hp),
                   hp_dropped=rf.hp_dropped)

        # (3) pipelining depth (the closed loop: HP capture in collect)
        if closed:
            rec["max_inflight_bitwise"] = []
            for depth in (1, 4, n_ticks):
                ss.LAUNCHES = ssi.LAUNCHES = 0
                sv = service(depth)
                got = serve(sv, raw_np, sync_free=depth >= n_ticks)
                check(ss.LAUNCHES + ssi.LAUNCHES == n_ticks,
                      f"{name}: max_inflight={depth}: not one scorer call "
                      f"a tick")
                same_as_runner(sv, got, f"{name}, max_inflight={depth}")
                rec["max_inflight_bitwise"].append(depth)
            rec["warm_dispatch_sync_free_at_max_inflight"] = n_ticks

        # timing: FleetRunner and the service, each fed host (numpy) and
        # card frames, each warm, in turns; the latency of the host-arrival
        # ticks
        warm = service()
        serve(warm, raw_np)
        rf.process(raw)
        walls = {}
        for what, fn in (("runner_card", lambda: rf.process(raw)),
                         ("service_host", lambda: serve(warm, raw_np)),
                         ("service_card", lambda: serve(warm, raw)),
                         ("runner_host", lambda: rf.process(raw_np)),
                         ("runner_card_again", lambda: rf.process(raw))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            walls[what] = time.perf_counter() - t0
            if what == "service_host":
                rec["latency_median_s"] = statistics.median(
                    ch.latency_s for ch in out)
        rec.update({f"{k}_fps": S * n / v for k, v in walls.items()})
        if not closed:
            rec["profile_service_card"] = device_profile(
                lambda: serve(warm, raw))
            rec["profile_service_host"] = device_profile(
                lambda: serve(warm, raw_np))
            rec["profile_runner_card"] = device_profile(
                lambda: rf.process(raw))
        emit(rec)
        records.append(rec)

    records += service_churn_checks(base_model, cal, raw)
    return records, launches


def service_churn_checks(base_model, cal, raw):
    """(2) and (4): the churn runs against independent StreamRunners and
    the rebuild count; (5): checkpoint at CKPT_TICK and resume."""
    n_ticks = raw.shape[1] // CHUNK
    schedule = churn_schedule(n_ticks)
    check(schedule[2][2] == () and any(a for _, a, _ in schedule[1:])
          and any(d for d, _, _ in schedule[1:]),
          "the churn schedule lost its silent tick, attach or detach")

    def frames_of(sid):
        return raw[sid % FLEET_S, N_STREAM // 4 * (sid // FLEET_S):]

    ctrl = service_ctrl()
    adapt = AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3,
                        confidence=0.0)
    records = []
    for name, precision, bits, sigma in (("churn_int8", "int8", 8, 0.0),
                                         ("churn_noisy_float32", "float32",
                                          4, 0.02)):
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      adc_sigma=sigma, precision=precision, device=DEVICE)
        svc = FleetService(model, ctrl, n_slots=FLEET_S, adapt=adapt,
                           adc_seed=SEED, **common)
        first, rest = schedule[:1], schedule[1:]
        got, fed = play_churn(svc, frames_of, first)
        rebuilds = svc.rebuild_count()
        more, fed = play_churn(svc, frames_of, rest, fed)
        check(svc.rebuild_count() == rebuilds,
              f"{name}: {svc.rebuild_count() - rebuilds} rebuilds under "
              f"churn")
        for sid, outs in more.items():
            got.setdefault(sid, []).extend(outs)
        moved = 0.0
        for sid, n_fed in fed.items():
            r = stream.StreamRunner(
                model, ctrl, adapt=dataclasses.replace(adapt, scope="shared"),
                adc_seed=fleet.stream_seed(SEED, svc.uid(sid)), **common)
            want = r.process(frames_of(sid)[:n_fed])
            what = f"{name}: sensor {sid} differs from its StreamRunner"
            for j, w in enumerate(want):
                check(np.array_equal(np.concatenate(
                    [o[j] for o in got[sid]]), w), f"{what} (gate)")
            log, rlog = svc.capture_log(sid), r.capture_log
            check(np.array_equal(log.sampled, rlog.sampled)
                  and np.array_equal(log.gated, rlog.gated),
                  f"{what} (capture log)")
            chvs = svc.class_hvs_of(sid)
            check(torch.equal(chvs, r.class_hvs), f"{what} (classifier)")
            moved = max(moved, float((chvs - model.class_hvs).abs().max()))
        check(moved > 0, f"{name}: adaptation never moved a classifier")
        rec = dict(run=name, precision=precision, adc_sigma=sigma,
                   slots=FLEET_S, sensors=len(fed), ticks=n_ticks,
                   schedule=[[list(d), list(a), list(r)]
                             for d, a, r in schedule],
                   sensors_bitwise_vs_runners=True,
                   rebuild_count=svc.rebuild_count(),
                   rebuilds_after_warmup=0, class_hvs_moved=moved)
        emit(rec)
        records.append(rec)
    records.append(service_resume_check(base_model, cal, raw, schedule,
                                        frames_of))
    return records


def service_resume_check(base_model, cal, raw, schedule, frames_of):
    """(5) The closed loop with per-stream pseudo adaptation under the
    churn schedule, checkpointed at CKPT_TICK (two sensors parked, HP
    frames undrained); a fresh service restores it, and both continue:
    outputs, capture logs, classifiers (parked ones too) and HP drains
    bitwise."""
    ckpt_dir = ROOT / "build" / "service_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    model = calibrated(base_model, *cal, "float32", 4)

    def build():
        return FleetService(
            model, service_ctrl(), n_slots=FLEET_S, chunk_size=CHUNK,
            block_d=BLOCK_D, adc_bits=4, adc_seed=SEED,
            control=CaptureConfig(hp_bits=12),
            adapt=AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3,
                              confidence=0.0),
            ckpt_dir=str(ckpt_dir), device=DEVICE)

    try:
        svc = build()
        _, fed = play_churn(svc, frames_of, schedule[:CKPT_TICK])
        svc.checkpoint()
        svc.wait_ckpt()
        parked = len(svc._parked)
        undrained = sum(len(v) for v in svc._hp.values())
        check(parked > 0 and undrained > 0,
              f"resume: {parked} parked sensors, {undrained} HP frames")
        ref, _ = play_churn(svc, frames_of, schedule[CKPT_TICK:], dict(fed))
        svc2 = build()
        check(svc2.restore() == CKPT_TICK, "resume: restored tick count")
        got, _ = play_churn(svc2, frames_of, schedule[CKPT_TICK:], dict(fed))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(set(got) == set(ref), "resume: sensors served differ")
    for sid in ref:
        for j in range(3):
            check(np.array_equal(np.concatenate([o[j] for o in got[sid]]),
                                 np.concatenate([o[j] for o in ref[sid]])),
                  f"resume: sensor {sid} outputs")
    for sid in fed:
        a, b = svc.capture_log(sid), svc2.capture_log(sid)
        check(np.array_equal(a.sampled, b.sampled)
              and np.array_equal(a.gated, b.gated),
              f"resume: sensor {sid} capture log")
        check(torch.equal(svc.class_hvs_of(sid), svc2.class_hvs_of(sid)),
              f"resume: sensor {sid} classifier")
        (ia, fa), (ib, fb) = svc.drain_hp(sid), svc2.drain_hp(sid)
        check(np.array_equal(ia, ib) and np.array_equal(fa, fb),
              f"resume: sensor {sid} HP drain")
    rec = dict(run="checkpoint_resume", checkpoint_tick=CKPT_TICK,
               parked_at_checkpoint=parked,
               undrained_hp_frames_at_checkpoint=undrained,
               resumed_bitwise=True)
    emit(rec)
    return rec


# the gated cascade: the closed-loop service's HP frames through the
# full-width detector, `batch` frames a step, `inflight` steps in flight;
# the CPU references at full width but CASCADE_REF_LAYERS layers (bf16)
# and at the smoke config (float32), on CASCADE_REF_FRAMES frames, each
# within its tolerance of the largest |logit| of the CPU run
CASCADE_ARCH, CASCADE_PATCH = "hubert-xlarge", 8
CASCADE_BATCH, CASCADE_INFLIGHT = 8, 2
CASCADE_REF_LAYERS, CASCADE_REF_FRAMES = 2, 4
CASCADE_BF16_RTOL, CASCADE_F32_RTOL = 5e-2, 1e-4
# batches timed warm, and batches under the profiler
CASCADE_TIMED, CASCADE_PROFILED = 16, 2


def detector_matmul_flops(cfg, seq: int, patch: int) -> int:
    """Hand count of one frame's products: per layer q, k, v, o, the
    scores and ``P·V``, and the MLP; the patch embedder and the unembedding
    of every position."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    kv = cfg.kv_heads
    layer = (2 * seq * d * (h + 2 * kv) * hd + 2 * seq * h * hd * d
             + 2 * 2 * seq * seq * h * hd + 2 * 2 * seq * d * f)
    return (cfg.n_layers * layer + 2 * seq * patch * patch * d
            + 2 * seq * d * cfg.vocab)


def cascade_reference(cfg, frames) -> dict:
    """``frames`` through a card cascade and through the same step on the
    CPU (weights copied from the card); returns the largest difference
    and the largest |logit| of the CPU run."""
    hw = frames.shape[1:]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    params = steps.init_detector_params(g, cfg, frame_hw=hw,
                                        patch=CASCADE_PATCH)
    card = CascadeService(params, cfg, batch_size=CASCADE_BATCH,
                          frame_hw=hw, patch=CASCADE_PATCH, device=DEVICE)
    got = card.eager(frames)
    cell = steps.build_detector_cell(cfg, batch=CASCADE_BATCH, frame_hw=hw,
                                     patch=CASCADE_PATCH)
    cpu = cell.prepare(model_common.tree_map(lambda a: a.cpu(), params))
    want = cell.step_fn(cpu, torch.from_numpy(frames)).numpy()
    return dict(layers=cfg.n_layers, d_model=cfg.d_model,
                compute_dtype=cfg.compute_dtype, frames=len(frames),
                max_abs_diff=float(np.abs(got - want).max()),
                max_abs_logit=float(np.abs(want).max()))


def cascade_phase(base_model, cal, raw):
    """The closed-loop float32 ``FleetService`` (FLEET_S slots, N_STREAM //
    CHUNK ticks, HP at 12 bits) feeding a ``CascadeService`` over the
    full-width detector, pumped after every collect, then flushed: every
    drained HP frame (the same trace's ``FleetRunner`` drains are the
    truth) returns once with its (sid, index), the logits are finite, one
    scorer call a tick. Then 2 ragged drains of ``inflight × batch`` frames
    and a 3-frame one, each submit free of host syncs, flushed; batched
    logits equal ``eager`` bitwise at every batch position and in the
    padded tail; ``rebuild_count()`` stays 1; the CPU references agree.
    It times the backbone warm, the site (gate plus cascade) against the
    gate alone, profiles two batches, and bills the energy. Returns the
    record and the scorers' launches of the main run."""
    S, n = raw.shape[:2]
    n_ticks = n // CHUNK
    B, hw = CASCADE_BATCH, (FRAME, FRAME)
    cfg = configs.get_config(CASCADE_ARCH)
    seq = steps.detector_seq_len(hw, CASCADE_PATCH)
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    params = steps.init_detector_params(g, cfg, frame_hw=hw,
                                        patch=CASCADE_PATCH)
    n_params = model_common.count_params(params["backbone"])
    casc = CascadeService(params, cfg, batch_size=B, frame_hw=hw,
                          patch=CASCADE_PATCH, max_inflight=CASCADE_INFLIGHT,
                          device=DEVICE)
    del params
    setup_s = time.perf_counter() - t0

    model = calibrated(base_model, *cal, "float32", 4)
    common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=4,
                  precision="float32", adc_seed=SEED,
                  control=CaptureConfig(hp_bits=12), device=DEVICE)
    raw_np = raw.cpu().numpy()
    rf = fleet.FleetRunner(model, service_ctrl(), **common)
    rf.process(raw)
    want = {(s, int(i)): f for s, (idx, frs) in enumerate(rf.drain_hp())
            for i, f in zip(idx, frs)}
    check(len(want) > 2 * B, f"cascade: {len(want)} HP frames")

    def service():
        svc = FleetService(model, service_ctrl(), n_slots=S,
                           max_inflight=SERVICE_INFLIGHT, **common)
        for s in range(S):
            svc.attach(s)
        return svc

    def site(svc, with_cascade: bool = True):
        """One pass of the trace through ``svc``, the cascade pumped after
        every collect; the cascade's batches."""
        for k, lo in enumerate(range(0, n, CHUNK)):
            svc.dispatch({s: raw_np[s, lo:lo + CHUNK] for s in range(S)})
            if k and svc.collect() is not None and with_cascade:
                casc.pump(svc)
        svc.flush()
        if not with_cascade:
            return []
        casc.pump(svc)
        return casc.flush()

    # the main path, counts zeroed right before
    svc = service()
    torch.cuda.synchronize()
    ss.LAUNCHES = ssi.LAUNCHES = 0
    t0 = time.perf_counter()
    batches = site(svc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"sliding_scores_f32": ss.LAUNCHES,
                "sliding_scores_int": ssi.LAUNCHES}
    check(launches["sliding_scores_f32"] == n_ticks
          and launches["sliding_scores_int"] == 0,
          f"cascade: {launches} scorer calls for {n_ticks} ticks")
    rows = [(sid, int(i)) for b in batches
            for sid, i in zip(b.sids, b.frame_idx)]
    check(len(rows) == len(set(rows)) and set(rows) == set(want),
          f"cascade: {len(rows)} rows back ({len(set(rows))} distinct) "
          f"for {len(want)} HP frames")
    logits = np.concatenate([b.logits for b in batches])
    check(logits.shape == (len(want), casc.n_out)
          and np.isfinite(logits).all(),
          "cascade: logits not finite or of the wrong shape")
    check(casc.rebuild_count() == 1, "cascade: rebuilt during the run")
    duty = float(np.mean([svc.capture_log(s).gated.mean()
                          for s in range(S)]))
    bill = casc.system_energy(svc.capture_log(0))

    # ragged drains after the warm-up: two full batches and a tail, every
    # submit free of host syncs (no more than max_inflight in flight)
    order = sorted(want)
    extra = order[:CASCADE_INFLIGHT * B + 3]
    cuts = (0, 5, 5, CASCADE_INFLIGHT * B, len(extra))
    for lo, hi in zip(cuts, cuts[1:]):
        part = extra[lo:hi]
        frs = (np.stack([want[r] for r in part]) if part
               else np.zeros((0, *hw), np.float32))
        torch.cuda.set_sync_debug_mode("error")
        try:
            casc.submit("ragged", [i for _, i in part], frs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ragged = casc.flush()
    check([b.n_padded for b in ragged] == [0] * CASCADE_INFLIGHT + [B - 3]
          and np.array_equal(np.concatenate([b.frame_idx for b in ragged]),
                             [i for _, i in extra]),
          f"cascade: ragged batches {[b.n_padded for b in ragged]} padded")
    # batched == eager at every batch position: the main run's first batch,
    # the ragged full batches and the padded tail
    first = batches[0]
    frames = np.stack([want[(sid, int(i))] for sid, i
                       in zip(first.sids, first.frame_idx)]
                      + [want[r] for r in extra])
    batched = np.concatenate([first.logits] + [b.logits for b in ragged])
    check(np.array_equal(casc.eager(frames), batched),
          "cascade: batched logits differ from eager")
    check(casc.rebuild_count() == 1, "cascade: rebuilt by ragged drains")

    # timing, warm: the backbone alone (CASCADE_TIMED full batches), the
    # site with and without the cascade, in turns
    timed = np.stack([want[r] for r in order[:CASCADE_TIMED * B]])

    def backbone(n_batches):
        casc.submit("timed", np.arange(n_batches * B), timed[:n_batches * B])
        return casc.flush()

    gate = service()
    site(gate, False)
    walls = {}
    for what, fn in (("backbone", lambda: backbone(CASCADE_TIMED)),
                     ("gate", lambda: site(gate, False)),
                     ("site", lambda: site(svc)),
                     ("gate_again", lambda: site(gate, False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
    # one batch alone, not pipelined: CUDA events around eager calls of one
    # frame (the copy in, the graph's launch and replay, the copy out)
    event_ms = time_ms(lambda: casc.eager(timed[:1]), runs=5, warmup=1)
    prof = device_profile(lambda: backbone(CASCADE_PROFILED))
    check(casc.rebuild_count() == 1, "cascade: rebuilt while timed")

    cost = casc.backbone_cost()
    hand = detector_matmul_flops(cfg, seq, CASCADE_PATCH)
    check(cost.flops == hand,
          f"cascade: backbone_cost {cost.flops} FLOPs/frame, hand count "
          f"{hand}")
    bounds = dict(bytes_ms=B * cost.bytes / HBM_BYTES_S * 1e3,
                  flops_ms=B * cost.flops / BF16_OPS_S * 1e3)
    refs = [cascade_reference(cfg.replace(n_layers=CASCADE_REF_LAYERS),
                              timed[:CASCADE_REF_FRAMES]),
            cascade_reference(configs.get_smoke(CASCADE_ARCH),
                              timed[:CASCADE_REF_FRAMES])]
    for r, rtol in zip(refs, (CASCADE_BF16_RTOL, CASCADE_F32_RTOL)):
        r["rtol"] = rtol
        check(r["max_abs_diff"] <= rtol * r["max_abs_logit"],
              f"cascade: card vs CPU at {r}")

    backbone_fps = CASCADE_TIMED * B / walls["backbone"]
    device_ms = (prof["device_ms"] / CASCADE_PROFILED
                 if prof["device_ms"] > 0 else "not measured")
    gate_fps = S * n / min(walls["gate"], walls["gate_again"])
    rec = dict(
        arch=CASCADE_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        compute_dtype=cfg.compute_dtype, backbone_params=n_params,
        frame=FRAME, patch=CASCADE_PATCH, seq=seq, batch=B,
        max_inflight=CASCADE_INFLIGHT, setup_s=setup_s,
        first_pass_s=first_s, hp_frames=len(want), batches=len(batches),
        launches=launches, rows_once=True, bitwise_vs_eager=True,
        eager_frames=len(frames), ragged_padded=B - 3,
        warm_submits_sync_free=True, rebuild_count=casc.rebuild_count(),
        backbone_fps=backbone_fps,
        ms_per_batch=walls["backbone"] / CASCADE_TIMED * 1e3,
        bound_ms_per_batch=bounds, alone_event_ms_per_batch=event_ms,
        device_ms_per_batch=device_ms,
        # the profiler's kernel time a batch over the unprofiled wall
        # time a batch of the pipelined pass
        device_share_of_wall=(device_ms / (walls["backbone"] * 1e3
                                           / CASCADE_TIMED)
                              if device_ms != "not measured"
                              else device_ms),
        device_busy_share=prof["device_busy_share"],
        top_kernels_ms=prof["top_kernels_ms"],
        site_fps=S * n / walls["site"], gate_fps=gate_fps,
        gate_duty=duty, hp_share=len(want) / (S * n),
        hp_fps_passed_by_gate=gate_fps * len(want) / (S * n),
        hp_fps_backbone_sustains=backbone_fps,
        backbone_cost=dataclasses.asdict(cost), flops_hand_count=hand,
        energy_slot0={k: dict(dataclasses.asdict(v), total=v.total)
                      for k, v in bill.items()},
        energy_saving=energy.savings(bill["cascade"],
                                     bill["always_on"])["total_saving"],
        references=refs, walls_s=walls)
    emit({"cascade": rec})
    return rec, launches


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
    (``ragged_encode_checks``). The library yardsticks (``torch.matmul``
    in float32) run without TF32."""
    with pin_fp32_matmul():
        return _train_kernel_checks(model, B0, x_tr, x_te, hv_te)


def _train_kernel_checks(model, B0, x_tr, x_te, hv_te):
    B, b = model.B, model.b
    lib = _build.load("similarity")
    check(all(sim.chunk(D) == lib.similarity_chunk(D) for D in SIM_PLAN_DS),
          "python and CUDA similarity chunk plans differ")
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


# the int-datapath phase: the claims of benchmarks/int_datapath.py (its
# constants, :57-74) and its --check gates (:441-486) on the port, the
# race also at the paper's operating point (configs/hypersense.py)
PAPER = paper_config.config()
INT_BITS = 8
# race shapes: (frame, fragment, stride, D, block_d, chunk)
RACE_SHAPES = {"reference": (32, 8, 4, 256, 128, 16),
               "paper": (PAPER.frame_h, PAPER.fragment, PAPER.stride,
                         PAPER.dim, BLOCK_D, CHUNK)}
# the expanded kernel against the live int kernel (the reference's
# assert_allclose, int_datapath.py:215)
RACE_RTOL = RACE_ATOL = 1e-6
# the AUC scenario (a gate trained on make_dataset(60) at 32x32, 2
# fragments a frame, 8 epochs; streams of 160 frames, bursts of 10 at 0.08)
AUC_FRAG, AUC_STRIDE, AUC_DIM, AUC_FRAMES, AUC_TOL = 8, 4, 512, 160, 0.01
AUC_DRIFT = dict(background_gain=(0.0, 0.5), noise_sigma=(0.12, 0.25),
                 object_intensity=(0.8, 0.45))
# The binary curve's D and the reference's claim on its best point. The
# claim is reported, not enforced: with sign-quantized slabs AND class
# hypervectors, a gate trained on 60 frames lands on either side of 0.85 at
# random, in the JAX package as in the port (CPU, D = 128, 256, 512: the
# reference's protocol best at 0.831 on its own keys, 0.537-0.946 on 8
# others, 4 of them >= 0.85; the port 0.513-0.987 on 12 seeds, 6 >= 0.85);
# each binary score map of the curve is held to its plain version instead.
BINARY_DIMS, BINARY_MIN_BEST_AUC = (128, 256, 512), 0.85
# the large-W check: 4x the reference's frame width, its dims; the
# reference's tolerance for it, printed beside the port's SCORE_ATOL
LARGE_W, LARGE_W_DIM, LARGE_W_BLOCK_D, LARGE_W_TOL = 128, 256, 128, 1e-6
# the deployment geometry of the reference's byte model
# (int_datapath.py:236): 4-bit codes, 128x4096 frames, 16x16 windows,
# stride 16
DEPLOY = dict(adc_bits=4, H=128, W=4096, h=16, w=16, stride=16)
GATE_FRAMES = 256
# every score a gate decision rests on sits this far from t_score
# (tests/test_golden.py:59)
DECISION_MARGIN = 5 * SCORE_ATOL
# every kernel wrapper the phase's main path may reach
ID_KERNELS = {"sliding_scores_f32": ss, "sliding_scores_int": ssi,
              "int_expanded": ie, "hdc_encode_perm": enc_perm,
              "hdc_encode": enc, "similarity": sim}


def race_inputs(g, frame, frag, stride, dim, block_d, chunk):
    """One model and one ADC capture for the race: uniform frames in
    [0, 1.5], their 8-bit codes for the int kernels and the float
    reconstruction of the same codes for the float kernel; the float and
    int tiles and the expanded operand."""
    B0, b = encoding.make_perm_base_rows(g, frag, dim)
    chvs = torch.randn((2, dim), generator=g, device=DEVICE)
    frames = 1.5 * torch.rand((chunk, frame, frame), generator=g,
                              device=DEVICE)
    codes = adc.pack_codes(adc.quantize_codes(frames, INT_BITS), INT_BITS)
    tkw = dict(W=frame, w=frag, stride=stride, block_d=block_d)
    itiles = ops.precompute_tiles_int(B0, b, chvs, **tkw)
    return dict(B0=B0, b=b, chvs=chvs, codes=codes,
                recon=adc.quantize(frames, INT_BITS),
                ftiles=ops.precompute_tiles(B0, b, chvs, **tkw),
                itiles=itiles, E=ie.expand_slabs(itiles.geom, frame),
                tkw=tkw, kw=dict(h=frag, w=frag, stride=stride))


def race_calls(inp):
    """The three scorers on the capture, through their entry points."""
    kw, model = inp["kw"], (inp["chvs"], inp["B0"], inp["b"])
    return {
        "float32": (ss, lambda: ops.fragment_score_map_batch(
            inp["recon"], *model, tiles=inp["ftiles"], **kw)),
        "int8": (ssi, lambda: ops.fragment_score_map_batch_int(
            inp["codes"], *model, tiles=inp["itiles"], **kw)),
        "expanded": (ie, lambda: ie.expanded_scores(
            inp["codes"], inp["E"], inp["itiles"], **kw))}


def race_scores(inp):
    """Each scorer once; each call must be one call of its C entry."""
    out = {}
    for name, (mod, fn) in race_calls(inp).items():
        before = mod.LAUNCHES
        out[name] = fn()
        check(mod.LAUNCHES == before + 1,
              f"race {name}: {mod.LAUNCHES - before} launches in one call")
    return out


def race_checks(name, inp, scores):
    """The race's gates and times at one shape: the expanded window sums
    bitwise the live kernel's, its scores within 1e-6 of the live kernel's
    and within SCORE_ATOL of its plain version; both int paths bitwise run
    to run and across a fresh precompute; ms per chunk (CUDA events), fps
    and speedups."""
    kw, codes, itiles, E = inp["kw"], inp["codes"], inp["itiles"], inp["E"]
    s_f, s_i, s_e = scores["float32"], scores["int8"], scores["expanded"]
    acc_e = ie.expanded_window_acc(codes, E, itiles.geom, **kw)
    acc_i = ssi.int_window_acc(codes, itiles.geom, **kw)
    plain = ie.expanded_scores_plain(codes, E, itiles, **kw)
    torch.cuda.synchronize()
    check(torch.equal(acc_e, acc_i),
          f"race {name}: expanded window sums differ from the live ones")
    live_err = float((s_e - s_i).abs().max())
    check(bool(torch.allclose(s_e, s_i, rtol=RACE_RTOL, atol=RACE_ATOL)),
          f"race {name}: expanded vs live int8 kernel {live_err}")
    plain_err = float((s_e - plain).abs().max())
    check(plain_err <= SCORE_ATOL,
          f"race {name}: expanded kernel vs plain {plain_err}")
    check(bool(torch.isfinite(s_e).all() & torch.isfinite(s_f).all())
          and s_e.shape == s_i.shape == s_f.shape,
          f"race {name}: scores not finite or of the wrong shape")
    # determinism: run to run, and across a fresh precompute
    fresh = ops.precompute_tiles_int(inp["B0"], inp["b"], inp["chvs"],
                                     **inp["tkw"])
    E2 = ie.expand_slabs(fresh.geom, inp["tkw"]["W"])
    again = {n: fn() for n, (_, fn) in race_calls(inp).items()}
    s_i2 = ssi.fragment_scores_batch_int(codes, fresh, **kw)
    s_e2 = ie.expanded_scores(codes, E2, fresh, **kw)
    torch.cuda.synchronize()
    check(torch.equal(E2, E), f"race {name}: a fresh operand differs")
    for n, (a, others) in dict(
            int8=(s_i, (again["int8"], s_i2)),
            expanded=(s_e, (again["expanded"], s_e2))).items():
        check(all(torch.equal(a, x) for x in others),
              f"race {name}: {n} not bitwise deterministic")
    ms = {n: time_ms(fn) for n, (_, fn) in race_calls(inp).items()}
    N = codes.shape[0]
    return dict(
        frames=N, frame=inp["tkw"]["W"], fragment=kw["h"],
        stride=kw["stride"], D=inp["chvs"].shape[1],
        td=itiles.geom.block_d, n_dt=itiles.geom.slabs_q.shape[0],
        operand_bytes=E.numel(), ms=ms,
        fps={n: N / (t / 1e3) for n, t in ms.items()},
        speedup_int8_vs_float32=ms["float32"] / ms["int8"],
        speedup_int8_vs_expanded=ms["expanded"] / ms["int8"],
        acc_bitwise=True, expanded_vs_live_max_abs=live_err,
        expanded_bitwise_live=bool(torch.equal(s_e, s_i)),
        expanded_vs_plain_max_abs=plain_err, deterministic=True)


def expanded_record(inp, race):
    """The expanded kernel's line at the paper's shape: its time, the
    device time of its three kernels, the plain version's, the library
    yardstick's (the int row's: the windows against the expanded base in
    one ``torch.matmul``) and the bound, each input read once."""
    kw, codes, itiles, E = inp["kw"], inp["codes"], inp["itiles"], inp["E"]
    h, w, stride = kw["h"], kw["w"], kw["stride"]
    N, H, W = codes.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    n_dt, td = itiles.geom.slabs_q.shape[0], itiles.geom.block_d
    lib = _build.load("int_expanded")
    check(ie.COL_TILE == lib.int_expanded_col_tile(),
          "python and CUDA expanded column tiles differ")
    win = codes.unfold(1, h, stride).unfold(2, w, stride).reshape(
        N * my * mx, h * w).to(torch.float32)
    base = encoding.flat_perm_base(inp["B0"], h)
    device_ms, by_kernel = kernel_device_ms(
        lambda: ie.expanded_scores(codes, E, itiles, **kw),
        ("window_norms", "score_expanded", "fold_epilogue"))
    n_bytes = (codes.numel() * codes.element_size() + E.numel()
               + 4 * itiles.geom.bias_t.numel() + 2 * itiles.cpos_t.numel()
               + 4 * N * my * mx)
    return dict(
        name="int_expanded", route="cuda",
        source="src/repro_torch/kernels/csrc/int_expanded.cu",
        replaces="benchmarks/int_datapath.py:96",
        max_abs_err=race["expanded_vs_plain_max_abs"],
        expanded_vs_live_max_abs=race["expanded_vs_live_max_abs"],
        bitwise_live=race["expanded_bitwise_live"],
        ms=race["ms"]["expanded"], kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=by_kernel,
        plain_ms=time_ms(lambda: ie.expanded_scores_plain(codes, E, itiles,
                                                          **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[N, H, W, h, w, stride, n_dt * td],
        smem_bytes=lib.int_expanded_smem_bytes(w, stride),
        blocks=n_dt * -(-td // ie.COL_TILE) * my * N,
        **bound(n_bytes, 2 * N * my * W * n_dt * td * (h + mx), INT8_OPS_S),
        # what this design reads: the operand again for every (frame, band)
        operand_reads_bytes=N * my * E.numel())


def large_w_checks(g):
    """The reference's large-W check (int_datapath.py:225-260): at W = 4x
    its frame the live int kernel matches its plain version (SCORE_ATOL;
    the reference's 1e-6 printed beside it) and the expanded kernel the
    live one; then the expanded operand's bytes at the deployment
    geometry beside the live kernel's fixed block and its im2col bytes
    per frame."""
    frame, frag, stride = RACE_SHAPES["reference"][:3]
    H, W = frame, LARGE_W
    kw = dict(h=frag, w=frag, stride=stride)
    ops.assert_int_datapath_fits(INT_BITS, H, W, frag, frag, stride=stride)
    B0, b = encoding.make_perm_base_rows(g, frag, LARGE_W_DIM)
    chvs = torch.randn((2, LARGE_W_DIM), generator=g, device=DEVICE)
    frames = 1.5 * torch.rand((4, H, W), generator=g, device=DEVICE)
    codes = adc.pack_codes(adc.quantize_codes(frames, INT_BITS), INT_BITS)
    tiles = ssi.precompute_tiles_int(B0, b, chvs, W=W, w=frag, stride=stride,
                                     block_d=LARGE_W_BLOCK_D)
    got = ssi.fragment_scores_batch_int(codes, tiles, **kw)
    want = ssi.fragment_scores_batch_int_plain(codes, tiles, **kw)
    E = ie.expand_slabs(tiles.geom, W)
    s_e = ie.expanded_scores(codes, E, tiles, **kw)
    acc_e = ie.expanded_window_acc(codes, E, tiles.geom, **kw)
    acc_i = ssi.int_window_acc(codes, tiles.geom, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= SCORE_ATOL, f"large W={W}: live int kernel vs plain {err}")
    check(torch.equal(acc_e, acc_i) and bool(torch.allclose(
        s_e, got, rtol=RACE_RTOL, atol=RACE_ATOL)),
        f"large W={W}: expanded vs live kernel")
    d = DEPLOY
    bounds = ssi.int_datapath_bounds(d["adc_bits"], d["H"], d["W"], d["h"],
                                     d["w"], stride=d["stride"])
    check(bounds["fits"], "the live layout must admit deployment scale")
    expanded = ie.expanded_bytes(d["h"], d["W"], PAPER.dim, BLOCK_D)
    return dict(
        W=W, D=LARGE_W_DIM, td=LARGE_W_BLOCK_D, live_vs_plain_max_abs=err,
        reference_tol=LARGE_W_TOL, within_reference_tol=err <= LARGE_W_TOL,
        expanded_vs_live_max_abs=float((s_e - got).abs().max()),
        expanded_operand_bytes=E.numel(),
        deploy=dict(d, D=PAPER.dim, block_d=BLOCK_D,
                    expanded_operand_bytes=expanded,
                    expanded_over_l2=expanded > 50e6,
                    live_smem_bytes=bounds["smem_bytes"],
                    live_im2col_bytes_per_frame=bounds[
                        "im2col_bytes_per_frame"]))


def train_gate(g, cfg, dim, frag, stride):
    """A gate trained as the reference's benchmark trains it (its
    ``_train_gate``): ``make_dataset(60)``, 2 fragments a frame, 8 epochs,
    the generator rows read back from the model's base, ``t_detection``
    1."""
    frames, masks, _ = synthetic.make_dataset(g, 60, cfg, device=DEVICE)
    frs, labs = fragments.sample_fragments(
        frames.cpu().numpy(), masks.cpu().numpy(), h=frag, w=frag,
        per_frame=2, seed=0)
    model, _ = fragment_model.train_fragment_model(g, frs, labs, dim=dim,
                                                   epochs=8, device=DEVICE)
    B0 = model.B.reshape(frag, frag, -1)[:, 0, :]
    return hypersense.from_fragment_model(model, B0, h=frag, w=frag,
                                          stride=stride, t_detection=1)


def frame_auc(scores, labels) -> float:
    fpr, tpr, _ = metrics.roc_curve(scores.cpu().numpy(),
                                    labels.cpu().numpy())
    return float(metrics.auc(fpr, tpr))


def auc_streams(g, cfg):
    """The scenario's synthetic stream and its drifted one."""
    drift = synthetic.DriftConfig(**AUC_DRIFT)
    kw = dict(event_prob=0.08, event_len=10, device=DEVICE)
    return {"synthetic": synthetic.make_stream(g, AUC_FRAMES, cfg, **kw),
            "drift": synthetic.make_drift_stream(g, AUC_FRAMES, cfg, drift,
                                                 **kw)}


def auc_parity(hs, streams) -> dict:
    """Frame-score AUC on each stream: float at 8 bits vs int8, and float
    at 4 bits vs packed int4, each pair on the same ADC capture."""
    out = {}
    for name, (frames, labels) in streams.items():
        def auc(view, **kw):
            return frame_auc(hypersense.frame_scores_batch(hs, view, **kw),
                             labels)
        f8 = auc(adc.quantize(frames, 8))
        i8 = auc(frames, precision="int8", adc_bits=8)
        f4 = auc(adc.quantize(frames, 4))
        i4 = auc(frames, precision="int4", adc_bits=4)
        out[name] = dict(float_auc=f8, int8_auc=i8, gap=abs(f8 - i8),
                         float4_auc=f4, int4_auc=i4, int4_gap=abs(f4 - i4),
                         positives=int(labels.sum()))
    return out


def binary_curve(g, cfg, frames, labels) -> dict:
    """The binary gate's D-vs-AUC curve on the synthetic stream (a gate
    trained per D) beside the float gate's at 8 bits, each binary score
    map held to the plain version's within SCORE_ATOL."""
    out = {}
    codes = adc.pack_codes(adc.quantize_codes(frames, 8), 8)
    for dim in BINARY_DIMS:
        hs = train_gate(g, cfg, dim, AUC_FRAG, AUC_STRIDE)
        tiles = ops.precompute_tiles_int(hs.B0, hs.b, hs.class_hvs,
                                         W=codes.shape[-1], w=hs.w,
                                         stride=hs.stride, mode="binary")
        kw = dict(h=hs.h, w=hs.w, stride=hs.stride)
        maps = ssi.fragment_scores_batch_int(codes, tiles, **kw)
        err = float((maps - ssi.fragment_scores_batch_int_plain(
            codes, tiles, **kw)).abs().max())
        check(err <= SCORE_ATOL and bool(torch.isfinite(maps).all()),
              f"binary scores at D={dim}: kernel vs plain {err}")
        out[f"d{dim}"] = dict(
            float_auc=frame_auc(hypersense.frame_scores_batch(
                hs, adc.quantize(frames, 8)), labels),
            binary_auc=frame_auc(frame_detection_score(
                maps, hs.t_detection), labels),
            binary_vs_plain_max_abs=err)
    out["best_binary_auc"] = max(v["binary_auc"] for v in out.values())
    return out


def gate_model(g, hs, cfg):
    """``hs`` at a ``t_score`` on the 80th percentile of the frame scores
    of the object-free frames of 64 calibration frames at the gate's ADC
    depth (the reference's gate test calibrates so)."""
    frames, _, labels = synthetic.make_dataset(g, 64, cfg, device=DEVICE)
    neg = adc.quantize(frames[labels == 0], PAPER.adc_low_bits)
    s = hypersense.frame_scores_batch(hs, neg)
    return dataclasses.replace(hs, t_score=float(torch.quantile(s, 0.8)))


def gate_checks(hs, lp, gate, kept, flops_per_frame):
    """The card's gate against the same gate on the CPU (plain versions):
    equal decisions on every frame whose deciding score sits more than
    DECISION_MARGIN from ``t_score``, equal kept indices where all do;
    then frames/s of ``select`` on the card, the duty cycle and the
    backend account."""
    cpu = hs_gate.HyperSenseGate(hs.to("cpu"), ControllerConfig())
    fired_card = gate.decide(lp)
    fired_cpu = cpu.decide(lp.cpu())
    kept_cpu = cpu.select_fired(fired_cpu)
    # the deciding scores (the card's are within SCORE_ATOL of the CPU's)
    scores = hypersense.frame_scores_batch(hs, lp).cpu().numpy()
    clear = np.abs(scores - hs.t_score) > DECISION_MARGIN
    check(np.array_equal(fired_card[clear], fired_cpu[clear]),
          "gate: card and CPU decisions differ on a frame clear of t_score")
    if clear.all():
        check(np.array_equal(kept_cpu, kept),
              "gate: card and CPU kept indices differ")
    timed = hs_gate.HyperSenseGate(hs, ControllerConfig())
    timed.select(lp)   # makes the float tiles, once per frame width
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed.select(lp)
    select_s = time.perf_counter() - t0
    return dict(
        frames=len(lp), t_score=hs.t_score, fired=int(fired_card.sum()),
        kept=len(kept), kept_cpu=len(kept_cpu),
        frames_within_margin=int((~clear).sum()), decisions_equal_cpu=True,
        kept_equal_cpu=bool(np.array_equal(kept_cpu, kept)),
        select_fps=len(lp) / select_s, flops_per_frame=flops_per_frame,
        **hs_gate.backend_flops_saved(gate.stats, flops_per_frame))


def int_datapath_phase(g, flops_per_frame):
    """The int-datapath path: its main run (each race scorer once at the
    reference's shape and at the paper's, the AUC parity at the
    reference's scenario and at the paper's operating point, the binary
    curve, the stream gate over GATE_FRAMES frames at the paper's point),
    counted from zero; then its checks and times. Returns the phase's
    record, its launches per kernel and the expanded kernel's record."""
    t0 = time.perf_counter()
    inputs = {k: race_inputs(g, *v) for k, v in RACE_SHAPES.items()}
    side = RACE_SHAPES["reference"][0]
    small = synthetic.RadarConfig(height=side, width=side)
    paper = synthetic.RadarConfig(height=PAPER.frame_h, width=PAPER.frame_w)
    torch.cuda.synchronize()
    for mod in ID_KERNELS.values():
        mod.LAUNCHES = 0
    # --- the main path
    scores = {k: race_scores(v) for k, v in inputs.items()}
    streams = auc_streams(g, small)
    auc = auc_parity(train_gate(g, small, AUC_DIM, AUC_FRAG, AUC_STRIDE),
                     streams)
    paper_hs = train_gate(g, paper, PAPER.dim, PAPER.fragment, PAPER.stride)
    auc_paper = auc_parity(paper_hs, auc_streams(g, paper))
    binary = binary_curve(g, small, *streams["synthetic"])
    gate_hs = gate_model(g, paper_hs, paper)
    frames, labels = synthetic.make_stream(g, GATE_FRAMES, paper,
                                           device=DEVICE)
    lp = adc.quantize(frames, PAPER.adc_low_bits)
    gate = hs_gate.HyperSenseGate(gate_hs, ControllerConfig())
    kept = gate.select(lp)
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in ID_KERNELS.items()}
    main_s = time.perf_counter() - t0
    # --- the reference's --check gates, then the race's
    for name, a in auc.items():
        check(a["gap"] <= AUC_TOL and a["int4_gap"] <= AUC_TOL,
              f"AUC parity on the {name} stream: {a}")
    binary["claim_min_best_auc"] = BINARY_MIN_BEST_AUC
    binary["claim_met"] = binary["best_binary_auc"] >= BINARY_MIN_BEST_AUC
    for k in ("sliding_scores_f32", "sliding_scores_int", "int_expanded"):
        check(launches[k] > 0, f"{k} never ran on the int-datapath path")
    race = {k: race_checks(k, inputs[k], scores[k]) for k in inputs}
    record = expanded_record(inputs["paper"], race["paper"])
    rec = dict(
        race=race, large_w=large_w_checks(g), auc=auc,
        auc_paper_point=auc_paper, binary_curve=binary,
        gate=gate_checks(gate_hs, lp, gate, kept, flops_per_frame),
        gate_stream_positives=int(labels.sum()), launches=launches,
        main_path_s=main_s, phase_s=time.perf_counter() - t0)
    emit({"int_datapath": rec})
    return rec, launches, record


# Table I (benchmarks/table1_auc.py on benchmarks/common.py's data): noisy
# 4-bit training frames, noisier held-out frames with 3% impulse spikes;
# per block (frame, fragment, D, training frames, held-out frames)
TABLE1_BLOCKS = {"paper": (128, 96, 5000, N_TRAIN, N_HELD_OUT),
                 "reference": (64, 16, 8192, 60, 100)}
TABLE1_NOISE = (0.20, 0.30)
IMPULSE_P, IMPULSE, LOW_BITS, LP_SIGMA = 0.03, 1.2, 4, 0.01
BASELINE_EPOCHS = {"mlp2": 25, "mlp4": 25, "tiny_conv": 15}
# partial AUC above TPR 0.8 in the paper's Table I (YOLO-tiny for tiny_conv)
PAPER_PAUC = {"hdc": 0.1739, "mlp2": 0.1685, "mlp4": 0.1681,
              "tiny_conv": 0.0803}
PAPER_SPEEDUP_VS_MLP = 2.4      # Fig. 16 (benchmarks/fig16_speedup.py:100)
BASELINE_RTOL = 1e-5
ENCODE_FRAMES_N = 2


def table1_data(g, frame: int, frag: int, n_train: int, n_test: int):
    """``benchmarks/common.py``'s dataset on the port: training and held-out
    frames from ``sensing.synthetic`` (noise 0.20 and 0.30), impulse
    spikes on the held-out ones, both at 4 bits; balanced fragments (2 and
    3 per frame, seeds 0 and 1), and the same held-out windows cut from a
    ``low_precision_view`` of the spiked frames."""
    def cfg(noise):
        return synthetic.RadarConfig(
            height=frame, width=frame, noise_sigma=noise, intensity_lo=0.25,
            intensity_hi=0.6, blob_sigma_lo=1.5, blob_sigma_hi=4.0)

    ftr, mtr, _ = synthetic.make_dataset(g, n_train, cfg(TABLE1_NOISE[0]),
                                         device=DEVICE)
    fte, mte, _ = synthetic.make_dataset(g, n_test, cfg(TABLE1_NOISE[1]),
                                         device=DEVICE)
    spikes = (torch.rand(fte.shape, generator=g, device=DEVICE)
              < IMPULSE_P).to(torch.float32)
    fte = torch.clamp(fte + spikes * IMPULSE, 0, 1.5)
    lp = adc.low_precision_view(fte, LOW_BITS, LP_SIGMA, generator=g)
    test = adc.quantize(fte, LOW_BITS)
    sets = {}
    for name, frames, masks, per_frame, seed in (
            ("train", adc.quantize(ftr, LOW_BITS), mtr, 2, 0),
            ("test", test, mte, 3, 1),
            ("low_precision", lp, mte, 3, 1)):
        frags, labels = fragments.sample_fragments(
            frames.cpu().numpy(), masks.cpu().numpy(), h=frag, w=frag,
            per_frame=per_frame, seed=seed)
        sets[name] = (torch.as_tensor(frags, device=DEVICE), labels)
    check(np.array_equal(sets["test"][1], sets["low_precision"][1]),
          "the low-precision view cut other windows")
    return sets, test


def roc_row(scores, labels, paper) -> dict:
    fpr, tpr, _ = metrics.roc_curve(scores, labels)
    return dict(auc=metrics.auc(fpr, tpr),
                partial_auc_tpr08=metrics.partial_auc_above_tpr(fpr, tpr,
                                                                0.8),
                paper_partial_auc=paper)


def timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def baseline_inits(n_in: int) -> dict:
    """The three baselines' initial weights, each from its own seeded
    generator on the card (the reference's keys 1, 2, 3)."""
    def gen(k):
        return torch.Generator(device=DEVICE).manual_seed(SEED + k)

    return {"mlp2": (baselines.init_mlp(gen(1), n_in, n_layers=2),
                     baselines.mlp_apply),
            "mlp4": (baselines.init_mlp(gen(2), n_in, n_layers=4),
                     baselines.mlp_apply),
            "tiny_conv": (baselines.init_tiny_conv(gen(3)),
                          baselines.tiny_conv_apply)}


def train_baseline(name, init, apply_fn, sets):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    return baselines.train_classifier(
        gen, init, apply_fn, *sets["train"], epochs=BASELINE_EPOCHS[name],
        batch_size=64, lr=1e-3)


def table1_block(g, frame, frag, dim, n_train, n_test):
    """Table I once: the HDC Fragment model and the three baselines trained
    on one block's fragments, each scored on the held-out fragments and on
    their low-precision view. Returns the rows, the trained models and
    the held-out frames."""
    sets, test_frames = table1_data(g, frame, frag, n_train, n_test)
    rows, models = {}, {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 42)
    (hdc, _), train_s = timed_s(lambda: fragment_model.train_fragment_model(
        gen, *sets["train"], dim=dim, epochs=EPOCHS, base_kind="perm",
        device=DEVICE))
    models["hdc"] = hdc
    rows["hdc"] = {"train_s": train_s}
    for name, (init, apply_fn) in baseline_inits(frag * frag).items():
        trained, s = timed_s(lambda: train_baseline(name, init, apply_fn,
                                                    sets))
        models[name] = (init, trained, apply_fn)
        rows[name] = {"train_s": s}
    for view in ("test", "low_precision"):
        frags, labels = sets[view]
        for name in rows:
            if name == "hdc":
                scores = fragment_model.positive_score(
                    hdc.class_hvs, fragment_model.encode(hdc, frags))
            else:
                _, trained, apply_fn = models[name]
                scores = baselines.positive_score(apply_fn, trained, frags)
            check(bool(torch.isfinite(scores).all())
                  and scores.shape == (len(labels),),
                  f"{name} scores on {view}: not finite or mis-shaped")
            rows[name][view] = roc_row(scores.cpu().numpy(), labels,
                                       PAPER_PAUC[name])
    info = dict(frame=frame, fragment=frag, D=dim, train_frames=n_train,
                held_out_frames=n_test, train_fragments=len(sets["train"][1]),
                train_positives=int(sets["train"][1].sum()),
                held_out_fragments=len(sets["test"][1]))
    return rows, models, sets, test_frames, info


def leaf_rel_err(card, cpu) -> float:
    """The largest over the leaves of ``max |card - cpu| / max |cpu|``."""
    return max(float((p.detach().cpu() - q.detach()).abs().max())
               / max(float(q.detach().abs().max()), 1e-30)
               for p, q in zip(model_common.leaves(card),
                               model_common.leaves(cpu)))


def baseline_checks(models, sets) -> dict:
    """The paper block's baselines: training lowered the training-set
    cross-entropy; the card's logits equal the CPU's on the same weights
    within BASELINE_RTOL of the largest |logit|; one training step on the
    card equals the CPU's within BASELINE_RTOL of each leaf's largest
    entry, its gradients and its AdamW update each; a second training run
    gives the same bits (required of the MLPs, reported for TinyConv)."""
    x, y = sets["train"]
    y_t = torch.as_tensor(y, device=DEVICE).long()
    held = sets["test"][0][:64]
    out = {}
    for name in BASELINE_EPOCHS:
        init, trained, apply_fn = models[name]
        with torch.no_grad():
            xent0 = float(baselines._xent(apply_fn(init, x), y_t))
            xent1 = float(baselines._xent(apply_fn(trained, x), y_t))
        check(xent1 < xent0, f"{name}: training did not lower the "
                             f"cross-entropy ({xent0} -> {xent1})")
        # the card against the CPU on the same weights
        cpu = copy.deepcopy(trained).to("cpu")
        card = apply_fn(trained, held).detach().cpu()
        host = apply_fn(cpu, held.cpu()).detach()
        scale = float(host.abs().max())
        logit_err = float((card - host).abs().max())
        check(logit_err <= BASELINE_RTOL * scale,
              f"{name}: card logits vs CPU {logit_err} of {scale}")
        # one training step on each: the gradients, then AdamW.update and
        # apply_updates from the same (the CPU's) gradients; a tiny
        # gradient whose sign rounds differently would turn the first
        # step's mhat / sqrt(vhat) around, so the two halves are held
        # apart
        xb, yb = x[:64], y_t[:64]
        cpu_init = copy.deepcopy(init).to("cpu")
        _, g_card = baselines.loss_and_grads(init, apply_fn, xb, yb)
        _, g_cpu = baselines.loss_and_grads(cpu_init, apply_fn, xb.cpu(),
                                            yb.cpu())
        grad_err = leaf_rel_err(g_card, g_cpu)
        check(grad_err <= BASELINE_RTOL,
              f"{name}: gradients on the card vs CPU: {grad_err}")
        opt = optim.AdamW(lr=1e-3, weight_decay=1e-4)
        stepped = {}
        with torch.no_grad():
            for dev, model in ((DEVICE, init), ("cpu", cpu_init)):
                tree = model.tree()
                grads = model_common.tree_map(lambda t: t.to(dev), g_cpu)
                updates, _ = opt.update(grads, opt.init(tree), tree)
                stepped[dev] = optim.apply_updates(tree, updates)
        step_err = leaf_rel_err(stepped[DEVICE], stepped["cpu"])
        check(step_err <= BASELINE_RTOL,
              f"{name}: an AdamW step on the card vs CPU: {step_err}")
        again = train_baseline(name, init, apply_fn, sets)
        bitwise = all(torch.equal(p, q) for p, q in zip(
            model_common.leaves(trained.tree()),
            model_common.leaves(again.tree())))
        check(bitwise or name == "tiny_conv",
              f"{name}: training differs run to run")
        out[name] = dict(train_xent_init=xent0, train_xent_trained=xent1,
                         card_vs_cpu_logit_err=logit_err, logit_scale=scale,
                         card_vs_cpu_grad_rel_err=grad_err,
                         card_vs_cpu_step_rel_err=step_err,
                         run_to_run_bitwise=bitwise)
    return out


def fig16_compare(models, frames) -> dict:
    """Fig. 16's model comparison at the paper's point, per 32-frame chunk:
    the float32 HDC scorer (``frame_scores_batch`` through
    ``sliding_scores_f32``, its tiles made once per model as the stream
    makes them, as the MLP's weights are) against MLP2 on every window of
    each frame;
    ``encode_frames`` with and without reuse on ENCODE_FRAMES_N frames.
    CUDA events, the median of 20 after 3 warm-ups; ms per frame."""
    hdc = models["hdc"]
    hs = hypersense.from_fragment_model(hdc, generators(hdc.B), h=FRAG,
                                        w=FRAG, stride=STRIDE)
    tiles = stream.model_tiles(hs, FRAME, BLOCK_D, "float32")
    chunk = frames[:CHUNK]
    _, mlp, _ = models["mlp2"]
    my = (FRAME - FRAG) // STRIDE + 1

    def mlp_chunk():
        windows = chunk.unfold(1, FRAG, STRIDE).unfold(2, FRAG, STRIDE)
        return baselines.mlp_apply(mlp, windows.reshape(-1, FRAG, FRAG))

    def hdc_chunk():
        return hypersense.frame_scores_batch(hs, chunk, tiles=tiles)

    check(mlp_chunk().shape == (CHUNK * my * my, 2)
          and hdc_chunk().shape == (CHUNK,),
          "Fig. 16 outputs of the wrong shape")
    hdc_ms = time_ms(hdc_chunk)
    mlp_ms = time_ms(mlp_chunk)
    few = frames[:ENCODE_FRAMES_N]
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    reuse = encoding.encode_frames(few, hs.B0, hs.b, reuse=True, **kw)
    naive = encoding.encode_frames(few, hs.B0, hs.b, reuse=False, **kw)
    gap = float((reuse - naive).abs().max())
    check(bool(torch.isfinite(reuse).all())
          and reuse.shape == (ENCODE_FRAMES_N, my, my, DIM) and gap <= 1e-4,
          f"encode_frames: reuse vs naive {gap}")
    del reuse, naive
    reuse_ms = time_ms(lambda: encoding.encode_frames(
        few, hs.B0, hs.b, reuse=True, **kw))
    naive_ms = time_ms(lambda: encoding.encode_frames(
        few, hs.B0, hs.b, reuse=False, **kw))
    return dict(
        chunk=CHUNK, windows_per_frame=my * my,
        hdc_scorer_ms_per_frame=hdc_ms / CHUNK,
        mlp2_ms_per_frame=mlp_ms / CHUNK,
        hdc_speedup_vs_mlp2=mlp_ms / hdc_ms,
        paper_speedup_vs_mlp=PAPER_SPEEDUP_VS_MLP,
        encode_frames_reuse_ms_per_frame=reuse_ms / ENCODE_FRAMES_N,
        encode_frames_naive_ms_per_frame=naive_ms / ENCODE_FRAMES_N,
        encode_frames_reuse_vs_naive_max_abs=gap)


def baselines_phase(g):
    """Table I and Fig. 16's model comparison: the paper block's rows (the
    HDC row's kernels counted from zero), the reference-scale block's,
    the baselines' checks and the Fig. 16 times. Returns the phase's
    record and its launches per kernel."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for mod in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    rows, models, sets, test_frames, info = table1_block(
        g, *TABLE1_BLOCKS["paper"])
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in TRAIN_KERNELS.items()}
    for k in ("hdc_encode_perm", "hdc_encode", "similarity"):
        check(launches[k] > 0, f"{k} never ran on the Table I path")
    blocks = {"paper": dict(info, rows=rows)}
    ref_rows, *_, ref_info = table1_block(g, *TABLE1_BLOCKS["reference"])
    blocks["reference"] = dict(ref_info, rows=ref_rows)
    for block in blocks.values():
        for view in ("test", "low_precision"):
            first = max(block["rows"],
                        key=lambda k: block["rows"][k][view][
                            "partial_auc_tpr08"])
            block[f"hdc_first_in_partial_auc_{view}"] = first == "hdc"
    rec = dict(table1=blocks, checks=baseline_checks(models, sets),
               fig16=fig16_compare(models, test_frames), launches=launches,
               phase_s=time.perf_counter() - t0)
    emit({"baselines": rec})
    return rec, launches


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
    t0 = time.perf_counter()
    gf = torch.Generator(device=DEVICE)
    gf.manual_seed(SEED + 7)
    fleet_raw, fleet_labels = fleet_data(gf)
    _, fleet_launches = fleet_phase(model, cal, fleet_raw, fleet_labels)
    emit({"fleet": {"streams": FLEET_S, "frames_per_stream": N_STREAM,
                    "runs": len(FLEET_RUNS), "launches": fleet_launches,
                    "phase_s": time.perf_counter() - t0,
                    "stacked_forms": stacked_forms(gf)}})
    t0 = time.perf_counter()
    _, service_launches = service_phase(model, cal, fleet_raw)
    emit({"service": {"slots": FLEET_S, "ticks": N_STREAM // CHUNK,
                      "launches": service_launches,
                      "phase_s": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    cascade, cascade_launches = cascade_phase(model, cal, fleet_raw)
    del fleet_raw
    emit({"cascade_phase_s": time.perf_counter() - t0})
    train, train_launches, train_records = train_phase(g)
    emit({"train": train})
    for r in train_records:
        if r["name"] == "similarity":
            r.update(sim_launches)
        emit({"kernel_check": r})
    records += train_records
    gi = torch.Generator(device=DEVICE)
    gi.manual_seed(SEED + 11)
    _, int_launches, expanded = int_datapath_phase(
        gi, cascade["backbone_cost"]["flops"])
    emit({"kernel_check": expanded})
    records.append(expanded)
    gb = torch.Generator(device=DEVICE)
    gb.manual_seed(SEED + 13)
    _, baseline_launches = baselines_phase(gb)
    # launches: the six stream runs', the six fleet runs', the three
    # service runs', the cascade's gate, the training path's, the
    # int-datapath path's and Table I's, each counted from zero right
    # before its run
    for r in records:
        r["launches"] = sum(n.get(r["name"], 0) for n in (
            launches, fleet_launches, service_launches, cascade_launches,
            train_launches, int_launches, baseline_launches))
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
