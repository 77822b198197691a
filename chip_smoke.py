#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card (built for
sm_90a: an H100). It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds both scoring kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all at once;
3. makes a HyperSense model at the paper's operating point (128x128
   frames, 96x96 fragments, stride 8, D=5000, RFF) from a seeded
   ``torch.Generator`` on the card: ``B0 ~ N(0, 1)``, ``b ~ U(0, 2 pi)``,
   class hypervectors bundled from encoded crops of synthetic object
   frames (Gaussian blobs on noise) and background frames;
4. holds each kernel against its plain PyTorch version on the same inputs
   at the main path's shape (a 32-frame chunk) — scores within 5e-5, the
   int kernel's int32 window sums bitwise, two runs bitwise equal — and
   times kernel, plain version, a library matmul of the same projection
   and the card's bound;
5. drives the main path, ``StreamRunner.process``, over 256 frames six
   times (float32, int8, int4, binary, the closed capture loop, online
   adaptation): each chunk must launch its kernel exactly once, the frame
   scores must equal the plain version's within 5e-5, and the run must be
   bitwise the same when fed in 32-frame slices;
6. profiles one float32 and one int8 run (device busy share, top
   kernels);
7. prints one JSON line per phase, a ``kernels`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero as well without a CUDA device, or outside a checkout.
"""

from __future__ import annotations

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

from repro_torch.convert import model_from_arrays  # noqa: E402
from repro_torch.core import encoding, hypersense  # noqa: E402
from repro_torch.core.hypersense import frame_detection_score  # noqa: E402
from repro_torch.core.online import AdaptConfig  # noqa: E402
from repro_torch.core.sensor_control import (  # noqa: E402
    CaptureConfig, ControllerConfig)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import sliding_scores as ss  # noqa: E402
from repro_torch.kernels import sliding_scores_int as ssi  # noqa: E402
from repro_torch.sensing import adc, stream  # noqa: E402

# the paper's operating point (configs/hypersense.py)
FRAME, FRAG, STRIDE, DIM, BLOCK_D = 128, 96, 8, 5000, 512
CHUNK, N_STREAM = 32, 256
SCORE_ATOL = 5e-5
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, float32 (CUDA cores)
# and int8 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
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
    yy = torch.arange(FRAME, device=dev, dtype=torch.float32)
    dy = (yy[None, :] - centres[:, :1]) ** 2
    dx = (yy[None, :] - centres[:, 1:]) ** 2
    blob = torch.exp(-(dy[:, :, None] + dx[:, None, :]) / (2 * 12.0 ** 2))
    frames = frames + 0.9 * labels[:, None, None].to(torch.float32) * blob
    return frames.clamp(0.0, 1.5), centres


def make_model(g):
    """Paper-shape model: bundled class hypervectors (the rule of
    ``fragment_model.bundle_init``) from 64 object and 64 background
    crops. Also returns 64 held-out calibration frames and their labels."""
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
    one_hot = torch.nn.functional.one_hot(labels, 2).to(torch.float32)
    class_hvs = one_hot.T @ hvs                               # (2, D)
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
    check(ss.smem_bytes(FRAME, mx) == _build.load(
        "sliding_scores").sliding_scores_f32_smem_bytes(FRAME, mx),
        "python and CUDA shared-memory sizes differ")

    # the projection as one library call: windows (N*my*mx, h*w) against
    # the expanded base (h*w, D); the port never calls it
    base = encoding.flat_perm_base(model.B0, FRAG)

    def windows(x):
        return x.unfold(1, FRAG, STRIDE).unfold(2, FRAG, STRIDE).reshape(
            N * my * mx, FRAG * FRAG).to(torch.float32)

    macs = N * my * n_dt * td * FRAG * FRAME      # h*W per (n, ky, column)
    records = []

    # --- float32 kernel
    got = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    again = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    plain = ss.fragment_scores_batch_plain(chunk_f, tiles, **kw)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err <= SCORE_ATOL, f"float kernel vs plain: {err}")
    check(torch.equal(got, again), "float kernel differs run to run")
    check(bool(torch.isfinite(got).all()) and got.shape == (N, my, mx),
          "float kernel scores not finite or of the wrong shape")
    oracle = torch.stack([ref.fragment_scores(
        f, model.class_hvs, model.B0, model.b, **kw) for f in chunk_f[:2]])
    oerr = float((got[:2] - oracle).abs().max())
    check(oerr <= SCORE_ATOL, f"float kernel vs naive oracle: {oerr}")
    win = windows(chunk_f)
    f_bytes = 4 * (chunk_f.numel() + tiles.slabs.numel()
                   + 3 * tiles.bias_t.numel() + 2 * N * my * mx)
    records.append(dict(
        name="sliding_scores_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores.cu",
        replaces="src/repro/kernels/sliding_scores.py:244",
        max_abs_err=err, oracle_max_abs_err=oerr, run_to_run_bitwise=True,
        ms=time_ms(lambda: ss.fragment_scores_batch(chunk_f, tiles,
                                                           **kw)),
        plain_ms=time_ms(lambda: ss.fragment_scores_batch_plain(
            chunk_f, tiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        **bound(f_bytes, 2 * macs, F32_OPS_S)))

    # --- integer kernel (int8 timed; int4 and binary checked and timed)
    ms_by_precision, errs = {}, {}
    for precision, bits in (("int8", 8), ("int4", 4), ("binary", 8)):
        packed = precision == "int4"
        codes = stream.adc_view_codes(raw, bits)
        kcodes = adc.pack_nibbles(codes) if packed else codes
        itiles = stream.model_tiles(model, FRAME, BLOCK_D, precision)
        got = ssi.fragment_scores_batch_int(kcodes, itiles, packed=packed,
                                            **kw)
        again = ssi.fragment_scores_batch_int(kcodes, itiles, packed=packed,
                                              **kw)
        plain = ssi.fragment_scores_batch_int_plain(kcodes, itiles,
                                                    packed=packed, **kw)
        acc = ssi.int_window_acc(kcodes, itiles.geom, packed=packed, **kw)
        acc_plain = ssi.int_window_acc(
            kcodes.cpu(), _geometry_to(itiles.geom, "cpu"), packed=packed,
            **kw)
        torch.cuda.synchronize()
        errs[precision] = float((got - plain).abs().max())
        check(errs[precision] <= SCORE_ATOL,
              f"{precision} kernel vs plain: {errs[precision]}")
        check(torch.equal(got, again), f"{precision} kernel run to run")
        check(torch.equal(acc.cpu(), acc_plain),
              f"{precision} int32 window sums differ from the plain ones")
        ms_by_precision[precision] = time_ms(
            lambda: ssi.fragment_scores_batch_int(
                kcodes, itiles, packed=packed, **kw))
        if precision == "int8":
            int8 = dict(codes=codes, tiles=itiles, kcodes=kcodes)
    codes, itiles = int8["codes"], int8["tiles"]
    win = windows(codes)
    i_bytes = (codes.numel() + itiles.geom.slabs_q.numel()
               + 4 * itiles.geom.bias_t.numel() + 2 * itiles.cpos_t.numel()
               + 4 * 2 * N * my * mx)
    records.append(dict(
        name="sliding_scores_int", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores_int.cu",
        replaces="src/repro/kernels/sliding_scores_int.py:463",
        max_abs_err=max(errs.values()), max_abs_err_by_precision=errs,
        acc_bitwise=True, run_to_run_bitwise=True,
        ms=ms_by_precision["int8"],
        ms_by_precision=ms_by_precision,
        plain_ms=time_ms(lambda: ssi.fragment_scores_batch_int_plain(
            codes, itiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        **bound(i_bytes, 2 * macs, INT8_OPS_S)))
    return records


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
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r.process(raw)
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = sorted(((e.key, e.self_device_time_total)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        device_us = sum(us for _, us in rows)
        out[precision] = dict(
            wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
            device_busy_share=(device_us / wall_us if device_us > 0
                               else "not measured"),
            top_kernels_ms={k[:80]: us / 1e3 for k, us in rows[:6]})
    return out


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
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()}})

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
    for r in records:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never ran on the main path")
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in records]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
