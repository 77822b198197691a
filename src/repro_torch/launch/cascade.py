"""Gated-frame -> downstream-backbone cascade serving on PyTorch (the
paper's loop). Twin of ``repro.launch.cascade``.

HyperSense's system claim is gate-then-detect: the always-on HDC gate runs
on low-precision ADC data, and only the frames it passes are captured at
high precision and fed to the heavy downstream detector (paper §V-E).
Every gate runner's ``drain_hp()`` delivers ``(absolute frame indices,
(M, H, W) HP frames)``; :class:`CascadeService` consumes them:

* **Fixed-shape batching.** Drains are ragged. Frames queue on the host
  and launch in fixed ``(batch_size, H, W)`` blocks, the tail padded with
  zero rows that are dropped on collect, so the step is built once
  (:meth:`~CascadeService.rebuild_count`).
* **Bitwise batching.** The step
  (:func:`repro_torch.launch.steps.build_detector_cell`) runs one
  per-frame program per row, so a frame's logits are bitwise the same
  alone, padded or co-batched: batched output equals
  :meth:`~CascadeService.eager` bitwise.
* **A submit never waits for the card.** A batch is assembled in one of a
  ring of ``max_inflight + 1`` pinned ``(B, H, W)`` blocks and copied to
  the card with ``non_blocking=True``; the step runs; its logits are copied
  into a pinned host buffer of the ring and an event is recorded. Up to
  ``max_inflight`` batches stay in flight; a launch beyond that finishes
  the oldest (back-pressure), and :meth:`~CascadeService.collect` waits
  for the oldest alone. A ring slot is reused only after the batch that
  last used it was finished.
* **One CUDA graph.** At full width the per-frame program launches on the
  order of 10^4 kernels per batch, far more host time than device time,
  and it would hold up the gate's dispatch on the same thread. So the
  fixed-shape step is captured once, on a static input block, in a CUDA
  graph that every batch (and :meth:`~CascadeService.eager`) replays. The
  copy in, the replay and the copy out are enqueued on one stream in
  order, which keeps the static buffers safe. On the CPU the step runs
  directly.
* **System accounting.** :meth:`~CascadeService.backbone_cost` counts the
  step's products and bytes per frame
  (:func:`repro_torch.core.energy.backbone_cost`),
  :meth:`~CascadeService.system_energy` bills gate duty × backbone cost
  against the always-on backbone, and :meth:`~CascadeService.roofline`
  gives a batch's roofline terms on the H100
  (:mod:`repro_torch.distributed.roofline`).
* **Sharded** (``mesh=``, a ``("data", "model")`` ``DeviceMesh`` of every
  rank of the world). Every rank builds the service from the same whole
  parameters and is fed the same drains: the frames are replicated, the
  backbone's weights sharded
  (:func:`repro_torch.launch.steps.build_detector_cell`'s ``mesh=``), and
  every rank returns the same logits, bitwise. On the card the sharded
  step is captured in the one CUDA graph with its NCCL collectives; the
  warm run before the capture creates the communicators.

``compile_count()`` becomes :meth:`~CascadeService.rebuild_count`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Hashable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis import sanitize
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import energy
from repro_torch.distributed import roofline as roofline_mod
from repro_torch.launch import steps
from repro_torch.models import common
from repro_torch.sensing import fleet


@dataclasses.dataclass(frozen=True)
class CascadeBatch:
    """One collected backbone batch: per-frame logits + provenance.

    Row ``j`` of ``logits`` is the detector output for the frame the gate
    captured at absolute index ``frame_idx[j]`` on sensor ``sids[j]``; pad
    rows are already dropped. ``latency_s`` is wall time from the batch's
    launch to its logits being on the host.
    """
    seq: int
    sids: tuple
    frame_idx: np.ndarray          # (m,) int64 absolute gate indices
    logits: np.ndarray             # (m, n_out) float32
    n_padded: int                  # zero rows the fixed batch carried
    latency_s: float


@dataclasses.dataclass
class _InFlightBatch:
    seq: int
    t0: float
    logits: torch.Tensor           # (batch_size, n_out) host buffer of the ring
    done: torch.cuda.Event | None  # recorded after the logits' copy
    rows: list                     # [(sid, abs_idx), ...] valid rows


class CascadeService:
    """Batched, pipelined backbone serving over ``drain_hp`` feeds.

    ``params`` are :func:`repro_torch.launch.steps.init_detector_params`-
    shaped (``{"backbone": ..., "embedder": ...}``, e.g. from
    :func:`repro_torch.convert.detector_params_from_arrays`) for an
    **embeds-in** ``cfg`` (``configs.get_config("hubert-xlarge")``). Only
    their compute-dtype copy is kept. ``frame_hw`` must match the gate's
    frames; ``batch_size`` fixes the step's shape. ``device``: ``None`` ->
    ``"cuda"``, raising without CUDA; pass ``"cpu"`` for the plain run.
    With a ``mesh`` (every rank of the world, each on its own card, or on
    the CPU with ``gloo``), only this rank's blocks of the backbone are
    kept, and every rank makes the same calls in the same order: a step
    is a collective.

    Feed it directly (:meth:`submit` takes any ``drain_hp()`` output) or
    through :meth:`pump`, which drains a
    :class:`~repro_torch.launch.serve.FleetService`,
    :class:`~repro_torch.sensing.fleet.FleetRunner` or
    :class:`~repro_torch.sensing.stream.StreamRunner` in place. Results come
    back through :meth:`collect` / :meth:`flush` as :class:`CascadeBatch`
    rows mapped back to (sensor, absolute frame).
    """

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int,
                 frame_hw: tuple[int, int], patch: int = 8,
                 n_out: int = 2, mesh=None, max_inflight: int = 2,
                 j_per_flop: float = energy.EDGE_J_PER_FLOP,
                 device: str | torch.device | None = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        if mesh is not None and mesh.size() != dist.get_world_size():
            # every rank of the world runs the step's collectives
            raise ValueError(f"a CascadeService mesh must span every rank: "
                             f"{mesh.size()} of {dist.get_world_size()}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        self.patch = patch
        self.n_out = n_out
        self.max_inflight = max_inflight
        self.j_per_flop = j_per_flop
        self._mesh = mesh
        self._cell = steps.build_detector_cell(
            cfg, batch=batch_size, frame_hw=self.frame_hw, patch=patch,
            n_out=n_out, mesh=mesh)
        self.device = resolve_device(device)
        if mesh is not None:
            self.device = fleet.rank_device(self.device)
        self._cuda = self.device.type == "cuda"
        self._weights = self._cell.prepare(common.tree_map(
            lambda a: torch.as_tensor(a).to(self.device), params))
        self._queue: collections.deque = collections.deque()
        self._pending: collections.deque[_InFlightBatch] = \
            collections.deque()
        self._ready: collections.deque[CascadeBatch] = collections.deque()
        self._blocks: list[torch.Tensor] = []   # ring of host blocks
        self._outs: list[torch.Tensor] = []     # ring of host logits
        self._static_in: torch.Tensor | None = None
        self._static_out: torch.Tensor | None = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._rebuilds = 0
        self._cost: energy.BackboneCost | None = None
        self._seq = 0
        self.frames_in = 0             # frames ever submitted
        self.frames_padded = 0         # zero slack rows ever launched
        self.batches = 0

    # ------------------------------------------------------------------
    # feed
    # ------------------------------------------------------------------

    def submit(self, sid: Hashable, idx, frames) -> int:
        """Enqueue one drain's frames; launches every full batch.

        ``(idx, frames)`` is a ``drain_hp()`` deliverable: ``(M,)`` absolute
        indices + ``(M, H, W)`` HP frames (an empty drain is ``(0, H, W)``).
        Returns frames enqueued.
        """
        # repro-lint: disable=RA003 (admission boundary: drains are host arrays, queued on the host until a full (B, H, W) batch launches)
        idx = np.asarray(idx, np.int64)
        frames = np.asarray(frames, np.float32)  # repro-lint: disable=RA003 (same admission boundary)
        if frames.ndim != 3 or frames.shape[0] != idx.shape[0]:
            raise ValueError(f"drain shapes disagree: idx {idx.shape}, "
                             f"frames {frames.shape}")
        if frames.shape[1:] != self.frame_hw:
            raise ValueError(f"frames are {frames.shape[1:]}, cascade "
                             f"was built for {self.frame_hw}")
        for j in range(idx.shape[0]):
            self._queue.append((sid, int(idx[j]), frames[j]))
        self.frames_in += int(idx.shape[0])
        while len(self._queue) >= self.batch_size:
            self._launch([self._queue.popleft()
                          for _ in range(self.batch_size)])
        return int(idx.shape[0])

    def pump(self, gate) -> int:
        """Drain a gate front end into the queue; returns frames taken.

        Accepts a ``FleetService`` (per-sensor drains, keyed by sid), a
        ``FleetRunner`` (per-stream drains, keyed by row index), or a
        ``StreamRunner`` (single stream, sid 0).
        """
        taken = 0
        if hasattr(gate, "attached"):              # FleetService
            for sid in gate.attached:
                taken += self.submit(sid, *gate.drain_hp(sid))
        else:
            out = gate.drain_hp()
            if isinstance(out, list):              # FleetRunner
                for si, (idx, frames) in enumerate(out):
                    taken += self.submit(si, idx, frames)
            else:                                  # StreamRunner
                taken += self.submit(0, *out)
        return taken

    # ------------------------------------------------------------------
    # the step: built once, replayed per batch
    # ------------------------------------------------------------------

    def _build(self) -> None:
        """The ring of ``max_inflight + 1`` host blocks and logits buffers
        (pinned on the card), the static input block on the device and, on
        the card, the step captured in a CUDA graph: made once."""
        if self._static_in is not None:
            return
        self._rebuilds += 1
        sanitize.note_rebuild("CascadeService step")
        shape = (self.batch_size, *self.frame_hw)
        n = self.max_inflight + 1
        self._blocks = [torch.zeros(shape, pin_memory=self._cuda)
                        for _ in range(n)]
        self._outs = [torch.zeros((self.batch_size, self.n_out),
                                  pin_memory=self._cuda) for _ in range(n)]
        self._static_in = torch.zeros(shape, device=self.device)
        if not self._cuda:
            return
        # one run outside the capture makes the library's handles and
        # workspaces, and on a mesh the NCCL communicators of its groups,
        # as a capture requires
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._cell.step_fn(self._weights, self._static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._static_out = self._cell.step_fn(self._weights,
                                                  self._static_in)

    def _run(self, block: torch.Tensor, out: torch.Tensor) -> None:
        """Copy ``block`` in, run the step, copy its logits into ``out``:
        all enqueued on the current stream, in order."""
        self._static_in.copy_(block, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
        else:
            self._static_out = self._cell.step_fn(self._weights,
                                                  self._static_in)
        out.copy_(self._static_out, non_blocking=True)

    def rebuild_count(self) -> int:
        """Builds of the step's graph and its fixed buffers so far: the
        ragged-drain witness (the twin of the reference's
        ``compile_count()``), 1 after the first batch whatever follows."""
        return self._rebuilds

    # ------------------------------------------------------------------
    # dispatch / collect
    # ------------------------------------------------------------------

    def _launch(self, rows: list) -> None:
        self._build()
        # ring slot k's previous batch (seq - max_inflight - 1) was
        # finished by the back-pressure below, so its buffers are free
        k = self._seq % (self.max_inflight + 1)
        block, out = self._blocks[k], self._outs[k]
        host = block.numpy()
        for j, (_, _, frame) in enumerate(rows):
            host[j] = frame
        host[len(rows):] = 0.0
        t0 = time.perf_counter()
        self._run(block, out)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        self._pending.append(_InFlightBatch(
            seq=self._seq, t0=t0, logits=out, done=done,
            rows=[(sid, idx) for sid, idx, _ in rows]))
        self._seq += 1
        self.batches += 1
        self.frames_padded += self.batch_size - len(rows)
        while len(self._pending) > self.max_inflight:
            self._ready.append(self._finish(self._pending.popleft()))

    def _finish(self, rec: _InFlightBatch) -> CascadeBatch:
        """The designed sync point: waits for this batch's logits alone."""
        if rec.done is not None:
            rec.done.synchronize()
        m = len(rec.rows)
        return CascadeBatch(
            seq=rec.seq,
            sids=tuple(sid for sid, _ in rec.rows),
            frame_idx=np.asarray([i for _, i in rec.rows], np.int64),
            logits=rec.logits.numpy()[:m].copy(),
            n_padded=self.batch_size - m,
            latency_s=time.perf_counter() - rec.t0)

    def _finish_pending(self) -> None:
        while self._pending:
            self._ready.append(self._finish(self._pending.popleft()))

    def collect(self) -> CascadeBatch | None:
        """Oldest finished batch (FIFO), or None with nothing in flight."""
        if self._ready:
            return self._ready.popleft()
        if not self._pending:
            return None
        return self._finish(self._pending.popleft())

    def flush(self) -> list[CascadeBatch]:
        """Force the partial tail batch out and drain the pipeline."""
        if self._queue:
            self._launch([self._queue.popleft()
                          for _ in range(len(self._queue))])
        self._finish_pending()
        out = list(self._ready)
        self._ready.clear()
        return out

    @property
    def queued(self) -> int:
        """Frames waiting for a full batch (flush() forces them)."""
        return len(self._queue)

    # ------------------------------------------------------------------
    # reference + accounting
    # ------------------------------------------------------------------

    def eager(self, frames) -> np.ndarray:
        """Per-frame reference evaluation: one step run per frame.

        Runs each ``(H, W)`` frame alone, as row 0 of a zero block, through
        the SAME step (on the card, the same graph) and returns ``(M,
        n_out)`` logits. Batched outputs must equal these bitwise. The
        batches in flight are finished first (their results stay
        collectable), which frees the ring.
        """
        frames = np.asarray(frames, np.float32)
        self._build()
        self._finish_pending()
        block, out = self._blocks[0], self._outs[0]
        res = np.empty((frames.shape[0], self.n_out), np.float32)
        for j in range(frames.shape[0]):
            block.zero_()
            block[0] = torch.from_numpy(frames[j])
            self._run(block, out)
            if self._cuda:
                torch.cuda.current_stream(self.device).synchronize()
            res[j] = out[0].numpy()
        return res

    def backbone_cost(self) -> energy.BackboneCost:
        """Per-frame FLOPs, bytes and Joules of the step, counted over one
        run on meta tensors of the step's weights and block; on a mesh over
        one real run (a collective: every rank calls it), every rank's
        products."""
        if self._cost is None:
            if self._mesh is None:
                weights = common.tree_map(
                    lambda a: torch.empty_like(a, device="meta"),
                    self._weights)
                block = torch.zeros((self.batch_size, *self.frame_hw),
                                    device="meta")
            else:
                weights, block = self._weights, self._zero_block()
            self._cost = energy.backbone_cost(
                self._cell.step_fn, weights, block,
                j_per_flop=self.j_per_flop, ranks=self._chips())
        return self._cost

    def roofline(self) -> roofline_mod.Roofline:
        """Roofline latency model of one backbone batch on the H100 (the
        per-batch service step the gate's duty cycle amortizes), from one
        uncaptured run of the step (on a mesh a collective: every rank
        calls it)."""
        seq = steps.detector_seq_len(self.frame_hw, self.patch)
        shape = ShapeConfig(name=f"detector_b{self.batch_size}",
                            seq_len=seq, global_batch=self.batch_size,
                            kind="prefill")
        mesh_name = ("x".join(str(n) for n in self._mesh.mesh.shape)
                     if self._mesh is not None else "single")
        return roofline_mod.from_step(
            self._cell.step_fn, self._weights, self._zero_block(),
            arch=self.cfg.arch_id, shape=shape, mesh_name=mesh_name,
            chips=self._chips())

    def _chips(self) -> int:
        return 1 if self._mesh is None else self._mesh.size()

    def _zero_block(self) -> torch.Tensor:
        return torch.zeros((self.batch_size, *self.frame_hw),
                           device=self.device)

    def system_energy(self, log, params: energy.EnergyParams | None = None,
                      precision: str = "float32"
                      ) -> dict[str, energy.EnergyBreakdown]:
        """Per-frame system energy: this cascade vs the always-on backbone.

        ``log`` is the gate's
        :class:`~repro_torch.core.sensor_control.CaptureLog` (closed loop:
        a real ``hp_bits`` is required); ``"cascade"`` bills LP sampling +
        HDC + duty-cycled HP capture + duty × backbone cost,
        ``"always_on"`` bills HP capture + backbone on every frame.
        """
        cost = self.backbone_cost()
        return {"cascade": energy.cascade_system(log, cost, params,
                                                 precision),
                "always_on": energy.always_on_backbone(cost, params)}
