"""Always-on fleet serving on PyTorch: pipelined dispatch and collect, a
slot pool under churn, checkpointed online state, sharded over a device
mesh. Twin of ``repro.launch.serve``.

The paper's Intelligent Sensor Control runs *continuously*: sensors attach
and detach at any time, and the host must prepare the next tick while the
card scores this one. :class:`FleetService` is that front door on top of
the same step as :class:`~repro_torch.sensing.fleet.FleetRunner`, split
into its device half (:func:`~repro_torch.sensing.stream.chunk_device_half`)
and its host half (:func:`~repro_torch.sensing.stream.chunk_host_half`).

**Pipelining** (:meth:`FleetService.dispatch` / :meth:`~FleetService.collect`).
``dispatch`` assembles the ``(n_slots, C, H, W)`` tick in one of a ring of
``max_inflight + 1`` pinned host buffers and copies it to the card with
``non_blocking=True`` (arrivals already on the card are copied there), runs
the ADC view and the device half on PyTorch's current stream, where the
kernels launch, copies the ``(S, C)`` scores into a pinned host buffer
with ``non_blocking=True``, records a ``torch.cuda.Event`` and returns.
On the frozen path (no ``adapt``) it never waits for the card. ``collect``
waits on the oldest tick's event and runs the host half in FIFO order: the
gate or capture-loop scans, the capture logs and the HP capture from the
tick's raw frames, which stay on the card until then (gathered on a second
stream, so this wait does not drain the ticks queued behind it). A ring
buffer is reused only after the tick that last used it has been finished.
Up to ``max_inflight`` ticks are in flight; ``dispatch`` finishes the
oldest beyond that (back-pressure).

The host half carries the holds and phases, so a slot's state is known
only once its ticks' host halves ran: :meth:`~FleetService.attach`,
:meth:`~FleetService.detach`, :meth:`~FleetService.checkpoint` and
:meth:`~FleetService.class_hvs_of` first finish every pending tick into
the ready queue (its results stay collectable). With ``adapt`` in the
closed loop the fold of tick t reads that tick's ``sampled``, so
``dispatch`` of tick t+1 first finishes tick t; results stay FIFO and
unchanged.

**Slot-pooled churn** (:meth:`~FleetService.attach` /
:meth:`~FleetService.detach`). The step always runs at ``(n_slots, C, H,
W)``; membership and ragged arrival only change which slots are active.
Geometry, tiles and the ring buffers are built once (:meth:`rebuild_count`
counts those builds: churn leaves it unchanged). A masked slot's hold,
phase and classifier are parked in place, and detach parks them on the
host, so detach -> reattach restores a sensor bitwise, even through
another tenant of its slot. Sensor ``uid``'s ADC noise is drawn from
``fleet.stream_seed(adc_seed, uid)`` at its own frame count, so under any
churn it equals ``StreamRunner(adc_seed=stream_seed(adc_seed, uid))``
bitwise, and a churn-free service with uids 0..S-1 equals ``FleetRunner``.

**Checkpointed online state** (:meth:`~FleetService.checkpoint` /
:meth:`~FleetService.restore`), through
:class:`repro_torch.ckpt.checkpoint.AsyncCheckpointer`, with the
reference's leaves and manifest, so a checkpoint of either package's
service restores into the other.

**Sharded** (``mesh=``, default: the current
:func:`~repro_torch.distributed.sharding.use_mesh` mesh). ``n_slots`` is
padded once to the mesh's "sensors" extent (churn never re-pads), slot
assignment is global and the same on every rank, and each rank scores its
contiguous slots against its D-tiles (:class:`~repro_torch.sensing.fleet.
FleetRunner`'s split): ``dispatch`` runs this rank's slots and gathers the
tick's scores over the sensor ranks on the card, ``collect`` and ``flush``
return whole ticks on every rank. Every rank makes the same calls with the
same arguments. A checkpoint keeps the unsharded format: gathered, written
by rank 0, read by every rank, so it resumes across meshes; the mesh must
therefore span every rank of the default group.

Not ported: ``backend=`` (the port has one route per device).
``compile_count()`` becomes :meth:`~FleetService.rebuild_count` (PyTorch
compiles nothing per shape).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Hashable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis import sanitize
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.core.hypersense import HyperSenseModel
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import (CaptureConfig, CaptureLog,
                                             ControllerConfig,
                                             assemble_capture_log,
                                             decimation)
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import ops
from repro_torch.sensing import adc as adc_sim
from repro_torch.sensing import fleet as fleet_mod
from repro_torch.sensing import stream as stream_mod
from repro_torch.sensing.fleet import stream_seed
from repro_torch.sensing.stream import StreamState, init_stream_state


@dataclasses.dataclass(frozen=True)
class ServedChunk:
    """One collected tick: per-sensor outputs + the dispatch->collect lag.

    ``outputs[sid]`` is ``(scores (C,), fired (C,), gated (C,))`` numpy
    arrays for every sensor that delivered frames in the tick;
    ``sampled[sid]`` marks the frames its LP ADC actually converted
    (closed-loop mode). ``latency_s`` is wall time from ``dispatch``
    returning to the scores being on the host.
    """
    seq: int
    outputs: dict[Hashable, tuple[np.ndarray, np.ndarray, np.ndarray]]
    sampled: dict[Hashable, np.ndarray]
    latency_s: float


@dataclasses.dataclass
class _Parked:
    """Per-sensor state parked across detach."""
    uid: int
    n_seen: int
    hold: int
    phase: int
    class_hvs: torch.Tensor | None   # (2, D) in per-stream scope, else None


@dataclasses.dataclass
class _InFlight:
    """A dispatched, not yet collected tick: its pinned scores buffer and
    the event after their copy, and what its host half needs."""
    seq: int
    t0: float
    scores: torch.Tensor             # (S, C) host buffer of the ring
    done: torch.cuda.Event | None    # recorded after the scores' copy
    sids: tuple                      # slot -> sid for arrival slots, else None
    starts: np.ndarray               # (S,) per-slot absolute frame base
    active: np.ndarray               # (S,) bool: the slots that delivered
    fold: tuple | None               # (frames, maps, labels): closed-loop fold
    raw: torch.Tensor | None         # raw frames on the card (HP capture)


def _adc_convert_fn(frames: torch.Tensor, active: np.ndarray,
                    uids: np.ndarray, starts: np.ndarray, *, bits: int,
                    sigma: float, adc_seed: int, codes: bool
                    ) -> torch.Tensor:
    """Per-slot ADC front end: each slot converts with the noise of its
    sensor's persistent uid (``stream_seed(adc_seed, uid)``) from its
    sensor's frame count, so a sensor's capture is bitwise the same in any
    slot and under any churn. Without noise the conversion is elementwise,
    so one call converts every slot."""
    view = stream_mod.adc_view_codes if codes else stream_mod.adc_view
    if sigma <= 0.0:
        return view(frames, bits)
    return torch.stack([
        view(frames[s], bits, sigma=sigma if active[s] else 0.0,
             seed=stream_seed(adc_seed, int(uids[s])),
             start_index=int(starts[s]))
        for s in range(frames.shape[0])])


def _integer_codes(fr) -> bool:
    if isinstance(fr, torch.Tensor):
        return not (fr.is_floating_point() or fr.is_complex())
    return bool(np.issubdtype(np.result_type(fr), np.integer))


def _on_card(fr) -> bool:
    return isinstance(fr, torch.Tensor) and fr.device.type == "cuda"


class FleetService:
    """Slot-pooled, pipelined, checkpointed fleet serving.

    Sensors :meth:`attach` / :meth:`detach` at any time into a fixed pool
    of ``n_slots``; each service *tick* is one :meth:`dispatch` of
    ``chunk_size`` frames from whichever sensors have them (ragged arrival
    = absent from the dict), and :meth:`collect` returns finished ticks in
    FIFO order. State (classifier adaptation, gate hysteresis, closed-loop
    ADC phase) carries exactly as in
    :class:`~repro_torch.sensing.fleet.FleetRunner`: with every slot
    delivering, the two are bitwise identical.

    Config mirrors ``FleetRunner`` (``precision``, ``adc_bits`` /
    ``adc_sigma`` / ``adc_seed``, ``adapt``, ``control``, ``block_d``,
    ``device``: ``None`` -> ``"cuda"``, raising without CUDA; pass
    ``"cpu"`` for the plain versions), plus:

    * ``n_slots`` — pool capacity (the runner's frozen S), padded to the
      mesh's "sensors" extent;
    * ``mesh`` — shards every tick over the mesh's ranks (module
      docstring), which must be every rank of the default group; every
      rank calls every method with the same arguments;
    * ``max_inflight`` — dispatched but uncollected ticks before
      ``dispatch`` itself finishes the oldest (back-pressure);
    * ``ckpt_dir`` / ``ckpt_every`` / ``ckpt_keep`` — automatic async
      snapshots of the mutable state every N ticks.

    Sensor ids must be JSON-serializable scalars (``str`` or ``int``): they
    ride the checkpoint manifest.
    """

    def __init__(self, model: HyperSenseModel,
                 config: ControllerConfig | None = None, *,
                 n_slots: int, chunk_size: int = 32,
                 t_detection: int | None = None, block_d: int = 512,
                 adc_bits: int | None = None, adc_sigma: float = 0.0,
                 adc_seed: int = 0, adapt: AdaptConfig | None = None,
                 precision: str = "float32",
                 control: CaptureConfig | None = None,
                 max_inflight: int = 2, ckpt_dir: str | None = None,
                 ckpt_every: int = 0, ckpt_keep: int = 3,
                 device: str | torch.device | None = None, mesh=None):
        stream_mod.validate_runner_args(chunk_size, adc_bits, adc_sigma,
                                        precision)
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        if ckpt_every and ckpt_dir is None:
            raise ValueError("ckpt_every > 0 needs ckpt_dir")
        self._mesh = mesh if mesh is not None else shlib.current_mesh()
        if (self._mesh is not None
                and self._mesh.size() != dist.get_world_size()):
            # rank 0 writes the checkpoint and the ranks meet at a barrier
            # of the default group, so the mesh holds every rank
            raise ValueError(f"a FleetService mesh must span every rank: "
                             f"{self._mesh.size()} of "
                             f"{dist.get_world_size()}")
        self.device = resolve_device(device)
        if self._mesh is not None:
            self.device = fleet_mod.rank_device(self.device)
        self.model = model.to(self.device)
        self.config = config or ControllerConfig()
        # capacity is padded ONCE: churn never re-pads, shapes never move
        self.n_slots = shlib.padded_extent(n_slots, "sensors", self._mesh)
        axes, _ = fleet_mod._sensor_axes(self._mesh)
        self._sensor_group = (shlib.axis_group(self._mesh, axes) if axes
                              else None)
        # this rank's slots: the device half runs over them alone
        self._lo, self._hi = (
            (0, self.n_slots) if self._sensor_group is None
            else shlib.local_range(self.n_slots, self._sensor_group))
        self._hyperdim_group = None
        self.chunk_size = chunk_size
        self.block_d = block_d
        self.t_detection = (model.t_detection if t_detection is None
                            else t_detection)
        self.adc_bits = adc_bits
        self.adc_sigma = adc_sigma
        self.adc_seed = adc_seed
        self.adapt = adapt
        self.precision = precision
        self.control = control
        self._decim = (None if control is None
                       else (decimation(self.config) if control.subsample
                             else 1))
        self.max_inflight = max_inflight
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self._ckpt = (ckpt_mod.AsyncCheckpointer(ckpt_dir, keep=ckpt_keep)
                      if ckpt_dir is not None else None)
        self._cuda = self.device.type == "cuda"

        self._slots: list = [None] * self.n_slots   # slot -> sid
        self._by_sid: dict = {}                 # sid -> slot
        self._uids: dict = {}                   # sid -> persistent uid
        self._n_seen: dict = {}                 # sid -> abs frame count
        self._parked: dict[Hashable, _Parked] = {}
        self._logs: dict = {}      # sid -> (sampled blocks, gated blocks)
        self._hp: dict = {}        # sid -> [(abs_idx, frame), ...]
        self.hp_dropped = 0
        self._next_uid = 0
        self._seq = 0              # ticks dispatched so far
        self._frame_hw: tuple[int, int] | None = None
        self._frame_pixels = 0
        self._can_fire = True
        self._tiles = None         # frozen tiles, or the adapting geometry
        self._rings: dict = {}     # name -> [buffer per ring slot]
        self._no_labels = None     # (S, C) zeros on the device (pseudo mode)
        self._side = None          # the HP capture's stream
        self._rebuilds = 0
        self._state = init_stream_state(self.model.class_hvs,
                                        self.n_slots)
        if self._per_stream():
            self._state = dataclasses.replace(
                self._state, class_hvs=self.model.class_hvs.expand(
                    self._hi - self._lo, *self.model.class_hvs.shape
                ).clone())
        self._pending: collections.deque[_InFlight] = collections.deque()
        self._ready: collections.deque[ServedChunk] = collections.deque()

    # ------------------------------------------------------------------
    # slot pool
    # ------------------------------------------------------------------

    def _per_stream(self) -> bool:
        return self.adapt is not None and self.adapt.scope == "per-stream"

    def _class_stack(self) -> torch.Tensor:
        """The per-stream ``(n_slots, 2, D)`` stack, gathered from every
        sensor rank on a mesh (a collective: every rank calls it)."""
        chvs = self._state.class_hvs
        if self._sensor_group is None:
            return chvs
        return shlib.all_gather_cat(chvs, self._sensor_group)

    @property
    def attached(self) -> tuple:
        """Currently attached sensor ids, in slot order."""
        return tuple(sid for sid in self._slots if sid is not None)

    @property
    def free_slots(self) -> int:
        return sum(1 for sid in self._slots if sid is None)

    def uid(self, sid) -> int:
        """Persistent per-sensor uid (keys the ADC noise stream; survives
        detach/reattach and checkpoint/restore)."""
        return self._uids[sid]

    def attach(self, sid) -> int:
        """Claim a slot for ``sid``; returns the slot index.

        A previously detached sensor resumes its parked state — adapted
        classifier row, gate hold, ADC phase, frame counter, capture log —
        bitwise, even if other tenants used the slot meanwhile.
        """
        if not isinstance(sid, (str, int)):
            raise TypeError(f"sensor id must be str or int (rides the "
                            f"checkpoint manifest), got {type(sid)}")
        if sid in self._by_sid:
            raise ValueError(f"sensor {sid!r} already attached")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError(
                f"slot pool exhausted ({self.n_slots} slots, "
                f"{len(self._parked)} parked): detach a sensor or build "
                f"the service with more n_slots") from None
        self._finish_pending()
        st = self._state
        holds, phases, chvs = st.holds.clone(), st.phases.clone(), None
        if sid in self._parked:
            p = self._parked.pop(sid)
            holds[slot], phases[slot] = p.hold, p.phase
            chvs = p.class_hvs
            self._n_seen[sid] = p.n_seen
            self._uids[sid] = p.uid
        else:
            holds[slot] = phases[slot] = 0
            if st.class_hvs.ndim == 3:
                chvs = self.model.class_hvs
            self._n_seen[sid] = 0
            self._uids[sid] = self._next_uid
            self._next_uid += 1
            self._logs[sid] = ([], [])
            self._hp[sid] = []
        class_hvs = st.class_hvs
        if chvs is not None and self._lo <= slot < self._hi:
            class_hvs = class_hvs.clone()
            class_hvs[slot - self._lo] = chvs
        self._state = dataclasses.replace(st, class_hvs=class_hvs,
                                          holds=holds, phases=phases)
        self._slots[slot] = sid
        self._by_sid[sid] = slot
        return slot

    def detach(self, sid) -> None:
        """Release ``sid``'s slot, parking its state for reattach (after
        finishing the pending ticks, whose host halves carry it)."""
        if sid not in self._by_sid:
            raise ValueError(f"sensor {sid!r} is not attached")
        self._finish_pending()
        slot = self._by_sid.pop(sid)
        st = self._state
        self._parked[sid] = _Parked(
            uid=self._uids[sid], n_seen=self._n_seen[sid],
            hold=int(st.holds[slot]), phase=int(st.phases[slot]),
            class_hvs=(self._class_stack()[slot].clone()
                       if st.class_hvs.ndim == 3 else None))
        self._slots[slot] = None

    # ------------------------------------------------------------------
    # step plumbing (shared with FleetRunner)
    # ------------------------------------------------------------------

    def _ensure_tiles(self, W: int):
        """The frozen tiles, or the class-independent geometry when
        adapting (re-tiled per tick in the device half): built once."""
        if self._tiles is None:
            self._rebuilds += 1
            sanitize.note_rebuild("FleetService tiles")
            geom = stream_mod.model_geometry(self.model, W, self.block_d,
                                             self.precision)
            hd = fleet_mod._hyperdim_axes(self._mesh, geom.idx.shape[0])
            if hd is not None:
                self._hyperdim_group = shlib.axis_group(self._mesh, hd)
                geom = fleet_mod.local_geometry(geom, *shlib.local_range(
                    geom.idx.shape[0], self._hyperdim_group))
            retile = (ops.retile_classes_int
                      if self.precision in adc_sim.INT_PRECISIONS
                      else ops.retile_classes)
            self._tiles = (geom if self.adapt is not None
                           else retile(geom, self.model.class_hvs))
        return self._tiles

    def _ring(self, name: str, shape: tuple, dtype: torch.dtype
              ) -> list[torch.Tensor]:
        """``max_inflight + 1`` host buffers (pinned on the card), made once
        per kind."""
        ring = self._rings.get(name)
        if ring is None:
            self._rebuilds += 1
            sanitize.note_rebuild(f"FleetService {name} ring")
            ring = [torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)
                    for _ in range(self.max_inflight + 1)]
            self._rings[name] = ring
        return ring

    def rebuild_count(self) -> int:
        """Geometry and tile builds and fixed-buffer allocations of this
        service so far.

        The churn contract's witness (the twin of the reference's
        ``compile_count()``): after the warm-up tick, attach, detach,
        ragged arrival and silent ticks leave this number unchanged.
        """
        return self._rebuilds

    @property
    def _adc_lsb(self) -> float:
        return (adc_sim.lsb(self.adc_bits)
                if self.precision in adc_sim.INT_PRECISIONS else 1.0)

    def _finish_pending(self) -> None:
        while self._pending:
            self._ready.append(self._finish(self._pending.popleft()))

    # ------------------------------------------------------------------
    # dispatch / collect
    # ------------------------------------------------------------------

    def _fix_frame_shape(self, shp: tuple) -> None:
        """Fix the frame shape from the first arrival (and check the int
        datapath for it)."""
        if len(shp) != 3:
            raise ValueError(f"expected (chunk_size, H, W) arrival, "
                             f"got shape {shp}")
        H, W = int(shp[1]), int(shp[2])
        m = self.model
        if self.precision in adc_sim.INT_PRECISIONS:
            ops.assert_int_datapath_fits(self.adc_bits, H, W, m.h, m.w,
                                         stride=m.stride)
        self._frame_hw = (H, W)
        self._frame_pixels = H * W
        n_windows = ((H - m.h) // m.stride + 1) * ((W - m.w) // m.stride + 1)
        self._can_fire = self.t_detection < n_windows

    def dispatch(self, arrivals: dict, labels: dict | None = None) -> int:
        """Enqueue one service tick; returns its sequence number.

        ``arrivals`` maps attached sensor ids to ``(chunk_size, H, W)``
        frame blocks (numpy arrays or tensors, on the host or on the card;
        raw float frames, or integer ADC codes under an integer precision);
        an attached sensor absent from the dict is masked for the tick —
        its carried state is parked in place, as if no time passed for it.
        ``labels`` (same keying, ``(C,)`` ints, on the host) feeds
        ``adapt.mode == "label"`` updates.

        Returns once the copies and the device half are enqueued; results
        come back through :meth:`collect`, oldest first.
        """
        C, S = self.chunk_size, self.n_slots
        label_mode = self.adapt is not None and self.adapt.mode == "label"
        if labels is not None and not label_mode:
            raise ValueError("labels passed without adapt.mode == 'label'")
        for sid in arrivals:
            if sid not in self._by_sid:
                raise ValueError(f"sensor {sid!r} is not attached")
            if label_mode and (labels is None or sid not in labels):
                raise ValueError(f'adapt.mode == "label": arrival for '
                                 f"{sid!r} needs labels[{sid!r}]")
        if arrivals and self._frame_hw is None:
            # a shape peek: np.shape reads .shape, no copy from the card
            self._fix_frame_shape(tuple(np.shape(next(iter(
                arrivals.values())))))
        if self._frame_hw is None:
            raise ValueError("first dispatch needs at least one arrival "
                             "to fix the frame shape")
        H, W = self._frame_hw
        for sid, fr in arrivals.items():
            if tuple(np.shape(fr)) != (C, H, W):
                raise ValueError(
                    f"arrival for {sid!r} has shape {tuple(np.shape(fr))}, "
                    f"expected (chunk_size, H, W) = {(C, H, W)} — a service "
                    f"tick is exactly one chunk; buffer partial chunks at "
                    f"the edge")
        codes = (self.precision in adc_sim.INT_PRECISIONS and bool(arrivals)
                 and all(_integer_codes(fr) for fr in arrivals.values()))
        if codes and self.adc_sigma > 0.0:
            raise ValueError("adc noise applies before conversion; input "
                             "is already integer ADC codes")
        hp_k = stream_mod.resolve_hp_buffer(
            self.control, C, torch.int32 if codes else torch.float32)
        if self.adapt is not None and self._decim is not None:
            # the closed loop's fold of the last tick reads its scan
            self._finish_pending()
        # ring slot k's previous tick (seq - max_inflight - 1) was finished
        # by the back-pressure below, so its buffers are free
        k = self._seq % (self.max_inflight + 1)

        active = np.zeros((S,), bool)
        starts = np.zeros((S,), np.int64)
        uids = np.zeros((S,), np.int64)
        for sid in arrivals:
            slot = self._by_sid[sid]
            active[slot] = True
            starts[slot] = self._n_seen[sid]
            uids[slot] = self._uids[sid]
            self._n_seen[sid] += C
        raw = self._assemble(arrivals, codes, k)
        dev = self.device
        local = slice(self._lo, self._hi)   # this rank's slots

        if codes:
            frames = adc_sim.pack_codes(raw[local], self.adc_bits)
        elif self.adc_bits is not None:
            frames = _adc_convert_fn(
                raw[local], active[local], uids[local], starts[local],
                bits=self.adc_bits, sigma=self.adc_sigma,
                adc_seed=self.adc_seed,
                codes=self.precision in adc_sim.INT_PRECISIONS)
        else:
            frames = raw[local]
        lab = mask = None
        if self.adapt is not None:
            mask = self._ring("mask", (S,), torch.bool)[k]
            mask.copy_(torch.from_numpy(active))
            mask = mask[local].to(dev, non_blocking=True, copy=True)
            if label_mode:
                lab = self._ring("labels", (S, C), torch.int32)[k]
                lab.zero_()
                for sid in arrivals:
                    lab[self._by_sid[sid]].copy_(torch.as_tensor(labels[sid]))
                lab = lab[local].to(dev, non_blocking=True, copy=True)
            else:
                if self._no_labels is None:
                    self._rebuilds += 1
                    sanitize.note_rebuild("FleetService label buffer")
                    self._no_labels = torch.zeros(
                        (self._hi - self._lo, C), dtype=torch.int32,
                        device=dev)
                lab = self._no_labels

        m = self.model
        tiles = self._ensure_tiles(W)
        maps, scores, folded = stream_mod.chunk_device_half(
            frames, self._state.class_hvs, m.B0, m.b, tiles, C, lab, mask,
            h=m.h, w=m.w, stride=m.stride, nonlinearity=m.nonlinearity,
            t_detection=self.t_detection, adapt=self.adapt,
            precision=self.precision, adc_lsb=self._adc_lsb,
            decim=self._decim, park_masked=True,
            sensor_group=self._sensor_group,
            hyperdim_group=self._hyperdim_group)
        self._state = dataclasses.replace(
            self._state, frame_idx=self._state.frame_idx + C,
            class_hvs=(self._state.class_hvs if folded is None
                       else folded))
        if self._sensor_group is not None:
            # the whole tick's scores on every rank, gathered on the card
            scores = shlib.all_gather_cat(scores, self._sensor_group)
        out = self._ring("scores", (S, C), torch.float32)[k]
        out.copy_(scores, non_blocking=True)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        rec = _InFlight(
            seq=self._seq, t0=time.perf_counter(), scores=out, done=done,
            sids=tuple(sid if active[i] else None
                       for i, sid in enumerate(self._slots)),
            starts=starts, active=active,
            fold=((frames, maps, lab) if self.adapt is not None
                  and self._decim is not None else None),
            raw=raw if hp_k > 0 else None)
        self._seq += 1
        self._pending.append(rec)
        # back-pressure, and what frees the ring: at most max_inflight ticks
        # stay pending
        while len(self._pending) > self.max_inflight:
            self._ready.append(self._finish(self._pending.popleft()))
        if self.ckpt_every and self._seq % self.ckpt_every == 0:
            self.checkpoint()
        return rec.seq

    def _assemble(self, arrivals: dict, codes: bool, k: int) -> torch.Tensor:
        """The ``(S, C, H, W)`` tick on the device: host arrivals through
        ring buffer ``k`` (pinned on the card) and one ``non_blocking``
        copy, arrivals on the card copied there, zeros in the other slots.
        Integer codes are range-checked on the host buffer, and the codes
        on the card, all at once, by
        :func:`~repro_torch.sensing.adc.check_codes_range`: one read back a
        tick, as the reference's one check of its assembled tick."""
        S, C = self.n_slots, self.chunk_size
        shape = (S, C, *self._frame_hw)
        dtype = torch.int32 if codes else torch.float32
        host = {sid: fr for sid, fr in arrivals.items() if not _on_card(fr)}
        if host:
            # PyTorch's host copies (on its intra-op threads, with the
            # cast numpy's assignment makes)
            buf = self._ring("codes" if codes else "frames", shape, dtype)[k]
            slots = [self._by_sid[sid] for sid in host]
            for slot in set(range(S)) - set(slots):
                buf[slot].zero_()
            for slot, fr in zip(slots, host.values()):
                buf[slot].copy_(torch.as_tensor(fr))
            if codes:
                lo, hi = torch.aminmax(buf[slots])
                adc_sim.check_codes_bounds(int(lo), int(hi), self.adc_bits)
            tick = buf.to(self.device, non_blocking=True, copy=True)
        else:
            tick = torch.zeros(shape, dtype=dtype, device=self.device)
        card = {sid: fr for sid, fr in arrivals.items() if _on_card(fr)}
        if codes and card:
            adc_sim.check_codes_range(list(card.values()), self.adc_bits)
        for sid, fr in card.items():
            tick[self._by_sid[sid]].copy_(fr)
        return tick

    def _hp_stream(self, rec: _InFlight):
        """The HP capture's stream on the card: a second stream, so its
        copy to the host waits for this tick alone, not for the ticks
        queued behind it on the current stream."""
        if rec.done is None:
            return contextlib.nullcontext()
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        self._side.wait_event(rec.done)
        rec.raw.record_stream(self._side)
        return torch.cuda.stream(self._side)

    def _finish(self, rec: _InFlight) -> ServedChunk:
        """The host half of one tick, in FIFO order: the designed sync
        point, which waits for this tick's scores alone."""
        if rec.done is not None:
            rec.done.synchronize()
        scores = rec.scores.clone()
        latency = time.perf_counter() - rec.t0
        C = self.chunk_size
        st = self._state
        active = torch.from_numpy(rec.active)
        fired, gated, sampled, holds, phases = stream_mod.chunk_host_half(
            scores, st.holds, st.phases, C, active,
            t_score=self.model.t_score, can_fire=self._can_fire,
            hold_frames=self.config.hold_frames, decim=self._decim,
            park_masked=True)
        if rec.fold is not None:
            m = self.model
            frames, maps, lab = rec.fold
            local = slice(self._lo, self._hi)
            chvs = stream_mod.fold_chunk(
                frames, maps, st.class_hvs, m.B0, m.b, lab, sampled[local],
                h=m.h, w=m.w, stride=m.stride, nonlinearity=m.nonlinearity,
                adapt=self.adapt, precision=self.precision,
                adc_lsb=self._adc_lsb, sensor_group=self._sensor_group)
            st = dataclasses.replace(
                st, class_hvs=stream_mod.park_classes(chvs, st.class_hvs,
                                                      active[local]))
        self._state = dataclasses.replace(st, holds=holds, phases=phases)
        s, f, g, smp = (x.numpy() for x in (scores, fired, gated, sampled))
        outputs, sampled_out = {}, {}
        for slot, sid in enumerate(rec.sids):
            if sid is None:
                continue
            outputs[sid] = (s[slot], f[slot], g[slot])
            sampled_out[sid] = smp[slot]
            logs = self._logs[sid]
            logs[0].append(smp[slot])
            logs[1].append(g[slot])
        if rec.raw is not None:
            hp_k = stream_mod.resolve_hp_buffer(self.control, C,
                                                rec.raw.dtype)
            # a masked slot still holding has gated noise: it must not be
            # HP-captured or counted as dropped
            with self._hp_stream(rec):
                entries, dropped = stream_mod.collect_hp(
                    rec.raw, g & rec.active[:, None], C, hp_k,
                    self.control.hp_bits, rec.starts)
            for slot, sid in enumerate(rec.sids):
                if sid is not None:
                    self._hp[sid].extend(entries[slot])
            self.hp_dropped += dropped
        return ServedChunk(seq=rec.seq, outputs=outputs, sampled=sampled_out,
                           latency_s=latency)

    def collect(self) -> ServedChunk | None:
        """Oldest finished tick (FIFO), or None when nothing is in flight.

        Waits only until the oldest dispatched tick's scores are on the
        host — younger ticks keep running behind it.
        """
        if self._ready:
            return self._ready.popleft()
        if not self._pending:
            return None
        return self._finish(self._pending.popleft())

    def flush(self) -> list[ServedChunk]:
        """Finish every in-flight tick (in order) — a full pipeline sync."""
        out = list(self._ready)
        self._ready.clear()
        while self._pending:
            out.append(self._finish(self._pending.popleft()))
        return out

    # ------------------------------------------------------------------
    # per-sensor views
    # ------------------------------------------------------------------

    def class_hvs_of(self, sid) -> torch.Tensor:
        """The live ``(2, D)`` classifier serving ``sid`` (parked or
        attached), after the pending ticks. Shared scope returns the fleet
        classifier."""
        self._finish_pending()
        chvs = self._state.class_hvs
        if chvs.ndim == 2:
            return chvs.clone()
        if sid in self._parked:
            return self._parked[sid].class_hvs.clone()
        return self._class_stack()[self._by_sid[sid]].clone()

    def capture_log(self, sid) -> CaptureLog:
        """What ``sid``'s ADC actually converted in the finished ticks
        (per-sensor billing ground truth; survives detach and
        checkpoint/restore)."""
        blocks = self._logs[sid]
        return assemble_capture_log(blocks[0], blocks[1],
                                    lp_bits=self.adc_bits,
                                    control=self.control,
                                    frame_pixels=self._frame_pixels)

    def drain_hp(self, sid) -> tuple[np.ndarray, np.ndarray]:
        """Take ``sid``'s high-precision burst frames captured in the
        finished ticks (absolute frame indices + frames at
        ``control.hp_bits``). An empty drain keeps the real ``(0, H, W)``
        frame shape, so drains concatenate."""
        idx, frames = stream_mod.hp_drain_arrays(self._hp[sid],
                                                 self._frame_hw)
        self._hp[sid] = []
        return idx, frames

    # ------------------------------------------------------------------
    # checkpoint / restore
    # ------------------------------------------------------------------

    def _snapshot(self) -> tuple[dict, dict]:
        """(single-level array tree, JSON extra) of the mutable state, with
        the reference's leaves and keys."""
        st = self._state
        tree = {"class_hvs": (self._class_stack() if st.class_hvs.ndim == 3
                              else st.class_hvs), "holds": st.holds,
                "phases": st.phases,
                "frame_idx": np.int32(st.frame_idx)}
        for i, p in enumerate(self._parked.values()):
            tree[f"parked_hold_{i}"] = np.int32(p.hold)
            tree[f"parked_phase_{i}"] = np.int32(p.phase)
            if p.class_hvs is not None:
                tree[f"parked_chvs_{i}"] = p.class_hvs
        log_sids = list(self._logs)
        for i, sid in enumerate(log_sids):
            blocks = self._logs[sid]
            tree[f"log_sampled_{i}"] = (np.concatenate(blocks[0])
                                        if blocks[0]
                                        else np.zeros((0,), bool))
            tree[f"log_gated_{i}"] = (np.concatenate(blocks[1])
                                      if blocks[1]
                                      else np.zeros((0,), bool))
            # undrained HP frames ride the checkpoint too
            hp_idx, hp_frames = stream_mod.hp_drain_arrays(
                self._hp.get(sid, []), self._frame_hw)
            tree[f"hp_idx_{i}"] = hp_idx
            tree[f"hp_frames_{i}"] = hp_frames
        extra = {
            "chunks": self._seq,
            "slots": [[i, sid, self._uids[sid], self._n_seen[sid]]
                      for i, sid in enumerate(self._slots)
                      if sid is not None],
            "parked": [[sid, p.uid, p.n_seen,
                        f"parked_chvs_{i}" in tree]
                       for i, (sid, p) in enumerate(self._parked.items())],
            "log_sids": log_sids,
            "next_uid": self._next_uid,
            "frame_hw": list(self._frame_hw) if self._frame_hw else None,
            "n_slots": self.n_slots,
            "precision": self.precision,
        }
        return tree, extra

    def checkpoint(self) -> None:
        """Async snapshot of the mutable fleet state.

        Finishes the in-flight ticks into the ready queue first (their
        outputs stay collectable) so the saved state, frame counters and
        capture logs describe one tick boundary; the state is copied to
        the host before this returns and written on the checkpointer's
        thread while serving continues. On a mesh the state is gathered
        on every rank and rank 0 alone writes it, in the unsharded format.
        """
        if self._ckpt is None:
            raise RuntimeError("service was built without ckpt_dir")
        self._finish_pending()
        tree, extra = self._snapshot()
        if self._mesh is None or dist.get_rank() == 0:
            self._ckpt.save(self._seq, tree, extra=extra)

    def wait_ckpt(self) -> None:
        """Block until the last async checkpoint write is on disk (on a
        mesh: rank 0's write, then a barrier of every rank)."""
        if self._ckpt is not None:
            self._ckpt.wait()
            if self._mesh is not None:
                dist.barrier()

    def restore(self, step: int | None = None) -> int:
        """Load fleet state from ``ckpt_dir`` into this (fresh) service.

        Rebuilds the slot table, parked pool, per-sensor counters, capture
        logs and undrained HP frames, and installs the saved state —
        resuming the trace from the returned tick count is bitwise the same
        as never having stopped. Construct the service with the SAME
        model and config as the saved run; a checkpoint of the reference's
        service restores too.
        """
        if self._ckpt is None:
            raise RuntimeError("service was built without ckpt_dir")
        if self._seq:
            raise RuntimeError("restore() needs a freshly constructed "
                               "service (no ticks dispatched)")
        leaves, extra = ckpt_mod.restore_tree(self.ckpt_dir, step=step)
        if extra["n_slots"] != self.n_slots:
            raise ValueError(f"checkpoint has n_slots={extra['n_slots']}, "
                             f"service has {self.n_slots}")
        if extra["precision"] != self.precision:
            raise ValueError(f"checkpoint precision {extra['precision']} "
                             f"!= service {self.precision}")
        chvs = leaves["class_hvs"]
        want = ((self.n_slots, *self._state.class_hvs.shape[1:])
                if self._state.class_hvs.ndim == 3
                else tuple(self._state.class_hvs.shape))
        if chvs.shape != want:
            raise ValueError(f"checkpoint class_hvs {chvs.shape} != "
                             f"service {want}")

        def dev(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        chvs = dev(chvs)
        self._state = StreamState(
            class_hvs=(chvs[self._lo:self._hi].clone() if chvs.ndim == 3
                       else chvs),
            holds=torch.from_numpy(np.array(leaves["holds"], np.int32)),
            phases=torch.from_numpy(np.array(leaves["phases"], np.int32)),
            frame_idx=int(leaves["frame_idx"]))
        self._slots = [None] * self.n_slots
        self._by_sid, self._uids, self._n_seen = {}, {}, {}
        for slot, sid, uid, n_seen in extra["slots"]:
            self._slots[slot] = sid
            self._by_sid[sid] = slot
            self._uids[sid] = uid
            self._n_seen[sid] = n_seen
        self._parked = {}
        for i, (sid, uid, n_seen, has_chvs) in enumerate(extra["parked"]):
            self._parked[sid] = _Parked(
                uid=uid, n_seen=n_seen,
                hold=int(leaves[f"parked_hold_{i}"]),
                phase=int(leaves[f"parked_phase_{i}"]),
                class_hvs=(dev(leaves[f"parked_chvs_{i}"]) if has_chvs
                           else None))
            self._uids[sid] = uid
            self._n_seen[sid] = n_seen
        self._logs, self._hp = {}, {}
        for i, sid in enumerate(extra["log_sids"]):
            smp, gat = leaves[f"log_sampled_{i}"], leaves[f"log_gated_{i}"]
            self._logs[sid] = ([smp] if smp.size else [],
                               [gat] if gat.size else [])
            self._hp[sid] = list(zip(
                leaves[f"hp_idx_{i}"].tolist(),
                leaves[f"hp_frames_{i}"].astype(np.float32)))
        self._next_uid = extra["next_uid"]
        self._seq = extra["chunks"]
        if extra["frame_hw"]:
            self._fix_frame_shape((self.chunk_size, *extra["frame_hw"]))
        return self._seq
