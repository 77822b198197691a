"""Scenarios of ``tests/test_torch_mesh.py`` and the ranks that run them.

Each scenario (a ``FleetRunner`` or ``FleetService`` run of the port on
the CPU) is a function of its spec and a mesh: the test process runs it
with ``mesh=None`` (the unsharded port), and :func:`spawn` runs it in
every rank of a ``gloo`` world of spawned processes on a ``(data,
model)`` ``DeviceMesh``. Every input is made here from numpy seeds, so
both sides compute on the same numbers. The ranks rendezvous through a
``FileStore`` under the caller's directory (no TCP port, so parallel test
workers cannot collide) and each writes its results to a file there; a
rank that fails or outlives the join timeout fails the spawn.

The spawned children import this module by name (``tests/`` is on their
path, which ``spawn`` hands them), never the test file.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np
import torch

#: the reference's mesh matrix sizes (tests/test_parity_matrix.py): 128
#: dims in tiles of 16, so n_dt = 8 splits 2-, 4- and 8-way
FRAME, FRAG, STRIDE, DIM, BLOCK_D, CHUNK = 24, 6, 3, 128, 16, 4
N_FRAMES = 10       # 4 + 4 + a tail of 2
BITS = {"float32": 4, "int8": 8, "int4": 4, "binary": 8}
CTRL = dict(hold_frames=2, base_rate_hz=10.0, active_rate_hz=30.0)
MODEL_SEED = 90
#: service scenarios: slots (a multiple of 2, so a checkpoint resumes on
#: the (2, 1) and (1, 2) meshes unpadded) and ticks
SVC_SLOTS, SVC_TICKS = 4, 8


def model_arrays(seed: int = MODEL_SEED):
    """``(class_hvs (2, D), B0 (h, D), b (D,))`` float32 from numpy."""
    rng = np.random.default_rng(seed)
    B0 = rng.standard_normal((FRAG, DIM)).astype(np.float32)
    b = rng.uniform(0.0, 2 * np.pi, DIM).astype(np.float32)
    C = rng.standard_normal((2, DIM)).astype(np.float32)
    return C, B0, b


def port_model(t_score: float = 0.0):
    from repro_torch.convert import model_from_arrays
    C, B0, b = model_arrays()
    return model_from_arrays(C, B0, b, h=FRAG, w=FRAG, stride=STRIDE,
                             t_score=t_score, t_detection=0, device="cpu")


def stream_frames(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(n, FRAME, FRAME)`` frames in [0, 1.5] (noise; a Gaussian blob on
    every other run of three frames) and their ``(n,)`` labels."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(0.0, 0.6, (n, FRAME, FRAME))
    labels = (np.arange(n) // 3) % 2
    yy, xx = np.mgrid[:FRAME, :FRAME]
    for i in np.flatnonzero(labels):
        cy, cx = rng.uniform(4, FRAME - 4, 2)
        out[i] += 0.9 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 10.0)
    return np.clip(out, 0.0, 1.5).astype(np.float32), labels.astype(np.int32)


def fleet_frames(S: int, n: int, seed: int = 200):
    fr, lab = zip(*(stream_frames(seed + s, n) for s in range(S)))
    return np.stack(fr), np.stack(lab)


#: fleet scenarios: (precision, adapt scope or None, S, closed loop,
#: ADC noise sigma, block_d)
FLEET = {f"{p}-{scope}": (p, scope, 2, False, 0.0, BLOCK_D)
         for p in BITS for scope in ("shared", "per-stream")}
FLEET.update({
    # S = 5 pads to 6 on (2, 1) and to 8 on (4, 1)
    "s5-int8-shared": ("int8", "shared", 5, False, 0.0, BLOCK_D),
    "s5-float32-noise-per-stream": ("float32", "per-stream", 5, False, 0.02,
                                    BLOCK_D),
    # the closed loop: the shared fold reads the scans' sampled frames
    "closed-float32-shared": ("float32", "shared", 3, True, 0.0, BLOCK_D),
    # one D-wide tile, which no "model" extent of 2 divides: replicated
    "one-tile-int8-per-stream": ("int8", "per-stream", 3, False, 0.0, DIM),
})

#: service scenarios: (precision, adapt, closed loop, ADC noise sigma,
#: slots); 3 slots pad to 4 on (2, 1) and (4, 1)
SERVICE = {
    "svc-int8-pseudo-per-stream": ("int8", ("pseudo", "per-stream"), False,
                                   0.02, SVC_SLOTS),
    "svc-float32-label-shared-closed": ("float32", ("label", "shared"), True,
                                        0.0, 3),
}


def thresholds() -> dict[str, float]:
    """Per precision, a ``t_score`` at the median of the unsharded frozen
    frame scores of the scenario frames (so the gates see both
    outcomes)."""
    from repro_torch.core import hypersense as ths
    from repro_torch.sensing import adc as tadc
    fr, _ = fleet_frames(5, N_FRAMES)
    flat = torch.from_numpy(fr.reshape(-1, FRAME, FRAME))
    out = {}
    for p, bits in BITS.items():
        view = tadc.quantize(flat, bits) if p == "float32" else flat
        s = ths.frame_scores_batch(port_model(), view, precision=p,
                                   adc_bits=bits)
        out[p] = float(np.median(s.numpy()))
    return out


def _adapt(scope, mode="label"):
    from repro_torch.core.online import AdaptConfig
    return None if scope is None else AdaptConfig(mode=mode, lr=0.5,
                                                  scope=scope)


def run_fleet(name: str, t_scores: dict, mesh) -> dict:
    """One ``FleetRunner`` scenario, fed as two ``process`` calls (a cut
    on the chunk grid): every output a rank returns."""
    from repro_torch.core.sensor_control import (CaptureConfig,
                                                 ControllerConfig)
    from repro_torch.sensing.fleet import FleetRunner
    p, scope, S, closed, sigma, block_d = FLEET[name]
    fr, lab = fleet_frames(S, N_FRAMES)
    r = FleetRunner(port_model(t_scores[p]), ControllerConfig(**CTRL),
                    chunk_size=CHUNK, block_d=block_d, adc_bits=BITS[p],
                    adc_sigma=sigma, adc_seed=7, precision=p,
                    adapt=_adapt(scope),
                    control=(CaptureConfig(hp_bits=12, hp_buffer=3)
                             if closed else None), device="cpu", mesh=mesh)
    outs = [r.process(fr[:, a:b], labels=lab[:, a:b])
            for a, b in ((0, CHUNK), (CHUNK, N_FRAMES))]
    s, f, g = (np.concatenate(x, 1) for x in zip(*outs))
    log = r.capture_log
    drains = r.drain_hp()
    return {"scores": s, "fired": f, "gated": g,
            "class_hvs": r.class_hvs.numpy().copy(),
            "holds": r.holds.numpy().copy(), "sampled": log.sampled,
            "log_gated": log.gated,
            "hp_idx": [i for i, _ in drains],
            "hp_frames": [x for _, x in drains],
            "hp_dropped": r.hp_dropped}


def churn_schedule() -> list[tuple[tuple, tuple, tuple]]:
    """(detach, attach, arrivals) per tick, never more than 3 attached:
    0-2 attach; 1 leaves for 3; a silent tick; 3 leaves and 1 comes back
    (through tenant 3's slot); 0 leaves, reattached a tick later; the
    other ticks ragged from a seeded generator, the last full."""
    rng = np.random.default_rng(5)
    churn = {0: ((), (0, 1, 2)), 1: ((1,), (3,)), 3: ((3,), (1,)),
             5: ((0,), ()), 6: ((), (0,))}
    attached, out = set(), []
    for k in range(SVC_TICKS):
        det, att = churn.get(k, ((), ()))
        attached = (attached - set(det)) | set(att)
        if k == 2:
            arrive = ()
        elif k in (0, SVC_TICKS - 1):
            arrive = tuple(sorted(attached))
        else:
            arrive = tuple(sid for sid in sorted(attached)
                           if rng.uniform() < 0.75)
        out.append((det, att, arrive))
    return out


def make_service(name: str, t_scores: dict, mesh, ckpt_dir=None):
    from repro_torch.core.sensor_control import (CaptureConfig,
                                                 ControllerConfig)
    from repro_torch.launch.serve import FleetService
    p, (mode, scope), closed, sigma, slots = SERVICE[name]
    return FleetService(
        port_model(t_scores[p]), ControllerConfig(**CTRL),
        n_slots=slots, chunk_size=CHUNK, block_d=BLOCK_D,
        adc_bits=BITS[p], adc_sigma=sigma, adc_seed=11, precision=p,
        adapt=_adapt(scope, mode),
        control=(CaptureConfig(hp_bits=12, hp_buffer=2) if closed
                 else None), max_inflight=2, ckpt_dir=ckpt_dir, device="cpu",
        mesh=mesh)


def play(svc, lo: int, hi: int) -> dict:
    """Ticks ``lo:hi`` of :func:`churn_schedule` on ``svc`` (sensor ``sid``
    reads its frames from where the schedule's earlier ticks left it):
    ``{sid: [(scores, fired, gated), ...]}``, its classifiers, capture logs
    and HP drains at the end."""
    sched = churn_schedule()
    frames, labels = fleet_frames(4, SVC_TICKS * CHUNK, seed=300)
    fed = {}
    for _, _, arrive in sched[:lo]:
        for sid in arrive:
            fed[sid] = fed.get(sid, 0) + CHUNK
    label_mode = svc.adapt is not None and svc.adapt.mode == "label"
    for det, att, arrive in sched[lo:hi]:
        for sid in det:
            svc.detach(sid)
        for sid in att:
            svc.attach(sid)
        arrivals, labs = {}, {}
        for sid in arrive:
            n0 = fed.get(sid, 0)
            arrivals[sid] = frames[sid, n0:n0 + CHUNK]
            labs[sid] = labels[sid, n0:n0 + CHUNK]
            fed[sid] = n0 + CHUNK
        svc.dispatch(arrivals, labels=labs if label_mode else None)
    got: dict = {}
    for ch in svc.flush():
        for sid, out in ch.outputs.items():
            got.setdefault(sid, []).append(out)
    sids = sorted({sid for _, att, _ in sched[:hi] for sid in att})
    return {"outputs": got,
            "class_hvs": {sid: svc.class_hvs_of(sid).numpy().copy()
                          for sid in sids},
            "logs": {sid: (svc.capture_log(sid).sampled,
                           svc.capture_log(sid).gated) for sid in sids},
            "drains": {sid: svc.drain_hp(sid) for sid in sids},
            "hp_dropped": svc.hp_dropped,
            "rebuilds": svc.rebuild_count(), "n_slots": svc.n_slots}


def run_service(name: str, t_scores: dict, mesh) -> dict:
    return play(make_service(name, t_scores, mesh), 0, SVC_TICKS)


#: the checkpoint chain: ticks [0, T1) on the first mesh, [T1, T2)
#: unsharded, [T2, SVC_TICKS) on the second mesh
RESUME = "svc-int8-pseudo-per-stream"
T1, T2 = 3, 6


def resume_stage(t_scores: dict, mesh, lo: int, hi: int,
                 ckpt_dir: str) -> dict:
    """Ticks ``lo:hi`` of the :data:`RESUME` service: restored from the
    latest checkpoint in ``ckpt_dir`` (taken at tick ``lo``) unless ``lo``
    is 0, then checkpointed there at tick ``hi``."""
    svc = make_service(RESUME, t_scores, mesh, ckpt_dir=ckpt_dir)
    if lo and svc.restore() != lo:
        raise AssertionError(f"the checkpoint in {ckpt_dir} is not tick {lo}")
    out = play(svc, lo, hi)
    svc.checkpoint()
    svc.wait_ckpt()
    return out


def refuses_a_short_mesh(t_scores: dict, mesh) -> bool | None:
    """Whether ``FleetService`` refuses a one-dim slice of ``mesh`` that
    holds fewer ranks than the world (its checkpoint writer and barrier
    assume every rank); ``None`` when every slice holds the whole world."""
    world = mesh.size()
    short = [name for i, name in enumerate(mesh.mesh_dim_names)
             if mesh.size(i) < world]
    if not short:
        return None
    try:
        make_service(RESUME, t_scores, mesh[short[0]])
    except ValueError:
        return True
    return False


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, shape: tuple, work: list,
               t_scores: dict, root: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        results = {}
        for kind, name, args in work:
            if kind == "fleet":
                results[name] = run_fleet(name, t_scores, mesh)
            elif kind == "service":
                results[name] = run_service(name, t_scores, mesh)
            else:
                results[name] = resume_stage(t_scores, mesh, *args)
        results["short_mesh_refused"] = refuses_a_short_mesh(t_scores, mesh)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn(shape: tuple[int, int], work: list, t_scores: dict, root: str,
          timeout: float = 240.0, target=None) -> list[dict]:
    """Run ``work`` (``[(kind, name, args), ...]``) in every rank of a
    ``gloo`` world on a ``shape`` ``("data", "model")`` mesh; returns each
    rank's results. Raises if a rank fails, or terminates every rank and
    raises if they are not all done within ``timeout`` seconds. ``target``
    (default :func:`_rank_main`) is another module's rank function of the
    same arguments, ``t_scores`` then its payload; it writes
    ``rank<r>.pkl`` or ``rank<r>.err`` under ``root`` as this one does."""
    import torch.multiprocessing as mp
    os.makedirs(root, exist_ok=True)
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or _rank_main,
                         args=(r, world, shape, work, t_scores, root))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"mesh {shape}: ranks {late} still running "
                               f"after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(root, f"rank{r}.err")
        if p.exitcode != 0 or os.path.exists(err):
            msg = open(err).read() if os.path.exists(err) else ""
            errors.append(f"rank {r} exit {p.exitcode}\n{msg}")
    if errors:
        raise RuntimeError(f"mesh {shape} failed:\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out
