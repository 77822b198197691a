"""Scenarios of ``tests/test_torch_cascade_mesh.py`` (and the smoke
configs ``tests/test_torch_roofline.py`` reads), and the ranks that run
them.

Each scenario is a ``CascadeService`` of the port on the CPU, a function
of its case and a mesh: the test process runs it with ``mesh=None`` (the
unsharded port), and every rank of a ``gloo`` world spawned by
``_torch_mesh_worker.spawn`` runs it on a ``(data, model)``
``DeviceMesh``. The inputs come in the payload (numpy arrays the test
process made), so both sides compute on the same numbers.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch

HW, PATCH, BATCH = (16, 16), 8, 4
ARCH = "hubert-xlarge"
#: ragged drains (sensor, absolute indices) of the frames in order
RAGGED = [("a", np.arange(2)), ("a", np.arange(0)), ("b", np.arange(3)),
          ("a", 2 + np.arange(4))]
N_FRAMES = 9
#: the smoke ``hubert-xlarge`` (float32) on the reference's parameters,
#: and one whose 6 heads and d_ff of 130 "model" divides at 2 but not at
#: 4 (on (1, 4) its attention and MLP run whole) on the port's own
CASES = {"smoke": {},
         "heads6": dict(n_heads=6, kv_heads=6, d_model=96, d_ff=130)}


def config(case: str):
    from repro_torch import configs
    return configs.get_smoke(ARCH).replace(**CASES[case])


def params(case: str, payload: dict) -> dict:
    from repro_torch.convert import detector_params_from_arrays
    from repro_torch.launch import steps
    if case == "smoke":
        return detector_params_from_arrays(payload["params"], device="cpu")
    return steps.init_detector_params(torch.Generator().manual_seed(3),
                                      config(case), frame_hw=HW,
                                      patch=PATCH)


def frames_of(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, *HW)).astype(
        np.float32)


def cascade(case: str, payload: dict, mesh):
    from repro_torch.launch.cascade import CascadeService
    return CascadeService(params(case, payload), config(case),
                          batch_size=BATCH, frame_hw=HW, patch=PATCH,
                          device="cpu", mesh=mesh)


def feed(casc, frames) -> list:
    lo = 0
    for sid, idx in RAGGED:
        casc.submit(sid, idx, frames[lo:lo + len(idx)])
        lo += len(idx)
    return casc.flush()


def run_cascade(case: str, payload: dict, mesh) -> dict:
    """Ragged drains served and flushed, ``eager`` on the same frames, more
    ragged drains with ``eager`` in between; this rank's weight blocks'
    shapes; ``backbone_cost`` and ``roofline``."""
    from repro_torch.models import common
    frames = payload["frames"]
    casc = cascade(case, payload, mesh)
    batches = feed(casc, frames)
    served = np.concatenate([b.logits for b in batches])
    eager = casc.eager(frames)
    casc.submit("c", [7], frames[:1])
    casc.eager(frames[:2])
    casc.submit("c", [8, 9, 10, 11], frames[1:5])
    more = casc.flush()
    return dict(
        batches=[(b.seq, b.sids, b.frame_idx, b.logits, b.n_padded)
                 for b in batches],
        served=served, eager=eager,
        more=np.concatenate([b.logits for b in more]),
        more_padded=[b.n_padded for b in more],
        more_eager=casc.eager(frames[:5]),
        rebuilds=casc.rebuild_count(),
        shapes=common.tree_map(lambda a: tuple(a.shape),
                               casc._weights["backbone"]),
        cost=casc.backbone_cost(),
        roofline=casc.roofline().to_dict())


def refuses_a_short_mesh(payload: dict, mesh) -> bool | None:
    """``CascadeService`` on one dim of ``mesh`` (fewer ranks than the
    world): refused? None on a one-rank world."""
    short = [n for n, k in zip(mesh.mesh_dim_names, mesh.mesh.shape)
             if k < mesh.size()]
    if not short:
        return None
    try:
        cascade("smoke", payload, mesh[short[0]])
    except ValueError:
        return True
    return False


def _rank_main(rank: int, world: int, shape: tuple, work: list,
               payload: dict, root: str) -> None:
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
        for _, name, _ in work:
            results[name] = run_cascade(name, payload, mesh)
        results["short_mesh_refused"] = refuses_a_short_mesh(payload, mesh)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
