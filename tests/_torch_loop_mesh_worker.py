"""Scenarios of ``tests/test_torch_train_loop_mesh.py`` and the ranks that
run them.

Each scenario is a run of the port's train loop (``train(mesh=)``) on the
CPU, a function of its case and a mesh: the test process runs it with
``mesh=None`` (the unsharded loop), and every rank of a ``gloo`` world
spawned by ``_torch_mesh_worker.spawn`` runs it on each mesh shape of its
world (``WORLDS``). The weights and the batches come in the payload
(numpy arrays the test process made, the same the reference trains on);
every rank hands the loop the whole of them and gathers its result back
whole (``steps.whole_args``), so every side is compared on whole arrays.
Each run writes its checkpoints under the world's directory, where the
test process reads them after the world ends.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import signal
import traceback

import numpy as np
import torch

#: the cases: (architecture, ModelConfig overrides of its smoke config).
#: olmo-1b's parameter-free norms and MHA; internlm2-1.8b's GQA (4 query
#: heads over 2 kv heads); bf16 under remat "full" and "dots", whose
#: recompute runs the layer's collectives again inside the backward pass
CASES = {
    "olmo": ("olmo-1b", {}),
    "internlm2": ("internlm2-1.8b", {}),
    "olmo-bf16-full": ("olmo-1b", {"compute_dtype": "bfloat16",
                                   "remat": "full"}),
    "olmo-bf16-dots": ("olmo-1b", {"compute_dtype": "bfloat16",
                                   "remat": "dots"}),
    "internlm2-bf16-full": ("internlm2-1.8b", {"compute_dtype": "bfloat16",
                                               "remat": "full"}),
    "internlm2-bf16-dots": ("internlm2-1.8b", {"compute_dtype": "bfloat16",
                                               "remat": "dots"}),
}
#: the run: STEPS steps of a batch of B sequences of S tokens in MICRO
#: microbatches (a 2-way "data" split leaves each rank one sequence of
#: each microbatch); the TrainConfig of every side, the reference's too
B, S, STEPS, MICRO = 4, 16, 4, 2
TRAIN = dict(steps=STEPS, microbatches=MICRO, ckpt_every=100, log_every=1,
             lr=1e-3, warmup=2)
#: the worlds, each spawned once, and the mesh shapes every rank of one
#: runs
WORLDS = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}
#: the preempted runs (olmo's float32 case): {name: {rank: step at which
#: that rank sends itself SIGTERM}}, on the first mesh of each world;
#: "one" signals the last rank alone, "both" every rank, each at its own
#: step, the first signal at PREEMPT_AT
PREEMPT_AT = 2
PREEMPT = {"one": lambda world: {world - 1: PREEMPT_AT},
           "both": lambda world: {r: PREEMPT_AT + (world - 1 - r)
                                  for r in range(world)}}
PREEMPT_CASE = "olmo"
#: the periodic run (olmo's float32 case, on the first mesh of each
#: world): a checkpoint every step, the last two kept, the last rank
#: signalled on PERIODIC_AT, the step after a periodic save, whose write
#: may still be in flight then
PERIODIC = dict(ckpt_every=1, keep=2)
PERIODIC_AT = PREEMPT_AT + 1


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def config(case: str):
    from repro_torch import configs
    arch, kw = CASES[case]
    return configs.get_smoke(arch).replace(**kw)


def batches(case: str, payload: dict, start: int = 0):
    """The case's batches from step ``start`` on, whole, on the CPU."""
    from repro_torch.models import lm
    return iter([lm.Batch(torch.from_numpy(t), torch.from_numpy(lab), None)
                 for t, lab in payload[case]["batches"][start:]])


def state_specs(case: str, mesh):
    """The state's specs on ``mesh`` (the train cell's ``(params,
    opt_state)`` ``in_shardings``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    return steps.build_train_cell(config(case), ShapeConfig(
        "loop", S, B, "train"), mesh).in_shardings[:2]


def state_arrays(params, opt_state) -> dict:
    """A train state as numpy: the parameters, ``mu`` and ``nu`` leaves in
    float32, in leaf order, and the step counter."""
    from repro_torch.models import common

    def leaves(t):
        return [x.detach().to(torch.float32).numpy().copy()
                for x in common.leaves(t)]
    return dict(params=leaves(params), mu=leaves(opt_state.mu),
                nu=leaves(opt_state.nu), step=int(opt_state.step))


def run(case: str, payload: dict, mesh, ckpt_dir: str, *,
        signals: dict | None = None, start: int = 0,
        train: dict | None = None) -> dict:
    """The loop on ``case`` in ``ckpt_dir`` (resumed from its checkpoint,
    the batches from step ``start``), on ``mesh`` or unsharded, its
    TrainConfig ``TRAIN`` with ``train`` over it: its exit (0, or the
    ``SystemExit`` code), the metrics of every step, and the final state,
    whole, as numpy. With ``signals`` (``{rank: step}``), a rank named
    sends itself SIGTERM on that step's metrics."""
    import torch.distributed as dist
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import loop
    cfg = config(case)
    rank = dist.get_rank() if mesh is not None else 0
    metrics = []

    def on_metrics(step, m):
        metrics.append((step, m["loss"], m["grad_norm"]))
        if (signals or {}).get(rank) == step:
            os.kill(os.getpid(), signal.SIGTERM)
    tc = loop.TrainConfig(ckpt_dir=ckpt_dir, **dict(TRAIN, **(train or {})))
    params = lm_params_from_arrays(payload[case]["params"], cfg=cfg,
                                   device="cpu")
    try:
        out = loop.train(lm.Model(cfg), batches(case, payload, start), tc,
                         params=params, on_metrics=on_metrics, device="cpu",
                         mesh=mesh)
    except SystemExit as e:
        return dict(exit=e.code, metrics=metrics)
    state = (out["params"], out["opt_state"])
    if mesh is not None:
        state = steps.whole_args(state, state_specs(case, mesh), mesh)
    return dict(exit=0, metrics=metrics, history=out["history"],
                **state_arrays(*state))


def restored(ckpt_dir: str, case: str, mesh, step: int | None = None
             ) -> dict:
    """The checkpoint of ``ckpt_dir`` at ``step`` (the latest where None)
    cut onto ``mesh`` (``ckpt.restore(specs=, mesh=)``), gathered whole
    again."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import steps
    from repro_torch.configs import ShapeConfig
    specs = state_specs(case, mesh)
    like = steps.input_specs(config(case), ShapeConfig(
        "loop", S, B, "train"))[:2]
    blocks, extra = ckpt.restore(ckpt_dir, like, step=step, device="cpu",
                                 specs=specs, mesh=mesh)
    return dict(extra=extra, **state_arrays(*steps.whole_args(
        blocks, specs, mesh)))


def mesh_runs(payload: dict, mesh, shape, world: int, root: str) -> dict:
    """Every run of one mesh shape in one rank: each case uninterrupted;
    on the world's first mesh the preempted runs and the same mesh's
    relaunch of "one", and the periodic run, each of its checkpoints
    restored onto the mesh before its relaunch there; on (2, 1) the relaunch of (1, 2)'s "both"
    checkpoint (restored, and finished); on the two-rank meshes the
    reference's checkpoint cut onto the mesh."""
    key = mesh_key(shape)
    out = {case: run(case, payload, mesh, os.path.join(root, key, case))
           for case in CASES}
    if shape == WORLDS[world][0]:
        for name, signals in PREEMPT.items():
            d = os.path.join(root, key, f"preempt-{name}")
            out[f"preempt-{name}"] = run(PREEMPT_CASE, payload, mesh, d,
                                         signals=signals(world))
            out[f"preempt-{name}"]["listing"] = sorted(os.listdir(d))
        d = os.path.join(root, key, "preempt-one")
        out["relaunch-one"] = run(PREEMPT_CASE, payload, mesh, d,
                                  start=PREEMPT_AT)
        d = os.path.join(root, key, "periodic")
        out["periodic"] = r = run(PREEMPT_CASE, payload, mesh, d,
                                  signals={world - 1: PERIODIC_AT},
                                  train=PERIODIC)
        r["listing"] = sorted(os.listdir(d))
        r["restored"] = {int(n[len("step_"):]): restored(
            d, PREEMPT_CASE, mesh, step=int(n[len("step_"):]))
            for n in r["listing"]}
        out["relaunch-periodic"] = run(PREEMPT_CASE, payload, mesh, d,
                                       start=PERIODIC_AT, train=PERIODIC)
    if shape == (2, 1):
        src = os.path.join(root, "1x2", "preempt-both")
        out["restored-both"] = restored(src, PREEMPT_CASE, mesh)
        d = os.path.join(root, key, "relaunch-both")
        import torch.distributed as dist
        if dist.get_rank() == 0:
            shutil.copytree(src, d)
        dist.barrier()
        out["relaunch-both"] = run(PREEMPT_CASE, payload, mesh, d,
                                   start=PREEMPT_AT)
    if world == 2:
        out["restored-ref"] = restored(payload["ref_ckpt"], PREEMPT_CASE,
                                       mesh)
    return out


def _rank_main(rank: int, world: int, shape: tuple, work: list,
               payload: dict, root: str) -> None:
    """One rank: every mesh shape of ``WORLDS[world]``;
    ``{mesh key: {run: result}}`` written to ``root/rank<r>.pkl``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        results = {}
        for mshape in WORLDS[world]:
            mesh = init_device_mesh("cpu", mshape,
                                    mesh_dim_names=("data", "model"))
            results[mesh_key(mshape)] = mesh_runs(payload, mesh, mshape,
                                                  world, root)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def np_leaves_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))
