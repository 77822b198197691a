"""Multi-pod dry run on PyTorch: count every (arch x shape x mesh) cell on
the production meshes. Twin of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step for 256 or 512
placeholder devices and reads XLA's analyses. The port has no compiler to
ask, so a cell is *counted*: one process starts a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 or 512 ranks,
builds :func:`~repro_torch.launch.mesh.make_production_mesh` over it and
the cell under ``use_mesh``, and runs rank 0's step once on meta tensors:
its parameters and moments
(:func:`~repro_torch.models.common.abstract_local_params`) and its batch
blocks, each at the shape of the rank's block. Every collective goes
through the fake group, which moves nothing; the step allocates nothing
and runs no card. The record
(:func:`~repro_torch.distributed.roofline.from_counts`) takes its FLOPs
from ``FlopCounterMode``, which counts every layer of the step as it
runs, so the reference's two-point layer scaling (``--roofline``) and
its ``--unroll`` lowering, both there because XLA's cost analysis counts
a loop's body once, are not ported; its collectives from
``count_collectives``; its memory from
:func:`~repro_torch.distributed.memory_model.analyze`. The record keeps
the reference's keys: ``Roofline.to_dict()``, ``n_params``, ``status``,
``lower_s`` (building the cell and its arguments), ``compile_s`` (the
counted run: nothing is compiled) and ``unrolled`` (True: every layer
is counted).

The port's ``configs.ARCH_IDS`` are the reference's, and every cell of
every architecture is counted. The ``decode_32k`` cells are counted like
the others: one token against the 32,768-position cache, split by kv
heads or, where "model" does not divide them, along the sequence; the
hybrid's (zamba2's) Mamba states split by SSM heads, the xLSTM's states
by heads (xlstm-350m's 4, whole on a "model" of 16); the sub-quadratic
families' ``long_500k`` cells (524,288 positions at batch 1) counted the
same way. A cell that raises is a ``"fail"`` row.

Usage (on any host, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hubert-xlarge \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from contextlib import contextmanager
from typing import Iterator

import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import roofline as rl
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, lm

MESH_CHIPS = {"single": 256, "multi": 512}


@contextmanager
def fake_world(world: int) -> Iterator[None]:
    """A fake default process group of ``world`` ranks, this process rank
    0, torn down on exit: its collectives move nothing and need no peer.
    Refuses a process that has a process group already."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) process "
                           "group; this process has one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count_cell(cfg, shape, mesh, mesh_name: str,
               rules: dict | None = None) -> dict:
    """The record of ``cfg``'s ``shape`` cell on ``mesh`` (every rank of
    it in this process, as under :func:`fake_world`), ``rules`` merged
    over the default rules: this rank's step run once on meta tensors
    (:func:`~repro_torch.distributed.roofline.from_counts`)."""
    rules = dict(sharding.DEFAULT_RULES, **(rules or {}))
    t0 = time.time()
    model = lm.Model(cfg)
    with sharding.use_mesh(mesh, rules):
        cell = steps.build_cell(cfg, shape, mesh, rules)
        params = common.abstract_local_params(
            model.spec(), mesh, rules, lm.dtype_of(cfg.param_dtype))
        args = (params, *steps.local_args(cell.abstract_args[1:],
                                          cell.in_shardings[1:], mesh))
        t_lower = time.time() - t0
        n_params = common.spec_param_count(model.spec())
        rec = rl.from_counts(cell.step_fn, args, arch=cfg.arch_id,
                             shape=shape, mesh=mesh, mesh_name=mesh_name,
                             cfg=cfg, n_params=n_params, rules=rules
                             ).to_dict()
    rec.update(n_params=n_params, lower_s=round(t_lower, 1),
               compile_s=round(time.time() - t0 - t_lower, 1), status="ok",
               unrolled=True)
    return rec


def run_cell(arch: str, shape_name: str | None, mesh_name: str,
             rules: dict | None = None, out_path: str | None = None,
             verbose: bool = True, overrides: dict | None = None) -> dict:
    """Count one cell (``overrides``: ModelConfig fields) and append its
    record to ``out_path``."""
    cfg = configs.get_config(arch).replace(**(overrides or {}))
    shape = configs.SHAPES[shape_name]
    with fake_world(MESH_CHIPS[mesh_name]):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi")
        rec = count_cell(cfg, shape, mesh, mesh_name, rules)
    if verbose:
        _summary(rec)
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def _summary(rec: dict) -> None:
    print(f"=== {rec['arch']} x {rec['shape']} x {rec['mesh']} "
          f"({rec['chips']} chips, counted on meta tensors) ===")
    print(f"params: {rec['n_params'] / 1e9:.2f}B  lower {rec['lower_s']}s "
          f"count {rec['compile_s']}s")
    print(f"per-device memory (analyze): "
          f"{rec['per_device_peak_mem_gb']:.3f} GB")
    print("cost: flops=%.3e bytes=%.3e (all chips)" % (
        rec["hlo_gflops"] * 1e9, rec["hlo_gbytes"] * 1e9))
    print("collectives (GB/device):", rec["coll_breakdown"])
    print("terms (s): compute=%.4f memory=%.4f collective=%.4f -> %s"
          % (rec["t_compute"], rec["t_memory"], rec["t_collective"],
             rec["bottleneck"]))
    print("roofline fraction=%.3f useful-flop ratio=%.3f" % (
        rec["roofline_fraction"], rec["useful_flop_ratio"]), flush=True)


def all_cells(mesh_names=("single", "multi")):
    """``(arch, shape name, mesh name)`` of every cell: each applicable
    shape of each architecture on each mesh."""
    for arch in configs.ARCH_IDS:
        for shape_name, sc in configs.applicable_shapes(
                configs.get_config(arch)).items():
            if sc is None:
                continue
            for mesh_name in mesh_names:
                yield arch, shape_name, mesh_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rules", default=None,
                    help="JSON dict of sharding-rule overrides, merged over "
                         "the default rules")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig field overrides")
    args = ap.parse_args(argv)
    rules = json.loads(args.rules) if args.rules else None
    overrides = json.loads(args.override) if args.override else None

    if not args.all:
        run_cell(args.arch, args.shape, args.mesh, rules, args.out,
                 overrides=overrides)
        return 0
    failures = []
    for arch, shape_name, mesh_name in all_cells():
        try:
            run_cell(arch, shape_name, mesh_name, rules, args.out,
                     overrides=overrides)
        except Exception as e:  # noqa: BLE001 -- a failed cell is a row
            traceback.print_exc()
            failures.append((arch, shape_name, mesh_name, str(e)))
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({
                        "arch": arch, "shape": shape_name,
                        "mesh": mesh_name, "status": "fail",
                        "error": str(e)[:500]}) + "\n")
    print(f"\n{len(failures)} failures")
    for f_ in failures:
        print("FAIL:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
