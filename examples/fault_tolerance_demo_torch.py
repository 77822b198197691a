"""Fault-tolerance demo on the PyTorch port: train, 'crash', resume; elastic
restore onto a mesh. The twin of ``examples/fault_tolerance_demo.py``.

Simulates the production contract:
  1. train 6 steps with async checkpointing every 3
  2. "node failure" — a fresh process state (a new model object)
  3. relaunch resumes from the latest valid checkpoint, continuing the
     exactly-once data stream
  4. elastic restore: the same checkpoint cut onto a mesh of the host's
     ranks (``ckpt.restore(specs=, mesh=)``): a one-rank group when the
     demo runs alone, as the reference's (1, 1) mesh

Runs on the card by default; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py
"""

import argparse
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import common, lm
from repro_torch.train import loop as train_loop

BATCH, SEQ = 2, 16


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ft_")
    cfg = configs.get_smoke("internlm2-1.8b")
    try:
        # --- phase 1: train + checkpoint ---
        tc = train_loop.TrainConfig(steps=6, ckpt_every=3, log_every=3,
                                    ckpt_dir=ckpt_dir, lr=1e-3)
        data = train_loop.synthetic_lm_data(cfg, BATCH, SEQ, device=dev)
        train_loop.train(lm.Model(cfg), data, tc, device=dev)
        print(f"[demo] latest checkpoint: step {ckpt.latest_step(ckpt_dir)}")

        # --- phase 2: 'crash' + relaunch with more steps ---
        print("[demo] simulating node failure + relaunch ...")
        model = lm.Model(cfg)                   # fresh process state
        tc2 = train_loop.TrainConfig(steps=10, ckpt_every=3, log_every=2,
                                     ckpt_dir=ckpt_dir, lr=1e-3)
        data2 = train_loop.synthetic_lm_data(cfg, BATCH, SEQ, start_step=6,
                                             device=dev)
        result = train_loop.train(model, data2, tc2, device=dev)
        if result["step"] != 10:
            raise RuntimeError(f"the relaunch ended at {result['step']}")
        print("[demo] resumed and finished at step 10")

        # --- phase 3: elastic restore onto a mesh of the host's ranks ---
        elastic_restore(model, cfg, ckpt_dir, dev)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def elastic_restore(model, cfg, ckpt_dir, dev) -> None:
    """The checkpoint cut onto the ``(1, world)`` mesh of the default
    process group (made here, of this process alone, when there is none):
    every rank's blocks, gathered, are the checkpoint's leaves."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(ckpt_dir, "store"), 1),
            rank=0, world_size=1, device_id=dev if dev.type == "cuda"
            else None)
    try:
        mesh = make_host_mesh(dev.type)
        cell = steps.build_train_cell(cfg, ShapeConfig("demo", SEQ, BATCH,
                                                       "train"), mesh)
        like, specs = cell.abstract_args[:2], cell.in_shardings[:2]
        blocks, extra = ckpt.restore(ckpt_dir, like, device=dev,
                                     specs=specs, mesh=mesh)
        whole, _ = ckpt.restore(ckpt_dir, like, device=dev)
        flat = common.leaves(steps.whole_args(blocks, specs, mesh))
        if not all(torch.equal(a, b) for a, b in zip(
                flat, common.leaves(whole), strict=True)):
            raise RuntimeError("the restored blocks differ from the "
                               "checkpoint")
        print(f"[demo] elastic restore ok (step {extra['step']}) onto a "
              f"{tuple(mesh.mesh.shape)} mesh: {len(flat)} leaves, each "
              f"rank's blocks the checkpoint's; the same checkpoint loads "
              f"on any mesh")
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
