"""Training launcher on PyTorch. The twin of ``repro.launch.train``.

One process trains one model on one device (``--device``, CUDA by
default, failing without it) through :func:`repro_torch.train.loop.train`:
synthetic LM data, AdamW, a checkpoint every ``--ckpt-every`` steps and
one on SIGTERM (exit 143). A relaunch with the same ``--ckpt-dir``
resumes from its latest checkpoint, and the data stream with it: the
stream starts at that checkpoint's step, so the relaunched run is
bitwise an uninterrupted one. (The reference's launcher starts its
stream at step 0 on every launch, so a relaunch there trains on the
first batches again after the restored step; ``ROADMAP.md`` §3.)

Several processes train one program (the reference's multi-host
contract): every process runs this launcher with the same flags and
``--coordinator host:port``, its ``--process-id`` and
``--num-processes``. They join one ``torch.distributed`` group there
(NCCL, each process on card ``process_id % device_count``; ``gloo`` with
``--device cpu``) and train over the ``(1, num_processes)`` ``("data",
"model")`` mesh of its ranks (``launch.mesh.make_host_mesh``;
``train(mesh=)``): rank 0 alone writes the checkpoints, each whole, and
a SIGTERM to any process stops every one at one agreed step, exit 143
after the checkpoint. A relaunch may take another number of processes:
each cuts its blocks from the whole checkpoint. A process group that
fails to start fails the launch.

Examples:
  # CPU smoke run (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 20 --batch 4 --seq 128 --device cpu
  # on the card, the full config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 100 --batch 4 --seq 4096 --microbatches 2
  # two processes (one a card; on the CPU add --device cpu), each run as:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 20 --coordinator 127.0.0.1:29500 \\
      --num-processes 2 --process-id {0,1}
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.train import loop as train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=train_loop.TrainConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the process group's rendezvous "
                         "(several processes)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    args = ap.parse_args(argv)
    if args.coordinator is None and args.num_processes != 1:
        ap.error("--num-processes needs --coordinator")
    if not 0 <= args.process_id < args.num_processes:
        ap.error(f"--process-id {args.process_id} is not a rank of "
                 f"{args.num_processes}")

    dev = resolve_device(None if args.device == "cuda" else args.device)
    mesh = None
    if args.coordinator is not None:
        if dev.type == "cuda":
            dev = torch.device("cuda", args.process_id
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}", rank=args.process_id,
            world_size=args.num_processes,
            device_id=dev if dev.type == "cuda" else None)
        mesh = make_host_mesh(dev.type)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    model = lm.Model(cfg)
    tc = train_loop.TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, lr=args.lr)
    data = train_loop.synthetic_lm_data(
        cfg, args.batch, args.seq,
        start_step=ckpt.latest_step(args.ckpt_dir) or 0, device=dev)
    try:
        result = train_loop.train(model, data, tc, device=dev, mesh=mesh)
    except SystemExit:          # the agreed preemption: every rank is here
        if mesh is not None:
            dist.destroy_process_group()
        raise
    if mesh is not None:
        dist.destroy_process_group()
    if args.process_id == 0:
        print(f"done at step {result['step']}; "
              f"loss history: {[round(x, 3) for x in result['history']]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
