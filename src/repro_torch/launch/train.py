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

The reference's multi-process flags (``--coordinator``,
``--process-id``, ``--num-processes``) are not here: they come with the
loop over a mesh (``ROADMAP.md`` §1 item 4(g)).

Examples:
  # CPU smoke run (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 20 --batch 4 --seq 128 --device cpu
  # on the card, the full config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 100 --batch 4 --seq 4096 --microbatches 2
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import configs, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
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
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device == "cuda" else args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    model = lm.Model(cfg)
    tc = train_loop.TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, lr=args.lr)
    data = train_loop.synthetic_lm_data(
        cfg, args.batch, args.seq,
        start_step=ckpt.latest_step(args.ckpt_dir) or 0, device=dev)
    result = train_loop.train(model, data, tc, device=dev)
    print(f"done at step {result['step']}; "
          f"loss history: {[round(x, 3) for x in result['history']]}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
