"""Train a ~100M-param backbone for a few hundred steps on the PyTorch port.
The twin of ``examples/train_backbone.py``.

Uses internlm2-1.8b's family at reduced width (~100M params) with the
production train loop (checkpointing, resume, preemption handler); runs
on the card by default, on the CPU with ``--device cpu``; ``--smoke``
trains the family's smoke config instead.

Run:  PYTHONPATH=src python examples/train_backbone_torch.py [--steps 200]
"""

import argparse
import os
import tempfile

from repro_torch import configs, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models import common, lm
from repro_torch.train import loop as train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="the family's reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)

    # ~100M-param dense config (internlm2 family, narrowed)
    base = (configs.get_smoke if args.smoke
            else configs.get_config)("internlm2-1.8b")
    cfg = base.replace(compute_dtype="float32", remat="none") if args.smoke \
        else base.replace(n_layers=8, d_model=768, n_heads=12, kv_heads=6,
                          d_ff=2048, vocab=32000, compute_dtype="float32",
                          remat="none")
    model = lm.Model(cfg)
    n = common.spec_param_count(model.spec())
    print(f"params: {n/1e6:.1f}M")

    tc = train_loop.TrainConfig(
        steps=args.steps, ckpt_every=50, log_every=10,
        ckpt_dir=args.ckpt_dir, lr=3e-4, warmup=20)
    data = train_loop.synthetic_lm_data(
        cfg, args.batch, args.seq,
        start_step=ckpt.latest_step(args.ckpt_dir) or 0, device=dev)
    result = train_loop.train(model, data, tc, device=dev)
    h = result["history"]
    print(f"loss: first {h[0]:.3f} -> last {h[-1]:.3f} "
          f"({'DECREASED' if h[-1] < h[0] else 'did not decrease'})")


if __name__ == "__main__":
    main()
