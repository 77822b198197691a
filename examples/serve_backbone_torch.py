"""Serve a small model with batched requests on the PyTorch port. The twin
of ``examples/serve_backbone.py``.

Batched greedy decoding with KV cache through the production decode path
(``repro_torch.launch.decode.greedy_decode``); runs on the card by
default, on the CPU with ``--device cpu``.

Run:  PYTHONPATH=src python examples/serve_backbone_torch.py
"""

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.decode import greedy_decode
from repro_torch.models import lm


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    cfg = configs.get_smoke("internlm2-1.8b").replace(
        n_layers=4, d_model=128, n_heads=4, kv_heads=2, d_ff=512)
    model = lm.Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    batch, prompt_len, gen = 4, 8, 24
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    t0 = time.time()
    toks = greedy_decode(model, params, prompts, gen,
                         max_seq=prompt_len + gen)
    dt = time.time() - t0
    print(f"served {batch} requests, {gen} new tokens each, in {dt:.1f}s")
    print("first request tokens:", toks[0].tolist())

    # determinism check: same prompts -> same generation
    toks2 = greedy_decode(model, params, prompts, gen,
                          max_seq=prompt_len + gen)
    if not torch.equal(toks, toks2):
        raise RuntimeError("decode must be deterministic")
    print("determinism check passed")


if __name__ == "__main__":
    main()
