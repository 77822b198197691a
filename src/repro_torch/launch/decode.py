"""Batched greedy decoding with a prefill-free cache, on PyTorch. The twin
of ``repro.launch.decode``.

:func:`greedy_decode` feeds the prompt a token at a time into the cache
(``Model.decode_step``, the state written in place), then takes ``gen``
tokens greedily (the argmax of the last logits). The index of each step
is a 0-d tensor on the device, cut from one ``arange``, so the loop makes
no host sync. :func:`main` prints, last, the whole ``(b, p + gen)``
tokens as one JSON object.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path on the
host, and without a card the script fails rather than fall back):
  PYTHONPATH=src python -m repro_torch.launch.decode --arch internlm2-1.8b \\
      --smoke --batch 2 --prompt-len 8 --gen 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import lm


def greedy_decode(model: lm.Model, params: dict, prompts: torch.Tensor,
                  gen: int, max_seq: int, state=None) -> torch.Tensor:
    """``prompts`` ``(b, p)`` int32 on the parameters' device -> ``(b, p +
    gen)`` int32: the prompt, then ``gen`` greedy tokens. ``state``: the
    decode state to fill, in place (by default zeros of ``max_seq``
    positions): the transformer families' ``KVCache``, the hybrid's
    dict of SSM states and caches (``convert.hybrid_state_from_arrays``
    makes one from the reference's), or the xLSTM's list of per-block
    states (``convert.xlstm_state_from_arrays``)."""
    b, p = prompts.shape
    dev = prompts.device
    if state is None:
        state = model.init_decode_state(batch=b, max_seq=max_seq,
                                        device=dev)
    index = torch.arange(p + gen - 1, dtype=torch.int32, device=dev)
    tok = prompts[:, 0:1]
    out = [tok]
    for t in range(p + gen - 1):
        logits, state = model.decode_step(
            params, state, lm.DecodeBatch(tokens=tok, index=index[t]))
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        tok = prompts[:, t + 1:t + 2] if t + 1 < p else nxt.to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(args.device)
    model = lm.Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=torch.int32,
        device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.time()
    toks = greedy_decode(model, params, prompts, args.gen,
                         max_seq=args.prompt_len + args.gen)
    toks = toks.cpu()
    dt = time.time() - t0
    n_new = args.batch * args.gen
    print(f"generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s on {dev})")
    print(toks[:, :12])
    print(json.dumps({"tokens": toks.tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
