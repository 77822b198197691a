"""Scenarios of ``tests/test_torch_train_mesh.py`` (and the count
``tests/test_torch_dryrun.py`` holds the dry run's against), and the
ranks that run them.

Each scenario is a train and prefill cell, or a decode cell
(``DECODE``), of the port on the CPU, a function of its case and a
mesh: the test process runs it with
``mesh=None`` (the unsharded port), and every rank of a ``gloo`` world
spawned by ``_torch_mesh_worker.spawn`` runs it on each mesh shape of
its world (``WORLDS``). The whole state comes in the payload (numpy
arrays the test process made); each rank cuts its own blocks from it
(``steps.local_args``) and gathers the results back whole
(``steps.whole_args``), so every side is compared on whole arrays.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch

ARCH = "hubert-xlarge"
#: ModelConfig overrides of a smoke config (hubert-xlarge's unless
#: CASE_ARCH names another), and (batch, seq): the smoke cell; remat
#: "full" in bf16 (the collectives inside each layer's recompute); a vocab
#: of 8192 over 2048 positions (the chunked loss, two checkpointed chunks,
#: vocab-parallel in each); the dense, vlm and moe families' token
#: batches (the smoke grok-1 with 3 experts, which "model" = 2 does not
#: divide: each expert's d_ff splits instead, "expert_mlp"); the hybrid's
#: (the smoke zamba2: 8 SSM heads, an in_proj 280 wide and 144
#: convolution channels, which split into blocks of 140 and 72 on two
#: ranks while a rank's heads take 64 channels; four SSD chunks of 16),
#: and at SSM state 7, whose in_proj (278 wide) and convolution (142
#: channels) (1, 4) leaves whole while it splits the 8 heads; the xLSTM's
#: (the smoke xlstm-350m: 2 heads, which (1, 2) and (2, 2) split and (1,
#: 4) leaves whole while its inner dims split, the production meshes'
#: layout), in float32 and in bf16 under remat "full"
CASES = {
    "smoke": ({}, (2, 64)),
    "remat-bf16": ({"remat": "full", "compute_dtype": "bfloat16"}, (2, 64)),
    "chunked": ({"vocab": 8192, "d_model": 16, "n_heads": 2, "kv_heads": 2,
                 "d_ff": 32, "n_layers": 1}, (1, 2048)),
    "internlm2": ({}, (2, 64)),
    "olmo": ({}, (2, 64)),
    "internvl2": ({}, (2, 64)),
    "qwen3-moe": ({}, (2, 64)),
    "grok-mlp": ({"n_experts": 3}, (2, 64)),
    "internlm2-decode": ({}, (2, 32)),
    "internlm2-seq": ({}, (2, 32)),
    "olmo-decode": ({}, (2, 32)),
    "qwen3-moe-decode": ({}, (2, 32)),
    "zamba2": ({}, (2, 64)),
    "zamba2-whole": ({"ssm_state": 7}, (2, 32)),
    "zamba2-decode": ({}, (2, 32)),
    "xlstm": ({}, (2, 64)),
    "xlstm-remat-bf16": ({"remat": "full", "compute_dtype": "bfloat16"},
                         (2, 64)),
    "xlstm-decode": ({}, (2, 32)),
}
#: the decode cases: (architecture, the cache's valid positions, the
#: rules over the default rules). (b, s) above is the batch and the
#: cache's length. The
#: smoke internlm2's 2 kv heads split over "model" on (1, 2) and (2, 2),
#: and along the sequence ("cache_seq") on (1, 4); with "act_kv_heads"
#: unmapped the cache splits along the sequence on every mesh while the
#: weights' kv heads still split (its k and v gathered), as internlm2's on
#: four cards; OLMo's 4 kv heads split over "model"; the smoke
#: qwen3-moe's 8 experts over "model" and its tokens gathered over "data";
#: the smoke zamba2's SSM states by SSM heads, its convolution buffers
#: whole, its two shared-block caches by kv heads; the smoke xlstm-350m's
#: per-block states by heads (whole on (1, 4)), its convolution buffers
#: whole (the index is unread: the state has no positions)
DECODE = {"internlm2-decode": ("internlm2-1.8b", 13, None),
          "internlm2-seq": ("internlm2-1.8b", 13, {"act_kv_heads": None}),
          "olmo-decode": ("olmo-1b", 20, None),
          "qwen3-moe-decode": ("qwen3-moe-235b-a22b", 13, None),
          "zamba2-decode": ("zamba2-1.2b", 13, None),
          "xlstm-decode": ("xlstm-350m", 13, None)}
TRAIN_CASES = [c for c in CASES if c not in DECODE]
#: the architecture of each case that is not hubert-xlarge's: internlm2's
#: 4 heads over 2 kv heads, which (1, 4) splits while it leaves the kv
#: heads whole (each rank one query head of a group of two); OLMo's
#: parameter-free norms and MHA; the VLM's image prefix; the mixture of
#: experts (each layer's routing global, over the gathered batch)
CASE_ARCH = {"internlm2": "internlm2-1.8b", "olmo": "olmo-1b",
             "internvl2": "internvl2-76b", "qwen3-moe": "qwen3-moe-235b-a22b",
             "grok-mlp": "grok-1-314b", "zamba2": "zamba2-1.2b",
             "zamba2-whole": "zamba2-1.2b", "xlstm": "xlstm-350m",
             "xlstm-remat-bf16": "xlstm-350m"}
#: the hybrid's cases: the random model is ill-conditioned at the other
#: cases' weight scale (at std 0.2 the reference's own logits move by
#: 1.3e-5 of the largest |logit| for a 1e-7 relative change of its
#: weights, in float32), so its weights are drawn at this scale, as
#: ``chip_smoke.py``'s CELLS_WEIGHT_STD
HYBRID_CASES = ("zamba2", "zamba2-whole", "zamba2-decode")
HYBRID_WEIGHT_STD = 0.02
#: the xLSTM's cases, drawn at HYBRID_WEIGHT_STD too (at 0.2 the
#: reference's own bf16 gradients lie up to 40% of a leaf's largest
#: |entry| off its float32 ones); their decode states are reached ones
XLSTM_CASES = ("xlstm", "xlstm-remat-bf16", "xlstm-decode")
#: the mixture-of-experts cases, whose routing margins are recorded
MOE_CASES = ("qwen3-moe", "grok-mlp", "qwen3-moe-decode")
#: the worlds, each spawned once, and the mesh shapes every rank of one
#: runs: (4, 1) leaves the smoke batch of 2 whole on every data rank; the
#: ("pod", "data", "model") (2, 1, 2) splits the batch and every "embed"
#: dim over the two-dim ("pod", "data") group
WORLDS = {1: [(1, 1)], 2: [(1, 2), (2, 1)],
          4: [(2, 2), (1, 4), (4, 1), (2, 1, 2)]}
#: the meshes a case runs on where not all of them (the chunked loss is
#: the slowest case: the two-rank splits and the one-rank mesh)
CASE_MESHES = {"chunked": [(1, 1), (1, 2), (2, 2)],
               "internlm2": [(1, 1), (1, 4)],
               "olmo": [(1, 1), (2, 2), (4, 1)],
               "internvl2": [(1, 1), (2, 2), (4, 1)],
               "qwen3-moe": [(1, 1), (1, 2), (2, 1), (2, 2)],
               "grok-mlp": [(1, 1), (1, 2), (2, 2)],
               "internlm2-decode": [(1, 1), (1, 2), (2, 2), (1, 4)],
               "internlm2-seq": [(1, 1), (1, 2), (1, 4)],
               "olmo-decode": [(1, 1), (2, 2), (4, 1)],
               "qwen3-moe-decode": [(1, 1), (1, 2), (2, 1), (2, 2)],
               "zamba2": [(1, 1), (1, 2), (2, 2), (1, 4)],
               "zamba2-whole": [(1, 1), (1, 4)],
               "zamba2-decode": [(1, 1), (1, 2), (2, 2), (1, 4)],
               "xlstm": [(1, 1), (1, 2), (2, 2), (1, 4)],
               "xlstm-remat-bf16": [(1, 1), (1, 2), (2, 2), (1, 4)],
               "xlstm-decode": [(1, 1), (1, 2), (2, 2), (1, 4)]}
#: the detector the cascade's bits are held on: frames, patch, batch
HW, PATCH, DETECT_BATCH = (16, 16), 8, 2


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


#: the least gap, among a token's k + 1 largest router probabilities,
#: under which two packages (or two layouts) may order its experts
#: differently: the precondition of every routing held equal
ROUTING_MARGIN = 1e-6


def routing_margin(probs: torch.Tensor, k: int) -> float:
    """The least gap between neighbours among each token's ``k + 1``
    largest probabilities (``k`` alone where there are no more experts)."""
    top = torch.sort(probs.detach().to(torch.float32), dim=-1,
                     descending=True).values[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def record_margins(fn, *args):
    """``fn(*args)`` with every routing of the port's ``mlp.route``
    recorded: ``(its output, the least routing margin, inf for none)``."""
    from repro_torch.models import mlp
    route, seen = mlp.route, []

    def recorded(logits, cfg):
        seen.append(routing_margin(torch.softmax(logits.detach(), -1),
                                   cfg.top_k))
        return route(logits, cfg)
    mlp.route = recorded
    try:
        out = fn(*args)
    finally:
        mlp.route = route
    return out, min(seen, default=float("inf"))


def arch(case: str) -> str:
    if case in DECODE:
        return DECODE[case][0]
    return CASE_ARCH.get(case, ARCH)


def decode_rules(case: str) -> dict:
    """The decode case's rules, over the default rules."""
    from repro_torch.distributed import sharding
    return dict(sharding.DEFAULT_RULES, **(DECODE[case][2] or {}))


def config(case: str):
    from repro_torch import configs
    return configs.get_smoke(arch(case)).replace(**CASES[case][0])


def shapes(case: str):
    """The case's train and prefill ``ShapeConfig``s."""
    from repro_torch.configs import ShapeConfig
    b, s = CASES[case][1]
    return (ShapeConfig(f"{case}_train", s, b, "train"),
            ShapeConfig(f"{case}_prefill", s, b, "prefill"))


def decode_shape(case: str):
    from repro_torch.configs import ShapeConfig
    b, s = CASES[case][1]
    return ShapeConfig(f"{case}", s, b, "decode")


def decode_args(case: str, payload: dict):
    """``(params, state, batch)`` of the decode case on the CPU: the
    parameters, the half-filled bf16 cache (the hybrid's: its float32
    SSM states, bf16 convolution buffers and caches; the xLSTM's list of
    per-block states) and the tokens of the payload, the index
    ``DECODE[case][1]``."""
    from repro_torch.convert import (hybrid_state_from_arrays,
                                     kv_cache_from_arrays,
                                     lm_params_from_arrays,
                                     xlstm_state_from_arrays)
    from repro_torch.models import lm
    p = payload[case]
    params = lm_params_from_arrays(p["params"], cfg=config(case),
                                   device="cpu")
    state = (hybrid_state_from_arrays if isinstance(p["cache"], dict)
             else xlstm_state_from_arrays if isinstance(p["cache"], list)
             else kv_cache_from_arrays)(p["cache"], device="cpu")
    index = torch.tensor(DECODE[case][1], dtype=torch.int32)
    return params, state, lm.DecodeBatch(torch.from_numpy(p["tokens"]),
                                         index)


def state_arrays(state) -> dict:
    """The decode state's leaves as float32 numpy: ``k`` and ``v``, and
    the hybrid's ``ssm`` and ``conv``; the xLSTM's each block's, keyed
    ``"<block>.<leaf>"``."""
    if isinstance(state, list):
        return {f"{i}.{name}": t.to(torch.float32).numpy()
                for i, st in enumerate(state)
                for name, t in zip(st._fields, st)}
    cache = state["attn"] if isinstance(state, dict) else state
    out = {"k": cache.k, "v": cache.v}
    if isinstance(state, dict):
        out.update(ssm=state["mamba"].ssm, conv=state["mamba"].conv)
    return {k: t.to(torch.float32).numpy() for k, t in out.items()}


def run_decode(case: str, payload: dict, mesh) -> dict:
    """The case's decode cell (twice, each from the whole state) and its
    logits (``Model.decode_step``), on ``mesh`` (this rank's blocks) or
    unsharded: the next tokens, the logits and the state after the step,
    whole, as numpy, and the cache's spec."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models import common, lm
    cfg = config(case)
    rules = None if mesh is None else decode_rules(case)
    cell = steps.build_decode_cell(cfg, decode_shape(case), mesh, rules)
    model = lm.Model(cfg)
    outs = []
    for _ in range(2):
        args = decode_args(case, payload)
        if mesh is not None:
            args = steps.local_args(args, cell.in_shardings, mesh)
        out = cell.step_fn(*args)
        if mesh is not None:
            out = steps.whole_args(out, cell.out_shardings, mesh)
        outs.append(out)
    run_to_run = all(torch.equal(a, b) for a, b in zip(
        common.leaves(list(outs[0])), common.leaves(list(outs[1]))))
    args = decode_args(case, payload)
    margin = float("inf")
    if mesh is None:
        (logits, _), margin = record_margins(model.decode_step, *args)
    else:
        st_sh = cell.in_shardings[1]
        par = common.Parallel(mesh, rules, CASES[case][1][0])
        logits, _ = model.decode_step(
            *steps.local_args(args, cell.in_shardings, mesh), par, st_sh)
        vocab = par.group(common.unembed_spec(cfg.vocab, cfg.d_model)[
            "kernel"], "vocab")
        if vocab is not None:
            logits = sharding.all_gather_cat(logits, vocab, dim=-1)
        logits = sharding.whole_block(
            logits, (cell.in_shardings[2].tokens[0], None, None), mesh)
    tokens, state = outs[0]
    cache_spec = None
    if mesh is not None:
        st_sh = cell.in_shardings[1]
        cache_spec = (tuple(st_sh[0].C) if isinstance(st_sh, list) else
                      (st_sh["attn"] if isinstance(st_sh, dict)
                       else st_sh).k)
    return dict(tokens=tokens.numpy(), logits=logits.numpy(), margin=margin,
                run_to_run=run_to_run, cache_spec=cache_spec,
                ssm_spec=None if mesh is None or not isinstance(
                    st_sh, dict) else tuple(st_sh["mamba"]),
                **state_arrays(state))


def whole_state(case: str, payload: dict):
    """``(params, opt_state, batch)`` on the CPU from the payload's numpy
    arrays for ``case``."""
    from repro_torch.convert import (adamw_state_from_arrays,
                                     lm_params_from_arrays)
    from repro_torch.models import lm
    p = payload[case]
    params = lm_params_from_arrays(p["params"], cfg=config(case),
                                   device="cpu")
    state = adamw_state_from_arrays(p["state"], device="cpu")
    batch = lm.Batch(*(None if p.get(k) is None else torch.from_numpy(p[k])
                       for k in ("tokens", "labels", "embeds")))
    return params, state, batch


def np_leaves(tree) -> list[np.ndarray]:
    from repro_torch.models import common
    return [t.detach().to(torch.float32).numpy().copy()
            for t in common.leaves(tree)]


def run_case(case: str, payload: dict, mesh) -> dict:
    """The case's train step (twice from one state), its loss and
    gradients, and its prefill, on ``mesh`` (this rank's blocks) or
    unsharded; every result whole, as numpy."""
    from repro_torch.launch import steps
    from repro_torch.models import common, lm
    cfg = config(case)
    train, prefill = shapes(case)
    params, state, batch = whole_state(case, payload)
    cell = steps.build_cell(cfg, train, mesh)
    pcell = steps.build_cell(cfg, prefill, mesh)
    args, pargs = (params, state, batch), (params, batch)
    par = None
    if mesh is not None:
        args = steps.local_args(args, cell.in_shardings, mesh)
        pargs = steps.local_args(pargs, pcell.in_shardings, mesh)
        par = common.Parallel(mesh, None, train.global_batch)
    out = cell.step_fn(*args)
    again = cell.step_fn(*args)
    run_to_run = all(torch.equal(a, b) for a, b in zip(
        common.leaves(list(out)), common.leaves(list(again))))
    (loss, grads), margin = record_margins(
        steps.loss_and_grads, lm.Model(cfg), args[0], args[2], par)
    with torch.no_grad():
        logits = pcell.step_fn(*pargs)
    if mesh is not None:
        p_sh, opt_sh, _ = cell.out_shardings
        out = steps.whole_args(out, cell.out_shardings, mesh)
        grads = steps.whole_args(grads, p_sh, mesh)
        logits = steps.whole_args(logits, pcell.out_shardings, mesh)
    new_params, new_state, step_loss = out
    return dict(
        loss=float(loss), step_loss=float(step_loss), grads=np_leaves(grads),
        params=np_leaves(new_params), mu=np_leaves(new_state.mu),
        nu=np_leaves(new_state.nu), step=int(new_state.step),
        logits=logits.to(torch.float32).numpy(), run_to_run=run_to_run,
        batch_spec=None if mesh is None else cell.in_shardings[2].labels,
        margin=margin)


def count_case(case: str, payload: dict, mesh) -> dict:
    """What this rank's train step (a decode case's decode step) does on
    ``mesh``: its products' FLOPs (``FlopCounterMode``) and its
    collectives' calls and bytes (``count_collectives``), the backward
    pass's included."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    if case in DECODE:
        cell = steps.build_cell(config(case), decode_shape(case), mesh,
                                decode_rules(case))
        whole = decode_args(case, payload)
    else:
        cell = steps.build_cell(config(case), shapes(case)[0], mesh)
        whole = whole_state(case, payload)
    args = steps.local_args(whole, cell.in_shardings, mesh)
    with sharding.count_collectives() as coll, \
            FlopCounterMode(display=False) as fc:
        cell.step_fn(*args)
    return dict(flops=fc.get_total_flops(), calls=coll.calls,
                bytes=coll.bytes)


def embed_bits(case: str, payload: dict, mesh) -> dict:
    """The case's token embedding vocab-parallel on ``mesh`` (this rank's
    block of the table, the whole tokens) and unsharded, in float32 and
    bf16: whether they are bitwise equal, and the sharded rows as float32
    numpy."""
    from repro_torch.models import common, lm
    cfg = config(case)
    params, _, batch = whole_state(case, payload)
    specs = common.param_specs(lm.Model(cfg).spec()["embed"], mesh)
    local = common.local_params(params["embed"], specs, mesh)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        got = common.embed(local, batch.tokens, dt, common.Parallel(mesh),
                           cfg.vocab, cfg.d_model)
        want = common.embed(params["embed"], batch.tokens, dt)
        out[str(dt)] = (got.dtype == dt and torch.equal(got, want),
                        got.to(torch.float32).numpy())
    return out


def cascade_bits(payload: dict, mesh) -> dict:
    """The sharded detector step (``build_detector_cell(mesh=)``, the
    smoke config in float32) through the collectives autograd
    differentiates, and through their forward arithmetic alone (the
    gather and the fold as plain functions, the group's entry as the
    identity): the logits of both."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch import configs
    cfg = configs.get_smoke(ARCH)
    params = steps.init_detector_params(torch.Generator().manual_seed(3),
                                        cfg, frame_hw=HW, patch=PATCH)
    frames = torch.from_numpy(payload["frames"])
    out = {}
    for how in ("autograd", "plain"):
        saved = (sharding.all_gather_cat, sharding.fold_partials,
                 sharding.enter_group)
        if how == "plain":
            sharding.all_gather_cat = lambda x, g, dim=0: torch.cat(
                sharding._gather(x, g), dim)
            sharding.fold_partials = sharding._fold
            sharding.enter_group = lambda x, g: x
        try:
            cell = steps.build_detector_cell(
                cfg, batch=DETECT_BATCH, frame_hw=HW, patch=PATCH,
                mesh=mesh)
            with torch.no_grad():
                out[how] = cell.step_fn(cell.prepare(params), frames).numpy()
        finally:
            (sharding.all_gather_cat, sharding.fold_partials,
             sharding.enter_group) = saved
    return out


def run(kind: str, name: str, payload: dict, mesh):
    """A work item: ``("case", case)``, ``("decode", case)``, ``("count",
    case)``, ``("embed", case)`` or ``("cascade", name)``."""
    if kind == "case":
        return run_case(name, payload, mesh)
    if kind == "decode":
        return run_decode(name, payload, mesh)
    if kind == "count":
        return count_case(name, payload, mesh)
    if kind == "embed":
        return embed_bits(name, payload, mesh)
    return cascade_bits(payload, mesh)


def _rank_main(rank: int, world: int, shape: tuple, work: list,
               payload: dict, root: str) -> None:
    """One rank: every mesh shape of ``WORLDS[world]``, every work item
    ``(kind, name, args)`` on each; ``{mesh key: {(kind, name): result}}``
    written to ``root/rank<r>.pkl``."""
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
            names = (("data", "model") if len(mshape) == 2
                     else ("pod", "data", "model"))
            mesh = init_device_mesh("cpu", mshape, mesh_dim_names=names)
            results[mesh_key(mshape)] = {
                (kind, name): run(kind, name, payload, mesh)
                for kind, name, _ in work
                if kind not in ("case", "decode")
                or mshape in CASE_MESHES.get(name, [mshape])}
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
