"""PyTorch port, the dry run (``repro_torch.launch.dryrun``) and the
production meshes (``launch.mesh.make_production_mesh``), on the CPU.

``python -m repro_torch.launch.dryrun --all`` runs in a subprocess, its
cells cut to ``DEPTH`` layers (``--override``; the full depth is counted
by ``chip_smoke.py``'s cells phase): one ``ok`` record for each
``train_4k`` and ``prefill_32k`` cell of each ported architecture on
each production mesh, and for each decoder's ``decode_32k`` cell, with
the reference's record keys, its FLOPs the hand count of the products
plus what the ranks repeat (hubert-xlarge's unembedding, whose vocab of
504 does not split 16 ways, on every "model" rank; the k and v
projections of a kv head that the ranks sharing it each run, where the
kv heads do not split 16 ways: in the decode cell, whose cache then
splits along the sequence, every rank projects all of them), its memory
``analyze()``'s; the mixture of experts' ``train_4k``, ``prefill_32k``
and ``decode_32k`` cells (``qwen3-moe-235b-a22b``, its 128 experts split
over "model"; ``grok-1-314b``, whose 8 experts 16 does not divide, each
expert's ``d_ff`` split instead), their FLOPs at least the hand count
and equal to it plus what the ranks repeat (every "data" rank routes the
whole batch and runs its experts over every routed token; grok's router,
whole on every rank); the hybrid's (``zamba2-1.2b``'s) four cells,
``long_500k`` among them (its batch of one whole on every data rank),
their FLOPs the hand count of the Mamba layers' products (the SSD's by
chunk) and the shared block's, plus what the ranks repeat (each "model"
rank's ``C·B`` of the one group and its ``h0 @ emb_proj``, whole); the
xLSTM's (``xlstm-350m``'s) four cells, ``decode_32k`` at its full batch
and ``long_500k`` among them, their FLOPs the hand count of the mLSTM
blocks' products (by chunk) and the sLSTM blocks' (the scan's registered
count, forward and backward), plus what the ranks repeat (its 4 heads,
whole on the 16 "model" ranks, run by each of them); 62 records, none
``not_ported`` nor ``fail``. In this process, under the dry run's fake process group: the production
meshes' shapes, a wrong world refused, the two-dim
``("pod", "data")`` group; and the fake group's count of the smoke train
cell and of the smoke decode cells (by kv heads, along the sequence, and
along the sequence with the weights' kv heads split) on each 4-rank mesh
against a real ``gloo`` run of the same step
(``tests/_torch_train_mesh_worker``): the FLOPs and every collective's
calls and bytes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import _torch_mesh_worker as W
import _torch_train_mesh_worker as TW
from repro.distributed import roofline as jroofline
from repro_torch import configs
from repro_torch.distributed import memory_model, sharding
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import attention, common, lm, ssm
from repro_torch.train import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "hubert-xlarge"
DEPTH = 2
#: the cells' cut: DEPTH layers, the hybrid's shared block after every
#: DEPTH of them (at its own cadence of 6 a 2-layer zamba2 would have
#: none, and its decode step needs one) and the xLSTM's sLSTM block every
#: DEPTH (at its cadence of 8 a 2-layer xlstm-350m would have none); the
#: other families read neither
OVERRIDE = {"n_layers": DEPTH, "shared_attn_every": DEPTH,
            "slstm_every": DEPTH}
#: the reference's record keys (``repro.launch.dryrun.run_cell``)
REF_KEYS = set(jroofline.Roofline("a", "s", "m", 1, 0.0, 0.0, 0.0).to_dict()
               ) | {"n_params", "lower_s", "compile_s", "status", "unrolled"}
CELLS = [(s, m) for s in ("train_4k", "prefill_32k")
         for m in ("single", "multi")]
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--override", json.dumps(OVERRIDE), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


#: the architectures the dense and vlm families added
NEW_ARCHS = ["olmo-1b", "codeqwen1.5-7b", "internlm2-1.8b", "deepseek-67b",
             "internvl2-76b"]
NEW_CELLS = [(a, s, m) for a in NEW_ARCHS for s, m in CELLS]
#: the "model" ranks of the production meshes
MODEL = 16


def ok_record(records, shape, mesh, arch=ARCH):
    got = [r for r in records if r["arch"] == arch and r["shape"] == shape
           and r["mesh"] == mesh]
    assert len(got) == 1 and got[0]["status"] == "ok", got
    return got[0]


def attn_pairs(S_all: int, causal: bool, q_chunk: int = 1024) -> int:
    """(query, key) pairs the attention scores: the whole square in one
    block; past it, each query block ``[lo, hi)`` against every key, or
    causally against its first ``hi`` (``attention._sdpa``)."""
    if S_all <= q_chunk:
        return S_all * S_all
    return sum((min(lo + q_chunk, S_all) - lo)
               * (min(lo + q_chunk, S_all) if causal else S_all)
               for lo in range(0, S_all, q_chunk))


def hand_flops(cfg, shape, kv_heads=None, vocab=None) -> tuple[int, int]:
    """The products of the unsharded cell (``tests/test_torch_cells.py``'s
    and ``tests/test_torch_lm_dense.py``'s counts), ``kv_heads`` k and v
    heads projected and a ``vocab``-wide unembedding (the config's by
    default); and of its unembedding alone."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    kv = kv_heads or cfg.kv_heads
    b, s, f = shape.global_batch, shape.seq_len, cfg.d_ff
    S_all = s + (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    T = b * S_all
    down = 2 * T * f * d
    n_in = 2 if cfg.activation == "silu" else 1
    causal = cfg.causal and not cfg.is_encoder
    layer = (2 * T * d * (h + 2 * kv) * hd + 2 * T * h * hd * d
             + 2 * 2 * b * attn_pairs(S_all, causal) * h * hd
             + n_in * 2 * T * d * f + down)
    unembed = 2 * b * s * d * (vocab or cfg.vocab)
    total = cfg.n_layers * layer + unembed
    if shape.kind == "train":
        chunked = (vocab or cfg.vocab) >= 8192 and s > 1024 and s % 1024 == 0
        n = 4 if chunked else 3
        return (3 * total + cfg.n_layers * (layer - down)
                + (unembed if chunked else 0), n * unembed)
    return total, unembed


#: the mixture of experts
MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
MOE_CELLS = [(a, s, m) for a in MOE_ARCHS
             for s in ("train_4k", "prefill_32k", "decode_32k")
             for m in ("single", "multi")]


def capacity(n: int, cfg) -> int:
    """``mlp._capacity``: the buffer rows an expert keeps of ``n`` routed
    tokens."""
    return max(int(n * cfg.top_k * cfg.capacity_factor / cfg.n_experts),
               cfg.top_k)


def moe_flops(cfg, shape, model: int = 1, data: int = 1) -> int:
    """The products of a mixture-of-experts cell: per layer q, k, v and o,
    the scores and ``P·V`` (causal, by query block; one token against the
    whole cache in decode), the router over every token (float32, ``(d,
    E)``) and the three expert products at the capacity of the batch's
    tokens, ``E * C`` rows; the unembedding. Train: three times the
    forward and, under remat "full", the whole layer again (its last saved
    tensor is the slot outputs the weighting reads, after ``w_down``), and
    the chunked loss's unembedding again. Over ``model`` "model" ranks and
    ``data`` ranks of the batch's dims, what they repeat: kv heads and a
    vocab ``model`` does not divide (as :func:`repeated_flops` and
    :func:`decode_flops`), and every data rank's routing and experts over
    the whole gathered batch; a router ``model`` does not split (its
    experts fewer than the ranks) on every rank."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    b, s, f, e = shape.global_batch, shape.seq_len, cfg.d_ff, cfg.n_experts
    kv, vocab = cfg.kv_heads, cfg.vocab
    if vocab % model:
        vocab *= model
    router = data * (1 if e % model == 0 else model)
    if shape.kind == "decode":
        kv *= model if kv % model else 1
        c = capacity(b, cfg)
        layer = (b * (2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
                      + 2 * 2 * h * s * hd)
                 + router * 2 * b * d * e + data * 3 * 2 * e * c * d * f)
        return cfg.n_layers * layer + b * 2 * d * vocab
    if kv % model:
        kv = model * max(h // model // (h // kv), 1)
    t = b * s
    c = capacity(t, cfg)
    layer = (2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
             + 2 * 2 * b * attn_pairs(s, True) * h * hd
             + router * 2 * t * d * e + data * 3 * 2 * e * c * d * f)
    unembed = 2 * b * s * d * vocab
    total = cfg.n_layers * layer + unembed
    if shape.kind == "prefill":
        return total
    chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
    return (3 * total + (cfg.n_layers * layer if cfg.remat == "full" else 0)
            + (unembed if chunked else 0))


def repeated_flops(cfg, shape) -> int:
    """The hand count with what the "model" ranks repeat: a vocab 16 does
    not divide unembedded whole on every rank, and kv heads 16 does not
    divide projected by every rank for its query heads (one kv head a
    rank for the published configs: ``attention.kv_heads_of_rank``)."""
    kv, vocab = cfg.kv_heads, cfg.vocab
    if kv % MODEL:
        group = cfg.n_heads // kv
        n = cfg.n_heads // MODEL
        kv = MODEL * max(n // group, 1)
    if vocab % MODEL:
        vocab = MODEL * vocab
    return hand_flops(cfg, shape, kv, vocab)[0]


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_records_have_the_reference_keys(records, shape, mesh):
    rec = ok_record(records, shape, mesh)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    cfg = configs.get_config(ARCH).replace(n_layers=DEPTH)
    assert rec["n_params"] == common.spec_param_count(lm.Model(cfg).spec())


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_flops_are_the_hand_count_plus_what_the_ranks_repeat(records, shape,
                                                             mesh):
    """Every layer's products split over the mesh with nothing repeated;
    the unembedding (vocab 504, which 16 does not divide) run whole by
    each of the 16 "model" ranks."""
    cfg = configs.get_config(ARCH).replace(n_layers=DEPTH)
    total, unembed = hand_flops(cfg, configs.SHAPES[shape])
    rec = ok_record(records, shape, mesh)
    assert rec["hlo_gflops"] * 1e9 == pytest.approx(
        total + 15 * unembed, rel=1e-12)
    assert rec["hlo_gflops"] * 1e9 > total


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_memory_is_analyze(records, shape, mesh):
    cfg = configs.get_config(ARCH).replace(n_layers=DEPTH)
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    want = memory_model.analyze(cfg, configs.SHAPES[shape], m).total_gb
    assert ok_record(records, shape, mesh)["per_device_peak_mem_gb"] == want


@pytest.mark.parametrize("arch,shape,mesh", NEW_CELLS)
def test_dense_and_vlm_records_have_the_reference_keys(records, arch, shape,
                                                       mesh):
    rec = ok_record(records, shape, mesh, arch)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    assert rec["n_params"] == common.spec_param_count(lm.Model(cfg).spec())


@pytest.mark.parametrize("arch,shape,mesh", NEW_CELLS)
def test_dense_and_vlm_flops_are_the_causal_hand_count_plus_repeats(
        records, arch, shape, mesh):
    """Causal attention counted by query block (the VLM's 256 image
    positions ahead of the text, a ragged last block), the chunked loss's
    recompute at train_4k, and the k and v projections that the ranks
    sharing a kv head each run (internlm2: 8 kv heads, deepseek and
    internvl2: 8, over 16 "model" ranks)."""
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    sh = configs.SHAPES[shape]
    want = repeated_flops(cfg, sh)
    rec = ok_record(records, shape, mesh, arch)
    assert rec["hlo_gflops"] * 1e9 == pytest.approx(want, rel=1e-12)
    assert (want > hand_flops(cfg, sh)[0]) == bool(cfg.kv_heads % MODEL)


@pytest.mark.parametrize("arch,shape,mesh", NEW_CELLS)
def test_dense_and_vlm_memory_is_analyze(records, arch, shape, mesh):
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    want = memory_model.analyze(cfg, configs.SHAPES[shape], m).total_gb
    assert ok_record(records, shape, mesh, arch)[
        "per_device_peak_mem_gb"] == want


DECODE_CELLS = [(a, m) for a in NEW_ARCHS for m in ("single", "multi")]


def decode_flops(cfg, shape, model: int = 1) -> int:
    """The decode cell's products, one token a sequence: per layer q, k, v
    and o, the scores and ``P·V`` over the whole cache, the MLP; the
    unembedding. Over ``model`` "model" ranks, what they repeat: where
    they do not divide the kv heads the cache splits along the sequence
    and every rank projects every kv head's k and v (its query heads'
    attention over its block repeats nothing); a vocab they do not divide
    is unembedded whole by every rank."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    b, s, f = shape.global_batch, shape.seq_len, cfg.d_ff
    n_in = 2 if cfg.activation == "silu" else 1
    kv_proj = 2 * 2 * d * kv * hd
    layer = (2 * d * h * hd + kv_proj + 2 * h * hd * d + 2 * 2 * h * s * hd
             + n_in * 2 * d * f + 2 * f * d)
    if kv % model:
        layer += (model - 1) * kv_proj
    vocab = cfg.vocab * (model if cfg.vocab % model else 1)
    return b * (cfg.n_layers * layer + 2 * d * vocab)


@pytest.mark.parametrize("arch,mesh", DECODE_CELLS)
def test_decode_records_have_the_reference_keys(records, arch, mesh):
    rec = ok_record(records, "decode_32k", mesh, arch)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    assert rec["n_params"] == common.spec_param_count(lm.Model(cfg).spec())
    assert rec["model_gflops"] * 1e9 == 2.0 * rec["n_params"] * 128


@pytest.mark.parametrize("arch,mesh", DECODE_CELLS)
def test_decode_flops_are_the_hand_count_plus_repeats(records, arch, mesh):
    """One token of 128 sequences against a 32,768-position cache: the
    cache splits by kv heads for OLMo (16) and CodeQwen (32), along the
    sequence for internlm2, deepseek and internvl2 (8 kv heads over 16
    "model" ranks), whose ranks each project all 8 kv heads."""
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    sh = configs.SHAPES["decode_32k"]
    want = decode_flops(cfg, sh, MODEL)
    rec = ok_record(records, "decode_32k", mesh, arch)
    assert rec["hlo_gflops"] * 1e9 == pytest.approx(want, rel=1e-12)
    assert (want > decode_flops(cfg, sh)) == bool(cfg.kv_heads % MODEL)


@pytest.mark.parametrize("arch,mesh", DECODE_CELLS)
def test_decode_memory_is_analyze(records, arch, mesh):
    """``analyze()``'s, its state the cache's block a device: 1/16 of the
    batch on "data" (1/32 on ("pod", "data")) and 1/16 of the kv heads or
    of the sequence on "model"."""
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    sh = configs.SHAPES["decode_32k"]
    mb = memory_model.analyze(cfg, sh, m)
    assert ok_record(records, "decode_32k", mesh, arch)[
        "per_device_peak_mem_gb"] == mb.total_gb
    whole = (2 * DEPTH * sh.global_batch * sh.seq_len * cfg.kv_heads
             * cfg.resolved_head_dim * 2)
    assert mb.state_gb == whole / (16 if mesh == "single" else 32) / 16 / 1e9


@pytest.mark.parametrize("arch,shape,mesh", MOE_CELLS)
def test_moe_records_have_the_reference_keys(records, arch, shape, mesh):
    rec = ok_record(records, shape, mesh, arch)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    assert rec["n_params"] == common.spec_param_count(lm.Model(cfg).spec())


@pytest.mark.parametrize("arch,shape,mesh", MOE_CELLS)
def test_moe_flops_are_the_hand_count_plus_repeats(records, arch, shape,
                                                   mesh):
    """At least the unsharded hand count, and equal to it with what the
    ranks repeat: the batch (256, 32 and 128 sequences) splits over the 16
    or 32 data ranks, each of which routes it whole."""
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    sh = configs.SHAPES[shape]
    data = 16 if mesh == "single" else 32
    got = ok_record(records, shape, mesh, arch)["hlo_gflops"] * 1e9
    assert got >= moe_flops(cfg, sh)
    assert got == pytest.approx(moe_flops(cfg, sh, MODEL, data),
                                rel=1e-12)


@pytest.mark.parametrize("arch,shape,mesh", MOE_CELLS)
def test_moe_memory_is_analyze(records, arch, shape, mesh):
    cfg = configs.get_config(arch).replace(n_layers=DEPTH)
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    want = memory_model.analyze(cfg, configs.SHAPES[shape], m).total_gb
    assert ok_record(records, shape, mesh, arch)[
        "per_device_peak_mem_gb"] == want


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}])
def test_moe_expert_splits_on_the_production_meshes(mesh):
    """qwen3-moe's 128 experts split over the 16-wide "model"; grok-1's 8
    do not divide it, so each expert's ``d_ff`` ("expert_mlp") splits
    there instead, and its router is whole on every "model" rank."""
    embed = "data" if len(mesh) == 2 else ("pod", "data")
    qwen = lm.Model(configs.get_config("qwen3-moe-235b-a22b")).param_specs(
        mesh)["layers"]["moe"]
    assert qwen["w_gate"] == (None, "model", embed, None)
    assert qwen["w_down"] == (None, "model", None, embed)
    assert qwen["router"] == (None, embed, "model")
    grok = lm.Model(configs.get_config("grok-1-314b")).param_specs(
        mesh)["layers"]["moe"]
    assert grok["w_gate"] == grok["w_up"] == (None, None, embed, "model")
    assert grok["w_down"] == (None, None, "model", embed)
    assert grok["router"] == (None, embed, None)


def test_no_failures_and_the_architectures_are_the_reference(records):
    """Every cell of every architecture of the reference is an ``ok``
    record: 62, none ``not_ported`` nor ``fail``."""
    from repro import configs as jconfigs
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert not [r for r in records if r["status"] == "fail"]
    assert sum(r["status"] == "ok" for r in records) == 62
    assert sum(r["status"] == "not_ported" for r in records) == 0
    assert len(records) == 62
    assert {r["arch"] for r in records} == set(configs.ARCH_IDS)


@pytest.mark.parametrize("multi", [False, True])
def test_make_production_mesh(multi):
    world = 512 if multi else 256
    with dryrun.fake_world(world):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert mesh.size() == world
        assert sharding.mesh_shape(mesh) == (
            {"pod": 2, "data": 16, "model": 16} if multi
            else {"data": 16, "model": 16})
    with dryrun.fake_world(8), pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(multi_pod=False)
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)
    assert not dist.is_initialized()


def test_axis_group_over_two_dims():
    """("pod", "data") on the 2x16x16 mesh: rank 0's group of 32, pod-major
    (the order ``local_range`` and the gather use), the same whatever order
    the dims are named in and made once; one dim is the mesh's own
    group."""
    with dryrun.fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=True)
        g = sharding.axis_group(mesh, ("pod", "data"))
        assert dist.get_process_group_ranks(g) == [
            16 * i for i in range(32)]
        assert sharding.axis_group(mesh, ("data", "pod")) is g
        assert dist.get_rank(g) == 0 and dist.get_world_size(g) == 32
        assert sharding.axis_group(mesh, "model") is mesh.get_group("model")
        assert sharding.local_range(256, g) == (0, 8)


def test_the_fake_world_refuses_a_process_with_a_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="process group"):
            with dryrun.fake_world(4):
                pass


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    """Every 4-rank mesh's smoke train step and decode steps in a real
    ``gloo`` world: each rank's FLOPs and collectives, by case."""
    rng = np.random.default_rng(3)

    def np_params(cfg):
        return common.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            lm.Model(cfg).spec(), lambda x: isinstance(x, common.P))

    cfg = TW.config("smoke")
    params = np_params(cfg)
    b, s = TW.CASES["smoke"][1]
    payload = {"smoke": dict(
        params=params, state=optim.AdamWState(
            step=np.int32(0), mu=common.tree_map(np.zeros_like, params),
            nu=common.tree_map(np.zeros_like, params)),
        labels=rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32),
        embeds=rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))}
    def normal(t):
        return rng.standard_normal(tuple(t.shape)).astype(np.float32)
    for case in TW.DECODE:
        cfg = TW.config(case)
        b, s = TW.CASES[case][1]
        spec = lm.Model(cfg).decode_state_spec(b, s)
        if cfg.family == "ssm":
            cache = [type(t)(*map(normal, t)) for t in spec]
        elif cfg.family == "hybrid":
            cache = {"mamba": ssm.SSMState(*map(normal, spec["mamba"])),
                     "attn": attention.KVCache(*map(normal, spec["attn"]))}
        else:
            cache = attention.KVCache(*map(normal, spec))
        payload[case] = dict(
            params=np_params(cfg), tokens=rng.integers(
                0, cfg.vocab, (b, 1)).astype(np.int32), cache=cache)
    cases = ["smoke", *TW.DECODE]
    ranks = W.spawn((1, 4), [("count", c, ()) for c in cases], payload,
                    str(tmp_path_factory.mktemp("count")),
                    timeout=SPAWN_TIMEOUT, target=TW._rank_main)
    return {(k, c): [r[k][("count", c)] for r in ranks]
            for k in ranks[0] for c in cases}


@pytest.mark.parametrize("shape", TW.WORLDS[4])
def test_the_fake_count_equals_a_real_run(real_counts, shape):
    """The dry run's count of the smoke cell (meta tensors, a fake group
    of 4) against rank 0 of a real ``gloo`` world: FLOPs (the record's are
    every rank's), and each collective's calls and bytes (per rank)."""
    real = real_counts[(TW.mesh_key(shape), "smoke")]
    assert all(r == real[0] for r in real[1:])
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        with sharding.count_collectives() as coll:
            rec = dryrun.count_cell(TW.config("smoke"), TW.shapes("smoke")[0],
                                    mesh, TW.mesh_key(shape))
    assert rec["hlo_gflops"] == real[0]["flops"] * 4 / 1e9
    assert coll.calls == real[0]["calls"]
    assert coll.bytes == real[0]["bytes"]
    assert rec["coll_breakdown"] == {k: v / 1e9 for k, v in
                                     real[0]["bytes"].items()}


@pytest.mark.parametrize("case", list(TW.DECODE))
@pytest.mark.parametrize("shape", TW.WORLDS[4])
def test_the_fake_decode_count_equals_a_real_run(real_counts, shape, case):
    """The dry run's count of a smoke decode cell (its rules merged over
    the default rules) against rank 0 of a real ``gloo`` world: every
    rank's FLOPs the same, and rank 0's equal to the count; each
    collective's calls and bytes."""
    real = real_counts[(TW.mesh_key(shape), case)]
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        with sharding.count_collectives() as coll:
            rec = dryrun.count_cell(TW.config(case), TW.decode_shape(case),
                                    mesh, TW.mesh_key(shape),
                                    TW.DECODE[case][2])
    assert all(r["flops"] == real[0]["flops"] for r in real[1:])
    assert rec["hlo_gflops"] == real[0]["flops"] * 4 / 1e9
    assert coll.calls == real[0]["calls"]
    assert coll.bytes == real[0]["bytes"]


# ---------------------------------------------------------------------------
# the hybrid
# ---------------------------------------------------------------------------

HYBRID = "zamba2-1.2b"
HYBRID_CELLS = [(sh, m) for sh in ("train_4k", "prefill_32k", "decode_32k",
                                   "long_500k")
                for m in ("single", "multi")]


def hybrid_cfg():
    return configs.get_config(HYBRID).replace(**OVERRIDE)


def hybrid_flops(cfg, shape, model: int = 1, data: int = 1) -> int:
    """The products of a hybrid cell: per Mamba layer the in and out
    projections and, for train and prefill, the SSD's by chunk (``C·B``
    of each group, its heads' ``L * C·B`` against x, the chunk states and
    the off-diagonal term), for decode the state against C; per
    shared-block call ``h0 @ emb_proj``, q, k, v, o, the causal scores and
    ``P·V`` (one token against the whole cache in decode) and the SwiGLU
    MLP; the unembedding. Train: three times the forward and, under remat
    "full", each layer again but its last product (``out_proj``, the
    shared block's ``w_down``), and the chunked loss's unembedding again.
    Over ``model`` "model" ranks, what they repeat: ``C·B`` of the one
    group and ``h0 @ emb_proj`` on every rank; over ``data`` ranks of the
    batch's dims, a batch they do not split, whole on every one."""
    d, di, n, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    hs, h, kv = cfg.ssm_heads, cfg.n_heads, cfg.kv_heads
    hd, f = cfg.resolved_head_dim, cfg.d_ff
    b, s = shape.global_batch, shape.seq_len
    dproj = 2 * di + 2 * n + hs
    calls = len(range(cfg.shared_attn_every - 1, cfg.n_layers,
                      cfg.shared_attn_every))
    L, unembed = cfg.n_layers, 2 * b * d * cfg.vocab
    rep_b = data if b % data else 1
    if shape.kind == "decode":
        mamba = b * (2 * d * dproj + 2 * hs * p * n + 2 * di * d)
        shared = b * (model * 2 * d * d + 2 * d * (h + 2 * kv) * hd
                      + 2 * h * hd * d + 2 * 2 * h * s * hd + 3 * 2 * d * f)
        return rep_b * (L * mamba + calls * shared + unembed)
    q = min(cfg.ssm_chunk, s)
    c, t = s // q, b * s
    out_proj, w_down = 2 * t * di * d, 2 * t * f * d
    mamba = (2 * t * d * dproj + out_proj + model * 2 * b * c * q * q * n
             + 2 * b * c * hs * q * q * p + 2 * 2 * t * hs * p * n)
    shared = (model * 2 * t * d * d + 2 * t * d * (h + 2 * kv) * hd
              + 2 * t * h * hd * d + 2 * 2 * b * attn_pairs(s, True) * h * hd
              + 2 * 2 * t * d * f + w_down)
    fwd = L * mamba + calls * shared + unembed * s
    if shape.kind == "prefill":
        return rep_b * fwd
    chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
    remat = (L * (mamba - out_proj) + calls * (shared - w_down)
             if cfg.remat == "full" else 0)
    return rep_b * (3 * fwd + remat + (unembed * s if chunked else 0))


@pytest.mark.parametrize("shape,mesh", HYBRID_CELLS)
def test_hybrid_records_have_the_reference_keys(records, shape, mesh):
    rec = ok_record(records, shape, mesh, HYBRID)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    assert rec["n_params"] == common.spec_param_count(
        lm.Model(hybrid_cfg()).spec())


@pytest.mark.parametrize("shape,mesh", HYBRID_CELLS)
def test_hybrid_flops_are_the_hand_count_plus_repeats(records, shape, mesh):
    """Its 64 SSM heads, 32 heads, 32 kv heads, d_ff and vocab all split
    16 ways; every "model" rank repeats ``C·B`` and ``h0 @ emb_proj``;
    long_500k's batch of one runs whole on each of the 16 or 32 data
    ranks."""
    cfg, sh = hybrid_cfg(), configs.SHAPES[shape]
    data = 16 if mesh == "single" else 32
    got = ok_record(records, shape, mesh, HYBRID)["hlo_gflops"] * 1e9
    assert got > hybrid_flops(cfg, sh)
    assert got == pytest.approx(hybrid_flops(cfg, sh, MODEL, data),
                                rel=1e-12)


@pytest.mark.parametrize("shape,mesh", HYBRID_CELLS)
def test_hybrid_memory_is_analyze(records, shape, mesh):
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    want = memory_model.analyze(hybrid_cfg(), configs.SHAPES[shape],
                                m).total_gb
    assert ok_record(records, shape, mesh, HYBRID)[
        "per_device_peak_mem_gb"] == want


# ---------------------------------------------------------------------------
# the xLSTM
# ---------------------------------------------------------------------------

XLSTM = "xlstm-350m"
XLSTM_CELLS = HYBRID_CELLS


def xlstm_cfg():
    return configs.get_config(XLSTM).replace(**OVERRIDE)


def xlstm_flops(cfg, shape, model: int = 1, data: int = 1) -> int:
    """The products of an xLSTM cell: per mLSTM block ``w_up``, ``wq``,
    ``wk``, ``wv``, ``w_i``, ``w_f`` and ``w_down`` and, for train and
    prefill, the chunkwise form's by chunk of ``q = min(ssm_chunk, s)``
    (``S_c = (ws k)^T v``, ``q k^T``, ``(qk s_intra) v`` and ``q C_prev``),
    for decode ``q C``; per sLSTM block ``w``, the scan's recurrent
    products (``2 b 4 h dh²`` a step) and ``w_down``; the unembedding.
    Train: three times the forward but for the scan, whose backward pass
    runs the plain loop again and takes ``r``'s gradient at every step and
    the hidden state's at every step but the first; under remat "full"
    each block again but its last product (``w_down``); the chunked
    loss's unembedding again. Over ``model`` "model" ranks that do not
    divide the heads, every block run whole by each of them; over
    ``data`` ranks of the batch's dims, a batch they do not split, whole
    on every one."""
    d, h, vocab = cfg.d_model, cfg.n_heads, cfg.vocab
    di, b, s = 2 * d, shape.global_batch, shape.seq_len
    dh, dhs = di // h, d // h
    kinds = ["slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
             else "mlstm" for i in range(cfg.n_layers)]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    rep_m = model if h % model else 1
    rep_b = data if b % data else 1
    step = 2 * b * 4 * h * dhs * dhs
    t = b if shape.kind == "decode" else b * s
    m_down, s_down = 2 * t * di * d, 2 * t * d * d
    m_proj = (2 * t * d * 2 * di + 3 * 2 * t * di * di + 2 * 2 * t * di * h
              + m_down)
    unembed = 2 * t * d * vocab
    if shape.kind == "decode":
        layers = (n_m * (m_proj + 2 * t * h * dh * dh)
                  + n_s * (2 * t * d * 4 * d + step + s_down))
        return rep_b * (rep_m * layers + unembed)
    q = min(cfg.ssm_chunk, s)
    m_layer = m_proj + 2 * 2 * t * h * dh * dh + 2 * 2 * t * h * q * dh
    s_layer = 2 * t * d * 4 * d + s * step + s_down
    layers = n_m * m_layer + n_s * s_layer
    if shape.kind == "prefill":
        return rep_b * (rep_m * layers + unembed)
    chunked = vocab >= 8192 and s > 1024 and s % 1024 == 0
    remat = (n_m * (m_layer - m_down) + n_s * (s_layer - s_down)
             if cfg.remat == "full" else 0)
    return rep_b * (rep_m * (3 * layers + n_s * (s - 1) * step + remat)
                    + 3 * unembed + (unembed if chunked else 0))


@pytest.mark.parametrize("shape,mesh", XLSTM_CELLS)
def test_xlstm_records_have_the_reference_keys(records, shape, mesh):
    rec = ok_record(records, shape, mesh, XLSTM)
    assert set(rec) == REF_KEYS
    assert rec["chips"] == dryrun.MESH_CHIPS[mesh] and rec["unrolled"]
    assert rec["n_params"] == common.spec_param_count(
        lm.Model(xlstm_cfg()).spec())


@pytest.mark.parametrize("shape,mesh", XLSTM_CELLS)
def test_xlstm_flops_are_the_hand_count_plus_repeats(records, shape, mesh):
    """Its 4 heads do not split 16 ways: every "model" rank runs every
    block whole, the weights split there gathered; the vocab (50,304)
    splits; long_500k's batch of one runs whole on each of the 16 or 32
    data ranks."""
    cfg, sh = xlstm_cfg(), configs.SHAPES[shape]
    data = 16 if mesh == "single" else 32
    got = ok_record(records, shape, mesh, XLSTM)["hlo_gflops"] * 1e9
    assert got > xlstm_flops(cfg, sh)
    assert got == pytest.approx(xlstm_flops(cfg, sh, MODEL, data),
                                rel=1e-12)


@pytest.mark.parametrize("shape,mesh", XLSTM_CELLS)
def test_xlstm_memory_is_analyze(records, shape, mesh):
    m = ({"data": 16, "model": 16} if mesh == "single"
         else {"pod": 2, "data": 16, "model": 16})
    want = memory_model.analyze(xlstm_cfg(), configs.SHAPES[shape],
                                m).total_gb
    assert ok_record(records, shape, mesh, XLSTM)[
        "per_device_peak_mem_gb"] == want


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}])
def test_xlstm_layout_on_the_production_meshes(mesh):
    """xlstm-350m's 4 heads do not divide "model": the heads' dims stay
    whole and the inner dims take "model" instead (``w_i`` and ``w_f``
    rows, ``wq``/``wk``/``wv`` rows, ``w_up`` columns); the sLSTM's
    ``w_down`` splits over the data dims alone."""
    embed = "data" if len(mesh) == 2 else ("pod", "data")
    specs = lm.Model(configs.get_config(XLSTM)).param_specs(mesh)["layers"]
    m, s = specs["mlstm"], specs["slstm"]
    assert m["w_i"] == m["w_f"] == (None, "model", None)
    assert m["b_i"] == (None, None)
    assert m["wq"] == (None, "model", None)
    assert m["w_up"] == (None, embed, "model")
    assert m["w_down"] == (None, "model", embed)
    assert s["r"] == (None, None, None, None, None)
    assert s["w"] == (None, embed, "model")
    assert s["w_down"] == (None, embed, None)
