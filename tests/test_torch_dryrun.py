"""PyTorch port, the dry run (``repro_torch.launch.dryrun``) and the
production meshes (``launch.mesh.make_production_mesh``), on the CPU.

``python -m repro_torch.launch.dryrun --all`` runs in a subprocess, its
cells cut to ``DEPTH`` layers (``--override``; the full depth is counted
by ``chip_smoke.py``'s cells phase): one ``ok`` record for each of
hubert-xlarge's cells (``train_4k``, ``prefill_32k``) on each production
mesh, with the reference's record keys, its FLOPs the hand count of the
products plus the unembedding every "model" rank repeats (the vocab of
504 does not split 16 ways), its memory ``analyze()``'s; one
``not_ported`` row a mesh for each other architecture. In this process,
under the dry run's fake process group: the production meshes' shapes,
a wrong world refused, the two-dim ``("pod", "data")`` group; and the
fake group's count of the smoke train cell on each 4-rank mesh against
a real ``gloo`` run of the same step (``tests/_torch_train_mesh_worker``):
the FLOPs and every collective's calls and bytes.
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
from repro_torch.models import common, lm
from repro_torch.train import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "hubert-xlarge"
DEPTH = 2
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
         "--override", json.dumps({"n_layers": DEPTH}), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


def ok_record(records, shape, mesh):
    got = [r for r in records if r["arch"] == ARCH and r["shape"] == shape
           and r["mesh"] == mesh]
    assert len(got) == 1 and got[0]["status"] == "ok", got
    return got[0]


def hand_flops(cfg, shape) -> tuple[int, int]:
    """The products of the unsharded cell (``tests/test_torch_cells.py``'s
    count), and of its unembedding alone."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    b, s, f = shape.global_batch, shape.seq_len, cfg.d_ff
    T = b * s
    down = 2 * T * f * d
    layer = (2 * T * d * (h + 2 * kv) * hd + 2 * T * h * hd * d
             + 2 * 2 * b * s * s * h * hd + 2 * T * d * f + down)
    unembed = 2 * T * d * cfg.vocab
    total = cfg.n_layers * layer + unembed
    if shape.kind == "train":
        return 3 * total + cfg.n_layers * (layer - down), 3 * unembed
    return total, unembed


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


@pytest.mark.parametrize("arch", sorted(dryrun.NOT_PORTED))
def test_other_archs_are_not_ported_rows(records, arch):
    rows = [r for r in records if r["arch"] == arch]
    assert sorted(r["mesh"] for r in rows) == ["multi", "single"]
    for r in rows:
        assert r["status"] == "not_ported"
        assert r["reason"].startswith("ROADMAP.md §1 item 4(")
    assert arch not in configs.ARCH_IDS


def test_no_failures_and_the_architectures_are_the_reference(records):
    from repro import configs as jconfigs
    assert dryrun.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(dryrun.NOT_PORTED) == set(dryrun.ARCH_IDS) - {ARCH}
    assert not [r for r in records if r["status"] == "fail"]
    assert len(records) == 4 + 2 * len(dryrun.NOT_PORTED)


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
    """Every 4-rank mesh's smoke train step in a real ``gloo`` world:
    each rank's FLOPs and collectives."""
    cfg = TW.config("smoke")
    rng = np.random.default_rng(3)
    params = common.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        lm.Model(cfg).spec(), lambda x: isinstance(x, common.P))
    b, s = TW.CASES["smoke"][1]
    payload = {"smoke": dict(
        params=params, state=optim.AdamWState(
            step=np.int32(0), mu=common.tree_map(np.zeros_like, params),
            nu=common.tree_map(np.zeros_like, params)),
        labels=rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32),
        embeds=rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))}
    ranks = W.spawn((1, 4), [("count", "smoke", ())], payload,
                    str(tmp_path_factory.mktemp("count")),
                    timeout=SPAWN_TIMEOUT, target=TW._rank_main)
    return {k: [r[k][("count", "smoke")] for r in ranks] for k in ranks[0]}


@pytest.mark.parametrize("shape", TW.WORLDS[4])
def test_the_fake_count_equals_a_real_run(real_counts, shape):
    """The dry run's count of the smoke cell (meta tensors, a fake group
    of 4) against rank 0 of a real ``gloo`` world: FLOPs (the record's are
    every rank's), and each collective's calls and bytes (per rank)."""
    real = real_counts[TW.mesh_key(shape)]
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
