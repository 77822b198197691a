"""PyTorch port, the sharded cascade on the CPU: ``CascadeService(mesh=)``
over ``gloo`` worlds of (1, 1), (1, 2), (2, 1), (2, 2) and (1, 4) ranks,
each spawned once per module (``tests/_torch_cascade_mesh_worker.py``).

Every rank builds the service from the same whole parameters (the smoke
``hubert-xlarge`` in float32 on the reference's ``init_detector_params``,
carried across by ``detector_params_from_arrays``; and a 6-head,
d_model 96, d_ff 130 config that "model" divides at 2 but not at 4) and is
fed the same ragged drains of 16x16 frames (patch 8, batch 4). On every
mesh: every rank's logits bitwise the same; batched equal to ``eager``
bitwise; ``rebuild_count() == 1``; the logits within ``F32_RTOL`` of the
largest |logit| of the unsharded port and of the JAX ``CascadeService``
(unsharded: the JAX side has one CPU device); each rank's weight blocks of
the shapes ``spec_for`` gives; a mesh short of the world refused. The
accounting on the mesh: ``backbone_cost`` counts every rank's products,
so it differs from the unsharded hand count only by the products every
rank repeats (the replicated embedder; on "data" > 1 the whole program,
as the frames are replicated), and ``roofline().coll_gbytes`` is the hand
count of the step's folds and gathers.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_cascade_mesh_worker as CW
import _torch_mesh_worker as W
from repro import configs as jconfigs
from repro.launch import cascade as jcascade
from repro.launch import steps as jsteps
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import common, lm

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"1x1": (1, 1), "1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2),
          "1x4": (1, 4)}
#: seconds a spawned world may take before it is terminated (a run takes
#: seconds; the bound only keeps a hung rendezvous from hanging the suite)
SPAWN_TIMEOUT = 240.0
F32_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The spawned ranks run single-threaded; so does the unsharded side
    (and the files after this one get their thread count back)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case unsharded (``"ref"``), through the JAX ``CascadeService``
    (``"jax"``, the smoke case) and on every mesh shape (one result dict
    per rank)."""
    ref_params = jsteps.init_detector_params(
        jax.random.PRNGKey(7), jconfigs.get_smoke(CW.ARCH), frame_hw=CW.HW,
        patch=CW.PATCH)
    payload = dict(params=jax.tree.map(np.asarray, ref_params),
                   frames=CW.frames_of(CW.N_FRAMES, 6))
    jbatches = CW.feed(jcascade.CascadeService(
        ref_params, jconfigs.get_smoke(CW.ARCH), batch_size=CW.BATCH,
        frame_hw=CW.HW), payload["frames"])
    out = {"ref": {c: CW.run_cascade(c, payload, None) for c in CW.CASES},
           "jax": np.concatenate([b.logits for b in jbatches])}
    work = [("cascade", c, ()) for c in CW.CASES]
    for name, shape in SHAPES.items():
        out[name] = W.spawn(shape, work, payload,
                            str(tmp_path_factory.mktemp(f"casc{name}")),
                            timeout=SPAWN_TIMEOUT, target=CW._rank_main)
    return out


def assert_close(got, want, rtol):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale, rtol)


CASES = [(s, c) for s in SHAPES for c in CW.CASES]


@pytest.mark.parametrize("shape,case", CASES)
def test_every_rank_returns_the_same_logits(runs, shape, case):
    first = runs[shape][0][case]
    for rank, got in enumerate(runs[shape][1:], 1):
        for key in ("served", "eager", "more", "more_eager"):
            np.testing.assert_array_equal(got[case][key], first[key],
                                          err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("shape,case", CASES)
def test_batched_equals_eager_bitwise(runs, shape, case):
    """Ragged drains, then more with ``eager`` in between: batched logits
    are ``eager``'s at every position, the batches mapped back as the
    unsharded service maps them, and the step is built once."""
    want = runs["ref"][case]
    for rank, got in enumerate(runs[shape]):
        got = got[case]
        np.testing.assert_array_equal(got["served"], got["eager"])
        np.testing.assert_array_equal(got["more"], got["more_eager"])
        assert got["more_padded"] == [0, 3]
        assert got["rebuilds"] == 1, rank
        for g, w in zip(got["batches"], want["batches"], strict=True):
            assert g[:2] == w[:2]
            np.testing.assert_array_equal(g[2], w[2])
            assert g[4] == w[4]


@pytest.mark.parametrize("shape,case", CASES)
def test_sharded_matches_the_unsharded_port(runs, shape, case):
    want = runs["ref"][case]
    for got in runs[shape]:
        for key in ("served", "more"):
            assert_close(got[case][key], want[key], F32_RTOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_matches_the_jax_cascade(runs, shape):
    for got in runs[shape]:
        assert_close(got["smoke"]["served"], runs["jax"], F32_RTOL)


@pytest.mark.parametrize("shape,case", CASES)
def test_weight_blocks_have_the_spec_shapes(runs, shape, case):
    """Each rank holds the block ``spec_for`` gives each weight: the dims
    it shards divided by their mesh extent (e.g. ``wq`` ``(L, d, h/2,
    hd)`` on (1, 2)), the others whole."""
    mesh = dict(zip(("data", "model"), SHAPES[shape]))
    model = lm.Model(CW.config(case))
    specs = common.param_specs(model.spec(), mesh)

    def block(p, spec):
        return tuple(n // np.prod([mesh[a] for a in (
            () if ax is None else (ax,) if isinstance(ax, str) else ax)])
            for n, ax in zip(p.shape, spec))

    want = {}

    def walk(p, s, path):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], path + (k,))
        else:
            want[path] = block(p, s)

    walk(model.spec(), specs, ())
    for got in runs[shape]:
        for path, shp in want.items():
            leaf = got[case]["shapes"]
            for k in path:
                leaf = leaf[k]
            assert leaf == shp, (path, leaf, shp)
    if shape == "1x2" and case == "smoke":
        cfg = CW.config(case)
        assert want[("layers", "attn", "wq")] == (
            cfg.n_layers, cfg.d_model, cfg.n_heads // 2,
            cfg.resolved_head_dim)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s != "1x1"])
def test_refuses_a_mesh_short_of_the_world(runs, shape):
    for rank, got in enumerate(runs[shape]):
        assert got["short_mesh_refused"] is True, rank


def test_heads_the_mesh_does_not_divide_run_whole(runs):
    """6 heads and a d_ff of 130 on (1, 4): ``spec_for`` leaves them
    replicated, so attention and MLP run whole on every rank and fold
    nothing (the step's collectives are the gathers alone, and its logits
    are the unsharded port's bitwise); on (1, 2) both split."""
    cfg = CW.config("heads6")
    for got in runs["1x4"]:
        attn = got["heads6"]["shapes"]["layers"]["attn"]
        assert attn["wq"] == (cfg.n_layers, cfg.d_model, 6,
                              cfg.resolved_head_dim)
        assert got["heads6"]["shapes"]["layers"]["mlp"]["w_up"] == (
            cfg.n_layers, cfg.d_model, cfg.d_ff)
        np.testing.assert_array_equal(got["heads6"]["served"],
                                      runs["ref"]["heads6"]["served"])
        coll = collective_bytes(cfg, 1, 4)
        assert coll["fold"] == 0
        assert got["heads6"]["roofline"]["coll_gbytes"] == \
            coll["total"] / 1e9
    for got in runs["1x2"]:
        assert got["heads6"]["shapes"]["layers"]["attn"]["wq"][2] == 3


# ---------------------------------------------------------------------------
# accounting on the mesh
# ---------------------------------------------------------------------------

def collective_bytes(cfg, D: int, M: int) -> dict:
    """Hand count of one batch's collective payload on a rank of a (D, M)
    mesh (each all-gather's output bytes, float32): per frame and layer,
    the FSDP gathers of ``wq``, ``wk``, ``wv``, ``wo``, ``w_up`` and
    ``w_down`` along d_model over "data" (issued wherever "data" divides
    d_model, at D = 1 too) and the two folds over "model" where it
    divides the heads and d_ff; then the unembedding's gather and the
    detection head's row of logits over "model"."""
    d, h, hd, f, V = (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
                      cfg.d_ff, cfg.vocab)
    seq = steps.detector_seq_len(CW.HW, CW.PATCH)
    hs = M if h % M == 0 else 1
    fs = M if f % M == 0 else 1
    vs = M if V % M == 0 else 1
    fsdp = d % D == 0
    gather = fsdp * 4 * (4 * d * h * hd // hs + 2 * d * f // fs)
    fold = 4 * seq * d * (M * (h % M == 0) + M * (f % M == 0))
    head = fsdp * 4 * d * V // vs + 4 * V * (V % M == 0)
    per_frame = cfg.n_layers * (gather + fold) + head
    return {"fold": CW.BATCH * cfg.n_layers * fold,
            "total": CW.BATCH * per_frame}


def embedder_flops(cfg) -> int:
    seq = steps.detector_seq_len(CW.HW, CW.PATCH)
    return 2 * seq * CW.PATCH * CW.PATCH * cfg.d_model


@pytest.mark.parametrize("shape", list(SHAPES))
def test_backbone_cost_counts_every_rank(runs, shape):
    """The sharded count is every rank's products: the unsharded hand
    count, split over "model" with nothing lost or added, plus what every
    rank repeats — the replicated embedder on each rank, and on "data"
    > 1 the whole program on each data rank (the frames are replicated).
    On (1, k): the hand count plus (k - 1) embedder products. So the
    count depends on the mesh's shape through the repeated products
    alone. The bytes are each rank's blocks, its embedder, the frame and
    the logits, times the ranks."""
    D, M = SHAPES[shape]
    cfg = CW.config("smoke")
    want = runs["ref"]["smoke"]["cost"]
    E = embedder_flops(cfg)
    seq = steps.detector_seq_len(CW.HW, CW.PATCH)
    per_rank = 4 * ((CW.PATCH * CW.PATCH + seq) * cfg.d_model
                    + CW.HW[0] * CW.HW[1] + 2)
    for got in runs[shape]:
        cost = got["smoke"]["cost"]
        assert cost.flops == D * (want.flops - E) + D * M * E
        if D == 1:
            assert cost.flops == want.flops + (M - 1) * E
        blocks = 4 * sum(int(np.prod(s)) for s in jax.tree.leaves(
            got["smoke"]["shapes"], is_leaf=lambda x: isinstance(x, tuple)))
        assert cost.bytes == D * M * (blocks + per_rank)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_roofline_on_the_mesh(runs, shape):
    """``roofline()`` on a (D, M) mesh: chips D·M, the mesh named "DxM",
    a batch's FLOPs and bytes those of ``backbone_cost``, and
    ``coll_gbytes`` (per rank) the hand count of its folds and gathers,
    all of them all-gathers."""
    D, M = SHAPES[shape]
    cfg = CW.config("smoke")
    coll = collective_bytes(cfg, D, M)["total"]
    for got in runs[shape]:
        rl, cost = got["smoke"]["roofline"], got["smoke"]["cost"]
        assert (rl["chips"], rl["mesh"]) == (D * M, f"{D}x{M}")
        assert rl["hlo_gflops"] == cost.flops * CW.BATCH / 1e9
        assert rl["hlo_gbytes"] == cost.bytes * CW.BATCH / 1e9
        assert rl["coll_gbytes"] == coll / 1e9
        assert rl["coll_breakdown"] == {"all-gather": coll / 1e9}
        assert rl["per_device_peak_mem_gb"] == 0.0
    assert runs["ref"]["smoke"]["roofline"]["coll_gbytes"] == 0.0


def test_fold_partials_on_one_rank_is_the_partial():
    """One rank (the card's (1, 1) mesh): the fold is the partial itself
    at its dtype, float32 and bf16, issued as one all-gather; its order
    over more ranks is held by the meshes above (every rank bitwise)."""
    import datetime
    import os
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, "s"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=30))
        try:
            x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
            for dt in (torch.float32, torch.bfloat16):
                with sharding.count_collectives() as coll:
                    got = sharding.fold_partials(x.to(dt), None)
                assert got.dtype == dt and torch.equal(got, x.to(dt))
                assert coll.calls == {"all-gather": 1}
                assert coll.bytes == {"all-gather": x.to(dt).nbytes}
        finally:
            dist.destroy_process_group()
