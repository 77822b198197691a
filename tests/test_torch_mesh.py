"""PyTorch port, the sharded fleet on the CPU: the ``gloo`` twin of the
reference's mesh matrix (``tests/test_parity_matrix.py``'s mesh parity,
``tests/test_serve.py``'s sharded service, ``tests/test_online.py``'s
shared fold under a sensor mesh).

Each ``(data, model)`` mesh shape — (1, 1), (2, 1), (1, 2), (2, 2),
(4, 1) — is spawned once per module as a world of ``gloo`` processes
(``tests/_torch_mesh_worker.py``), which run every scenario through
``FleetRunner(mesh=...)`` / ``FleetService(mesh=...)``: float32, int8,
int4 and binary, each with shared and per-stream adaptation; S = 5
streams padded to the sensor extent (with ADC noise keyed by the global
stream index); the closed loop; two services under churn (one padded from
3 slots); and a checkpoint chain (2, 1) -> unsharded -> (1, 2). Every
rank's scores, decisions, classifiers, holds, capture logs, HP drains and
service ticks must be bitwise the unsharded port's, computed here on the
same numpy inputs. At ``DIM = 128`` and ``block_d = 16`` the D-tile axis
has 8 tiles, so (1, 2) and (2, 2) split D; a one-tile case is
replicated over "model".

Also: the unsharded port against the JAX ``FleetRunner`` under a (1, 1)
``shard_map`` mesh, within ``SCORE_ATOL``; and the split scorers' plain
partials, a tile's bits the same at 1, 2 and 8 tiles a call.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from _torch_parity import SCORE_ATOL
from repro_torch.kernels import sliding_scores as tss
from repro_torch.kernels import sliding_scores_int as tssi
from repro_torch.sensing import fleet as tfleet

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
          "4x1": (4, 1)}
#: seconds a spawned world may take before it is terminated (a run takes
#: a few seconds; the bound only keeps a hung rendezvous from hanging the
#: suite)
SPAWN_TIMEOUT = 240.0


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
    """Every scenario unsharded (``"ref"``) and on every mesh shape (one
    result dict per rank), spawned once each, in the checkpoint chain's
    order: (2, 1) writes tick T1, the unsharded service resumes it and
    writes tick T2, (1, 2) resumes that."""
    ts = W.thresholds()
    work = ([("fleet", n, ()) for n in W.FLEET]
            + [("service", n, ()) for n in W.SERVICE])
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    out = {"ref": {**{n: W.run_fleet(n, ts, None) for n in W.FLEET},
                   **{n: W.run_service(n, ts, None) for n in W.SERVICE}},
           "ts": ts}
    for name, shape in SHAPES.items():
        extra = []
        if name == "2x1":
            extra = [("resume", "resume", (0, W.T1, ckpt))]
        elif name == "1x2":
            out["resume-mid"] = W.resume_stage(ts, None, W.T1, W.T2, ckpt)
            extra = [("resume", "resume", (W.T2, W.SVC_TICKS, ckpt))]
        out[name] = W.spawn(shape, work + extra, ts,
                            str(tmp_path_factory.mktemp(f"mesh{name}")),
                            timeout=SPAWN_TIMEOUT)
    return out


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


@pytest.mark.parametrize("case", list(W.FLEET))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fleet_mesh_bitwise(runs, shape, case):
    """Every rank returns the unsharded runner's scores, decisions,
    adapted classifiers, holds, capture log and HP drains, bitwise."""
    want = runs["ref"][case]
    for rank, got in enumerate(runs[shape]):
        _equal(got[case], want, f"{shape} rank {rank} {case}")


@pytest.mark.parametrize("case", list(W.SERVICE))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_service_mesh_bitwise(runs, shape, case):
    """The sharded service's churn trace — every tick's outputs, each
    sensor's classifier (parked ones too), capture log and HP drain — is
    the unsharded one's on every rank; its slots pad to the sensor
    extent once."""
    want = dict(runs["ref"][case])
    k = SHAPES[shape][0]
    slots = W.SERVICE[case][-1]
    for rank, got in enumerate(runs[shape]):
        got = dict(got[case])
        assert got.pop("n_slots") == -(-slots // k) * k
        assert got.pop("rebuilds") == want["rebuilds"]
        _equal(got, {k_: v for k_, v in want.items()
                     if k_ not in ("n_slots", "rebuilds")},
               f"{shape} rank {rank} {case}")


@pytest.mark.parametrize("shape", [s for s in SHAPES if s != "1x1"])
def test_service_refuses_a_mesh_short_of_the_world(runs, shape):
    """On every rank, ``FleetService`` refuses a mesh that leaves out
    ranks of the world (one dim of the world's mesh), whose checkpoint
    would have no writer or a barrier that never meets."""
    for rank, got in enumerate(runs[shape]):
        assert got["short_mesh_refused"] is True, f"{shape} rank {rank}"


def test_checkpoint_resumes_across_meshes(runs):
    """Ticks [0, T1) on (2, 1), a checkpoint; [T1, T2) unsharded from it,
    a checkpoint; [T2, end) on (1, 2) from that: the stitched trace and
    the final classifiers, logs and drains are the uninterrupted unsharded
    run's."""
    want = runs["ref"][W.RESUME]
    stages = [runs["2x1"][0]["resume"], runs["resume-mid"],
              runs["1x2"][0]["resume"]]
    for rank_runs in (runs["2x1"], runs["1x2"]):
        for r in rank_runs[1:]:
            _equal(r["resume"]["outputs"], rank_runs[0]["resume"]["outputs"],
                   "ranks of one stage")
    stitched: dict = {}
    for st in stages:
        for sid, outs in st["outputs"].items():
            stitched.setdefault(sid, []).extend(outs)
    _equal(stitched, want["outputs"], "ticks")
    last = stages[-1]
    _equal(last["class_hvs"], want["class_hvs"], "class_hvs")
    _equal(last["logs"], want["logs"], "capture logs")
    # HP frames drained in one stage do not ride the next checkpoint
    drains = {sid: tuple(np.concatenate([st["drains"][sid][j]
                                         for st in stages
                                         if sid in st["drains"]])
                         for j in range(2))
              for sid in want["drains"]}
    _equal(drains, want["drains"], "HP drains")


def test_mesh_scenarios_are_not_trivial(runs):
    """The matrix compares real work: gates that see both outcomes,
    classifiers that moved, streams that hold, a closed loop that skips
    idle frames and HP-captures bursts."""
    ref = runs["ref"]
    C, _, _ = W.model_arrays()
    for case, (p, scope, S, closed, _, _) in W.FLEET.items():
        r = ref[case]
        assert 0 < r["fired"].sum() < r["fired"].size, case
        chvs = r["class_hvs"]
        assert not np.array_equal(chvs, np.broadcast_to(C, chvs.shape)), \
            case
        if closed:
            assert not r["sampled"].all(), case
            assert sum(len(i) for i in r["hp_idx"]) > 0, case


def test_unsharded_port_matches_jax_on_a_1x1_mesh(runs):
    """The unsharded port against the JAX ``FleetRunner`` sharded with
    ``shard_map`` over a (1, 1) mesh (Pallas in interpret mode), float32
    with per-stream adaptation: scores within ``SCORE_ATOL``, decisions
    equal wherever the score sits clear of ``t_score``."""
    import jax.numpy as jnp
    from repro.core import hypersense as jhs
    from repro.core.online import AdaptConfig as JAdapt
    from repro.core.sensor_control import ControllerConfig as JController
    from repro.distributed import sharding as jsh
    from repro.sensing import fleet as jfleet
    case = "float32-per-stream"
    p, scope, S, _, _, _ = W.FLEET[case]
    C, B0, b = W.model_arrays()
    jm = jhs.HyperSenseModel(jnp.asarray(C), jnp.asarray(B0), jnp.asarray(b),
                             W.FRAG, W.FRAG, W.STRIDE,
                             t_score=runs["ts"][p], t_detection=0,
                             nonlinearity="rff")
    fr, lab = W.fleet_frames(S, W.N_FRAMES)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jsh.use_mesh(mesh):
        jr = jfleet.FleetRunner(
            jm, JController(**W.CTRL), chunk_size=W.CHUNK, backend="pallas",
            block_d=W.BLOCK_D, adc_bits=W.BITS[p], precision=p,
            adapt=JAdapt(mode="label", lr=0.5, scope=scope))
        outs = [jr.process(fr[:, a:b_], labels=lab[:, a:b_])
                for a, b_ in ((0, W.CHUNK), (W.CHUNK, W.N_FRAMES))]
    js, jf, _ = (np.concatenate(x, 1) for x in zip(*outs))
    want = runs["ref"][case]
    np.testing.assert_allclose(want["scores"], js, rtol=0, atol=SCORE_ATOL)
    clear = np.abs(js - runs["ts"][p]) > 5 * SCORE_ATOL
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(want["fired"][clear], jf[clear])


def _plain_geometry(int_mode):
    C, B0, b = (torch.from_numpy(x) for x in W.model_arrays())
    kw = dict(W=W.FRAME, w=W.FRAG, stride=W.STRIDE, block_d=W.BLOCK_D)
    if int_mode is None:
        return tss.precompute_geometry(B0, b, **kw), C
    return tssi.precompute_geometry_int(B0, b, mode=int_mode, **kw), C


def test_plain_projections_at_one_tile_are_one_product():
    """At one D-wide tile (the default block at the paper's D) the plain
    float version's per-tile window projections are bitwise one masked
    product per base row against the whole unfolded slab row (the
    single product over all D columns that the tiles replace)."""
    C, B0, b = (torch.from_numpy(x) for x in W.model_arrays())
    tiles = tss.precompute_tiles(B0, b, C, W=W.FRAME, w=W.FRAG,
                                 stride=W.STRIDE, block_d=512)
    assert tiles.slabs.shape[0] == 1
    fr, _ = W.fleet_frames(2, W.CHUNK)
    frames = torch.from_numpy(fr.reshape(-1, W.FRAME, W.FRAME)).float()
    N, H, Wd = frames.shape
    my = (H - W.FRAG) // W.STRIDE + 1
    mx = (Wd - W.FRAG) // W.STRIDE + 1
    lo, hi = tss._window_masks(Wd, W.FRAG, W.STRIDE, mx, frames.device,
                               torch.float32)
    ky = torch.arange(my) * W.STRIDE
    L = tiles.slabs.shape[-1]
    want = torch.zeros((N, my, mx, tiles.block_d))
    for r in range(W.FRAG):
        S = tiles.slabs[:, r, :].unfold(-1, L - Wd + 1, 1)
        S = S.permute(1, 0, 2).reshape(Wd, -1)
        x = frames[:, ky + r, :][:, :, None, :]
        want = want + (x * hi) @ S - (x * lo) @ S
    got = tss.tile_window_acc(frames, tiles, W.FRAG, W.FRAG, W.STRIDE)
    assert len(got) == 1 and torch.equal(got[0], want)


@pytest.mark.parametrize("per_call", [1, 2, 8])
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_plain_partials_do_not_depend_on_the_tiles_of_the_call(precision,
                                                               per_call):
    """A D-tile's plain partials have the same bits in a call of 1, 2 or
    all 8 tiles (each call's tiles cut by ``fleet.local_geometry``), for
    shared and per-stream class tiles; gathered in tile order and folded
    they are the unsplit plain scores."""
    int_mode = None if precision == "float32" else "int8"
    geom, C = _plain_geometry(int_mode)
    n_dt = geom.idx.shape[0]
    assert n_dt == 8
    fr, _ = W.fleet_frames(2, W.CHUNK)
    frames = torch.from_numpy(fr.reshape(-1, W.FRAME, W.FRAME))
    kw = dict(h=W.FRAG, w=W.FRAG, stride=W.STRIDE)
    if int_mode is not None:
        from repro_torch.sensing import adc as tadc
        frames = tadc.pack_codes(tadc.quantize_codes(frames, 8), 8)
    per_stream = torch.stack([C, C.flip(0) * 0.5])
    for chvs, fps in ((C, None), (per_stream, W.CHUNK)):
        if int_mode is None:
            retile = (tss.retile_classes_fleet if chvs.ndim == 3
                      else tss.retile_classes)
            partials, scores = (tss.score_partials_plain,
                                tss.fragment_scores_batch_plain)
        else:
            retile = (tssi.retile_classes_int_fleet if chvs.ndim == 3
                      else tssi.retile_classes_int)
            partials, scores = (tssi.score_partials_int_plain,
                                tssi.fragment_scores_batch_int_plain)
        full = retile(geom, chvs)
        want = partials(frames, full, frames_per_stream=fps, **kw)
        got = torch.cat([
            partials(frames, retile(tfleet.local_geometry(geom, lo,
                                                          lo + per_call),
                                    chvs),
                     frames_per_stream=fps, **kw)
            for lo in range(0, n_dt, per_call)])
        assert torch.equal(got, want)
        folded = tss.fold_partials_plain(got, full, chvs.ndim == 3,
                                         fps or frames.shape[0])
        assert torch.equal(folded, scores(frames, full,
                                          frames_per_stream=fps, **kw))
