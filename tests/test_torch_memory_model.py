"""PyTorch port, the analytic memory model:
``repro_torch.distributed.memory_model.analyze`` against
``repro.distributed.memory_model.analyze`` term by term.

``hubert-xlarge`` full and smoke, at ``train_4k``, ``prefill_32k``,
``SMOKE_SHAPE`` and a batch-4 ``train_4k``; on (data, model) meshes
(1, 1), (1, 4), (2, 2), 16x16 and the 2x16x16 (pod, data, model) one. The
reference takes a ``jax.sharding.AbstractMesh``, the port a
``{name: size}`` mapping of the same shape. Both compute on Python
integers, so every term must be equal, not close. ``fits_h100`` replaces
the reference's ``fits_v5e``: the same total against 80 GB, not 16.
The hybrid ``zamba2-1.2b``, full and smoke, at all four shapes (its
decode states a dict of SSM states and caches) on one device, (1, 1),
16x16 and 2x16x16; the xLSTM ``xlstm-350m`` the same way (its decode
states a list of per-block states), and the figures its cells record.
"""

import dataclasses

import jax
import pytest

from repro import configs as jconfigs
from repro.distributed import memory_model as jmm
from repro_torch import configs
from repro_torch.distributed import memory_model as mm

jax.config.update("jax_platform_name", "cpu")

ARCH = "hubert-xlarge"
MESHES = {"1x1": (1, 1), "1x4": (1, 4), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
SHAPES = ("train_4k", "prefill_32k", "smoke", "train_4k_b4")


def meshes(name):
    shape = MESHES[name]
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return (jax.sharding.AbstractMesh(shape, names),
            dict(zip(names, shape)))


def shapes(name):
    """``(reference ShapeConfig, the port's)`` of a shape's name."""
    if name == "smoke":
        return jconfigs.SMOKE_SHAPE, configs.SMOKE_SHAPE
    if name == "train_4k_b4":
        return (jconfigs.ShapeConfig("train_4k_b4", 4096, 4, "train"),
                configs.ShapeConfig("train_4k_b4", 4096, 4, "train"))
    return jconfigs.SHAPES[name], configs.SHAPES[name]


def cfgs(which):
    return (getattr(jconfigs, which)(ARCH), getattr(configs, which)(ARCH))


def same_breakdown(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_gb == want.total_gb
    assert got.fits_h100 == (want.total_gb <= 80.0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_analyze_equals_the_reference(which, shape, mesh):
    jcfg, cfg = cfgs(which)
    jshape, tshape = shapes(shape)
    jm, tm = meshes(mesh)
    same_breakdown(mm.analyze(cfg, tshape, tm),
                   jmm.analyze(jcfg, jshape, jm))


RULES = {"no_fsdp": {"embed": None},
         "no_tp": {"heads": None, "kv_heads": None, "mlp": None,
                   "vocab": None},
         "pod_only": {"embed": ("pod",), "act_batch": ("pod",)}}


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_rules_overrides(shape, rules):
    jcfg, cfg = cfgs("get_config")
    jshape, tshape = shapes(shape)
    jm, tm = meshes("2x16x16")
    got = mm.analyze(cfg, tshape, tm, RULES[rules])
    same_breakdown(got, jmm.analyze(jcfg, jshape, jm, RULES[rules]))
    assert got != mm.analyze(cfg, tshape, tm) or rules == "pod_only"


def test_recorded_points():
    """The figures the chip phase records beside the allocator: train_4k
    needs 286.8 GB on one card and 1.439 GB a card on 16x16; at batch 4
    it fits one H100 (19.36 GB); prefill_32k counts 77.0 GB at batch 32
    and 4.24 at batch 1."""
    cfg = configs.get_config(ARCH)
    one = {"data": 1, "model": 1}
    full = mm.analyze(cfg, configs.SHAPES["train_4k"], one)
    assert round(full.total_gb, 1) == 286.8 and not full.fits_h100
    assert round(mm.analyze(cfg, configs.SHAPES["train_4k"],
                            {"data": 16, "model": 16}).total_gb, 3) == 1.439
    b4 = mm.analyze(cfg, shapes("train_4k_b4")[1], one)
    assert b4.fits_h100 and round(b4.total_gb, 2) == 19.36
    pre = configs.SHAPES["prefill_32k"]
    assert round(mm.analyze(cfg, pre, one).total_gb, 1) == 77.0
    assert round(mm.analyze(cfg, dataclasses.replace(pre, global_batch=1),
                            one).total_gb, 2) == 4.24


def test_decode_raises_as_the_reference():
    jcfg, cfg = cfgs("get_config")
    jm, tm = meshes("16x16")
    with pytest.raises(ValueError, match="no decode step"):
        mm.analyze(cfg, configs.SHAPES["decode_32k"], tm)
    with pytest.raises(ValueError, match="no decode step"):
        jmm.analyze(jcfg, jconfigs.SHAPES["decode_32k"], jm)


HYBRID = "zamba2-1.2b"
HYBRID_MESHES = {"one": (), "1x1": (1, 1), "16x16": (16, 16),
                 "2x16x16": (2, 16, 16)}


@pytest.mark.parametrize("mesh", list(HYBRID_MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_hybrid_analyze_equals_the_reference(which, shape, mesh):
    """zamba2 on every shape, the two decode shapes' states (the Mamba
    layers' float32 SSM states split by heads, their bf16 convolution
    buffers whole on "model", the shared block's caches by kv heads)
    flattened from the dict in one order with their axes."""
    jcfg = getattr(jconfigs, which)(HYBRID)
    cfg = getattr(configs, which)(HYBRID)
    dims = HYBRID_MESHES[mesh]
    names = {0: (), 2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(dims)]
    same_breakdown(mm.analyze(cfg, configs.SHAPES[shape],
                              dict(zip(names, dims))),
                   jmm.analyze(jcfg, jconfigs.SHAPES[shape],
                               jax.sharding.AbstractMesh(dims, names)))


def test_hybrid_long_500k_state():
    """long_500k uncut on one card: the six shared-block calls' bf16
    caches (25.77 GB) and 38 layers' SSM states and buffers."""
    cfg = configs.get_config(HYBRID)
    mb = mm.analyze(cfg, configs.SHAPES["long_500k"], {})
    cache = 6 * 2 * 524288 * 32 * 64 * 2
    ssm = 38 * (64 * 64 * 64 * 4 + 3 * (4096 + 2 * 64) * 2)
    assert mb.state_gb == (cache + ssm) / 1e9
    assert mb.fits_h100 and round(cache / 1e9, 2) == 25.77


XLSTM = "xlstm-350m"


@pytest.mark.parametrize("mesh", list(HYBRID_MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_xlstm_analyze_equals_the_reference(which, shape, mesh):
    """xlstm-350m on every shape, the decode shapes' states (a list of
    per-block states: the mLSTM's float32 C, n and m split by heads where
    "model" divides them, its bf16 convolution buffer whole; the sLSTM's
    four float32 leaves) flattened in one order with their axes."""
    jcfg = getattr(jconfigs, which)(XLSTM)
    cfg = getattr(configs, which)(XLSTM)
    dims = HYBRID_MESHES[mesh]
    names = {0: (), 2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(dims)]
    same_breakdown(mm.analyze(cfg, configs.SHAPES[shape],
                              dict(zip(names, dims))),
                   jmm.analyze(jcfg, jconfigs.SHAPES[shape],
                               jax.sharding.AbstractMesh(dims, names)))


def test_xlstm_recorded_points():
    """decode_32k at its full batch of 128 fits one card: 21 mLSTM
    blocks' float32 C (537 MB each) among 12.378 GB; 0.751 GB a card on
    16x16 and 0.395 on 2x16x16; long_500k 1.126 GB on one card; train_4k
    1.423 / 0.870 GB and prefill_32k 0.991 / 0.515 GB on the two
    production meshes."""
    cfg = configs.get_config(XLSTM)
    one, single = {}, {"data": 16, "model": 16}
    multi = {"pod": 2, "data": 16, "model": 16}

    def gb(shape, mesh):
        return round(mm.analyze(cfg, configs.SHAPES[shape], mesh).total_gb,
                     3)
    dec = mm.analyze(cfg, configs.SHAPES["decode_32k"], one)
    state = 21 * 128 * (4 * 512 * 512 * 4 + 4 * 512 * 4 + 4 * 4
                        + 3 * 2048 * 2) + 3 * 4 * 128 * 4 * 256 * 4
    assert dec.state_gb == state / 1e9 and dec.fits_h100
    assert (gb("decode_32k", one), gb("decode_32k", single),
            gb("decode_32k", multi)) == (12.378, 0.751, 0.395)
    assert gb("long_500k", one) == 1.126
    assert (gb("train_4k", single), gb("train_4k", multi)) == (1.423, 0.870)
    assert (gb("prefill_32k", single), gb("prefill_32k", multi)) == (
        0.991, 0.515)
