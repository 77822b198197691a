"""PyTorch port, the roofline model on the H100's figures:
``repro_torch.distributed.roofline`` against ``repro.distributed.roofline``
on the CPU.

``model_flops`` and ``active_params`` equal the reference's on every config
of the JAX registry (MoE included) at every shape kind; ``Roofline`` has
the reference's fields, properties and ``to_dict()`` keys, its terms the
H100's (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s NVLink per direction);
``CascadeService.roofline()`` unsharded is the hand count of a batch.
The sharded roofline and ``backbone_cost`` on ``gloo`` meshes are held in
``tests/test_torch_cascade_mesh.py``, which spawns each mesh once.

Also the reference difference the port does not copy (``ROADMAP.md`` §3):
on a (1, 2) mesh the JAX ``backbone_cost`` bills one device's share of
the products (a subprocess with two forced host devices: the driver's
JAX process has one).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_cascade_mesh_worker as CW
from repro import configs as jconfigs
from repro.distributed import roofline as jroofline
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import roofline

jax.config.update("jax_platform_name", "cpu")

KINDS = [jconfigs.SMOKE_SHAPE] + [s for s in jconfigs.SHAPES.values()]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_and_active_params_match_the_reference(arch):
    jcfg = jconfigs.get_config(arch)
    n_params = jcommon.spec_param_count(jlm.build(jcfg).spec())
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert roofline.active_params(cfg, n_params) == \
        jroofline.active_params(jcfg, n_params)
    if jcfg.n_experts:
        assert roofline.active_params(cfg, n_params) < n_params
    assert {s.kind for s in KINDS} == {"train", "prefill", "decode"}
    for jshape in KINDS:
        shape = ShapeConfig(**dataclasses.asdict(jshape))
        assert roofline.model_flops(cfg, shape, n_params) == \
            jroofline.model_flops(jcfg, jshape, n_params), jshape.name


def _record(mod, **kw):
    base = dict(arch="a", shape="s", mesh="2x2", chips=4, hlo_gflops=8e3,
                hlo_gbytes=4.0, coll_gbytes=0.5,
                coll_breakdown={"all-gather": 0.5}, model_gflops=6e3,
                per_device_peak_mem_gb=1.5)
    return mod.Roofline(**dict(base, **kw))


def test_roofline_keeps_the_reference_record():
    assert [f.name for f in dataclasses.fields(roofline.Roofline)] == \
        [f.name for f in dataclasses.fields(jroofline.Roofline)]
    assert set(_record(roofline).to_dict()) == \
        set(_record(jroofline).to_dict())
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == \
        (989e12, 3.35e12, 450e9)


def test_roofline_terms_on_the_h100():
    r = _record(roofline)
    t_c, t_m, t_x = 8e12 / (4 * 989e12), 4e9 / (4 * 3.35e12), 0.5e9 / 450e9
    assert (r.t_compute, r.t_memory, r.t_collective) == (t_c, t_m, t_x)
    assert r.bottleneck == "compute"
    assert r.roofline_fraction == 1.0
    assert r.useful_flop_ratio == 6e3 / 8e3
    assert r.model_roofline_fraction == pytest.approx(0.75, rel=1e-12)
    m = _record(roofline, hlo_gbytes=4e4)
    assert m.bottleneck == "memory"
    assert m.roofline_fraction == pytest.approx(t_c / (4e13 / 1.34e13),
                                                rel=1e-12)
    x = _record(roofline, coll_gbytes=1e3)
    assert x.bottleneck == "collective"
    assert x.t_collective == 1e12 / 450e9
    zero = _record(roofline, hlo_gflops=0.0, hlo_gbytes=0.0,
                   coll_gbytes=0.0)
    assert (zero.useful_flop_ratio, zero.roofline_fraction,
            zero.model_roofline_fraction) == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("batch", [1, 4])
def test_cascade_roofline_unsharded_is_the_batch_hand_count(batch):
    """``roofline()`` of the unsharded smoke cascade: one chip, "single",
    a prefill shape of the batch, a batch's FLOPs (the hand count of
    ``tests/test_torch_cascade.py``, 598,016 a frame) and bytes, no
    collective, and no device peak on the CPU."""
    from repro_torch.launch.cascade import CascadeService
    from repro_torch.launch import steps
    cfg = CW.config("smoke")
    params = steps.init_detector_params(torch.Generator().manual_seed(1),
                                        cfg, frame_hw=CW.HW, patch=CW.PATCH)
    casc = CascadeService(params, cfg, batch_size=batch, frame_hw=CW.HW,
                          patch=CW.PATCH, device="cpu")
    rl = casc.roofline()
    cost = casc.backbone_cost()
    assert isinstance(rl, roofline.Roofline)
    assert (rl.arch, rl.shape, rl.mesh, rl.chips) == (
        "hubert-xlarge", f"detector_b{batch}", "single", 1)
    assert cost.flops == 598_016
    assert rl.hlo_gflops == batch * 598_016 / 1e9
    assert rl.hlo_gbytes == batch * cost.bytes / 1e9
    assert (rl.coll_gbytes, rl.coll_breakdown, rl.per_device_peak_mem_gb,
            rl.model_gflops) == (0.0, {}, 0.0, 0.0)
    assert rl.t_compute == batch * 598_016 / 989e12
    assert rl.bottleneck == "memory"


def test_from_step_bills_the_model_flops_when_given_a_config():
    cfg = CW.config("smoke")
    shape = ShapeConfig("detector_b2", 4, 2, "prefill")
    w = {"w": torch.ones(3, 5)}
    rl = roofline.from_step(lambda w, f: f.reshape(2, 3) @ w["w"], w,
                            torch.ones(2, 3), arch="x", shape=shape,
                            mesh_name="single", chips=1, cfg=cfg,
                            n_params=1000)
    assert rl.model_gflops == 2.0 * 1000 * 8 / 1e9
    assert rl.hlo_gflops == 2 * 2 * 3 * 5 / 1e9
    assert rl.hlo_gbytes == (4 * 15 * 2 + 4 * 6 + 4 * 10) / 1e9


_REFERENCE_PROBE = """
import json
import jax
from repro import configs
from repro.launch import cascade, steps
cfg = configs.get_smoke("hubert-xlarge")
p = steps.init_detector_params(jax.random.PRNGKey(7), cfg, frame_hw=(16, 16),
                               patch=8)
out = {}
for name, mesh in (("single", None),
                   ("1x2", jax.make_mesh((1, 2), ("data", "model")))):
    c = cascade.CascadeService(p, cfg, batch_size=2, frame_hw=(16, 16),
                               patch=8, mesh=mesh)
    out[name] = c.backbone_cost().flops
print(json.dumps(out))
"""


def test_reference_backbone_cost_bills_one_device_share_on_a_mesh():
    """The JAX ``backbone_cost`` reads ``cost_analysis()``, which is one
    device's share under GSPMD: at the smoke shape (16x16 frames, patch
    8, batch 2) 96,397.5 FLOPs a frame on a (1, 2) mesh against 172,416
    unsharded (itself the ``lax.map`` undercount of ``ROADMAP.md`` §3).
    The port's count covers every rank: the unsharded hand count plus
    the embedder the second rank repeats
    (``tests/test_torch_cascade_mesh.py``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in (env.get("PYTHONPATH"),) if p])
    out = subprocess.run([sys.executable, "-c", _REFERENCE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"single": 172_416.0, "1x2": 96_397.5}
    assert np.isclose(got["1x2"] / got["single"], 0.5591, atol=1e-4)
