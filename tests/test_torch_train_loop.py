"""PyTorch port, the production train loop: ``repro_torch.train.loop`` and
``repro_torch.launch.train`` against ``repro.train.loop`` and
``repro.launch.train`` on the same numpy weights and batches.

* ``make_train_step`` at 1 and 2 microbatches from a mid-run AdamW state,
  ``olmo-1b`` and ``internlm2-1.8b`` smoke weights: loss and gradient norm
  within ``LOSS_RTOL`` relative, parameters and moments within
  ``STEP_RTOL`` of each leaf's largest |entry| in float32; in bf16 the
  dense family's bf16 bounds (``BF16_LOSS_RTOL``, ``BF16_RTOL``);
* ``train`` resumed bitwise an uninterrupted run; the preemption save
  (the installed SIGTERM handler called from ``on_metrics``): exit 143, a
  checkpoint at that step, the caller's handler back;
* a reference ``train`` checkpoint resumed by the port's ``train``, and
  the reverse, each continuation within the float32 bounds of the
  resuming package's own continuation;
* ``synthetic_lm_data``: the five properties of
  ``tests/test_data_pipeline.py`` (exactly-once resume, determinism,
  shifted labels, the embeds-in stream, the VLM's image prefix);
* the launcher relaunched bitwise an uninterrupted run, its stream
  started at the checkpoint's step; the reference launcher's stream
  pinned at step 0 whatever the checkpoint (``ROADMAP.md`` §3).
"""

import os
import shutil
import signal
import sys

try:  # prefer the real library when installed (requirements-dev.txt)
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # fallback keeps these tests running without the dep
    from _hypothesis_fallback import hypothesis, st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_dense import np_batch, np_params, rel
from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch import configs
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.convert import train_state_from_arrays
from repro_torch.launch import train as launch
from repro_torch.models import common, lm
from repro_torch.train import loop, optim

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

LOSS_RTOL = 1e-5
STEP_RTOL = 1e-4
BF16_LOSS_RTOL, BF16_RTOL = 1e-2, 5e-2
MID_RUN_STEP = 2400
B, S = 4, 16
ARCHS = ["olmo-1b", "internlm2-1.8b"]


@pytest.fixture(autouse=True)
def sigterm_handler_kept():
    """The reference's ``train`` installs its SIGTERM handler for good:
    give the worker's back after every test."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


def smoke(arch, **kw):
    return (configs.get_smoke(arch).replace(**kw),
            jconfigs.get_smoke(arch).replace(**kw))


def leaves_of(result) -> list:
    """A train result's parameters and AdamW state, in checkpoint order."""
    return [t for _, t in tckpt._flatten((result["params"],
                                          result["opt_state"]))]


def assert_close(got, want, rtol):
    g, w = common.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == torch.float32 and str(b.dtype) == "float32"
        assert rel(a, b) <= rtol


# ---------------------------------------------------------------------------
# make_train_step against the reference's
# ---------------------------------------------------------------------------

def mid_run(jcfg, arrays, jb, jopt):
    """Two reference steps from the drawn weights, the step counter then
    set past the warmup: the state both packages step from."""
    jmodel = jlm.build(jcfg)
    jstep = jax.jit(jloop.make_train_step(jmodel, jopt, 1))
    jp = jax.tree.map(jnp.asarray, arrays)
    js = jopt.init(jp)
    for _ in range(2):
        jp, js, _ = jstep(jp, js, jb)
    return jp, js._replace(step=jnp.int32(MID_RUN_STEP))


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_against_the_reference(arch, micro):
    cfg, jcfg = smoke(arch)
    arrays = np_params(lm.Model(cfg).spec(), 6)
    jb, tb = np_batch(cfg, 7, B, S)
    jopt = joptim.AdamW(lr=joptim.warmup_cosine(1e-3, 10, 10_000),
                        weight_decay=0.1)
    jp, js = mid_run(jcfg, arrays, jb, jopt)
    params, state = train_state_from_arrays(
        jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js), cfg=cfg,
        device="cpu")
    want_p, want_s, want_m = jax.jit(jloop.make_train_step(
        jlm.build(jcfg), jopt, micro))(jp, js, jb)
    opt = optim.AdamW(lr=optim.warmup_cosine(1e-3, 10, 10_000),
                      weight_decay=0.1)
    got_p, got_s, m = loop.make_train_step(lm.Model(cfg), opt, micro)(
        params, state, tb)
    for k in ("loss", "grad_norm"):
        assert m[k].shape == () and m[k].dtype == torch.float32
        assert abs(float(m[k]) - float(want_m[k])) <= \
            LOSS_RTOL * abs(float(want_m[k])), k
    assert int(got_s.step) == int(want_s.step) == MID_RUN_STEP + 1
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        assert_close(got, want, STEP_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_against_the_reference(arch):
    """bf16 compute on float32 masters, 2 microbatches: the gradients of
    the masters in float32, the dense family's bf16 bounds."""
    cfg, jcfg = smoke(arch, compute_dtype="bfloat16")
    arrays = np_params(lm.Model(cfg).spec(), 8)
    jb, tb = np_batch(cfg, 9, B, S)
    jopt = joptim.AdamW(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, arrays)
    want_p, want_s, want_m = jax.jit(jloop.make_train_step(
        jlm.build(jcfg), jopt, 2))(jp, jopt.init(jp), jb)
    params, _ = train_state_from_arrays(arrays, jopt.init(arrays), cfg=cfg,
                                        device="cpu")
    opt = optim.AdamW(lr=1e-3)
    got_p, got_s, m = loop.make_train_step(lm.Model(cfg), opt, 2)(
        params, opt.init(params), tb)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(want_m[k])) <= \
            BF16_LOSS_RTOL * abs(float(want_m[k])), k
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        assert_close(got, want, BF16_RTOL)


def test_microbatched_loss_scale():
    """The reference's check (``tests/test_train_runtime.py``): at lr 0
    the loss of 1 and 2 microbatches agree within 1e-3."""
    cfg = configs.get_smoke("internlm2-1.8b")
    model = lm.Model(cfg)
    opt = optim.AdamW(lr=0.0)
    params = model.init(torch.Generator().manual_seed(0))
    batch = next(loop.synthetic_lm_data(cfg, 4, 16, device="cpu"))
    _, _, m1 = loop.make_train_step(model, opt, 1)(params, opt.init(params),
                                                   batch)
    p2, _, m2 = loop.make_train_step(model, opt, 2)(params, opt.init(params),
                                                    batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(common.leaves(p2), common.leaves(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train: resume, preemption
# ---------------------------------------------------------------------------

def port_train(tmp_path, name, steps, microbatches=1, on_metrics=None,
               warmup=10):
    cfg = configs.get_smoke("olmo-1b")
    d = tmp_path / name
    tc = loop.TrainConfig(steps=steps, ckpt_every=3, log_every=2,
                          ckpt_dir=os.fspath(d), lr=1e-3,
                          microbatches=microbatches, warmup=warmup)
    data = loop.synthetic_lm_data(cfg, 2, 16, device="cpu",
                                  start_step=tckpt.latest_step(d) or 0)
    return loop.train(lm.Model(cfg), data, tc, on_metrics=on_metrics,
                      device="cpu")


def sigterm_at(stop):
    """An ``on_metrics`` that calls the installed SIGTERM handler (the
    preemption save, then exit 143) on step ``stop``."""
    def on_metrics(step, metrics):
        if step == stop:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    return on_metrics


def test_train_resumed_is_bitwise_uninterrupted(tmp_path, capsys):
    """An 8-step run (warmup 3) preempted at step 6 and resumed with the
    same ``TrainConfig``, so the resumed steps run on the cosine part of
    the schedule: bitwise 8 uninterrupted steps."""
    with pytest.raises(SystemExit):
        port_train(tmp_path, "ck", 8, microbatches=2, warmup=3,
                   on_metrics=sigterm_at(6))
    assert tckpt.latest_step(tmp_path / "ck") == 6
    r2 = port_train(tmp_path, "ck", 8, microbatches=2, warmup=3)
    assert "[train] resumed from step 6" in capsys.readouterr().out
    r3 = port_train(tmp_path, "whole", 8, microbatches=2, warmup=3)
    assert r2["step"] == r3["step"] == 8
    assert all(torch.equal(a, b) for a, b in zip(leaves_of(r2),
                                                 leaves_of(r3)))
    assert isinstance(r2["opt_state"], optim.AdamWState)
    assert int(r2["opt_state"].step) == 8
    assert len(r3["history"]) == 5            # steps 1, 2, 4, 6, 8


def test_preemption_save_through_the_installed_handler(tmp_path, capsys):
    """SIGTERM's handler, called from ``on_metrics`` at step 4: the
    write in flight (step 3) finished, a checkpoint at step 4, exit 143,
    and the caller's handler back; a relaunch resumes at 4."""
    before = signal.getsignal(signal.SIGTERM)

    seen = []

    def preempt(step, metrics):
        seen.append(set(metrics))
        sigterm_at(4)(step, metrics)

    with pytest.raises(SystemExit) as exc:
        port_train(tmp_path, "ck", 8, on_metrics=preempt)
    assert seen and all(m == {"loss", "grad_norm"} for m in seen)
    assert exc.value.code == 128 + signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    assert tckpt.latest_step(tmp_path / "ck") == 4
    assert "[train] preemption checkpoint at step 4" in \
        capsys.readouterr().out
    port_train(tmp_path, "ck", 8)
    assert "[train] resumed from step 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a checkpoint written by one package, resumed by the other
# ---------------------------------------------------------------------------

def np_stream(cfg, n, seed=11):
    return [np_batch(cfg, seed + i, 2, 16) for i in range(n)]


def ref_train(cfg, jcfg, arrays, d, steps, batches):
    tc = jloop.TrainConfig(steps=steps, ckpt_every=3, log_every=1,
                           ckpt_dir=os.fspath(d), lr=1e-3)
    start = jckpt.latest_step(os.fspath(d)) or 0
    return jloop.train(jlm.build(jcfg), iter([b[0] for b in
                                              batches[start:]]), tc,
                       params=jax.tree.map(jnp.asarray, arrays))


def torch_train(cfg, arrays, d, steps, batches):
    tc = loop.TrainConfig(steps=steps, ckpt_every=3, log_every=1,
                          ckpt_dir=os.fspath(d), lr=1e-3)
    start = tckpt.latest_step(os.fspath(d)) or 0
    params, _ = train_state_from_arrays(arrays, joptim.AdamW().init(arrays),
                                        cfg=cfg, device="cpu")
    return loop.train(lm.Model(cfg), iter([b[1] for b in batches[start:]]),
                      tc, params=params, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumed_by_the_other_package(writer, tmp_path, capsys):
    """3 steps in the writer's ``train``, then 2 more from its checkpoint
    in the other package's and in its own: the two continuations within
    the float32 step bounds, leaf by leaf, the step counters equal."""
    cfg, jcfg = smoke("olmo-1b")
    arrays = np_params(lm.Model(cfg).spec(), 12)
    batches = np_stream(cfg, 5)
    first = tmp_path / "first"
    run = {"jax": lambda d, n: ref_train(cfg, jcfg, arrays, d, n, batches),
           "torch": lambda d, n: torch_train(cfg, arrays, d, n, batches)}
    run[writer](first, 3)
    assert tckpt.latest_step(first) == jckpt.latest_step(os.fspath(first))
    same, other = tmp_path / "same", tmp_path / "other"
    shutil.copytree(first, same)
    shutil.copytree(first, other)
    reader = "torch" if writer == "jax" else "jax"
    want = run[writer](same, 5)
    got = run[reader](other, 5)
    assert capsys.readouterr().out.count("[train] resumed from step 3") == 2
    tr, jr = (got, want) if reader == "torch" else (want, got)
    assert int(tr["opt_state"].step) == int(jr["opt_state"].step) == 5
    assert_close([tr["params"], tr["opt_state"].mu, tr["opt_state"].nu],
                 [jr["params"], jr["opt_state"].mu, jr["opt_state"].nu],
                 STEP_RTOL)


# ---------------------------------------------------------------------------
# the data stream (tests/test_data_pipeline.py's properties)
# ---------------------------------------------------------------------------

def test_synthetic_lm_data_exactly_once_resume():
    cfg = configs.get_smoke("olmo-1b")
    a = loop.synthetic_lm_data(cfg, batch=2, seq=8, device="cpu")
    batches = [next(a) for _ in range(6)]
    b = loop.synthetic_lm_data(cfg, batch=2, seq=8, start_step=3,
                               device="cpu")
    for orig, res in zip(batches[3:], [next(b) for _ in range(3)]):
        assert torch.equal(orig.tokens, res.tokens)
        assert torch.equal(orig.labels, res.labels)
    assert not torch.equal(batches[0].tokens, batches[1].tokens)


@hypothesis.given(st.integers(0, 50))
@hypothesis.settings(max_examples=8, deadline=None)
def test_synthetic_lm_data_deterministic(start):
    cfg = configs.get_smoke("internlm2-1.8b")
    ba, bb = (next(loop.synthetic_lm_data(cfg, batch=2, seq=8,
                                          start_step=start, device="cpu"))
              for _ in range(2))
    assert ba.tokens.dtype == torch.int32
    assert torch.equal(ba.tokens, bb.tokens)


def test_labels_are_shifted_tokens():
    cfg = configs.get_smoke("olmo-1b")
    batch = next(loop.synthetic_lm_data(cfg, batch=2, seq=8, device="cpu"))
    assert torch.equal(batch.labels[:, :-1], batch.tokens[:, 1:])
    assert torch.equal(batch.labels[:, -1], batch.tokens[:, 0])
    assert batch.embeds is None


def test_embeds_in_arch_stream():
    cfg = configs.get_smoke("hubert-xlarge")
    batch = next(loop.synthetic_lm_data(cfg, batch=2, seq=8, device="cpu"))
    assert batch.tokens is None
    assert tuple(batch.embeds.shape) == (2, 8, cfg.d_model)
    assert batch.embeds.dtype == torch.float32
    assert int(batch.labels.max()) < cfg.vocab


def test_vlm_stream_has_image_prefix():
    cfg = configs.get_smoke("internvl2-76b")
    batch = next(loop.synthetic_lm_data(cfg, batch=2, seq=8, device="cpu"))
    assert tuple(batch.embeds.shape) == (2, cfg.n_image_tokens, cfg.d_model)
    assert tuple(batch.tokens.shape) == (2, 8)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--batch",
          "2", "--seq", "16", "--ckpt-every", "4"]


def last_checkpoint(d):
    step = tckpt.latest_step(os.fspath(d))
    leaves, extra = tckpt.restore_tree(os.fspath(d))
    return step, extra, leaves


def test_launcher_relaunched_is_bitwise_uninterrupted(tmp_path, capsys,
                                                    monkeypatch):
    """``main`` for 14 steps preempted at step 10 (the SIGTERM handler
    called on that log step), then relaunched with the same flags: its
    steps 11-14 on the cosine part of the schedule (warmup 10), its last
    checkpoint bitwise an uninterrupted ``main``'s."""
    real_train = launch.train_loop.train

    def preempted(*args, **kw):
        return real_train(*args, on_metrics=sigterm_at(10), **kw)
    args = [*LAUNCH, "--steps", "14"]
    ck = ["--ckpt-dir", os.fspath(tmp_path / "ck")]
    with monkeypatch.context() as m:
        m.setattr(launch.train_loop, "train", preempted)
        with pytest.raises(SystemExit) as exc:
            launch.main([*args, *ck])
    assert exc.value.code == 128 + signal.SIGTERM
    assert tckpt.latest_step(tmp_path / "ck") == 10
    assert launch.main([*args, *ck]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out
    assert "done at step 14" in out
    assert launch.main([*args, "--ckpt-dir",
                        os.fspath(tmp_path / "whole")]) == 0
    (sa, ea, a), (sb, eb, b) = (last_checkpoint(tmp_path / n)
                                for n in ("ck", "whole"))
    assert sa == sb == 14 and ea == eb == {"step": 14}
    assert sorted(a) == sorted(b) and len(a) == 28
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def captured_stream(monkeypatch, module, argv):
    """The ``data`` stream and ``TrainConfig`` a launcher's ``main`` hands
    to ``train`` (replaced, so nothing trains)."""
    seen = {}

    def fake_train(model, data, tc, **kw):
        seen.update(data=data, tc=tc)
        return {"step": tc.steps, "history": []}
    monkeypatch.setattr(module.train_loop, "train", fake_train)
    if module is jlaunch:
        monkeypatch.setattr(sys, "argv", ["train", *argv])
        module.main()
    else:
        module.main(argv)
    return seen


def test_the_reference_launcher_replays_from_step_zero(tmp_path,
                                                       monkeypatch):
    """With a checkpoint at step 5, the reference's launcher still hands
    ``train`` the stream from step 0 (its batches 0, 1, ... trained again
    after the restored step 5); the port's starts at step 5."""
    d = os.fspath(tmp_path / "ck")
    jckpt.save(d, 5, {"x": np.zeros(2, np.float32)}, extra={"step": 5})
    args = ["--arch", "olmo-1b", "--smoke", "--batch", "2", "--seq", "8",
            "--steps", "8", "--ckpt-dir", d]
    ref = captured_stream(monkeypatch, jlaunch, args)
    jcfg = jconfigs.get_smoke("olmo-1b")
    first = next(ref["data"])
    np.testing.assert_array_equal(np.asarray(first.tokens), np.asarray(next(
        jloop.synthetic_lm_data(jcfg, 2, 8, start_step=0)).tokens))
    assert not np.array_equal(np.asarray(first.tokens), np.asarray(next(
        jloop.synthetic_lm_data(jcfg, 2, 8, start_step=5)).tokens))
    port = captured_stream(monkeypatch, launch, [*args, "--device", "cpu"])
    cfg = configs.get_smoke("olmo-1b")
    assert torch.equal(next(port["data"]).tokens, next(
        loop.synthetic_lm_data(cfg, 2, 8, start_step=5,
                               device="cpu")).tokens)
    assert port["tc"].ckpt_dir == ref["tc"].ckpt_dir == d
