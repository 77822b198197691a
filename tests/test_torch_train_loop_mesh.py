"""PyTorch port, the train loop over a mesh: ``train(mesh=)``, the elastic
restore (``ckpt.restore(specs=, mesh=)``), the checkpoints a mesh writes
and the launcher's multi-process flags, on the CPU.

``gloo`` worlds of 1, 2 and 4 ranks, each spawned once per module
(``tests/_torch_loop_mesh_worker.py``), every rank running each mesh of
its world: (1, 1); (1, 2), (2, 1); (2, 2). The cases: the smoke olmo-1b
and internlm2-1.8b (GQA), 4 steps of 4 sequences in 2 microbatches,
float32, and the same in bf16 under remat "full" and "dots"; the weights
and batches numpy arrays (labels with masked positions) that the
reference trains on too, through its ``params=`` and an iterator of
``lm.Batch``. Held:

* the (1, 1) run bitwise the unsharded ``train``: every logged loss and
  gradient norm, the parameters, both moments and the step counter;
* every mesh against ``repro.train.loop.train``: the losses within
  ``LOSS_RTOL`` relative and the parameters within ``PARAM_RTOL`` of a
  leaf's largest |entry| in float32, within ``BF16_TOL`` in bf16;
* every rank's metrics and gathered state bitwise the same;
* preemption: SIGTERM to the last rank alone, and to every rank at its
  own step: every rank leaves ``train`` with 143 at the first signalled
  step, with one checkpoint, at that step, and no hang within the
  spawn's timeout; a relaunch on the same mesh bitwise the uninterrupted
  run; the (1, 2) checkpoint restored onto (2, 1) and onto one unsharded
  rank bitwise its leaves, each relaunch finishing within the float32
  bounds of an uninterrupted run there;
* the periodic checkpoints on a mesh: one every step, two kept, SIGTERM
  on the step after a periodic save: the directory holds the last two,
  each restored onto the mesh bitwise the state at its step, and the
  relaunch bitwise the uninterrupted run;
* ``restore(specs=, mesh=)``, the counterpart of
  ``tests/test_train_runtime.py::test_elastic_reshard_restore``: a
  checkpoint written by ``repro.ckpt`` cut onto both two-rank meshes and
  gathered back bitwise; a checkpoint the (1, 2) mesh wrote read by
  ``repro.ckpt.restore``;
* the launcher's ``--coordinator``/``--num-processes`` on ``gloo``:
  two processes sent SIGTERM (one of them), each exits 143 at one step;
  relaunched with two processes bitwise an uninterrupted two-process
  run, and with one process finishing from the same checkpoint.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_mesh_worker as LW
import _torch_mesh_worker as W
from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.models import common, lm

jax.config.update("jax_platform_name", "cpu")

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
BF16_TOL = {"loss": 1e-2, "params": 5e-2}
SPAWN_TIMEOUT = 240.0
MESHES = [LW.mesh_key(m) for ms in LW.WORLDS.values() for m in ms]
REF_CKPT_STEP = 7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The spawned ranks run single-threaded; so does the unsharded side
    (and the files after this one get their thread count back)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def sigterm_handler_kept():
    """The reference's ``train`` installs its SIGTERM handler for good:
    give the worker's back after every test."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


def np_params(spec, seed, std=0.2):
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return std * x
    return common.tree_map(one, spec, lambda x: isinstance(x, common.P))


def case_payload(case, seed):
    """The case's weights and its STEPS batches (int32 tokens; labels in
    ``[-1, vocab)``, -1 masked), as numpy."""
    cfg = LW.config(case)
    rng = np.random.default_rng(seed + 1)
    return dict(
        params=np_params(lm.Model(cfg).spec(), seed),
        batches=[(rng.integers(0, cfg.vocab, (LW.B, LW.S)).astype(np.int32),
                  rng.integers(-1, cfg.vocab, (LW.B, LW.S)).astype(np.int32))
                 for _ in range(LW.STEPS)])


def write_reference_checkpoint(d, p):
    """A ``(params, AdamWState)`` checkpoint written by ``repro.ckpt``:
    the case's weights, moments drawn, the step counter at
    REF_CKPT_STEP."""
    rng = np.random.default_rng(5)
    params = jax.tree.map(jnp.asarray, p["params"])
    state = joptim.AdamWState(
        step=jnp.int32(REF_CKPT_STEP),
        mu=jax.tree.map(lambda a: jnp.asarray(0.01 * rng.standard_normal(
            a.shape).astype(np.float32)), params),
        nu=jax.tree.map(lambda a: jnp.asarray(1e-4 * rng.random(
            a.shape).astype(np.float32)), params))
    jckpt.save(d, REF_CKPT_STEP, (params, state),
               extra={"step": REF_CKPT_STEP})
    return params, state


def reference(case, p, d):
    """``repro.train.loop.train`` on the case's weights and batches: the
    logged metrics and the final state, as numpy."""
    arch, kw = LW.CASES[case]
    jcfg = jconfigs.get_smoke(arch).replace(**kw)
    seen = []
    out = jloop.train(
        jlm.build(jcfg),
        iter([jlm.Batch(jnp.asarray(t), jnp.asarray(lab), None)
              for t, lab in p["batches"]]),
        jloop.TrainConfig(ckpt_dir=d, **LW.TRAIN),
        params=jax.tree.map(jnp.asarray, p["params"]),
        on_metrics=lambda s, m: seen.append((s, m["loss"], m["grad_norm"])))

    def leaves(t):
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
    return dict(metrics=seen, params=leaves(out["params"]),
                mu=leaves(out["opt_state"].mu),
                nu=leaves(out["opt_state"].nu),
                step=int(out["opt_state"].step))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks (``{mesh key: [rank results]}``, each
    ``{run: result}``), the unsharded loop's runs (``"port"``) and the
    reference's (``"jax"``), the payload and the worlds' directories."""
    payload = {c: case_payload(c, 30 + 7 * i)
               for i, c in enumerate(LW.CASES)}
    ref_dir = str(tmp_path_factory.mktemp("refckpt"))
    write_reference_checkpoint(ref_dir, payload[LW.PREEMPT_CASE])
    payload["ref_ckpt"] = ref_dir
    roots = {world: str(tmp_path_factory.mktemp(f"loop{world}"))
             for world in LW.WORLDS}
    out = {"payload": payload, "roots": roots}
    # the worlds run at once, each in its own processes, while this
    # process runs the unsharded loop and the reference
    with ThreadPoolExecutor(len(LW.WORLDS)) as pool:
        futures = {world: pool.submit(
            W.spawn, (1, world), [], payload, roots[world],
            timeout=SPAWN_TIMEOUT, target=LW._rank_main)
            for world in LW.WORLDS}
        unsharded = str(tmp_path_factory.mktemp("unsharded"))
        out["port"] = {c: LW.run(c, payload, None,
                                 os.path.join(unsharded, c))
                       for c in LW.CASES}
        jdir = str(tmp_path_factory.mktemp("jax"))
        out["jax"] = {c: reference(c, payload[c], os.path.join(jdir, c))
                      for c in LW.CASES}
        for world, fut in futures.items():
            ranks = fut.result()
            for key in ranks[0]:
                out[key] = [r[key] for r in ranks]
    return out


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def same_state(a: dict, b: dict) -> bool:
    return a["step"] == b["step"] and all(
        LW.np_leaves_equal(a[k], b[k]) for k in ("params", "mu", "nu"))


# ---------------------------------------------------------------------------
# the loop on every mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(LW.CASES))
def test_one_rank_mesh_is_bitwise_unsharded(runs, case):
    got, want = runs["1x1"][0][case], runs["port"][case]
    assert got["exit"] == want["exit"] == 0
    assert got["metrics"] == want["metrics"]
    assert got["history"] == want["history"]
    assert got["step"] == LW.STEPS
    assert same_state(got, want)


@pytest.mark.parametrize("case", list(LW.CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_against_the_reference(runs, mesh, case):
    got, want = runs[mesh][0][case], runs["jax"][case]
    bf16 = "bf16" in case
    loss_tol = BF16_TOL["loss"] if bf16 else LOSS_RTOL
    param_tol = BF16_TOL["params"] if bf16 else PARAM_RTOL
    assert [m[0] for m in got["metrics"]] == [m[0] for m in want["metrics"]]
    for (_, loss, _), (_, jloss, _) in zip(got["metrics"], want["metrics"]):
        assert abs(loss - jloss) <= loss_tol * abs(jloss)
    assert got["step"] == want["step"] == LW.STEPS
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert rel(a, b) <= param_tol


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_bitwise_the_same(runs, mesh):
    first = runs[mesh][0]
    for other in runs[mesh][1:]:
        for case in LW.CASES:
            assert other[case]["metrics"] == first[case]["metrics"]
            assert same_state(other[case], first[case])


# ---------------------------------------------------------------------------
# preemption and the elastic relaunch
# ---------------------------------------------------------------------------

FIRST_MESHES = [(world, LW.mesh_key(ms[0])) for world, ms in
                LW.WORLDS.items()]


@pytest.mark.parametrize("name", list(LW.PREEMPT))
@pytest.mark.parametrize("world,mesh", FIRST_MESHES)
def test_sigterm_stops_every_rank_at_one_step(runs, world, mesh, name):
    """Whichever ranks are signalled, every rank leaves with 143 after
    the first signalled step's metrics, and the directory holds one
    checkpoint, at that step."""
    for rank in runs[mesh]:
        r = rank[f"preempt-{name}"]
        assert r["exit"] == 128 + signal.SIGTERM
        assert [m[0] for m in r["metrics"]] == list(
            range(1, LW.PREEMPT_AT + 1))
        assert r["listing"] == [f"step_{LW.PREEMPT_AT:010d}"]


@pytest.mark.parametrize("world,mesh", FIRST_MESHES)
def test_relaunch_on_the_same_mesh_is_bitwise_uninterrupted(runs, world,
                                                           mesh):
    for rank in runs[mesh]:
        got, want = rank["relaunch-one"], rank[LW.PREEMPT_CASE]
        assert got["exit"] == 0
        assert got["metrics"] == want["metrics"][LW.PREEMPT_AT:]
        assert same_state(got, want)


def checkpoint_state(d, step=None) -> dict:
    """The checkpoint of ``d`` at ``step`` (the latest where None), read
    unsharded by the port."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    like = steps.input_specs(LW.config(LW.PREEMPT_CASE), ShapeConfig(
        "loop", LW.S, LW.B, "train"))[:2]
    state, extra = tckpt.restore(d, like, step=step, device="cpu")
    return dict(extra=extra, **LW.state_arrays(*state))


@pytest.mark.parametrize("world,mesh", FIRST_MESHES)
def test_periodic_checkpoints_on_a_mesh(runs, world, mesh):
    """A checkpoint every step, two kept (rank 0's clean-up), the last
    rank signalled on the step after a periodic save: every rank leaves
    with 143 there; the directory holds the last two checkpoints, the
    periodic one restored onto the mesh bitwise the state the same mesh's
    preemption checkpoint holds at that step, the preemption one bitwise
    as read unsharded; the relaunch from it bitwise the uninterrupted
    run."""
    at, root = LW.PREEMPT_AT, os.path.join(runs["roots"][world], mesh)
    want = {at: checkpoint_state(os.path.join(root, "preempt-one"), step=at),
            LW.PERIODIC_AT: checkpoint_state(os.path.join(root, "periodic"),
                                             step=LW.PERIODIC_AT)}
    for rank in runs[mesh]:
        r = rank["periodic"]
        assert r["exit"] == 128 + signal.SIGTERM
        assert [m[0] for m in r["metrics"]] == list(
            range(1, LW.PERIODIC_AT + 1))
        assert r["listing"] == [f"step_{s:010d}"
                                for s in (at, LW.PERIODIC_AT)]
        for s, got in r["restored"].items():
            assert got["extra"] == {"step": s}
            assert same_state(got, want[s])
        fin, whole = rank["relaunch-periodic"], rank[LW.PREEMPT_CASE]
        assert fin["exit"] == 0
        assert fin["metrics"] == whole["metrics"][LW.PERIODIC_AT:]
        assert same_state(fin, whole)


def test_relaunch_on_another_mesh_restores_the_checkpoint(runs):
    """The (1, 2) mesh's preemption checkpoint cut onto (2, 1): every
    rank's blocks, gathered, bitwise its leaves; the relaunch there
    finishes within the float32 bounds of (2, 1)'s uninterrupted run."""
    d = os.path.join(runs["roots"][2], "1x2", "preempt-both")
    want = checkpoint_state(d)
    assert want["extra"] == {"step": LW.PREEMPT_AT}
    for rank in runs["2x1"]:
        got = rank["restored-both"]
        assert got["extra"] == want["extra"]
        assert same_state(got, want)
        fin, whole = rank["relaunch-both"], rank[LW.PREEMPT_CASE]
        assert fin["exit"] == 0 and fin["step"] == LW.STEPS
        for (s, loss, _), (s2, loss2, _) in zip(
                fin["metrics"], whole["metrics"][LW.PREEMPT_AT:]):
            assert s == s2 and abs(loss - loss2) <= LOSS_RTOL * abs(loss2)
        for a, b in zip(fin["params"], whole["params"]):
            assert rel(a, b) <= PARAM_RTOL


def reference_read(d, step=None) -> dict:
    """The latest checkpoint of ``d``, read by ``repro.ckpt.restore``."""
    arch, kw = LW.CASES[LW.PREEMPT_CASE]
    jmodel = jlm.build(jconfigs.get_smoke(arch).replace(**kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    (p, s), extra = jckpt.restore(os.fspath(d), (
        params, joptim.AdamW().init(params)), step=step)

    def leaves(t):
        return [np.asarray(x) for x in jax.tree.leaves(t)]
    return dict(extra=extra, params=leaves(p), mu=leaves(s.mu),
                nu=leaves(s.nu), step=int(s.step))


def test_relaunch_unsharded_restores_the_mesh_checkpoint(runs, tmp_path):
    """The same checkpoint relaunched by the unsharded loop: its state
    bitwise the checkpoint's leaves as the reference reads them and as
    (2, 1) gathered them, the run finishing within the float32 bounds of
    the unsharded uninterrupted run."""
    d = tmp_path / "ck"
    shutil.copytree(os.path.join(runs["roots"][2], "1x2", "preempt-both"), d)
    got = checkpoint_state(os.fspath(d))
    assert same_state(got, reference_read(d))
    assert same_state(got, runs["2x1"][0]["restored-both"])
    fin = LW.run(LW.PREEMPT_CASE, runs["payload"], None, os.fspath(d),
                 start=LW.PREEMPT_AT)
    whole = runs["port"][LW.PREEMPT_CASE]
    assert fin["exit"] == 0 and fin["step"] == LW.STEPS
    for (s, loss, _), (s2, loss2, _) in zip(
            fin["metrics"], whole["metrics"][LW.PREEMPT_AT:]):
        assert s == s2 and abs(loss - loss2) <= LOSS_RTOL * abs(loss2)
    for a, b in zip(fin["params"], whole["params"]):
        assert rel(a, b) <= PARAM_RTOL


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_reference_checkpoint_cut_onto_a_mesh(runs, mesh):
    """``restore(specs=, mesh=)`` of a checkpoint ``repro.ckpt`` wrote:
    every rank's blocks, gathered, bitwise the arrays it saved."""
    params, state = write_reference_checkpoint(
        os.path.join(runs["roots"][2], "ref-again"),
        runs["payload"][LW.PREEMPT_CASE])
    want = dict(params=[np.asarray(x) for x in jax.tree.leaves(params)],
                mu=[np.asarray(x) for x in jax.tree.leaves(state.mu)],
                nu=[np.asarray(x) for x in jax.tree.leaves(state.nu)],
                step=REF_CKPT_STEP)
    for rank in runs[mesh]:
        got = rank["restored-ref"]
        assert got["extra"] == {"step": REF_CKPT_STEP}
        assert same_state(got, want)


def test_mesh_checkpoint_read_by_the_reference(runs):
    """The final checkpoint the (1, 2) mesh's rank 0 wrote, read by
    ``repro.ckpt.restore``: bitwise the state every rank gathered."""
    got = reference_read(os.path.join(runs["roots"][2], "1x2",
                                      LW.PREEMPT_CASE))
    assert got["extra"] == {"step": LW.STEPS}
    assert same_state(got, runs["1x2"][0][LW.PREEMPT_CASE])


# ---------------------------------------------------------------------------
# the launcher over several processes
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--batch",
          "4", "--seq", "16", "--steps", "100", "--ckpt-every", "1000"]
KILL_AT = 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, d, **kw) -> list:
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.train", *LAUNCH,
         "--ckpt-dir", os.fspath(d), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, **kw) for r in range(n)]


def finish(procs, timeout=120) -> list:
    out = []
    try:
        for p in procs:
            out.append((p.communicate(timeout=timeout)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def preempt_and_relaunch(root) -> dict:
    """Two launcher processes in ``root/ck`` beside two uninterrupted ones
    in ``root/whole``; rank 1 of the first pair sent SIGTERM on rank 0's
    ``step 10/`` line; then two processes relaunched in ``ck`` and one
    from a copy of its checkpoint in ``root/one``: each run's outputs and
    exit codes, rank 0's lines of the preempted run and the checkpoint
    directory's listing after it."""
    ck = root / "ck"
    procs = launch(2, ck)
    uninterrupted = launch(2, root / "whole")
    lines = []
    for line in procs[0].stdout:
        lines.append(line.rstrip())
        if line.startswith(f"[train] step {KILL_AT}/"):
            procs[1].send_signal(signal.SIGTERM)
            break
    out = {"preempted": finish(procs)}
    out["lines"] = lines + out["preempted"][0][0].splitlines()
    out["listing"] = sorted(os.listdir(ck))
    shutil.copytree(ck, root / "one")
    again, alone = launch(2, ck), launch(1, root / "one")
    out.update(again=finish(again), alone=finish(alone),
               uninterrupted=finish(uninterrupted))
    return out


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """:func:`preempt_and_relaunch` on a thread from the module's start,
    beside the worlds: its result or its error, and its directory."""
    root = tmp_path_factory.mktemp("launcher")
    box = {"root": root}

    def work():
        try:
            box["out"] = preempt_and_relaunch(root)
        except BaseException as e:          # noqa: BLE001 - raised below
            box["error"] = e
    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    yield lambda: (thread.join(timeout=600), box)[1]
    thread.join(timeout=600)


def test_launcher_over_processes_preempted_and_relaunched(launched):
    """Two processes on ``gloo``, rank 1 sent SIGTERM on rank 0's ``step
    10/`` line: both exit 143 with one checkpoint at one step; relaunched
    with two processes, the last checkpoint bitwise an uninterrupted
    two-process run's; relaunched with one, finishing at step 100."""
    box = launched()
    assert "error" not in box, box.get("error")
    out, root = box["out"], box["root"]
    rest = out["preempted"]
    assert [rc for _, rc in rest] == [128 + signal.SIGTERM] * 2, \
        "\n".join(out["lines"] + rest[1][0].splitlines())
    saved = [int(ln.rsplit(" ", 1)[1]) for ln in out["lines"]
             if ln.startswith("[train] preemption checkpoint at step")]
    assert len(saved) == 1 and KILL_AT <= saved[0] < 100
    assert out["listing"] == [f"step_{saved[0]:010d}"]
    again, alone = out["again"], out["alone"]
    for text, rc in again + alone + out["uninterrupted"]:
        assert rc == 0, text
    assert f"[train] resumed from step {saved[0]}" in again[0][0]
    assert "done at step 100" in again[0][0] and "done" not in again[1][0]
    assert f"[train] resumed from step {saved[0]}" in alone[0][0]
    assert "done at step 100" in alone[0][0]
    (sa, ea, a), (sb, eb, b) = (
        (tckpt.latest_step(os.fspath(d)), *tckpt.restore_tree(os.fspath(d))
         [::-1]) for d in (root / "ck", root / "whole"))
    assert sa == sb == 100 and ea == eb == {"step": 100}
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert tckpt.latest_step(os.fspath(root / "one")) == 100
