"""PyTorch port, the checkpoint: ``repro_torch.ckpt.checkpoint`` writes and
reads the reference's on-disk format (one ``.npy`` per leaf, the
``MANIFEST.json``, ``step_%010d`` directories, the reference's leaf
names), so a checkpoint written by either package is read bitwise by the
other; then keep-K, the orphaned ``.tmp`` cleanup, ``latest_step``, the
shape guard, the async writer's error and snapshot, and the preemption
handler."""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as tckpt

jax.config.update("jax_platform_name", "cpu")


def nested(seed):
    """A nested dict with a list, in float32, int32 and bool."""
    rng = np.random.default_rng(seed)
    return {"model": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                      "step": np.int32(seed)},
            "holds": rng.integers(-9, 9, (5,)).astype(np.int32),
            "logs": [rng.random(6) > 0.5, rng.random((2, 2)) > 0.5],
            "chvs": rng.standard_normal((2, 2, 7)).astype(np.float32)}


def flat(seed):
    """A single-level dict, as the fleet service saves."""
    rng = np.random.default_rng(seed)
    return {"class_hvs": rng.standard_normal((2, 9)).astype(np.float32),
            "holds": rng.integers(0, 4, (3,)).astype(np.int32),
            "log_gated_0": rng.random(8) > 0.5,
            "frame_idx": np.int32(12)}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def leaves_of(tree):
    return [np.asarray(x) for _, x in tckpt._flatten_with_paths(tree)]


def assert_same_leaves(a, b):
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_nested_tree_read_by_the_other_package(writer, tmp_path):
    tree = nested(3)
    d = os.fspath(tmp_path)
    if writer == "jax":
        jckpt.save(d, 7, tree, extra={"n": 1})
        got, extra = tckpt.restore(d, to_torch(nested(4)))
        assert isinstance(got["model"]["w"], torch.Tensor)
        got = jax.tree.map(lambda x: x.numpy(), got)
    else:
        tckpt.save(d, 7, to_torch(tree), extra={"n": 1})
        got, extra = jckpt.restore(d, nested(4))
    assert extra == {"n": 1}
    assert_same_leaves(got, tree)
    assert list(got) == sorted(tree) and isinstance(got["logs"], list)


def test_both_packages_write_the_same_files(tmp_path):
    """Same leaf names and the same bytes in every ``.npy``."""
    tree = nested(5)
    jd, td = os.fspath(tmp_path / "jax"), os.fspath(tmp_path / "torch")
    jckpt.save(jd, 1, tree)
    tckpt.save(td, 1, to_torch(tree))
    step = "step_0000000001"
    jman = jckpt.restore_tree(jd)[0]
    tman = tckpt.restore_tree(td)[0]
    assert sorted(jman) == sorted(tman)
    names = [n for n, _ in jckpt._flatten_with_paths(tree)]
    assert names == [n for n, _ in tckpt._flatten_with_paths(tree)]
    assert names == ["(chvs)", "(holds)", "(logs)(0)", "(logs)(1)",
                     "(model)(step)", "(model)(w)"]
    for n in names:
        with open(os.path.join(jd, step, n + ".npy"), "rb") as f:
            jb = f.read()
        with open(os.path.join(td, step, n + ".npy"), "rb") as f:
            assert f.read() == jb, n


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_flat_tree_restore_tree_both_ways(writer, tmp_path):
    tree = flat(1)
    d = os.fspath(tmp_path)
    if writer == "jax":
        jckpt.save(d, 2, tree, extra={"chunks": 2})
        leaves, extra = tckpt.restore_tree(d)
    else:
        tckpt.save(d, 2, to_torch(tree), extra={"chunks": 2})
        leaves, extra = jckpt.restore_tree(d)
    assert extra == {"chunks": 2} and sorted(leaves) == sorted(tree)
    for k, v in tree.items():
        assert leaves[k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(leaves[k], v)


def test_keep_k_and_orphaned_tmp(tmp_path):
    d = os.fspath(tmp_path)
    orphan = tmp_path / "step_0000000099.tmp"
    orphan.mkdir()
    for step in range(1, 6):
        tckpt.save(d, step, {"x": torch.full((2,), float(step))}, keep=2)
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    assert tckpt.latest_step(d) == 5
    got, _ = tckpt.restore(d, {"x": torch.zeros(2)}, step=4)
    assert torch.equal(got["x"], torch.full((2,), 4.0))


def test_latest_step_empty_or_missing(tmp_path):
    assert tckpt.latest_step(os.fspath(tmp_path / "absent")) is None
    assert tckpt.latest_step(os.fspath(tmp_path)) is None
    (tmp_path / "step_0000000003").mkdir()      # no manifest: incomplete
    assert tckpt.latest_step(os.fspath(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.restore_tree(os.fspath(tmp_path))


def test_restore_refuses_a_shape_mismatch(tmp_path):
    d = os.fspath(tmp_path)
    tckpt.save(d, 1, {"w": torch.zeros((3, 4))})
    with pytest.raises(ValueError, match=r"\(w\): ckpt"):
        tckpt.restore(d, {"w": torch.zeros((4, 3))})


def test_async_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = tckpt.AsyncCheckpointer(os.fspath(blocker / "ckpt"))
    ac.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                                   # raised once, then clear


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    d = os.fspath(tmp_path)
    src = torch.arange(6, dtype=torch.float32)
    ac = tckpt.AsyncCheckpointer(d, keep=1)
    ac.save(3, {"x": src, "n": [np.arange(3, dtype=np.int32)]},
            extra={"k": "v"})
    src.add_(100.0)                             # the next step, in place
    ac.wait()
    got, extra = tckpt.restore(d, {"x": src, "n": [np.zeros(3, np.int32)]})
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
    assert got["n"][0].dtype == torch.int32 and extra == {"k": "v"}


def test_preemption_handler_saves_then_exits():
    saved = []
    old = signal.getsignal(signal.SIGTERM)
    try:
        tckpt.install_preemption_handler(lambda: saved.append(True))
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 128 + signal.SIGTERM and saved == [True]
    finally:
        signal.signal(signal.SIGTERM, old)
