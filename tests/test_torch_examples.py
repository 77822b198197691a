"""PyTorch port, the port-side examples: ``examples/*_torch.py``, each the
twin of the reference's example of the same name, run on the CPU with
small arguments in a subprocess (``--device cpu``):

* ``fault_tolerance_demo_torch.py``: its three phases, the relaunch
  resumed at step 6 and finished at 10, the elastic restore's blocks on
  a one-rank mesh the checkpoint's;
* ``train_backbone_torch.py`` on the smoke config: the run's last
  checkpoint at its last step, a relaunch resumed there;
* ``serve_backbone_torch.py``: its requests served, two runs equal;
* without ``--device`` each refuses to run off the card, and none
  imports JAX or the reference.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.ckpt import checkpoint as tckpt
from test_torch_core import _imported_modules

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["fault_tolerance_demo_torch", "train_backbone_torch",
            "serve_backbone_torch"]


def run_example(name, *args):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"))


def test_fault_tolerance_demo():
    out = run_example("fault_tolerance_demo_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "[demo] latest checkpoint: step 6" in lines
    assert "[train] resumed from step 6" in lines
    assert "[demo] resumed and finished at step 10" in lines
    assert any(ln.startswith("[demo] elastic restore ok (step 10) onto a "
                             "(1, 1) mesh") for ln in lines), out.stdout


def test_train_backbone(tmp_path):
    args = ["--device", "cpu", "--smoke", "--steps", "12", "--batch", "2",
            "--seq", "16", "--ckpt-dir", os.fspath(tmp_path)]
    out = run_example("train_backbone_torch", *args)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("params: ")
    assert "loss: first " in out.stdout.splitlines()[-1]
    assert tckpt.latest_step(os.fspath(tmp_path)) == 12
    again = run_example("train_backbone_torch", *args[:4], "24",
                        *args[5:])
    assert again.returncode == 0, again.stdout + again.stderr
    assert "[train] resumed from step 12" in again.stdout
    assert tckpt.latest_step(os.fspath(tmp_path)) == 24


def test_serve_backbone():
    out = run_example("serve_backbone_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("served 4 requests, 24 new tokens each")
    assert lines[1].startswith("first request tokens: [")
    assert lines[-1] == "determinism check passed"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_by_default(name):
    """Without ``--device`` an example runs on CUDA and, with no card
    there, fails rather than falling back to the CPU; its imports are
    the port's."""
    for mod in _imported_modules(ROOT / "examples" / f"{name}.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = run_example(name)
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr
