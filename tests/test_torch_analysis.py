"""PyTorch port, the analysis package: ``repro_torch.analysis`` (the port's
lint and its runtime sanitizers) against its own fixtures and against
``repro.analysis`` on the same inputs.

Each RA rule gets the reference suite's three-way contract as parametrised
cases: it fires on a bad torch fixture, stays silent on the good form, and
a ``repro-lint`` waiver with a reason suppresses it. Then: the waiver
grammar, the JSON payload, the file walk and the ``REPRO_SANITIZE``
parsing equal the reference's on one corpus; the linter applied to
``src/repro_torch`` (zero unwaived findings, all 20 C entry points held);
seeded defects in copies of real port files; the CLI; the imports; and the
sanitizers around warm ``FleetService`` and ``CascadeService`` runs on the
CPU.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import linter as jlinter
from repro.analysis import sanitize as jsanitize
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis import linter as tlinter
from repro_torch.analysis import sanitize
from repro_torch.analysis.__main__ import main as cli
from repro_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

torch.set_num_threads(2)


def lint(py=None, c=None):
    return tlinter.lint_sources(py or {}, c or {})


def unwaived(findings):
    return sorted((f.rule, f.line) for f in findings if not f.waived)


def waive(text, lines, rule, marker="#"):
    """``text`` with a waiver (with a reason) at the end of ``lines``."""
    out = text.splitlines()
    for ln in set(lines):
        out[ln - 1] += "  %s repro-lint: disable=%s (deliberate, fixture)" % (marker, rule)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# RA001-RA005: Python fixtures (path, bad source, good source)
# ---------------------------------------------------------------------------

SYNC_FREE = "pkg/sensing/stream.py"
HOT = "pkg/launch/serve.py"

_ROOT = (
    "import torch\n"
    "def chunk_device_half(frames: torch.Tensor, n: int, mode: str = 'a'):\n"
    "    s = frames.sum(dim=-1)\n"
)
_CAPTURE = (
    "import random\n"
    "import time\n"
    "import numpy as np\n"
    "import torch\n"
    "def step(x: torch.Tensor):\n"
    "    y = x * 2\n"
    "{body}"
    "    return y\n"
    "def build(g, x: torch.Tensor):\n"
    "    with torch.cuda.graph(g):\n"
    "        out = step(x)\n"
    "    return out\n"
)
_HOT = (
    "import numpy as np\n"
    "import torch\n"
    "class FleetService:\n"
    "    def _scores(self) -> torch.Tensor:\n"
    "        return torch.zeros(3)\n"
    "    def dispatch(self, arrivals: dict):\n"
    "        scores = self._scores()\n"
    "{body}"
    "        return 0\n"
)


def _hot(body):
    return (HOT, _HOT.format(body=body))


PY_CASES = {
    # RA001: control flow on a tensor on a sync-free path
    "RA001-if": ("RA001",
                 (SYNC_FREE, _ROOT + "    if s.max() > 0:\n        s = s * 2\n    return s\n"),
                 (SYNC_FREE, _ROOT + "    if frames.shape[0] > n:\n        s = s[:n]\n"
                  "    if mode == 'a':\n        s = torch.where(s > 0, s, -s)\n"
                  "    if n is None:\n        return s\n    return s\n")),
    "RA001-while": ("RA001",
                    (SYNC_FREE, _ROOT + "    while s.sum() < 5:\n        s = s + 1\n    return s\n"),
                    (SYNC_FREE, _ROOT + "    k = 0\n    while k < n:\n        s = s + 1\n"
                     "        k += 1\n    return s\n")),
    "RA001-assert": ("RA001",
                     (SYNC_FREE, _ROOT + "    assert (s >= 0).all()\n    return s\n"),
                     (SYNC_FREE, _ROOT + "    assert s.ndim == 2, s.shape\n    return s\n")),
    "RA001-bool": ("RA001",
                   (SYNC_FREE, _ROOT + "    flag = bool(s.any())\n    return s, flag\n"),
                   (SYNC_FREE, _ROOT + "    flag = s.any()\n    return s, flag\n")),
    "RA001-for": ("RA001",
                  (SYNC_FREE, _ROOT + "    for row in s:\n        s = s + row\n    return s\n"),
                  (SYNC_FREE, _ROOT + "    for i in range(s.shape[0]):\n        s = s + i\n"
                   "    return s\n")),
    "RA001-helper": ("RA001",
                     (SYNC_FREE, _ROOT + "    return _fold(s)\n"
                      "def _fold(x: torch.Tensor):\n    if x.sum() > 0:\n        x = -x\n"
                      "    return x\n"),
                     (SYNC_FREE, _ROOT + "    return _fold(s)\n"
                      "def _fold(x: torch.Tensor):\n    return torch.where(x.sum() > 0, -x, x)\n")),
    # RA002: impurity frozen into a capture; global RNG anywhere
    "RA002-time": ("RA002",
                   ("pkg/m.py", _CAPTURE.format(body="    t0 = time.perf_counter()\n")),
                   ("pkg/m.py", _CAPTURE.format(body=""))),
    "RA002-print": ("RA002",
                    ("pkg/m.py", _CAPTURE.format(body="    print(y.shape)\n")),
                    ("pkg/m.py", _CAPTURE.format(body="    shape = y.shape\n"))),
    "RA002-random": ("RA002",
                     ("pkg/m.py", _CAPTURE.format(body="    y = y * random.random()\n")),
                     ("pkg/m.py", _CAPTURE.format(body="    y = y * 0.5\n"))),
    "RA002-randn": ("RA002",
                    ("pkg/m.py", "import torch\ndef f(n):\n    return torch.randn(n)\n"),
                    ("pkg/m.py", "import torch\ndef f(n, g):\n"
                     "    return torch.randn(n, generator=g)\n")),
    "RA002-inplace": ("RA002",
                      ("pkg/m.py", "import torch\ndef f(w):\n    w.normal_(0.0, 0.02)\n"),
                      ("pkg/m.py", "import torch\ndef f(w, g):\n"
                       "    w.normal_(0.0, 0.02, generator=g)\n")),
    "RA002-seed": ("RA002",
                   ("pkg/m.py", "import torch\ndef f():\n    torch.manual_seed(0)\n"),
                   ("pkg/m.py", "import torch\ndef f(dev):\n"
                    "    return torch.Generator(device=dev).manual_seed(0)\n")),
    "RA002-np-random": ("RA002",
                        ("pkg/m.py", "import numpy as np\ndef f():\n"
                         "    return np.random.rand()\n"),
                        ("pkg/m.py", "import numpy as np\ndef f(x):\n"
                         "    return np.asarray(x)\n")),
    # RA003: implicit syncs on sync-free and hot serving paths
    "RA003-item": ("RA003",
                   (SYNC_FREE, _ROOT + "    peak = s.max().item()\n    return s, peak\n"),
                   (SYNC_FREE, _ROOT + "    peak = s.max()\n    return s, peak\n")),
    "RA003-float": ("RA003",
                    (SYNC_FREE, _ROOT + "    v = float(s[0, 0])\n    return s, v\n"),
                    (SYNC_FREE, _ROOT + "    v = float(n)\n    return s, v\n")),
    "RA003-numpy": ("RA003",
                    (SYNC_FREE, _ROOT + "    import numpy as np\n"
                     "    return np.asarray(s)\n"),
                    (SYNC_FREE, _ROOT + "    import numpy as np\n"
                     "    return np.asarray(frames.shape)\n")),
    "RA003-nonzero": ("RA003",
                      (SYNC_FREE, _ROOT + "    idx = torch.nonzero(s > 0)\n    return idx\n"),
                      (SYNC_FREE, _ROOT + "    idx = torch.where(s > 0, s, 0.0)\n"
                       "    return idx\n")),
    "RA003-where": ("RA003",
                    (SYNC_FREE, _ROOT + "    idx = torch.where(s > 0)\n    return idx\n"),
                    (SYNC_FREE, _ROOT + "    idx = torch.where(s > 0, 1, 0)\n"
                     "    return idx\n")),
    "RA003-synchronize": ("RA003",
                          (SYNC_FREE, _ROOT + "    torch.cuda.synchronize()\n    return s\n"),
                          (SYNC_FREE, _ROOT + "    done = torch.cuda.Event()\n"
                           "    done.record()\n    return s, done\n")),
    "RA003-hot-item": ("RA003",
                       _hot("        x = scores.sum().item()\n"),
                       _hot("        x = scores.sum().cpu()\n")),
    "RA003-hot-stream": ("RA003",
                         _hot("        torch.cuda.current_stream().synchronize()\n"),
                         _hot("        ev = torch.cuda.Event()\n        ev.record()\n"
                              "        ev.synchronize()\n")),
    "RA003-hot-branch": ("RA003",
                         _hot("        if scores.max() > 0:\n            return 1\n"),
                         _hot("        if arrivals:\n            return 1\n")),
    "RA003-hot-tolist": ("RA003",
                         _hot("        out = scores.tolist()\n"),
                         _hot("        out = scores.to('cpu').tolist()\n")),
    # RA004: use before an asynchronous hand-off completed
    "RA004-h2d-source": ("RA004",
                         ("pkg/m.py", "def f(buf, dev, done):\n"
                          "    t = buf.to(dev, non_blocking=True)\n"
                          "    buf.zero_()\n    return t\n"),
                         ("pkg/m.py", "def f(buf, dev, done):\n"
                          "    t = buf.to(dev, non_blocking=True)\n"
                          "    done.synchronize()\n    buf.zero_()\n    return t\n")),
    "RA004-h2d-store": ("RA004",
                        ("pkg/m.py", "def f(ring, k, x, dev):\n    buf = ring[k]\n"
                         "    dev_t = buf.to(dev, non_blocking=True)\n"
                         "    buf[0] = x\n    return dev_t\n"),
                        ("pkg/m.py", "def f(ring, k, x, dev):\n    buf = ring[k]\n"
                         "    buf[0] = x\n"
                         "    dev_t = buf.to(dev, non_blocking=True)\n    return dev_t\n")),
    "RA004-d2h-read": ("RA004",
                       ("pkg/m.py", "def f(x):\n"
                        "    host = x.to('cpu', non_blocking=True)\n"
                        "    return host[0] + 1\n"),
                       ("pkg/m.py", "import torch\ndef f(x):\n"
                        "    host = x.to('cpu', non_blocking=True)\n"
                        "    ev = torch.cuda.Event()\n    ev.record()\n"
                        "    ev.synchronize()\n    return host[0] + 1\n")),
    "RA004-ring": ("RA004",
                   ("pkg/m.py", "def f(out, scores):\n"
                    "    out.copy_(scores, non_blocking=True)\n"
                    "    return out.numpy().sum()\n"),
                   ("pkg/m.py", "class _Rec:\n    pass\n"
                    "def f(out, scores, done):\n"
                    "    out.copy_(scores, non_blocking=True)\n"
                    "    done.record()\n    return _Rec(out, done)\n")),
    "RA004-collective": ("RA004",
                         ("pkg/m.py", "import torch.distributed as dist\n"
                          "def f(t, g):\n"
                          "    w = dist.all_reduce(t, group=g, async_op=True)\n"
                          "    t.add_(1)\n    w.wait()\n    return t\n"),
                         ("pkg/m.py", "import torch.distributed as dist\n"
                          "def f(t, g):\n"
                          "    w = dist.all_reduce(t, group=g, async_op=True)\n"
                          "    w.wait()\n    t.add_(1)\n    return t\n")),
    # RA005: a graph, stream, generator, pinned buffer built per call
    "RA005-loop": ("RA005",
                   ("pkg/m.py", "import torch\ndef f(n):\n    out = []\n"
                    "    for i in range(n):\n        out.append(torch.cuda.Stream())\n"
                    "    return out\n"),
                   ("pkg/m.py", "import torch\ndef f(n):\n    s = torch.cuda.Stream()\n"
                    "    return [s] * n\n")),
    "RA005-hot": ("RA005",
                  _hot("        g = torch.cuda.CUDAGraph()\n"),
                  _hot("        if self._g is None:\n"
                       "            self._g = torch.cuda.CUDAGraph()\n")),
    "RA005-hot-helper": ("RA005",
                         (HOT, _HOT.format(body="        self._side_stream()\n")
                          + "    def _side_stream(self):\n"
                          "        self._side = torch.cuda.Stream()\n"
                          "        return self._side\n"),
                         (HOT, _HOT.format(body="        self._side_stream()\n")
                          + "    def _side_stream(self):\n"
                          "        if self._side is None:\n"
                          "            self._side = torch.cuda.Stream()\n"
                          "        return self._side\n")),
    "RA005-hot-pinned": ("RA005",
                         _hot("        buf = torch.zeros(3, pin_memory=True)\n"),
                         (HOT, _HOT.format(body="        self._ring()\n")
                          + "    def _ring(self):\n"
                          "        if self._buf is not None:\n"
                          "            return self._buf\n"
                          "        self._buf = torch.zeros(3, pin_memory=True)\n"
                          "        return self._buf\n")),
    "RA005-generator": ("RA005",
                        ("pkg/m.py", "import torch\ndef f(seeds, dev):\n"
                         "    out = []\n    for s in seeds:\n"
                         "        g = torch.Generator(device=dev)\n"
                         "        out.append(g.manual_seed(s))\n    return out\n"),
                        ("pkg/m.py", "import torch\ndef f(seeds, dev):\n"
                         "    g = torch.Generator(device=dev)\n    out = []\n"
                         "    for s in seeds:\n        out.append(g.manual_seed(s).initial_seed())\n"
                         "    return out\n")),
}

@pytest.mark.parametrize("case", sorted(PY_CASES))
def test_rule_fires_on_the_bad_form(case):
    rule, (path, bad), _ = PY_CASES[case]
    assert rule in [r for r, _ in unwaived(lint({path: bad}))], case


@pytest.mark.parametrize("case", sorted(PY_CASES))
def test_rule_silent_on_the_good_form(case):
    _, _, (path, good) = PY_CASES[case]
    assert unwaived(lint({path: good})) == [], case


@pytest.mark.parametrize("case", sorted(PY_CASES))
def test_waiver_with_a_reason_suppresses_the_rule(case):
    rule, (path, bad), _ = PY_CASES[case]
    lines = [f.line for f in lint({path: bad}) if f.rule == rule]
    out = lint({path: waive(bad, lines, rule)})
    assert [f for f in out if f.rule == rule and not f.waived] == []
    assert any(f.rule == rule and f.waived for f in out)


def test_static_forms_and_code_outside_the_roots_stay_silent():
    # the same body outside every root, capture and hot path: no finding
    src = ("import torch\ndef helper(x: torch.Tensor):\n"
           "    if x.max() > 0:\n        return x.sum().item()\n    return 0.0\n")
    assert unwaived(lint({"pkg/other.py": src})) == []
    # isinstance narrowing: past `if isinstance(t, torch.Tensor): return`,
    # a `t: int | torch.Tensor` is an int
    src = (_ROOT + "    return g(s, n)\n"
           "def g(s: torch.Tensor, t: int | torch.Tensor):\n"
           "    if isinstance(t, torch.Tensor):\n        return s[t]\n"
           "    return s[:int(t)]\n")
    assert unwaived(lint({SYNC_FREE: src})) == []


def test_hot_path_rule_applies_only_to_serving_files():
    body = "        x = scores.sum().item()\n"
    assert unwaived(lint({"pkg/launch/other.py": _HOT.format(body=body)})) == []
    assert [r for r, _ in unwaived(lint({HOT: _HOT.format(body=body)}))] == ["RA003"]


# ---------------------------------------------------------------------------
# RA006: the C ABI and launch contract
# ---------------------------------------------------------------------------

BUILD = '''import ctypes
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
SIGNATURES = {
    "foo": {
        "foo_f32": (I, [P] * 2 + [I, F, P]),
        "foo_smem_bytes": (ctypes.c_size_t, []),
    },
}
'''
WRAPPER = '''def run(lib, a, b, s):
    return lib.foo_f32(a, b, 3, 1.0, s)
'''
CU = '''#include <cuda_runtime.h>
constexpr int kRows = 64;
constexpr int kSmemBytes = kRows * 256 * (int)sizeof(float);
__global__ void k(const float* x, float* y) {}
static cudaError_t allow() {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}
extern "C" {
// out = k(x): returns cudaGetLastError()
int foo_f32(const float* x, float* y, int n, float eps,
            cudaStream_t stream) {
  k<<<n, 256, kSmemBytes, stream>>>(x, y);
  return (int)cudaGetLastError();
}
size_t foo_smem_bytes() { return kSmemBytes; }
}  // extern "C"
'''
C_CASES = {
    "arity": (CU.replace("int n, float eps", "int n, int m, float eps"), WRAPPER),
    "kind": (CU.replace("int n, float eps", "float n, float eps"), WRAPPER),
    "return": (CU.replace("size_t foo_smem_bytes", "int foo_smem_bytes"), WRAPPER),
    "missing-entry": (CU.replace("foo_smem_bytes", "foo_smem"), WRAPPER),
    "call-arity": (CU, WRAPPER.replace("3, 1.0, s", "3, s")),
    "no-opt-in": (CU.replace("cudaFuncSetAttribute(k,", "cudaFuncGetAttributes(k,"),
                  WRAPPER),
    "too-much-smem": (CU.replace("kRows = 64", "kRows = 256"), WRAPPER),
}


def lint_c(cu, wrapper, build=BUILD):
    return lint({"pkg/kernels/_build.py": build, "pkg/kernels/foo.py": wrapper},
                {"pkg/kernels/csrc/foo.cu": cu})


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_ra006_fires_on_the_bad_form(case):
    assert "RA006" in [r for r, _ in unwaived(lint_c(*C_CASES[case]))]


def test_ra006_silent_on_the_good_form():
    stats = {}
    out = tlinter.lint_sources(
        {"pkg/kernels/_build.py": BUILD, "pkg/kernels/foo.py": WRAPPER},
        {"pkg/kernels/csrc/foo.cu": CU}, stats)
    assert unwaived(out) == []
    assert stats["c_entries"] == 2
    assert stats["smem_sizes"] == [("foo.cu:kSmemBytes", 65536)]
    # within the 48 KiB every block may take, no opt-in is needed
    small = CU.replace("kRows = 64", "kRows = 32").replace(
        "cudaFuncSetAttribute(k,", "cudaFuncGetAttributes(k,")
    assert unwaived(lint_c(small, WRAPPER)) == []


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_ra006_waiver_with_a_reason_suppresses_it(case):
    cu, wrapper = C_CASES[case]
    found = [f for f in lint_c(cu, wrapper) if f.rule == "RA006"]
    by_path = {}
    for f in found:
        by_path.setdefault(f.path, []).append(f.line)
    cu_w = waive(cu, by_path.get("pkg/kernels/csrc/foo.cu", []), "RA006", "//")
    wr_w = waive(wrapper, by_path.get("pkg/kernels/foo.py", []), "RA006")
    build_w = waive(BUILD, by_path.get("pkg/kernels/_build.py", []), "RA006")
    out = lint_c(cu_w, wr_w, build_w)
    assert unwaived(out) == [], case
    assert any(f.waived for f in out)


# ---------------------------------------------------------------------------
# parity with repro.analysis on the same inputs
# ---------------------------------------------------------------------------

WAIVER_CORPUS = "\n".join([
    "x = 1  # repro-lint: disable=RA003 (a plain reason)",
    "y = 2  # repro-lint: disable=RA001,RA004 (two codes, one reason)",
    "# repro-lint: disable=RA005 (a reason holding (B, H, W) stops at its first paren)",
    "z = 3  # repro-lint: disable=RA002",
    "w = 4  # repro-lint: disable=RA009 (an unknown code)",
    "v = 5  # repro-lint: disable=RA000 (RA000 cannot be waived)",
    "u = 6  # repro-lint: enable=RA001 (not a directive the grammar knows)",
    "# repro-lint: disable-file=RA006 (a file-level waiver)",
    "t = 7  # repro-lint:disable = RA003 ,RA001(tight spacing)",
    "s = 8",
])


def _waivers(mod, text):
    w = mod.parse_waivers(text)
    return w.by_line, w.file_level, w.malformed


def test_waiver_grammar_equals_the_reference():
    assert _waivers(tfindings, WAIVER_CORPUS) == _waivers(jfindings, WAIVER_CORPUS)
    by_line, _, _ = _waivers(tfindings, WAIVER_CORPUS)
    # the reference's quirk, copied on purpose: a reason ends at its first ")"
    assert by_line[3]["RA005"] == "a reason holding (B, H, W"


def test_apply_waivers_and_json_equal_the_reference():
    def run(mod):
        found = [mod.Finding(rule, "m.py", line, "msg")
                 for rule, line in [("RA003", 1), ("RA004", 2), ("RA005", 4),
                                    ("RA002", 4), ("RA006", 10), ("RA001", 10)]]
        out = mod.apply_waivers(found, mod.parse_waivers(WAIVER_CORPUS), "m.py")
        return [dataclasses.asdict(f) for f in out], json.loads(mod.findings_json(out))

    t_out, t_json = run(tfindings)
    j_out, j_json = run(jfindings)
    assert t_out == j_out
    assert set(t_json["rules"]) == set(j_json["rules"]) == {
        "RA000", "RA001", "RA002", "RA003", "RA004", "RA005", "RA006"}
    t_json.pop("rules")
    j_json.pop("rules")
    assert t_json == j_json


def test_file_walk_equals_the_reference():
    src = os.path.join(REPO, "src")
    assert tlinter._collect_files([src]) == jlinter._collect_files([src])
    one = os.path.join(PORT, "launch", "serve.py")
    assert tlinter._collect_files([one, PORT + "/x.txt"]) == \
        jlinter._collect_files([one, PORT + "/x.txt"])


@pytest.mark.parametrize("raw", ["", "0", "false", "no", "1", "true", "yes",
                                 " 1 ", "False", "off"])
def test_sanitize_enabled_equals_the_reference(raw, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", raw)
    assert sanitize.enabled() is jsanitize.enabled()


SHARED_FIXTURES = {
    "syntax-error": "def f(:\n    pass\n",
    "np-random": ("import numpy as np\n\ndef gen():\n"
                  "    return np.random.default_rng(0).normal()\n"),
    "np-random-waived": ("import numpy as np\n\ndef gen():\n"
                         "    # repro-lint: disable=RA002 (seeded host sampler)\n"
                         "    return np.random.rand()\n"),
    "bad-waiver": "x = 1  # repro-lint: disable=RA002\n",
}


@pytest.mark.parametrize("case", sorted(SHARED_FIXTURES))
def test_shared_fixtures_give_the_reference_findings(case):
    text = SHARED_FIXTURES[case]

    def key(findings):
        return sorted((f.rule, f.line, f.waived) for f in findings)

    assert key(tlinter.lint_text(text)) == key(jlinter.lint_text(text))
    assert tlinter.lint_text(text)


# ---------------------------------------------------------------------------
# self-application: the port's tree stays clean
# ---------------------------------------------------------------------------

def test_port_tree_has_zero_unwaived_findings():
    stats = {}
    findings = tlinter.lint_paths([PORT], stats)
    bad = [f.render() for f in findings if not f.waived]
    assert bad == [], "\n".join(bad)
    for f in findings:
        if f.waived:
            assert f.waiver_reason.strip(), f.render()
    # RA006 held every C entry point of SIGNATURES against its prototype
    assert stats["c_entries"] == sum(len(v) for v in _build.SIGNATURES.values()) == 20
    assert stats["c_files"] == 8
    assert dict(stats["smem_sizes"]) == {
        "sliding_scores.cu:kSmemBytes": 214400,
        "sliding_scores_int.cu:kSmemBytes": 30976,
        "encode_common.cuh:Tile<5>::kSmemBytes": 160256,
        "encode_common.cuh:Tile<4>::kSmemBytes": 143872,
        "int_expanded.cu:kSmemLimit": 232448}
    assert stats["sync_free_reachable"] > 50 and stats["capture_reachable"] >= 1


def test_port_waivers_use_only_the_shared_codes():
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            text = open(os.path.join(root, f), encoding="utf-8").read()
            w = jfindings.parse_waivers(text.replace("// repro-lint", "# repro-lint"))
            assert w.malformed == [], (f, w.malformed)


# ---------------------------------------------------------------------------
# seeded defects in copies of real port files
# ---------------------------------------------------------------------------

def _copy(rel, tmp_path):
    dst = tmp_path / "repro_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(PORT, rel), dst)
    return dst


def _seed(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    return text.replace(old, new).splitlines().index(new.splitlines()[-1]) + 1


def test_seeded_item_in_dispatch_fires_ra003(tmp_path):
    serve = _copy("launch/serve.py", tmp_path)
    assert tlinter.lint_paths([str(tmp_path)]) == []
    line = _seed(serve, "        raw = self._assemble(arrivals, codes, k)\n",
                 "        raw = self._assemble(arrivals, codes, k)\n"
                 "        peak = raw.amax().item()\n")
    assert unwaived(tlinter.lint_paths([str(tmp_path)])) == [("RA003", line)]


def test_seeded_abi_mismatch_fires_ra006(tmp_path):
    _copy("kernels/_build.py", tmp_path)
    for f in os.listdir(os.path.join(PORT, "kernels", "csrc")):
        cu = _copy("kernels/csrc/" + f, tmp_path)
    assert unwaived(tlinter.lint_paths([str(tmp_path)])) == []
    cu = tmp_path / "repro_torch" / "kernels" / "csrc" / "similarity.cu"
    line = _seed(cu, "int similarity_f32(const float* q, const float* c, float* out, int N, int D,\n",
                 "int similarity_f32(const float* q, const float* c, float* out, int N, int D,\n"
                 "                   int extra,\n")
    got = [f for f in tlinter.lint_paths([str(tmp_path)]) if not f.waived]
    assert [(f.rule, f.line) for f in got] == [("RA006", line - 1)]
    assert "similarity_f32" in got[0].message and "10 parameters" in got[0].message


def test_seeded_stream_per_tick_fires_ra005(tmp_path):
    serve = _copy("launch/serve.py", tmp_path)
    line = _seed(serve, "        if self._side is None:\n"
                 "            self._side = torch.cuda.Stream(device=self.device)\n",
                 "        self._side = torch.cuda.Stream(device=self.device)\n")
    assert unwaived(tlinter.lint_paths([str(tmp_path)])) == [("RA005", line)]


# ---------------------------------------------------------------------------
# the CLI and the imports
# ---------------------------------------------------------------------------

def test_cli_check_exits_0_on_the_tree_and_1_on_a_bad_fixture(tmp_path, capsys):
    assert cli(["--check", PORT]) == 0
    bad = tmp_path / "m.py"
    bad.write_text("import torch\ndef f(n):\n    return torch.rand(n)\n")
    assert cli(["--check", str(bad)]) == 1
    assert cli([str(bad)]) == 0
    assert "RA002" in capsys.readouterr().out


def test_cli_json_has_the_reference_payload_keys(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import torch\ndef f(n):\n    return torch.rand(n)\n")
    out = tmp_path / "t.json"
    ref = tmp_path / "j.json"
    cli(["--json", str(out), str(bad)])
    from repro.analysis.__main__ import main as jcli
    jcli(["--json", str(ref), str(bad)])
    got, want = json.loads(out.read_text()), json.loads(ref.read_text())
    assert set(got) == set(want) == {"rules", "total", "unwaived", "findings"}
    assert got["unwaived"] == 1
    assert set(got["findings"][0]) == set(dataclasses.asdict(
        jfindings.Finding("RA000", "p", 0, "m")))


def test_the_package_imports_neither_jax_nor_the_reference():
    code = ("import sys\nimport repro_torch.analysis, repro_torch.analysis.sanitize\n"
            "import repro_torch.analysis.__main__\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


# ---------------------------------------------------------------------------
# the runtime sanitizers on the CPU
# ---------------------------------------------------------------------------

DEV = torch.device("cpu")  # a torch.device: "on the card" to the CPU guard


@pytest.mark.parametrize("implicit", [
    lambda t: t.item(), lambda t: bool(t), lambda t: float(t),
    lambda t: t.tolist(), lambda t: int(t), lambda t: t.numpy(),
    lambda t: np.asarray(t), lambda t: torch.nonzero(t)],
    ids=["item", "bool", "float", "tolist", "int", "numpy", "asarray", "nonzero"])
def test_cpu_guard_raises_on_implicit_reads(implicit):
    with sanitize.no_implicit_transfers(always=True):
        t = torch.ones((), device=DEV) * 3
        with pytest.raises(RuntimeError, match="implicit host read"):
            implicit(t)
        # the explicit form is allowed, and so is host memory
        assert t.cpu().item() == 3.0
        assert torch.ones(2).sum().item() == 2.0
        assert torch.from_numpy(np.ones(2)).tolist() == [1.0, 1.0]
    assert implicit(torch.ones((), device=DEV)) is not None  # disarmed on exit


def test_cpu_guard_disarms_after_an_exception():
    with pytest.raises(ValueError):
        with sanitize.no_implicit_transfers(always=True):
            raise ValueError("boom")
    assert (torch.ones(2, device=DEV) * 2).sum().item() == 4.0


def test_guard_is_a_noop_unless_asked(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    with sanitize.no_implicit_transfers():
        assert (torch.ones(2, device=DEV) * 2).sum().item() == 4.0
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with sanitize.no_implicit_transfers():
        with pytest.raises(RuntimeError, match="implicit host read"):
            (torch.ones(2, device=DEV) * 2).sum().item()


def test_rebuild_ledger_and_steady_state():
    led = sanitize.ledger()
    before = led.events
    sanitize.note_rebuild("a fixture build")
    assert led.events == before + 1
    with sanitize.steady_state("quiet region"):
        pass
    with pytest.raises(AssertionError, match="rebuild ledger: noisy region.*a fixture"):
        with sanitize.steady_state("noisy region"):
            sanitize.note_rebuild("a fixture build")


def test_nan_check_names_the_op():
    sanitize.install_global_checks()
    try:
        assert torch.is_anomaly_enabled()
        torch.log(torch.tensor([2.0]))  # no NaN: fine
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0]))
    finally:
        sanitize.uninstall_global_checks()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


# the service and the cascade, warm, under both sanitizers

from test_torch_serve import CFG, C, port_model  # noqa: E402
from repro_torch.launch.serve import FleetService  # noqa: E402
from repro_torch.sensing import stream as stream_mod  # noqa: E402


@contextlib.contextmanager
def guards(on, what):
    """Both sanitizers around the block when ``on``."""
    with contextlib.ExitStack() as stack:
        if on:
            stack.enter_context(sanitize.steady_state(what))
            stack.enter_context(sanitize.no_implicit_transfers(always=True))
        yield


def _service(precision, n_slots=2):
    model, trace = port_model()
    kw = {"adc_bits": 8} if precision == "int8" else {}
    svc = FleetService(model, CFG, n_slots=n_slots, chunk_size=C,
                       precision=precision, device="cpu", **kw)
    if precision == "int8":
        trace = np.clip(np.abs(trace) * 8, 0, 255).astype(np.int32)
    return svc, trace


@pytest.mark.parametrize("arrivals", ["host", "tensor"])
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_warm_dispatch_is_rebuild_and_sync_clean(precision, arrivals):
    """Warm ticks — ragged, silent, host (numpy) or tensor arrivals —
    record no rebuild and read no device tensor implicitly; their results
    are the unguarded service's bitwise."""
    of = (lambda a: a) if arrivals == "host" else (lambda a: torch.tensor(a, device=DEV))

    def play(guarded):
        svc, trace = _service(precision)
        svc.attach(0)
        svc.attach(1)
        svc.dispatch({0: of(trace[0, :C]), 1: of(trace[1, :C])})  # warm-up builds
        svc.flush()
        c0 = svc.rebuild_count()
        ticks = [{0: of(trace[0, C:2 * C]), 1: of(trace[1, C:2 * C])},
                 {0: of(trace[0, 2 * C:3 * C])}, {},
                 {1: of(trace[1, 3 * C:4 * C])}]
        with guards(guarded, "warm dispatch"):
            for tick in ticks:
                svc.dispatch(tick)
            out = svc.flush()
        assert svc.rebuild_count() == c0
        return [(ch.seq, {s: tuple(np.asarray(x) for x in o)
                          for s, o in ch.outputs.items()}) for ch in out]

    got, want = play(True), play(False)
    assert len(got) == 4
    for (sg, og), (sw, ow) in zip(got, want):
        assert sg == sw and og.keys() == ow.keys()
        for sid in og:
            for a, b in zip(og[sid], ow[sid]):
                np.testing.assert_array_equal(a, b)


def test_a_new_geometry_inside_steady_state_raises():
    svc, trace = _service("float32")
    svc.attach(0)
    with pytest.raises(AssertionError, match="rebuild ledger: first tick.*FleetService"):
        with sanitize.steady_state("first tick"):
            svc.dispatch({0: trace[0, :C]})
    svc.flush()


def test_an_item_in_the_device_half_is_caught(monkeypatch):
    svc, trace = _service("float32")
    svc.attach(0)
    svc.dispatch({0: trace[0, :C]})
    svc.flush()
    half = stream_mod.chunk_device_half

    def peeking(*args, **kwargs):
        maps, scores, folded = half(*args, **kwargs)
        scores.max().item()  # a seeded sync on this tick's scores
        return maps, scores, folded

    monkeypatch.setattr(stream_mod, "chunk_device_half", peeking)
    svc.dispatch({0: trace[0, C:2 * C]})  # unguarded: runs
    with pytest.raises(RuntimeError, match=r"implicit host read: item\(\)"):
        with sanitize.no_implicit_transfers(always=True):
            svc.dispatch({0: trace[0, 2 * C:3 * C]})


from test_torch_cascade import cascade, frames_of, ref_params  # noqa: E402,F401


def test_warm_cascade_batches_are_rebuild_and_sync_clean(ref_params):  # noqa: F811
    """Post-warmup cascade batches — a ragged tail, tensor drains — record
    no rebuild and read no device tensor implicitly; their logits are the
    unguarded cascade's bitwise."""
    def play(guarded):
        casc = cascade(ref_params)
        casc.submit(0, np.arange(4), frames_of(4, seed=1))  # warm-up batch
        casc.flush()
        with guards(guarded, "warm cascade batches"):
            casc.submit(1, np.arange(4, 9), frames_of(5, seed=2))
            casc.submit(0, torch.arange(9, 12), torch.from_numpy(frames_of(3, seed=3)))
            got = casc.flush()                   # the ragged tail
        assert casc.rebuild_count() == 1
        return got

    got, want = play(True), play(False)
    assert [len(b.frame_idx) for b in got] == [4, 4] and sum(b.n_padded for b in got) == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.logits, b.logits)


def test_a_new_cascade_geometry_inside_steady_state_raises(ref_params):  # noqa: F811
    casc = cascade(ref_params)
    with pytest.raises(AssertionError, match="CascadeService step"):
        with sanitize.steady_state("first batch"):
            casc.submit(0, np.arange(4), frames_of(4, seed=1))
