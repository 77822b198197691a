"""PyTorch port: the process-wide matmul and cuDNN flags stay the caller's.

``pin_fp32_matmul``, ``pin_detector_matmul`` and ``pin_conv`` are scopes:
inside them float32 matmuls and cuDNN convolutions run without TF32 (for
the detector, bf16 products reduce in float32; for the baselines' convs,
cuDNN is deterministic and does not autotune); on exit, exceptions
included, ``matmul.allow_tf32``, ``allow_bf16_reduced_precision_reduction``,
``cudnn.allow_tf32``, ``cudnn.deterministic`` and ``cudnn.benchmark`` are
what the caller had. The flags can be set on a CPU build of torch, so each
pinned entry of the port is called here with the flags preset away from
what the port pins (:data:`CALLER`): every product it runs sees them
pinned (a ``TorchFunctionMode`` records the flags at each matmul, linear
and convolution), and after the call, returned or raised, they are the
caller's again.
"""

import copy

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _torch_parity import FRAG, STRIDE, frames, model_arrays, t
from repro_torch import (configs, pin_conv, pin_detector_matmul,
                         pin_fp32_matmul)
from repro_torch.core import encoding, fragment_model, hdc
from repro_torch.kernels import hdc_encode as enc
from repro_torch.kernels import ref
from repro_torch.kernels import similarity as sim
from repro_torch.kernels import sliding_scores as ss
from repro_torch.kernels import sliding_scores_int as ssi
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.sensing import baselines
from repro_torch.train import optim

torch.set_num_threads(2)

MATMUL = torch.backends.cuda.matmul
CUDNN = torch.backends.cudnn
PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum,
            torch.nn.functional.linear, torch.conv2d}
#: the caller's flags: TF32 everywhere, reduced bf16 reductions, cuDNN
#: free to autotune non-deterministic algorithms
CALLER = (True, True, True, False, True)


def flags():
    """(matmul TF32, bf16 reduced reductions, cuDNN TF32, cuDNN
    deterministic, cuDNN benchmark)."""
    return (MATMUL.allow_tf32, MATMUL.allow_bf16_reduced_precision_reduction,
            CUDNN.allow_tf32, CUDNN.deterministic, CUDNN.benchmark)


def set_flags(values):
    (MATMUL.allow_tf32, MATMUL.allow_bf16_reduced_precision_reduction,
     CUDNN.allow_tf32, CUDNN.deterministic, CUDNN.benchmark) = values


class FlagsAtProducts(TorchFunctionMode):
    """Records ``flags()`` at every matmul run inside the mode."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.seen.append(flags())
        return func(*args, **(kwargs or {}))


@pytest.fixture
def caller_flags():
    """The flags preset to :data:`CALLER` (the TF32 flags not at their
    defaults), as a caller that asked for TF32, reduced bf16 reductions
    and cuDNN autotuning; restored afterwards."""
    before = flags()
    set_flags(CALLER)
    yield
    set_flags(before)


def call_pinned(fn, *, detector: bool = False, conv: bool = False):
    """Run ``fn`` under the spy; every product must see the pinned flags,
    and the caller's come back."""
    with FlagsAtProducts() as spy:
        out = fn()
    assert spy.seen, "no product ran"
    for tf32, bf16, cudnn_tf32, deterministic, benchmark in spy.seen:
        assert tf32 is False and cudnn_tf32 is False
        if detector:
            assert bf16 is False
        if conv:
            assert deterministic is True and benchmark is False
    assert flags() == CALLER
    return out


def test_scopes_restore_on_exit_and_on_error(caller_flags):
    with pin_fp32_matmul():
        assert flags() == (False, True, False, False, True)
    assert flags() == CALLER
    with pin_detector_matmul():
        assert flags() == (False, False, False, False, True)
        with pin_fp32_matmul():          # nested scopes unwind in order
            assert flags() == (False, False, False, False, True)
        assert flags() == (False, False, False, False, True)
    assert flags() == CALLER
    with pin_conv():
        assert flags() == (False, True, False, True, False)
    assert flags() == CALLER
    for scope in (pin_fp32_matmul, pin_detector_matmul, pin_conv):
        with pytest.raises(ZeroDivisionError):
            with scope():
                1 / 0
        assert flags() == CALLER
    # the defaults are kept too
    MATMUL.allow_tf32 = False
    CUDNN.allow_tf32 = True
    with pin_detector_matmul():
        pass
    assert flags() == (False, True, True, False, True)


# ---------------------------------------------------------------------------
# the port's pinned entries
# ---------------------------------------------------------------------------

D = 128
C, B0, b = (t(a) for a in model_arrays(41, D))
FRAMES = t(frames(42, 3)[0])
Q = t(np.random.default_rng(43).standard_normal((5, D)).astype(np.float32))
X = t(np.random.default_rng(44).standard_normal((6, FRAG * FRAG))
      .astype(np.float32))
B = encoding.flat_perm_base(B0, FRAG)
KW = dict(h=FRAG, w=FRAG, stride=STRIDE)


def _float_scores():
    tiles = ss.precompute_tiles(B0, b, C, W=32, w=FRAG, stride=STRIDE,
                                block_d=128)
    return ss.fragment_scores_batch_plain(FRAMES, tiles, **KW)


def _int_scores():
    tiles = ssi.precompute_tiles_int(B0, b, C, W=32, w=FRAG, stride=STRIDE,
                                     block_d=128)
    codes = (FRAMES * 100).to(torch.uint8)
    return ssi.fragment_scores_batch_int_plain(codes, tiles, **KW)


ENTRIES = {
    "fragment_scores_batch_plain": _float_scores,
    "fragment_scores_batch_int_plain": _int_scores,
    "similarity_plain": lambda: sim.similarity_plain(Q, C),
    "ref.similarity": lambda: ref.similarity(Q, C),
    "ref.hdc_encode": lambda: ref.hdc_encode(X, B, b),
    "hdc_encode_plain": lambda: enc.hdc_encode_plain(X, B, b),
    "hdc.class_scores": lambda: hdc.class_scores(Q, C),
    "encoding.encode_fragments": lambda: encoding.encode_fragments(X, B, b),
    "fragment_model.bundle_init": lambda: fragment_model.bundle_init(
        Q, torch.tensor([0, 1, 1, 0, 1])),
    "fragment_model.train_fragment_model": lambda: (
        fragment_model.train_fragment_model(
            torch.Generator().manual_seed(0),
            np.random.default_rng(45).uniform(0, 1, (8, 4, 4)).astype(
                np.float32), np.arange(8) % 2, dim=64, epochs=2,
            device="cpu")),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_pinned_entry_keeps_caller_flags(caller_flags, name):
    call_pinned(ENTRIES[name])


RAISING = {
    # each raises inside its scope, at the product
    "hdc.class_scores": lambda: hdc.class_scores(Q, C[:, :-1]),
    "similarity_plain": lambda: sim.similarity_plain(Q, C[:, :-1]),
    "ref.hdc_encode": lambda: ref.hdc_encode(X, B[:-1], b),
    "encoding.encode_fragments": lambda: encoding.encode_fragments(
        X, B[:-1], b),
    "fragment_model.bundle_init": lambda: fragment_model.bundle_init(
        Q, torch.tensor([0, 1, 1])),
}


@pytest.mark.parametrize("name", list(RAISING))
def test_pinned_entry_restores_flags_when_it_raises(caller_flags, name):
    with pytest.raises(RuntimeError):
        RAISING[name]()
    assert flags() == CALLER


# ---------------------------------------------------------------------------
# the baselines of Table I: linear and cuDNN products in pin_conv's scope
# ---------------------------------------------------------------------------

MLP = baselines.init_mlp(torch.Generator().manual_seed(6), FRAG * FRAG,
                         hidden=16)
CONV = baselines.init_tiny_conv(torch.Generator().manual_seed(7), (4, 8))
XB = X.reshape(6, FRAG, FRAG)
YB = torch.tensor([0, 1, 1, 0, 1, 0])


def _train(model, apply_fn, labels=YB):
    return baselines.train_classifier(torch.Generator().manual_seed(8),
                                      model, apply_fn, XB, labels, epochs=2,
                                      batch_size=3)


def _step(model, apply_fn):
    opt = optim.AdamW()
    return baselines.train_step(copy.deepcopy(model), apply_fn,
                                opt, opt.init(model.tree()), XB, YB)


BASELINE_ENTRIES = {
    "mlp_apply": lambda: baselines.mlp_apply(MLP, XB),
    "tiny_conv_apply": lambda: baselines.tiny_conv_apply(CONV, XB),
    "positive_score": lambda: baselines.positive_score(
        baselines.tiny_conv_apply, CONV, XB),
    "train_step[mlp]": lambda: _step(MLP, baselines.mlp_apply),
    "train_step[tiny_conv]": lambda: _step(CONV, baselines.tiny_conv_apply),
    "train_classifier[mlp]": lambda: _train(MLP, baselines.mlp_apply),
    "train_classifier[tiny_conv]": lambda: _train(
        CONV, baselines.tiny_conv_apply),
}


@pytest.mark.parametrize("name", list(BASELINE_ENTRIES))
def test_baseline_keeps_caller_flags(caller_flags, name):
    call_pinned(BASELINE_ENTRIES[name], conv=True)


BASELINE_RAISING = {
    "mlp_apply": lambda: baselines.mlp_apply(MLP, X[:, :-1]),   # width
    "tiny_conv_apply": lambda: baselines.tiny_conv_apply(CONV, X),  # 2-D
    "train_classifier": lambda: _train(                 # label out of range
        MLP, baselines.mlp_apply, torch.tensor([0, 1, 5, 0, 1, 0])),
}


@pytest.mark.parametrize("name", list(BASELINE_RAISING))
def test_baseline_restores_flags_when_it_raises(caller_flags, name):
    with pytest.raises(RuntimeError):
        BASELINE_RAISING[name]()
    assert flags() == CALLER


def test_encode_frames_keeps_caller_flags(caller_flags):
    """The naive frame encoder's product is pinned (the reuse encoder runs
    none)."""
    call_pinned(lambda: encoding.encode_frames(
        FRAMES[:2], B0, b, reuse=False, **KW))


# ---------------------------------------------------------------------------
# the detector: detector_step and Model.forward
# ---------------------------------------------------------------------------

HW, PATCH = (16, 16), 8


def _detector(dtype="float32"):
    cfg = configs.get_smoke("hubert-xlarge").replace(compute_dtype=dtype,
                                                     n_layers=2)
    cell = steps.build_detector_cell(cfg, batch=2, frame_hw=HW, patch=PATCH)
    params = steps.init_detector_params(torch.Generator().manual_seed(1),
                                        cfg, frame_hw=HW, patch=PATCH)
    return cfg, cell, cell.prepare(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_step_keeps_caller_flags(caller_flags, dtype):
    _, cell, weights = _detector(dtype)
    blk = torch.rand((2, *HW), generator=torch.Generator().manual_seed(2))
    out = call_pinned(lambda: cell.step_fn(weights, blk), detector=True)
    assert out.shape == (2, 2)
    with pytest.raises(RuntimeError):
        cell.step_fn(weights, torch.rand((2, 15, 16)))   # not patchable
    assert flags() == CALLER


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_pins_its_products(caller_flags, dtype):
    """``Model.forward`` called outside ``detector_step`` pins its own
    products and leaves the caller's flags as they were."""
    cfg, _, weights = _detector(dtype)
    model = lm.Model(cfg)
    x = torch.rand((1, 4, cfg.d_model),
                   generator=torch.Generator().manual_seed(3)).to(
        model.compute_dtype)
    out = call_pinned(lambda: model.forward(
        weights["backbone"], lm.Batch(None, None, x)), detector=True)
    assert out.shape == (1, 4, cfg.vocab)
    with pytest.raises(RuntimeError):
        model.forward(weights["backbone"],
                      lm.Batch(None, None, x[..., :-1]))   # wrong width
    assert flags() == CALLER
