"""PyTorch port: the process-wide matmul flags stay the caller's.

``pin_fp32_matmul`` and ``pin_detector_matmul`` are scopes: inside them
float32 products run without TF32 (and, for the detector, bf16 products
reduce in float32); on exit, exceptions included, ``allow_tf32`` and
``allow_bf16_reduced_precision_reduction`` are what the caller had. The
flags can be set on a CPU build of torch, so each pinned entry of the port
is called here with both flags preset to ``True``: every product it runs
sees them pinned (a ``TorchFunctionMode`` records the flags at each matmul),
and after the call, returned or raised, both are ``True`` again.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _torch_parity import FRAG, STRIDE, frames, model_arrays, t
from repro_torch import configs, pin_detector_matmul, pin_fp32_matmul
from repro_torch.core import encoding, fragment_model, hdc
from repro_torch.kernels import hdc_encode as enc
from repro_torch.kernels import ref
from repro_torch.kernels import similarity as sim
from repro_torch.kernels import sliding_scores as ss
from repro_torch.kernels import sliding_scores_int as ssi
from repro_torch.launch import steps
from repro_torch.models import lm

torch.set_num_threads(2)

MATMUL = torch.backends.cuda.matmul
PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum}


def flags():
    return (MATMUL.allow_tf32, MATMUL.allow_bf16_reduced_precision_reduction)


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
    """Both flags preset to True (not their defaults), as a caller that
    asked for TF32 and reduced bf16 reductions; restored afterwards."""
    before = flags()
    MATMUL.allow_tf32 = True
    MATMUL.allow_bf16_reduced_precision_reduction = True
    yield
    MATMUL.allow_tf32, MATMUL.allow_bf16_reduced_precision_reduction = before


def call_pinned(fn, *, detector: bool = False):
    """Run ``fn`` under the spy; every product must see the pinned flags,
    and the caller's come back."""
    with FlagsAtProducts() as spy:
        out = fn()
    assert spy.seen, "no product ran"
    for tf32, bf16 in spy.seen:
        assert tf32 is False
        if detector:
            assert bf16 is False
    assert flags() == (True, True)
    return out


def test_scopes_restore_on_exit_and_on_error(caller_flags):
    with pin_fp32_matmul():
        assert flags() == (False, True)
    assert flags() == (True, True)
    with pin_detector_matmul():
        assert flags() == (False, False)
        with pin_fp32_matmul():          # nested scopes unwind in order
            assert flags() == (False, False)
        assert flags() == (False, False)
    assert flags() == (True, True)
    for scope in (pin_fp32_matmul, pin_detector_matmul):
        with pytest.raises(ZeroDivisionError):
            with scope():
                1 / 0
        assert flags() == (True, True)
    # the defaults are kept too
    MATMUL.allow_tf32 = False
    with pin_detector_matmul():
        pass
    assert flags() == (False, True)


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
    assert flags() == (True, True)


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
    assert flags() == (True, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_pins_its_products(caller_flags, dtype):
    """``Model.forward`` called outside ``detector_step`` pins its own
    products and leaves the caller's flags as they were."""
    cfg, _, weights = _detector(dtype)
    model = lm.Model(cfg)
    x = torch.rand((1, 4, cfg.d_model),
                   generator=torch.Generator().manual_seed(3)).to(
        model.compute_dtype)
    out = call_pinned(lambda: model.forward(weights["backbone"], x),
                      detector=True)
    assert out.shape == (1, 4, cfg.vocab)
    with pytest.raises(RuntimeError):
        model.forward(weights["backbone"], x[..., :-1])   # wrong width
    assert flags() == (True, True)
