"""PyTorch port, core modules: encoding, hdc, the oracles, the ADC and the
weight conversion, each held against its JAX twin on the CPU; plus the
port's two structural rules — no JAX at run time, no hidden CPU."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FRAG, STRIDE, model_arrays, t
from repro.core import encoding as jenc
from repro.core import hdc as jhdc
from repro.kernels import ref as jref
from repro.sensing import adc as jadc
from repro_torch.convert import model_from_arrays
from repro_torch.core import encoding as tenc
from repro_torch.core import hdc as thdc
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sliding_scores as tss
from repro_torch.sensing import adc as tadc
from repro_torch.sensing.stream import StreamRunner

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-6


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rff", "linear", "sign"])
def test_nonlinearity_and_fragment_encoding(kind):
    C, B0, b = model_arrays(0, 96)
    rng = np.random.default_rng(1)
    proj = rng.standard_normal((5, 96)).astype(np.float32) * 3
    close(tenc.apply_nonlinearity(t(proj), t(b), kind),
          jenc.apply_nonlinearity(jnp.asarray(proj), jnp.asarray(b), kind))
    frags = rng.uniform(0, 1.5, (6, FRAG, FRAG)).astype(np.float32)
    close(tenc.normalize_flat(t(frags.reshape(6, -1))),
          jenc.normalize_flat(jnp.asarray(frags.reshape(6, -1))))
    Bf = np.asarray(jenc.flat_perm_base(jnp.asarray(B0), FRAG))
    for normalize in (True, False):
        close(tenc.encode_fragments(t(frags), t(Bf), t(b),
                                    nonlinearity=kind, normalize=normalize),
              jenc.encode_fragments(jnp.asarray(frags), jnp.asarray(Bf),
                                    jnp.asarray(b), nonlinearity=kind,
                                    normalize=normalize),
              atol=ATOL if normalize else 1e-5)


def test_perm_base_and_fragments_exact():
    _, B0, _ = model_arrays(2, 64)
    for w in (1, 3, FRAG):
        np.testing.assert_array_equal(
            tenc.expand_perm_base(t(B0), w).numpy(),
            np.asarray(jenc.expand_perm_base(jnp.asarray(B0), w)))
        np.testing.assert_array_equal(
            tenc.flat_perm_base(t(B0), w).numpy(),
            np.asarray(jenc.flat_perm_base(jnp.asarray(B0), w)))
    frame = np.random.default_rng(3).uniform(0, 1, (30, 27)).astype(
        np.float32)
    for h, w, s in ((8, 8, 4), (5, 7, 3), (30, 27, 1)):
        np.testing.assert_array_equal(
            tenc.extract_fragments(t(frame), h, w, s).numpy(),
            np.asarray(jenc.extract_fragments(jnp.asarray(frame), h, w, s)))
        assert tenc.num_windows(30, h, s) == jenc.num_windows(30, h, s)
    assert tenc.num_windows(4, 8, 2) == jenc.num_windows(4, 8, 2) == 0
    assert tenc.SHIFT == jenc.SHIFT == -1


@pytest.mark.parametrize("encoder", ["encode_frame_naive",
                                     "encode_frame_reuse"])
def test_frame_encoders_match_jax(encoder):
    _, B0, b = model_arrays(4, 128)
    frame = np.random.default_rng(5).uniform(0, 1.5, (24, 28)).astype(
        np.float32)
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    # the reuse encoder's prefix sums along a row carry ~W float32
    # roundings each, and the two packages associate them differently; the
    # reference's own reuse-vs-naive gap is of the same size (its tests
    # allow 3e-5), so that encoder is held at 1e-5
    atol = ATOL if encoder == "encode_frame_naive" else 1e-5
    got = getattr(tenc, encoder)(t(frame), t(B0), t(b), **kw)
    want = getattr(jenc, encoder)(jnp.asarray(frame), jnp.asarray(B0),
                                  jnp.asarray(b), **kw)
    close(got, want, atol=atol)
    # the two oracles agree with each other inside the port as well
    close(tenc.encode_frame_naive(t(frame), t(B0), t(b), **kw), got,
          atol=1e-5)


def test_make_perm_base_rows_from_generator():
    g = torch.Generator().manual_seed(7)
    B0, b = tenc.make_perm_base_rows(g, 6, 4096)
    assert B0.shape == (6, 4096) and b.shape == (4096,)
    assert B0.dtype == b.dtype == torch.float32
    assert float(b.min()) >= 0.0 and float(b.max()) < 2 * np.pi
    assert abs(float(B0.mean())) < 0.05 and abs(float(B0.std()) - 1) < 0.05
    B0_again, b_again = tenc.make_perm_base_rows(
        torch.Generator().manual_seed(7), 6, 4096)
    assert torch.equal(B0, B0_again) and torch.equal(b, b_again)


# ---------------------------------------------------------------------------
# hdc + oracles
# ---------------------------------------------------------------------------

def test_hdc_ops_match_jax():
    rng = np.random.default_rng(6)
    a, b2 = (rng.standard_normal((4, 100)).astype(np.float32)
             for _ in range(2))
    C = rng.standard_normal((2, 100)).astype(np.float32)
    ja, jb, jC = jnp.asarray(a), jnp.asarray(b2), jnp.asarray(C)
    close(thdc.bundle(t(a), t(b2), t(a)), jhdc.bundle(ja, jb, ja))
    close(thdc.bind(t(a), t(b2)), jhdc.bind(ja, jb))
    np.testing.assert_array_equal(thdc.permute(t(a), 3).numpy(),
                                  np.asarray(jhdc.permute(ja, 3)))
    close(thdc.cosine_similarity(t(a), t(b2)),
          jhdc.cosine_similarity(ja, jb))
    close(thdc.class_scores(t(a), t(C)), jhdc.class_scores(ja, jC))
    close(thdc.hamming_similarity(t(a), t(b2)),
          jhdc.hamming_similarity(ja, jb))


@pytest.mark.parametrize("kind", ["rff", "sign"])
def test_oracles_match_jax(kind):
    C, B0, b = model_arrays(8, 96)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (5, 40)).astype(np.float32)
    B = rng.standard_normal((40, 96)).astype(np.float32)
    close(tref.hdc_encode(t(x), t(B), t(b), kind),
          jref.hdc_encode(jnp.asarray(x), jnp.asarray(B), jnp.asarray(b),
                          kind), atol=1e-5)
    q = rng.standard_normal((5, 96)).astype(np.float32)
    close(tref.similarity(t(q), t(C)),
          jref.similarity(jnp.asarray(q), jnp.asarray(C)))
    frame = rng.uniform(0, 1.5, (20, 24)).astype(np.float32)
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE, nonlinearity=kind)
    close(tref.fragment_scores(t(frame), t(C), t(B0), t(b), **kw),
          jref.fragment_scores(jnp.asarray(frame), jnp.asarray(C),
                               jnp.asarray(B0), jnp.asarray(b), **kw))


# ---------------------------------------------------------------------------
# ADC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
def test_adc_codes_bitwise(bits):
    rng = np.random.default_rng(bits)
    levels = (1 << bits) - 1
    # random values plus every half-LSB rounding edge and the clip edges
    grid = (np.arange(levels + 1)[:512] + 0.5) * (jadc.V_MAX / levels)
    f = np.concatenate([rng.uniform(-0.2, 1.7, 4000), grid,
                        [0.0, jadc.V_MAX, -1.0, 9.0]]).astype(np.float32)
    f = f.reshape(1, -1)
    jf = jnp.asarray(f)
    np.testing.assert_array_equal(tadc.quantize_codes(t(f), bits).numpy(),
                                  np.asarray(jadc.quantize_codes(jf, bits)))
    np.testing.assert_array_equal(tadc.quantize(t(f), bits).numpy(),
                                  np.asarray(jadc.quantize(jf, bits)))
    codes = tadc.pack_codes(tadc.quantize_codes(t(f), bits), bits)
    assert codes.dtype == tadc.codes_dtype(bits)
    assert str(tadc.codes_dtype(bits)).split(".")[-1] == \
        np.dtype(jadc.codes_dtype(bits)).name
    np.testing.assert_array_equal(tadc.unpack_codes(codes).numpy(),
                                  tadc.quantize_codes(t(f), bits).numpy())
    # the per-frame-depth converters: the edges above at this depth, then
    # mixed depths including a skipped frame (bits 0)
    np.testing.assert_array_equal(
        tadc.quantize_codes_per_frame(t(f), t(np.array([bits]))).numpy(),
        np.asarray(jadc.quantize_codes_per_frame(jf, jnp.array([bits]))))
    fr = rng.uniform(-0.1, 1.6, (3, 5, 6)).astype(np.float32)
    depth = np.array([bits, 0, max(bits - 1, 1)], np.int32)
    np.testing.assert_array_equal(
        tadc.quantize_codes_per_frame(t(fr), t(depth)).numpy(),
        np.asarray(jadc.quantize_codes_per_frame(jnp.asarray(fr),
                                                 jnp.asarray(depth))))
    np.testing.assert_array_equal(
        tadc.quantize_per_frame(t(fr), t(depth)).numpy(),
        np.asarray(jadc.quantize_per_frame(jnp.asarray(fr),
                                           jnp.asarray(depth))))


def test_adc_nibbles_and_range_checks():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 16, (3, 4, 10)).astype(np.uint8)
    packed = tadc.pack_nibbles(t(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jadc.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(tadc.unpack_nibbles(packed).numpy(),
                                  codes.astype(np.int32))
    np.testing.assert_array_equal(
        tadc.unpack_nibbles(packed).numpy(),
        np.asarray(jadc.unpack_nibbles(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even row width"):
        tadc.pack_nibbles(t(codes[..., :9]))
    tadc.check_codes_range(t(codes), 4)
    tadc.check_codes_range(torch.zeros(0, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="outside"):
        tadc.check_codes_range(t(codes), 3)
    with pytest.raises(ValueError, match="outside"):
        tadc.check_codes_range(torch.tensor([-1, 2]), 4)
    assert tadc.lsb(4) == jadc.lsb(4)
    assert tadc.PRECISIONS == jadc.PRECISIONS
    assert tadc.INT_PRECISIONS == jadc.INT_PRECISIONS


def test_adc_noise_comes_from_the_generator():
    f = torch.full((4, 5), 0.7)
    a = tadc.adc_noise(f, 0.01, torch.Generator().manual_seed(3))
    b = tadc.adc_noise(f, 0.01, torch.Generator().manual_seed(3))
    c = tadc.adc_noise(f, 0.01, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a - f).abs().max()) < 0.1


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def test_model_from_arrays():
    C, B0, b = model_arrays(12, 64)
    m = model_from_arrays(C.astype(np.float64), B0, b, h=FRAG, w=FRAG,
                          stride=STRIDE, t_score=0.25, t_detection=1,
                          device="cpu")
    assert m.class_hvs.dtype == torch.float32 and m.device.type == "cpu"
    np.testing.assert_array_equal(m.class_hvs.numpy(), C)
    np.testing.assert_array_equal(m.B0.numpy(), B0)
    np.testing.assert_array_equal(m.b.numpy(), b)
    assert (m.h, m.w, m.stride, m.t_score, m.t_detection) == (
        FRAG, FRAG, STRIDE, 0.25, 1)
    with pytest.raises(ValueError, match="generator rows"):
        model_from_arrays(C, B0, b, h=FRAG + 1, w=FRAG, stride=STRIDE,
                          t_score=0.0, t_detection=0, device="cpu")


# ---------------------------------------------------------------------------
# structural rules of the port
# ---------------------------------------------------------------------------

def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    # the modules of every slice are among them, the newest included
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("kernels/int_expanded.py", "sensing/synthetic.py",
                   "core/gate.py", "configs/hypersense.py",
                   "launch/cascade.py", "sensing/stream.py"):
        assert f"src/repro_torch/{module}" in names, module
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_default_device_is_cuda_and_never_falls_back(no_cuda):
    C, B0, b = model_arrays(13, 64)
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE, t_score=0.0, t_detection=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_from_arrays(C, B0, b, **kw)
    model = model_from_arrays(C, B0, b, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamRunner(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("sliding_scores")
    # a tensor that is on neither the CPU nor the card is refused, not
    # quietly scored on the CPU
    tiles = tss.precompute_tiles(model.B0, model.b, model.class_hvs, W=32,
                                 w=FRAG, stride=STRIDE)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tss.fragment_scores_batch(torch.zeros((1, 32, 32), device="meta"),
                                  tiles, h=FRAG, w=FRAG, stride=STRIDE)
