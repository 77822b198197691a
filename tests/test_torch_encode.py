"""PyTorch port, the fragment encoders and the cosine classifier held
against the JAX package's Pallas kernels (interpret mode) on the CPU: the
plain versions the wrappers run on CPU tensors, at the JAX kernel tests'
shapes. Hypervectors within 1e-4 absolute, scores within ``SCORE_ATOL``;
bf16 operands within the JAX tests' bf16 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, t
from repro.core import encoding as jenc
from repro.kernels import hdc_encode as jk_enc
from repro.kernels import ops as jops
from repro.kernels import similarity as jk_sim
from repro.kernels.hdc_encode_perm import hdc_encode_perm as j_perm
from repro_torch.convert import fragment_model_from_arrays
from repro_torch.core import encoding as tenc
from repro_torch.core import fragment_model as tfm
from repro_torch.kernels import _build
from repro_torch.kernels import hdc_encode as tk_enc
from repro_torch.kernels import hdc_encode_perm as tk_perm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import similarity as tk_sim

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

#: hypervector tolerance (float32 projections of unit rows)
HV_ATOL = 1e-4
#: the JAX kernel tests' bf16 tolerance (tests/test_kernels.py)
BF16_TOL = 5e-2


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=atol)


def unit_rows(rng, n, k):
    x = rng.standard_normal((n, k)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def dense_inputs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    return (unit_rows(rng, n, k),
            rng.standard_normal((k, d)).astype(np.float32),
            rng.uniform(0, 2 * np.pi, d).astype(np.float32))


# ---------------------------------------------------------------------------
# hdc_encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonlin", ["rff", "linear"])
@pytest.mark.parametrize("shape", [(16, 64, 256), (7, 1000, 513),
                                   (1, 9, 2048)])
def test_hdc_encode_matches_jax_kernel(shape, nonlin):
    x, B, b = dense_inputs(1, *shape)
    want = jk_enc.hdc_encode(jnp.asarray(x), jnp.asarray(B), jnp.asarray(b),
                             nonlinearity=nonlin, interpret=True,
                             block_n=32, block_d=256, block_k=128)
    got = tk_enc.hdc_encode(t(x), t(B), t(b), nonlinearity=nonlin)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got, want, HV_ATOL)


def test_hdc_encode_bf16_matches_jax_kernel():
    x, B, b = dense_inputs(2, 16, 64, 256)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jB = jnp.asarray(B).astype(jnp.bfloat16)
    want = jk_enc.hdc_encode(jx, jB, jnp.asarray(b), interpret=True,
                             block_n=32, block_d=256, block_k=128)
    got = tk_enc.hdc_encode(t(x).to(torch.bfloat16), t(B).to(torch.bfloat16),
                            t(b))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got.to(torch.float32), np.asarray(want, np.float32), BF16_TOL)


def test_ops_hdc_encode_normalizes_and_flattens_like_jax():
    rng = np.random.default_rng(3)
    frags = rng.uniform(0, 1.5, (10, 4, 4)).astype(np.float32)
    B = rng.standard_normal((16, 128)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, 128).astype(np.float32)
    want = jops.hdc_encode(jnp.asarray(frags), jnp.asarray(B),
                           jnp.asarray(b))
    close(tops.hdc_encode(t(frags), t(B), t(b)), want, HV_ATOL)
    # the jnp training-path encoder computes the same function
    close(tops.hdc_encode(t(frags), t(B), t(b)),
          jenc.encode_fragments(jnp.asarray(frags), jnp.asarray(B),
                                jnp.asarray(b)), HV_ATOL)


# ---------------------------------------------------------------------------
# hdc_encode_perm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonlin", ["rff", "linear", "sign"])
@pytest.mark.parametrize("shape", [(10, 4, 8, 128, 16, 64),
                                   (7, 3, 5, 90, 15, 45)])
def test_hdc_encode_perm_matches_jax_kernel(shape, nonlin):
    n, h, w, dim, bk, bd = shape
    rng = np.random.default_rng(4)
    B0 = rng.standard_normal((h, dim)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, dim).astype(np.float32)
    x = unit_rows(rng, n, h * w)
    want = np.asarray(j_perm(jnp.asarray(x), jnp.asarray(B0), jnp.asarray(b),
                             h=h, w=w, nonlinearity=nonlin, block_n=8,
                             block_d=bd, block_k=bk, interpret=True))
    got = tk_perm.hdc_encode_perm(t(x), t(B0), t(b), h=h, w=w,
                                  nonlinearity=nonlin).numpy()
    assert got.shape == want.shape == (n, dim)
    if nonlin == "sign":
        # compare only where the projection is clear of 0
        proj = x.astype(np.float64) @ np.asarray(
            jenc.flat_perm_base(jnp.asarray(B0), w), np.float64)
        keep = np.abs(proj) > 1e-4
        assert keep.mean() > 0.99
        got, want = got[keep], want[keep]
    close(got, want, HV_ATOL)


def test_hdc_encode_perm_equals_encode_on_expanded_base():
    rng = np.random.default_rng(5)
    h, w, dim = 3, 5, 97  # D prime: no tiling of the reference divides it
    B0 = t(rng.standard_normal((h, dim)).astype(np.float32))
    b = t(rng.uniform(0, 2 * np.pi, dim).astype(np.float32))
    x = t(unit_rows(rng, 6, h * w))
    from repro_torch.core.encoding import flat_perm_base
    close(tk_perm.hdc_encode_perm(x, B0, b, h=h, w=w),
          tk_enc.hdc_encode(x, flat_perm_base(B0, w), b), 1e-6)
    with pytest.raises(ValueError, match="B0 must be"):
        tk_perm.hdc_encode_perm(x, B0, b, h=h + 1, w=w)
    with pytest.raises(ValueError, match="encode takes"):
        tk_perm.hdc_encode_perm(x, B0, b, h=h, w=w + 1)


# ---------------------------------------------------------------------------
# the CUDA encoders' numeric design (csrc/encode_common.cuh), emulated: each
# operand v is split into big = tf32(v) and small = tf32(v - big), and every
# 32-deep K step sums big*small + small*big + big*big (exact products of
# TF32 values, as the tensor cores take them) into a partial that joins a
# float32 accumulator with one float32 add
# ---------------------------------------------------------------------------

def tf32_rna(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by integer bit masking: the bits of cvt.rna.tf32.f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_encode_projection(x, B, *, split, step=32):
    """``x @ B`` as the kernel sums it, with the 3xTF32 split or (``split``
    False) one TF32 product."""
    xb, Bb = tf32_rna(x), tf32_rna(B)
    xs, Bs = tf32_rna(x - xb), tf32_rna(B - Bb)
    acc = torch.zeros((x.shape[0], B.shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], step):
        k = slice(k0, k0 + step)
        big = xb[:, k].double() @ Bb[k].double()
        part = (xb[:, k].double() @ Bs[k].double()
                + xs[:, k].double() @ Bb[k].double() + big) if split else big
        acc = acc + part.float()
    return acc


@pytest.fixture(scope="module")
def paper_depth_encode():
    """64 fragments of the paper's 96 x 96 (K = 9216) against a (9216, 512)
    base: the port's unit-norm rows and the JAX ``encode_fragments``."""
    rng = np.random.default_rng(9)
    frags = rng.uniform(0, 1.5, (64, 96, 96)).astype(np.float32)
    B = rng.standard_normal((96 * 96, 512)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, 512).astype(np.float32)
    want = jenc.encode_fragments(jnp.asarray(frags), jnp.asarray(B),
                                 jnp.asarray(b))
    x = tenc.normalize_flat(t(frags).reshape(64, -1))
    return x, t(B), t(b), np.asarray(want)


def test_tf32_split_encode_matches_jax_at_paper_depth(paper_depth_encode):
    x, B, b, want = paper_depth_encode
    got = tenc.apply_nonlinearity(
        tf32_encode_projection(x, B, split=True), b, "rff")
    close(got, want, HV_ATOL)


def test_single_tf32_product_misses_hv_tolerance(paper_depth_encode):
    """Why the split exists: one TF32 product keeps 10 mantissa bits and
    lands outside the hypervector tolerance at K = 9216."""
    x, B, b, want = paper_depth_encode
    got = tenc.apply_nonlinearity(
        tf32_encode_projection(x, B, split=False), b, "rff").numpy()
    assert np.abs(got - want).max() > 5 * HV_ATOL


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(50, 300, 2), (3, 5000, 4),
                                   (257, 129, 3), (40, 300, 9),
                                   (9, 130, 17)])
def test_similarity_matches_jax_kernel(shape):
    n, d, c = shape
    rng = np.random.default_rng(6)
    q = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((c, d)).astype(np.float32)
    want = jk_sim.similarity(jnp.asarray(q), jnp.asarray(C), interpret=True)
    got = tk_sim.similarity(t(q), t(C))
    assert got.shape == want.shape == (n, c)
    close(got, want, SCORE_ATOL)
    close(tops.similarity(t(q), t(C)),
          jops.similarity(jnp.asarray(q), jnp.asarray(C)), SCORE_ATOL)


def test_similarity_clamps_zero_rows_like_jax():
    q = np.zeros((2, 16), np.float32)
    q[1] = 1.0
    C = np.ones((2, 16), np.float32)
    C[0] = 0.0
    want = jk_sim.similarity(jnp.asarray(q), jnp.asarray(C), interpret=True)
    close(tk_sim.similarity(t(q), t(C)), want, SCORE_ATOL)
    with pytest.raises(ValueError, match="similarity takes"):
        tk_sim.similarity(t(q), t(C[:, :8]))


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_count_a_launch():
    before = (tk_enc.LAUNCHES, tk_perm.LAUNCHES, tk_sim.LAUNCHES)
    x, B, b = dense_inputs(7, 4, 16, 32)
    tk_enc.hdc_encode(t(x), t(B), t(b))
    tops.hdc_encode(t(x), t(B), t(b))
    tk_perm.hdc_encode_perm(t(x), t(B[:4]), t(b), h=4, w=4)
    tk_sim.similarity(t(x), t(x[:2]))
    tfm.positive_score(t(x[:2]), t(x))
    assert (tk_enc.LAUNCHES, tk_perm.LAUNCHES, tk_sim.LAUNCHES) == before


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_default_device_is_cuda_and_never_falls_back(no_cuda):
    for name in ("similarity", "hdc_encode", "hdc_encode_perm"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name)
    x, B, b = dense_inputs(8, 4, 16, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fragment_model_from_arrays(x[:2], B, b)
    frags = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.train_fragment_model(torch.Generator(), frags, np.arange(4) % 2,
                                 dim=32)
    # a tensor on neither the CPU nor the card is refused, not computed on
    # the CPU
    meta = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk_enc.hdc_encode(meta, t(B).to("meta"), t(b).to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk_sim.similarity(meta, meta[:2])
    # operands on two devices are refused before any launch
    with pytest.raises(ValueError, match="base on meta"):
        tk_enc.hdc_encode(t(x), t(B).to("meta"), t(b))
