"""PyTorch port, gradient compression: ``repro_torch.train.compress``
against ``repro.train.compress`` on the same numpy gradients.

The int8 codes and the per-block scales bitwise the reference's, and the
error-feedback residual within ``ERR_ATOL`` of it, over seeds (hypothesis),
leaves whose size is not a multiple of ``BLOCK``, an all-zero block and a
bf16 leaf; the dequantized gradients; the quantization bound; error
feedback's bias test (the mean of the dequantized gradients over steps
reaches the true mean) step for step against the reference; and
``compression_ratio``.
"""

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

from repro.train import compress as jcompress
from repro_torch.convert import qgrads_from_arrays
from repro_torch.train import compress

jax.config.update("jax_platform_name", "cpu")

ERR_ATOL = 1e-7
#: leaf shapes: one block, ragged sizes (300, 7 x 13, 513), a 2-D leaf of
#: several blocks
SHAPES = {"w": (300,), "b": (7, 13), "one": (256,), "odd": (513,),
          "m": (40, 33)}


def np_grads(seed):
    """Normal gradients at a per-leaf scale, and an all-zero leaf, whose
    blocks' scale is the 1e-12 floor."""
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * rng.uniform(1e-4, 1e2))
         .astype(np.float32) for k, s in SHAPES.items()}
    g["zero"] = np.zeros((3, 200), np.float32)
    return g


def both(tree, dtype=np.float32):
    jd = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {np.float32: torch.float32, "bf16": torch.bfloat16}[dtype]
    return ({k: jnp.asarray(v, jd) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(td) for k, v in tree.items()})


def assert_codes_equal(tq, jq):
    got = qgrads_from_arrays(jax.tree.map(np.asarray, jq), device="cpu")
    assert sorted(got) == sorted(tq)
    for k in tq:
        assert tq[k].q.dtype == torch.int8
        assert tq[k].scale.dtype == torch.float32
        assert torch.equal(tq[k].q, got[k].q), k
        assert torch.equal(tq[k].scale, got[k].scale), k


def err_diff(tef, jef) -> float:
    return max(float(np.abs(tef[k].to(torch.float32).numpy()
                            - np.asarray(jef[k], np.float32)).max())
               for k in tef)


@hypothesis.given(st.integers(0, 2 ** 16))
@hypothesis.settings(max_examples=10, deadline=None)
def test_codes_scales_and_error_equal_the_reference(seed):
    jg, tg = both(np_grads(seed))
    jq, jef = jcompress.compress_grads(jg, jcompress.init_error_feedback(jg))
    tq, tef = compress.compress_grads(tg, compress.init_error_feedback(tg))
    assert_codes_equal(tq, jq)
    assert err_diff(tef, jef) <= ERR_ATOL
    # with a carried error: the second round quantizes g + ef
    jq2, jef2 = jcompress.compress_grads(jg, jef)
    tq2, tef2 = compress.compress_grads(tg, tef)
    assert_codes_equal(tq2, jq2)
    assert err_diff(tef2, jef2) <= ERR_ATOL


def test_bf16_leaf_keeps_its_dtype():
    jg, tg = both({"a": np.random.default_rng(1).standard_normal(
        (3, 100)).astype(np.float32)}, "bf16")
    jq, jef = jcompress.compress_grads(jg, jcompress.init_error_feedback(jg))
    tq, tef = compress.compress_grads(tg, compress.init_error_feedback(tg))
    assert tef["a"].dtype == torch.bfloat16
    assert_codes_equal(tq, jq)
    assert err_diff(tef, jef) <= ERR_ATOL
    deq = compress.decompress_grads(tq, tg)
    assert deq["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        deq["a"].to(torch.float32).numpy(),
        np.asarray(jcompress.decompress_grads(jq, jg)["a"], np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_decompress_and_the_quantization_bound(seed):
    """Dequantized gradients bitwise the reference's, within one step of
    the block's scale of the gradient; the residual the exact difference;
    the all-zero leaf's scale the 1e-12 floor."""
    g = np_grads(seed)
    jg, tg = both(g)
    jq, _ = jcompress.compress_grads(jg, jcompress.init_error_feedback(jg))
    tq, tef = compress.compress_grads(tg, compress.init_error_feedback(tg))
    deq = compress.decompress_grads(tq, tg)
    jdeq = jcompress.decompress_grads(jq, jg)
    for k, v in g.items():
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
        assert tuple(deq[k].shape) == v.shape
        assert float(np.abs(deq[k].numpy() - v).max()) <= \
            float(np.abs(v).max()) / 127.0 + 1e-6
        np.testing.assert_allclose(tef[k].numpy(), v - deq[k].numpy(),
                                   atol=1e-6)
    assert torch.all(tq["zero"].scale == torch.tensor(1e-12))
    assert tq["odd"].q.shape == (3, compress.BLOCK)


def test_error_feedback_reduces_bias():
    """The mean of the dequantized gradients over 50 steps reaches the
    true mean (the residual re-injected), step for step the reference's."""
    g = {"w": np.full((64,), 0.101, np.float32)}
    jg, tg = both(g)
    jef, tef = jcompress.init_error_feedback(jg), \
        compress.init_error_feedback(tg)
    total = torch.zeros(64)
    for _ in range(50):
        jq, jef = jcompress.compress_grads(jg, jef)
        tq, tef = compress.compress_grads(tg, tef)
        assert_codes_equal(tq, jq)
        total = total + compress.decompress_grads(tq, tg)["w"]
    np.testing.assert_allclose((total / 50).numpy(), 0.101, rtol=1e-3)
    assert err_diff(tef, jef) <= ERR_ATOL


def test_compression_ratio_equals_the_reference():
    for tree in ({"w": np.zeros((10000,), np.float32)}, np_grads(3)):
        jg, tg = both(tree)
        assert compress.compression_ratio(tg) == \
            jcompress.compression_ratio(jg)
    assert 0.25 <= compress.compression_ratio(
        {"w": torch.zeros(10000)}) <= 0.30
