"""The port's RoPE (roar_tpu_torch/ops/rope.py) against roar_tpu/ops/rope.py on
the same numpy-seeded inputs: fp32 on both sides, elementwise arithmetic only,
so the bar is a few ulps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roar_tpu.ops import rope as jrope
from roar_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seq_len,n_elem,base,condense", [
    (32, 16, 10000.0, 1.0), (64, 8, 1000000.0, 1.0), (48, 32, 10000.0, 4.0), (1, 2, 10000.0, 8.0),
])
def test_rope_cache_equals_jax(seq_len, n_elem, base, condense):
    want = jrope.build_rope_cache(seq_len, n_elem, base=base, condense_ratio=condense)
    got = trope.build_rope_cache(seq_len, n_elem, base=base, condense_ratio=condense)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (seq_len, n_elem // 2)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 8), (1, 33, 2, 32), (3, 1, 1, 2)])
def test_apply_rope_matches_jax(b, t, h, d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, h, d)).astype(np.float32)
    cos, sin = trope.build_rope_cache(t, d)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a rotation: norms of the channel pairs are kept
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), np.linalg.norm(x, axis=-1),
                               atol=1e-5, rtol=1e-5)


def test_apply_rope_bf16_rotates_in_fp32_and_returns_bf16():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    cos, sin = trope.build_rope_cache(12, 16)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos),
                                       jnp.asarray(sin)).astype(jnp.float32))
    got = trope.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(cos),
                           torch.from_numpy(sin))
    assert got.dtype == torch.bfloat16
    # both round x to bf16, rotate in fp32 and round once more: equal bits
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_partial_rotary_offset_slice_matches_positions():
    """Rotating rows at positions 5..8 with the cache's rows 5..8 equals
    rotating the whole sequence and slicing."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 9, 2, 8)).astype(np.float32))
    cos, sin = (torch.from_numpy(a) for a in trope.build_rope_cache(9, 8))
    whole = trope.apply_rope(x, cos, sin)
    part = trope.apply_rope(x[:, 5:], cos[5:], sin[5:])
    torch.testing.assert_close(part, whole[:, 5:], atol=0, rtol=0)
