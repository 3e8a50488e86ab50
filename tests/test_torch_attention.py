"""K5-fwd port: segment-masked flash attention against the JAX package.

On the CPU the port's `flash_self_attention` takes its plain version; the JAX
`MultiHeadAttn(use_flash=True)` runs its einsum path off the TPU
(roar_tpu/models/transformer.py:166), the oracle the JAX package's own flash
test uses (tests/test_fastpitch_module.py:375-403).  The CUDA kernel itself is
checked against the plain version by the `cuda`-marked test, which skips
without a card.  jax is imported inside the tests that use it, so that the
card's tests run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention.py -m cuda
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models.transformer import MultiHeadAttn
from roar_tpu_torch.training.convert import load_fastpitch_params

# fp32 on both sides; only the order of summation differs
FP32_TOL = dict(atol=1e-5, rtol=1e-4)


def _segment_attention_np(q, k, v, lens, scale):
    """Independent oracle: per (batch, head, query), softmax over exactly the
    keys in the query's segment (valid: j < len; pad: j >= len)."""
    b, t, h, d = q.shape
    out = np.zeros_like(q, dtype=np.float64)
    for bi in range(b):
        valid = np.arange(t) < lens[bi]
        for hi in range(h):
            for i in range(t):
                keys = valid if valid[i] else ~valid
                s = k[bi, keys, hi].astype(np.float64) @ q[bi, i, hi] * scale
                p = np.exp(s - s.max())
                out[bi, i, hi] = (p / p.sum()) @ v[bi, keys, hi]
    return out


@pytest.mark.parametrize("use_flash", [True, False])
def test_multihead_attn_matches_jax_on_valid_rows(use_flash):
    import jax
    import jax.numpy as jnp

    from roar_tpu.models.transformer import MultiHeadAttn as JaxMultiHeadAttn

    rng = np.random.default_rng(0)
    b, t, d_model, n_head, d_head = 2, 200, 64, 2, 32  # t % 64 != 0
    x = rng.standard_normal((b, t, d_model)).astype(np.float32)
    lens = np.array([200, 150])
    key_mask = np.arange(t)[None, :] < lens[:, None]

    jmod = JaxMultiHeadAttn(n_head, d_model, d_head, 0.0, use_flash=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), key_mask=jnp.asarray(key_mask))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), key_mask=jnp.asarray(key_mask)))

    tmod = load_fastpitch_params(MultiHeadAttn(n_head, d_model, d_head, use_flash=use_flash),
                                 jax.device_get(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), key_mask=torch.from_numpy(key_mask)).numpy()
    # pad rows follow each path's own masking and are zeroed downstream
    np.testing.assert_allclose(got[key_mask], want[key_mask], **FP32_TOL)


def test_plain_flash_segment_semantics_on_all_rows():
    rng = np.random.default_rng(1)
    b, t, h, d = 3, 70, 2, 32
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    lens = np.array([70, 33, 1])  # full, ragged, a single valid key
    key_mask = np.arange(t)[None, :] < lens[:, None]
    scale = 1.0 / np.sqrt(d)
    before = fa.LAUNCHES
    got = fa.flash_self_attention(*(torch.from_numpy(z) for z in (q, k, v)),
                                  torch.from_numpy(key_mask), scale).numpy()
    np.testing.assert_allclose(got, _segment_attention_np(q, k, v, lens, scale), **FP32_TOL)
    assert fa.LAUNCHES == before  # a CPU tensor never reaches the kernel


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 1, 48)
    with pytest.raises(ValueError):
        fa.flash_self_attention(q.to("meta"), q.to("meta"), q.to("meta"), None, 1.0)
    with pytest.raises(ValueError):
        fa.segment_ids(torch.ones(2, 8, dtype=torch.bool), 1, 8, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 1, 64), (1, 200, 1, 64), (2, 200, 2, 32),
                                     (2, 130, 2, 128)])
def test_cuda_kernel_matches_plain(b, t, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
    lens = torch.tensor([t, 1, t // 2, t - 37, 5, t, 64, 65][:b], device="cuda")
    key_mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    scale = 1.0 / d ** 0.5
    before = fa.LAUNCHES
    got = fa.flash_self_attention(q, k, v, key_mask, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.flash_self_attention_plain(q, k, v, key_mask, scale)
    # fp32 FMA kernel vs cuBLAS fp32 einsum: summation order only
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
