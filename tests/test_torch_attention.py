"""K5 port: segment-masked flash attention, forward and backward, against the
JAX package.

On the CPU the port's `flash_self_attention` takes its plain version; the JAX
`MultiHeadAttn(use_flash=True)` runs its einsum path off the TPU
(roar_tpu/models/transformer.py:166), the oracle the JAX package's own flash
test uses (tests/test_fastpitch_module.py:375-403).  The CUDA kernel itself is
checked against the plain version by the `cuda`-marked test, which skips
without a card.  The backward's plain version is held against `jax.grad` of
the JAX attention, against upstream's `mha_reference_bwd`, and (through the
autograd Function) against autograd of the plain forward.  jax is imported inside the tests that use it, so that the
card's tests run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention.py -m cuda
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models.transformer import MultiHeadAttn
from roar_tpu_torch.ops.flash_attention import flash_self_attention
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


def _qkv(rng, b, t, h, d):
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))


def test_plain_backward_matches_jax_grad_of_the_einsum_attention():
    """jax.vjp through the einsum path of roar_tpu/models/transformer.py:170-182
    (additive -1e9 key mask).  The cotangent is zero on pad query rows, as
    `TransformerLayer`'s mask makes it, so every row of dq, dk, dv compares."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    b, t, h, d = 3, 70, 2, 32
    q, k, v, do = _qkv(rng, b, t, h, d)
    lens = np.array([70, 33, 1])
    key_mask = np.arange(t)[None, :] < lens[:, None]
    do = do * key_mask[:, :, None, None]
    scale = 1.0 / np.sqrt(d)

    def attention(q, k, v):
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
        scores = scores + jnp.where(jnp.asarray(key_mask)[:, None, None, :], 0.0, -1e9)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(scores, axis=-1), v)

    _, vjp = jax.vjp(attention, *(jnp.asarray(z) for z in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (torch.from_numpy(z) for z in (q, k, v, do))
    tmask = torch.from_numpy(key_mask)
    o, lse = fa.flash_self_attention_plain(tq, tk, tv, tmask, scale, return_lse=True)
    got = fa.flash_self_attention_bwd_plain(tq, tk, tv, tmask, scale, o, lse, tdo)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **FP32_TOL)


def test_plain_backward_matches_upstream_reference_bwd_on_all_rows():
    """Upstream's `mha_reference_bwd` with SegmentIds and the residuals (l, m),
    garbage cotangents on the pad rows included; it takes [B, H, T, D] and
    sm_scale 1 only."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference_bwd

    rng = np.random.default_rng(3)
    b, t, h, d = 2, 50, 2, 32
    q, k, v, do = _qkv(rng, b, t, h, d)
    q *= 0.3
    lens = np.array([50, 17])
    key_mask = np.arange(t)[None, :] < lens[:, None]
    tq, tk, tv, tdo = (torch.from_numpy(z) for z in (q, k, v, do))
    tmask = torch.from_numpy(key_mask)
    o, lse = fa.flash_self_attention_plain(tq, tk, tv, tmask, 1.0, return_lse=True)
    got = fa.flash_self_attention_bwd_plain(tq, tk, tv, tmask, 1.0, o, lse, tdo)

    ids = jnp.asarray((~key_mask).astype(np.int32))
    scores = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64)
    seg = (~key_mask).astype(np.int32)
    scores = np.where(seg[:, None, :, None] == seg[:, None, None, :], scores, -np.inf)
    m = scores.max(-1)
    l = np.exp(scores - m[..., None]).sum(-1)
    np.testing.assert_allclose(lse.numpy(), m + np.log(l), **FP32_TOL)
    bhtd = lambda z: jnp.asarray(np.swapaxes(np.asarray(z), 1, 2))
    dq, dk, dv, _ = mha_reference_bwd(
        bhtd(q), bhtd(k), bhtd(v), None, SegmentIds(q=ids, kv=ids), bhtd(o.numpy()),
        jnp.asarray(l, jnp.float32), jnp.asarray(m, jnp.float32), bhtd(do), sm_scale=1.0)
    for name, g, w in zip("qkv", got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(w), 1, 2),
                                   err_msg=f"d{name}", **FP32_TOL)


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True), (True, False, False)])
def test_function_matches_autograd_of_the_plain_forward(needs):
    """The autograd Function (plain backward on the CPU) against autograd of
    the plain forward, in float64; it returns gradients only where asked."""
    rng = np.random.default_rng(4)
    b, t, h, d = 3, 40, 2, 32
    lens = torch.tensor([40, 9, 1])
    key_mask = torch.arange(t)[None, :] < lens[:, None]
    base = [torch.from_numpy(rng.standard_normal((b, t, h, d))) for _ in range(4)]
    do = base[3]

    def grads(fn):
        qkv = [z.clone().requires_grad_(n) for z, n in zip(base[:3], needs)]
        out = fn(*qkv, key_mask, 0.2)
        wanted = [z for z in qkv if z.requires_grad]
        return out, torch.autograd.grad(out, wanted, do)

    out_f, got = grads(flash_self_attention)
    out_p, want = grads(fa.flash_self_attention_plain)
    torch.testing.assert_close(out_f, out_p, atol=1e-12, rtol=1e-12)
    assert len(got) == sum(needs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


def test_function_saves_nothing_without_grad():
    q = torch.randn(1, 8, 1, 32)
    with torch.no_grad():
        out = flash_self_attention(q.requires_grad_(True), q, q, None, 1.0)
    assert out.grad_fn is None
    assert flash_self_attention(q.detach(), q.detach(), q.detach(), None, 1.0).grad_fn is None


def test_multihead_attn_gradients_match_jax():
    """Port `MultiHeadAttn(use_flash=True)` (the Function with its plain
    backward) against jax.grad through the JAX module, for the input and
    every parameter; the loss reads valid rows only."""
    import jax
    import jax.numpy as jnp

    from roar_tpu.models.transformer import MultiHeadAttn as JaxMultiHeadAttn
    from roar_tpu_torch.training.convert import flatten_params

    rng = np.random.default_rng(5)
    b, t, d_model, n_head, d_head = 2, 37, 32, 2, 16
    x = rng.standard_normal((b, t, d_model)).astype(np.float32)
    w = rng.standard_normal((b, t, d_model)).astype(np.float32)
    key_mask = np.arange(t)[None, :] < np.array([37, 20])[:, None]
    w = w * key_mask[..., None]

    jmod = JaxMultiHeadAttn(n_head, d_model, d_head, 0.0, 0.0, use_flash=True)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), key_mask=jnp.asarray(key_mask))

    def loss(params, x):
        return jnp.sum(jmod.apply(params, x, key_mask=jnp.asarray(key_mask)) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = load_fastpitch_params(MultiHeadAttn(n_head, d_model, d_head, use_flash=True),
                                 jax.device_get(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tmod(tx, key_mask=torch.from_numpy(key_mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **FP32_TOL)
    flat = flatten_params(jax.device_get(gp))
    pairs = {"qkv_net.weight": flat["qkv_net/kernel"].T, "qkv_net.bias": flat["qkv_net/bias"],
             "o_net.weight": flat["o_net/kernel"].T,
             "layer_norm.norm.weight": flat["layer_norm/LayerNorm_0/scale"],
             "layer_norm.norm.bias": flat["layer_norm/LayerNorm_0/bias"]}
    grads = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    assert set(grads) == set(pairs)
    for name, want in pairs.items():
        np.testing.assert_allclose(grads[name], want, err_msg=name, atol=2e-5, rtol=1e-4)


# kernel vs plain on the card: every gradient within atol = 1e-4 of its largest
# magnitude and rtol 1e-3 (fp32 FMA sums against cuBLAS fp32 einsums)
@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 200, 1, 64), (2, 130, 2, 32), (2, 70, 2, 128),
                                     (32, 160, 1, 64)])
def test_cuda_backward_kernels_match_plain(b, t, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(4))
    lens = torch.tensor(([t, 1, t // 2, t - 37] * 8)[:b], device="cuda")
    key_mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    scale = 1.0 / d ** 0.5
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True)
    got = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    again = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    assert torch.equal(out, fa.flash_self_attention(q, k, v, key_mask, scale))
    out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, return_lse=True)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-3)
    want = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, out_p, lse_p, do)
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name}: two runs differ"
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=1e-3,
                                   msg=lambda m, n=name: f"d{n}: {m}")
    # the Function on the card against autograd of the plain forward
    qkv = [z.clone().requires_grad_(True) for z in (q, k, v)]
    gf = torch.autograd.grad(flash_self_attention(*qkv, key_mask, scale), qkv, do)
    gp = torch.autograd.grad(fa.flash_self_attention_plain(*qkv, key_mask, scale), qkv, do)
    for a, w in zip(gf, gp):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=1e-3)
