"""K5 port: segment-masked flash attention, non-causal and causal, forward and
backward, against the JAX package.

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

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models.transformer import MultiHeadAttn
from roar_tpu_torch.ops.flash_attention import flash_self_attention
from roar_tpu_torch.training.convert import load_fastpitch_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

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
    before = fa.LAUNCHES.copy()
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 1, 64), (1, 200, 1, 64), (2, 200, 2, 32),
                                     (2, 130, 2, 128), (4, 200, 2, 256), (2, 130, 2, 80),
                                     (2, 70, 2, 100)])
def test_cuda_kernel_matches_plain(b, t, h, d, dtype):
    """Ragged segment masks: a full row, a single valid key, half, T - 37, a
    pad-heavy row of 5 valid keys.  fp32 (the tensor-core kernel in 3xTF32,
    at fp32's level) against the cuBLAS fp32 einsum: summation order only.
    bf16 (the tensor-core kernel) at the bars of
    `chip_smoke.assert_flash_close`, with `lse` and without.  D 256 on its
    own kernels; D 80 and 100 zero-padded to the D 128 kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([t, 1, t // 2, t - 37, 5, t, 64, 65][:b], device="cuda")
    key_mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    scale = 1.0 / d ** 0.5
    before, padded = fa.LAUNCHES.copy(), fa.LAUNCHES_PADDED.copy()
    got = fa.flash_self_attention(q, k, v, key_mask, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == {"fwd": 1}
    assert fa.LAUNCHES_PADDED - padded == ({} if d in fa.HEAD_DIMS else {"fwd": 1})
    assert got.shape == q.shape
    want, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, return_lse=True)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
        return
    _chip_smoke().assert_flash_close(got, want, "o")
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-3)


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
    sm_scale 1 only.  At D 32 without `causal`, and at D 256 (the fp32
    backward's head size since its kernels were ported) with it."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference_bwd

    rng = np.random.default_rng(3)
    # (B, T, H, D, valid lengths, causal, q's scale: softmax of moderate
    # width).  At D 256 dP sums 256 products, so its fp32 rounding, and dq's
    # largest magnitude (36 here), are some 8 times D 32's: there each
    # gradient's atol is FP32_TOL's taken relative to its largest magnitude
    # (1e-5 at D 32's largest, about 4)
    for b, t, h, d, lens, causal, q_scale in ((2, 50, 2, 32, [50, 17], False, 0.3),
                                              (2, 40, 1, 256, [40, 23], True, 0.1)):
        q, k, v, do = _qkv(rng, b, t, h, d)
        q *= q_scale
        key_mask = np.arange(t)[None, :] < np.array(lens)[:, None]
        tq, tk, tv, tdo = (torch.from_numpy(z) for z in (q, k, v, do))
        tmask = torch.from_numpy(key_mask)
        o, lse = fa.flash_self_attention_plain(tq, tk, tv, tmask, 1.0, True, causal)
        got = fa.flash_self_attention_bwd_plain(tq, tk, tv, tmask, 1.0, o, lse, tdo, causal)

        ids = jnp.asarray((~key_mask).astype(np.int32))
        scores = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64)
        seg = (~key_mask).astype(np.int32)
        visible = seg[:, None, :, None] == seg[:, None, None, :]
        if causal:
            visible = visible & np.tril(np.ones((t, t), bool))
        scores = np.where(visible, scores, -np.inf)
        m = scores.max(-1)
        l = np.exp(scores - m[..., None]).sum(-1)
        np.testing.assert_allclose(lse.numpy(), m + np.log(l), **FP32_TOL)
        bhtd = lambda z: jnp.asarray(np.swapaxes(np.asarray(z), 1, 2))
        dq, dk, dv, _ = mha_reference_bwd(
            bhtd(q), bhtd(k), bhtd(v), None, SegmentIds(q=ids, kv=ids), bhtd(o.numpy()),
            jnp.asarray(l, jnp.float32), jnp.asarray(m, jnp.float32), bhtd(do), causal=causal,
            sm_scale=1.0)
        for name, g, w in zip("qkv", got, (dq, dk, dv)):
            w = np.swapaxes(np.asarray(w), 1, 2)
            tol = FP32_TOL if d == 32 else dict(FP32_TOL, atol=2.5e-6 * float(np.abs(w).max()))
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name} at D {d}", **tol)


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


# kernel vs plain on the card: fp32, every gradient within atol = 1e-4 of its
# largest magnitude and rtol 1e-3 (the kernels' 3xTF32 sums on the tensor
# cores, at fp32's level, against cuBLAS fp32 einsums); bf16 at the bars of
# `chip_smoke.assert_flash_close`
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,d", [(4, 200, 1, 64), (2, 130, 2, 32), (2, 70, 2, 128),
                                     (32, 160, 1, 64), (4, 200, 2, 256), (4, 130, 2, 80),
                                     (4, 70, 2, 100)])
def test_cuda_backward_kernels_match_plain(b, t, h, d, dtype):
    """At D 256 both types run their own kernels (fp32 since its backward
    was ported); D 80 and 100 take the padded route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    lens = torch.tensor(([t, 1, t // 2, t - 37] * 8)[:b], device="cuda")
    key_mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    scale = 1.0 / d ** 0.5
    before = fa.LAUNCHES.copy()
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True)
    got = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    again = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == {"fwd": 1, "dkv": 2, "dq": 2}
    assert torch.equal(out, fa.flash_self_attention(q, k, v, key_mask, scale))
    out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, return_lse=True)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-3)
    want = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, out_p, lse_p, do)
    bf16 = dtype == torch.bfloat16
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name}: two runs differ"
        if bf16:
            _chip_smoke().assert_flash_close(a, w, f"d{name}")
        else:
            torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=1e-3,
                                       msg=lambda m, n=name: f"d{n}: {m}")
    qkv = [z.clone().requires_grad_(True) for z in (q, k, v)]
    gf = torch.autograd.grad(flash_self_attention(*qkv, key_mask, scale), qkv, do)
    if bf16:  # the Function launches these same kernels
        assert all(torch.equal(a, w) for a, w in zip(gf, got))
        # a cotangent that is zero on the pad rows leaves the pad keys'
        # gradients exactly zero
        _, dk0, dv0 = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse,
                                                  do * key_mask[:, :, None, None])
        pad = ~key_mask[:, :, None, None].expand_as(dk0)
        assert not dk0[pad].any() and not dv0[pad].any()
        return
    # the Function on the card against autograd of the plain forward
    gp = torch.autograd.grad(fa.flash_self_attention_plain(*qkv, key_mask, scale), qkv, do)
    for a, w in zip(gf, gp):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=1e-3)


# ---------------------------------------------------------------------------
# K5-causal: the causal form that roar_tpu/models/gpt.py:491 reaches
# ---------------------------------------------------------------------------

# the plain versions against jax.nn.softmax attention under a causal mask:
# fp32 on both sides, other summation orders
CAUSAL_TOL = dict(atol=2e-4, rtol=1e-3)
# (B, T, H, D, valid lengths or None): ragged T, a trailing pad mask, T = 1
CAUSAL_CASES = [
    (2, 70, 2, 32, None), (2, 130, 2, 64, [130, 41]), (1, 200, 1, 128, None),
    (3, 64, 2, 32, [64, 1, 33]), (2, 1, 2, 32, None),
]


def _causal_inputs(case, seed):
    b, t, h, d, lens = case
    rng = np.random.default_rng(seed)
    q, k, v, do = _qkv(rng, b, t, h, d)
    key_mask = None if lens is None else np.arange(t)[None, :] < np.array(lens)[:, None]
    return q, k, v, do, key_mask, 1.0 / np.sqrt(d)


def _jax_causal_attention(key_mask, scale):
    """Softmax attention with a causal mask and, where a padding mask is
    given, the segment rule of `_causal_flash` (a pad query sees the pad keys
    at or before it), in jax.numpy."""
    import jax
    import jax.numpy as jnp

    def attention(q, k, v):
        t = q.shape[1]
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
        visible = jnp.tril(jnp.ones((t, t), bool))[None, None]
        if key_mask is not None:
            seg = jnp.asarray(~key_mask)
            visible = visible & (seg[:, None, :, None] == seg[:, None, None, :])
        scores = jnp.where(visible, scores, -1e9)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(scores, axis=-1), v)

    return attention


@pytest.mark.parametrize("case", CAUSAL_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_causal_plain_forward_and_backward_match_jax(case):
    import jax
    import jax.numpy as jnp

    q, k, v, do, key_mask, scale = _causal_inputs(case, 6)
    out_j, vjp = jax.vjp(_jax_causal_attention(key_mask, scale),
                         *(jnp.asarray(z) for z in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (torch.from_numpy(z) for z in (q, k, v, do))
    tmask = None if key_mask is None else torch.from_numpy(key_mask)
    before = fa.LAUNCHES.copy()
    o, lse = fa.flash_self_attention(tq, tk, tv, tmask, scale, return_lse=True, causal=True)
    assert fa.LAUNCHES == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(o.numpy(), np.asarray(out_j), **CAUSAL_TOL)
    assert lse.shape == (case[0], case[2], case[1]) and lse.dtype == torch.float32
    got = fa.flash_self_attention_bwd(tq, tk, tv, tmask, scale, o, lse, tdo, causal=True)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **CAUSAL_TOL)


def test_causal_first_row_sees_only_itself():
    q, k, v, _, _, scale = _causal_inputs((2, 70, 2, 32, None), 7)
    tq, tk, tv = (torch.from_numpy(z) for z in (q, k, v))
    o, lse = fa.flash_self_attention_plain(tq, tk, tv, None, scale, return_lse=True, causal=True)
    torch.testing.assert_close(o[:, 0], tv[:, 0])
    torch.testing.assert_close(lse[:, :, 0], (tq[:, 0] * tk[:, 0]).sum(-1) * scale)


@pytest.mark.parametrize("case", CAUSAL_CASES[:4], ids=lambda c: "x".join(map(str, c[:4])))
def test_causal_function_matches_autograd_of_the_plain_forward(case):
    """float64, so the two differ by rounding only."""
    q, k, v, do, key_mask, scale = _causal_inputs(case, 8)
    tmask = None if key_mask is None else torch.from_numpy(key_mask)
    base = [torch.from_numpy(z).double() for z in (q, k, v, do)]

    def grads(fn):
        qkv = [z.clone().requires_grad_(True) for z in base[:3]]
        out = fn(*qkv, tmask, scale, causal=True)
        return out, torch.autograd.grad(out, qkv, base[3])

    out_f, got = grads(flash_self_attention)
    out_p, want = grads(fa.flash_self_attention_plain)
    torch.testing.assert_close(out_f, out_p, atol=1e-12, rtol=1e-12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_versions_round_like_the_kernels(causal):
    """bf16 in, bf16 out, fp32 `lse`; close to the fp32 result at bf16's
    resolution (8 bits of mantissa: 2^-8 of the largest magnitude per rounding,
    a few roundings deep)."""
    q, k, v, do, key_mask, scale = _causal_inputs((2, 130, 2, 64, [130, 41]), 9)
    tmask = torch.from_numpy(key_mask)
    f32 = [torch.from_numpy(z).bfloat16().float() for z in (q, k, v, do)]
    b16 = [z.bfloat16() for z in f32]
    o32, lse32 = fa.flash_self_attention_plain(*f32[:3], tmask, scale, True, causal)
    o16, lse16 = fa.flash_self_attention_plain(*b16[:3], tmask, scale, True, causal)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(lse16, lse32, atol=1e-5, rtol=1e-5)  # same fp32 sums
    torch.testing.assert_close(o16.float(), o32, atol=2e-2 * float(o32.abs().max()), rtol=0)
    g32 = fa.flash_self_attention_bwd_plain(*f32[:3], tmask, scale, o32, lse32, f32[3], causal)
    g16 = fa.flash_self_attention_bwd_plain(*b16[:3], tmask, scale, o16, lse16, b16[3], causal)
    for a, w in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, atol=2e-2 * float(w.abs().max()), rtol=0)


def test_wrapper_rejects_mixed_types_and_head_size_256():
    """D 512 has no kernel; the fp32 backward at D 256 has one now, so the
    wrapper passes its head size and refuses only the device (no kernel runs
    on a meta tensor); mixed and half types are refused."""
    q = torch.zeros(1, 8, 1, 512, device="meta")
    with pytest.raises(ValueError, match="512"):
        fa.flash_self_attention(q, q, q, None, 1.0, causal=True)
    q = torch.zeros(1, 8, 1, 256, device="meta")
    lse = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_self_attention_bwd(q, q, q, None, 1.0, q, lse, q, causal=True)
    q = torch.zeros(1, 8, 1, 64, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_self_attention(q, q.bfloat16(), q, None, 1.0, causal=True)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_self_attention(q.half(), q.half(), q.half(), None, 1.0)


# the card's cases: ragged T, B 4 x T 2048, D 32 and 128, a trailing pad mask,
# T 1, the GPT path's own shape, and D 256, 80 and 100 (the last two through
# the padded route)
CUDA_CAUSAL_CASES = [
    (2, 70, 2, 32, None), (2, 130, 2, 128, [130, 41]), (1, 200, 1, 64, None),
    (2, 1000, 2, 64, [1000, 333]), (4, 2048, 2, 64, None), (2, 1, 2, 64, None),
    (1, 4096, 32, 64, None), (2, 300, 2, 256, [300, 77]), (1, 2048, 8, 256, None),
    (2, 130, 2, 80, [130, 41]), (1, 200, 2, 100, None),
]


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CUDA_CAUSAL_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_cuda_causal_kernels_match_plain(case, dtype):
    """Forward (with and without lse), dkv and dq with `causal=True` against
    the plain versions, at the bars of `chip_smoke.assert_flash_close`: fp32
    (the tensor-core kernels in 3xTF32) as the non-causal kernels; bf16
    against plain versions that round at the same places, element by element
    within 2^-6 of the value + 2^-7 of its row's largest, and within 1e-2 in
    relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    close = _chip_smoke().assert_flash_close
    b, t, h, d, lens = case
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype) for _ in range(4))
    key_mask = None if lens is None else (
        torch.arange(t, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None])
    scale = 1.0 / d ** 0.5
    before = fa.LAUNCHES.copy()
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True, causal=True)
    got = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do, causal=True)
    again = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == {"causal_fwd": 1, "causal_dkv": 2, "causal_dq": 2}
    assert torch.equal(out, fa.flash_self_attention(q, k, v, key_mask, scale, causal=True))
    assert out.dtype == dtype and lse.dtype == torch.float32
    out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal=True)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-3)
    if dtype == torch.float32:
        torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-3)
    else:
        close(out, out_p, "o")
    want = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, out_p, lse_p, do,
                                             causal=True)
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name}: two runs differ"
        close(a, w, f"d{name}")
    qkv = [z.clone().requires_grad_(True) for z in (q, k, v)]
    gf = torch.autograd.grad(flash_self_attention(*qkv, key_mask, scale, causal=True), qkv, do)
    for a, a2 in zip(gf, got):
        assert torch.equal(a, a2)


def _tiled_causal_forward_bf16(q, k, v, scale, q_tile=64, k_tile=64, drop=None):
    """The causal forward as a tiled kernel runs it in bf16: query tiles of
    `q_tile` rows, key tiles of `k_tile` taken in turn up to the query tile's
    last row, p rounded to bf16 against the running maximum, fp32 sums.
    `drop` = (query tile, key tile) leaves that tile's keys out, as a wrong
    tile loop would."""
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    q32, k32, v32 = (z.float() for z in (q, k, v))
    for i0 in range(0, t, q_tile):
        rows = torch.arange(i0, min(i0 + q_tile, t))
        top = torch.full((b, h, len(rows)), float("-inf"))
        total = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for j0 in range(0, min(i0 + q_tile, t), k_tile):
            if drop == (i0 // q_tile, j0 // k_tile):
                continue
            cols = torch.arange(j0, min(j0 + k_tile, t))
            s_ = torch.einsum("bqhd,bkhd->bhqk", q32[:, rows], k32[:, cols]) * scale
            s_ = s_.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
            new_top = torch.maximum(top, s_.amax(-1))
            # a row that has seen no visible key yet takes its exponents against 0
            use = torch.where(new_top == float("-inf"), 0.0, new_top)
            p = torch.exp(s_ - use[..., None])
            fix = torch.exp(top - use)
            total = total * fix + p.sum(-1)
            acc = acc * fix[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), v32[:, cols])
            top = new_top
        out[:, rows] = (acc / total[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return out


def _bf16_bar_inputs():
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(z).bfloat16() for z in _qkv(rng, 1, 1024, 2, 64))
    return q, k, v, do, 1.0 / 8.0


# (query tile, key tile): a 64 x 64 block; the tensor-core kernel's 16-row
# warp tile over 64-key tiles; 128-row tiles over 64-key tiles, where the
# diagonal spans two key tiles
TILINGS = [(64, 64), (16, 64), (128, 64)]


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda c: "x".join(map(str, c)))
def test_bf16_bar_takes_a_tiled_kernel_s_roundings(tiling):
    """What the bar must let through: the running-maximum rounding of p and
    the other order of the fp32 sums, at rows that see 1 to 1024 keys."""
    close = _chip_smoke().assert_flash_close
    q, k, v, _, scale = _bf16_bar_inputs()
    want = fa.flash_self_attention_plain(q, k, v, None, scale, causal=True)
    got = _tiled_causal_forward_bf16(q, k, v, scale, *tiling)
    assert not torch.equal(got, want)
    errs = close(got, want, "tiled o")
    assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3


@pytest.mark.parametrize("fault", ["dropped_late_tile", "zeroed_late_row", "diagonal_unmasked",
                                   "dv_missing_late_queries", "dq_missing_a_key_tile"])
def test_bf16_bar_fails_a_fault_among_the_late_rows(fault):
    """Late causal rows average over many keys, so their values are small
    beside the tensor's largest: each of these faults moves the result by a
    few hundredths of the largest magnitude at T 1024 (less at T 4096), and
    must fail the bar."""
    close = _chip_smoke().assert_flash_close
    q, k, v, do, scale = _bf16_bar_inputs()
    want, lse = fa.flash_self_attention_plain(q, k, v, None, scale, True, causal=True)
    if fault in ("dv_missing_late_queries", "dq_missing_a_key_tile"):
        dq, _, dv = fa.flash_self_attention_bwd_plain(q, k, v, None, scale, want, lse, do, True)
        if fault == "dv_missing_late_queries":
            cut = do.clone()
            cut[:, 960:] = 0  # the last query tile never reaches dv
            got = fa.flash_self_attention_bwd_plain(q, k, v, None, scale, want, lse, cut, True)[2]
            want = dv
        else:
            p = torch.exp(fa._masked_scores(q, k, None, scale, True) - lse[..., None])
            dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
            delta = (want.float() * do.float()).sum(-1).permute(0, 2, 1)
            ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
            ds[:, :, 900:, 128:192] = 0  # the late rows skip key tile 2
            got = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).bfloat16()
            want = dq
    elif fault == "dropped_late_tile":
        got = _tiled_causal_forward_bf16(q, k, v, scale, drop=(15, 3))
    elif fault == "zeroed_late_row":
        got = want.clone()
        got[:, 1000] = 0
    else:
        got = want.clone()  # rows 960.. also see the keys after them in their tile
        s_ = torch.einsum("bqhd,bkhd->bhqk", q.float()[:, 960:], k.float()) * scale
        got[:, 960:] = torch.einsum("bhqk,bkhd->bqhd", s_.softmax(-1).bfloat16().float(),
                                    v.float()).bfloat16()
    # small beside the tensor's largest value: only a bar that follows the row sees it
    assert float((got.float() - want.float()).abs().max()) < 0.1 * float(want.float().abs().max())
    with pytest.raises(AssertionError):
        close(got, want, fault)
