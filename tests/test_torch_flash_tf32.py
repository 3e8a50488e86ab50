"""The arithmetic of the fp32 flash-attention kernels (K5 forward, dK/dV and
dQ on the tensor cores, 3xTF32), emulated in numpy on the CPU.

`csrc/flash_attention_bwd.cu` forms every product of the fp32 backward, the
score products q.k^T and dO.v^T and the gradient products p^T dO, dS^T q and
dS k, on `mma.sync.m16n8k8` with TF32 operands and fp32 sums.  Every fp32
operand v is split into big = tf32(v) and small = tf32(v - big) (round to
nearest, ties away from zero, 10 mantissa bits: the bits of
`cvt.rna.tf32.f32`, formed there by integer operations), and each k-chunk of
8 adds small.big, then big.small, then big.big into a fresh accumulator,
which one fp32 add rounded to nearest puts into the thread's sum.  The
emulation forms each chunk's products exactly and rounds once per `mma`, as
the tensor core adds its products to the accumulator, toward zero (the H100's
accumulator truncates: carried over a whole contraction of 4096 queries, the
kernel's error on the card is over ten times the flushed one).
p = exp(s * scale - lse) and dS = p (dP - delta) scale are fp32 operations on
the emulated sums, as in the kernels.

The gradient products take the score tiles' accumulators as their A operand.
An m16n8k8 C fragment holds columns 2t and 2t + 1 in lane 4 g + t where the A
fragment holds columns t and t + 4, so the kernels permute the contraction
index within each k-chunk (A's column t is C's column 2t, A's column t + 4 is
C's column 2t + 1) and read the B operand's rows with the same permutation;
`test_permuted_contraction_index` checks that mapping lane by lane.  Within a
chunk the order of the 8 products does not change an exact chunk sum, so the
matrix-level emulation needs no permutation.

Every case holds the emulated kernel to the card's fp32 bar (`chip_smoke.py`
`assert_flash_close`: within 1e-4 of the largest magnitude plus rtol 1e-3),
against the port's plain fp32 backward and against upstream's
`mha_reference_bwd` in fp32, at a small causal shape and at a ragged,
segment-masked one.  What the other orders read at these shapes (largest
error over the largest magnitude of dq, dk, dv against the plain version):
3xTF32 flushed 2e-7 to 1.4e-6; 3xTF32 unflushed 1e-6 to 9e-6; plain TF32
(big.big only) 3e-4 to 1.2e-3, which fails the bar, so a kernel that dropped
the small terms would fail it too.

At D 256 the backward runs its split kernels: two warps form the halves of
each score tile along D (columns 0..127 and 128..255), each half summed in
the order above, and add them in fp32; `D256_WALK` and `split_product`
emulate that walk, which holds the same bar while plain TF32 in it fails.
At D 128 it runs its pair kernels: each score tile formed once over the
whole of D by one warp (`parts` 1), dK/dV over 64-key blocks and 64-query
tiles, 128 output columns a warp, dQ over 32-key tiles, 64 output columns
a warp (`D128_WALK`); the same bar holds there and plain TF32 fails it.
D 128's scale 2^-3.5 is no power of two, so q * scale is not exact in fp32
and upstream's `mha_reference_bwd`, which takes scale 1 only, could not be
handed the same function: every D 128 case of the backward hands all sides
(the emulated kernels, the port's plain version and upstream's reference)
the same pre-scaled q, fp32(q * 2^-3.5), with scale 1 (`_case`).  The
forward's references take any scale, so its D 128 cases run at the true
scale 2^-3.5 on an unscaled q (`_fwd_case`).

The forward (`csrc/flash_attention_fwd.cu`) forms S = q.k^T the same way and,
per 32-key tile, the online softmax (running maximum, p = 2^((s - m) log2 e),
o rescaled by alpha) and P V with p's accumulator as the split A operand.  At
D 256 and 128 its split kernel forms S as the backward's split kernels do,
two halves of D / 2 columns added in fp32, per 16-key tile at D 256
(`FWD_D256_WALK`) and per 32-key tile at D 128 (`FWD_D128_WALK`).
For P V it splits V exactly, big + mid + low (`mma_4xtf32`: the rest v - big
with its 13 low bits cleared, and what remains), since a row that sees one
key must get o = v to the bit; `test_forward_single_key_rows_get_v_exactly`
shows that a two-part split misses bits there.  The emulation holds o and lse
to `chip_smoke.KERNEL_TOL` (and o to `assert_flash_close`'s fp32 bar)
against the port's plain fp32 forward and upstream's `mha_reference` at the
six cases.  What it reads: o 1.8e-7 to 6.4e-7 of its largest magnitude,
lse 4.8e-7 to 9.5e-7 absolute (0.0017 to 0.0081 of KERNEL_TOL); plain TF32 in
both products 2.1e-4 to 4.4e-4 of the largest magnitude, 2.7 to 4.3 times
KERNEL_TOL, which fails it.  The split walks' o sits 1.5e-7 to 1.8e-7 (D
256) and 1.4e-7 to 1.6e-7 (D 128) of the largest magnitude from the
whole-row order of the kernels before them, over the same key tiles.
"""

import functools
from typing import Optional

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa

ATOL_REL = 1e-4  # chip_smoke.FLASH_BWD_ATOL_REL
RTOL = 1e-3      # chip_smoke.FLASH_BWD_RTOL
# (B, T, H, D, valid lengths or None, causal): the GPT path's kind, and
# FastPitch's kind with a ragged T, a short row and a single valid key; the
# same two at D 256, where the forward and the backward run their split
# kernels, and at D 128, where the backward runs its pair kernels
CASES = {"causal": (1, 512, 2, 64, None, True),
         "ragged_segments": (3, 200, 1, 64, [200, 117, 1], False),
         "causal_d256": (1, 96, 1, 256, None, True),
         "ragged_segments_d256": (3, 80, 1, 256, [80, 33, 1], False),
         "causal_d128": (1, 160, 1, 128, None, True),
         "ragged_segments_d128": (3, 100, 1, 128, [100, 41, 1], False)}
D256_NAMES = ["causal_d256", "ragged_segments_d256"]
D128_NAMES = ["causal_d128", "ragged_segments_d128"]
# the backward kernels' walk at D 256 (`flash_bwd_{dkv,dq}_tf32_split_kernel`):
# dK/dV blocks of 32 keys over 32-query tiles, dQ's 16-key tiles, each warp
# over 128 of the 256 output columns, and the score products S and dP split
# along their contraction into two halves of 128 that two warps form and add
D256_WALK = dict(key_block=32, dkv_rows=32, dq_rows=16, cols=128, parts=2)
# the backward kernels' walk at D 128 (`flash_bwd_{dkv,dq}_tf32_pair_kernel`):
# dK/dV blocks of 64 keys over 64-query tiles, each warp over all 128
# columns of dV or dK; dQ's 32-key tiles, each warp over 64 of dQ's columns;
# each score tile formed whole by one warp
D128_WALK = dict(key_block=64, dkv_rows=64, dq_rows=32, cols=128, dq_cols=64, parts=1)


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest TF32 value, ties away from zero, as fp32: the
    int32 view with 0x1000 added to the 13 dropped bits, then cleared."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def to_fp32(v: np.ndarray, toward_zero: bool) -> np.ndarray:
    """fp64 -> fp32, to nearest or toward zero."""
    out = v.astype(np.float32)
    if toward_zero:
        bits = out.view(np.uint32)
        bits -= (np.abs(out.astype(np.float64)) > np.abs(v)).astype(np.uint32)
    return out


def product(a: np.ndarray, b: np.ndarray, three_terms: bool = True, toward_zero: bool = True,
            flushed: bool = True, exact_b: bool = False,
            init: Optional[np.ndarray] = None) -> np.ndarray:
    """a [..., M, K] @ b [..., K, N] as the kernels sum it: k-chunks of 8 in
    order (K padded with zeros, as the kernels mask a ragged tile), per chunk
    small.big, big.small, big.big (or big.big alone), each `mma` one rounding
    of (accumulator + exact chunk sum) to fp32.  `flushed`: each chunk's
    products go into a fresh accumulator, added to the sum in fp32.
    `exact_b`: b split exactly as the forward's P V splits V (`mma_4xtf32`):
    small.big, big.low, big.mid, big.big, where mid is the rest b - big with
    its 13 low bits cleared and low = rest - mid.  `init`: the sum the
    chunks are added to (default zeros)."""
    pad = (-a.shape[-1]) % 8
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)], -1)
        b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad, b.shape[-1]), np.float32)], -2)
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    if exact_b and three_terms:
        rest = (b - b_big).astype(np.float32)
        mid = (rest.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        terms = ((a_small, b_big), (a_big, rest - mid), (a_big, mid), (a_big, b_big))
    elif three_terms:
        terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))
    else:
        terms = ((a_big, b_big),)
    total = np.zeros(a.shape[:-1] + (b.shape[-1],), np.float32) if init is None else init
    acc = total
    for k0 in range(0, a.shape[-1], 8):
        if flushed:
            acc = np.zeros_like(total)
        for x, y in terms:
            part = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            acc = to_fp32(acc.astype(np.float64) + part, toward_zero)
        if flushed:
            total = total + acc
    return total if flushed else acc


def emulate_bwd(q, k, v, do, lse, delta, seg, scale, causal, **order):
    """(dq, dk, dv) [B, T, H, D] of the two kernels from fp32 q, k, v, do
    [B, T, H, D], lse and delta [B, H, T], segment ids [B, T]."""
    t = q.shape[1]
    bq, bk, bv, bo = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, do))
    s = product(bq, bk.transpose(0, 1, 3, 2), **order)
    dp = product(bo, bv.transpose(0, 1, 3, 2), **order)
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        visible = visible & np.tril(np.ones((t, t), bool))
    f32 = np.float32
    p = np.where(visible, np.exp(s * f32(scale) - lse[..., None]), f32(0)).astype(f32)
    ds = (p * (dp - delta[..., None]) * f32(scale)).astype(f32)
    dv = product(p.transpose(0, 1, 3, 2), bo, **order)
    dk = product(ds.transpose(0, 1, 3, 2), bq, **order)
    dq = product(ds, bk, **order)
    return tuple(x.transpose(0, 2, 1, 3) for x in (dq, dk, dv))


def _tile_visible(seg, causal, rows, cols):
    """[B, 1, len(rows), len(cols)]: query `rows[i]` sees key `cols[j]`."""
    visible = seg[:, None, rows, None] == seg[:, None, None, cols]
    if causal:
        visible = visible & (cols[None, :] <= rows[:, None])
    return visible


def split_product(a: np.ndarray, b: np.ndarray, parts: int, **order) -> np.ndarray:
    """a @ b with the contraction cut into `parts` equal parts, each summed in
    `product`'s order (by its own warp), the parts' fp32 sums then added in
    part order."""
    n = a.shape[-1] // parts
    total = product(a[..., :n], b[..., :n, :], **order)
    for i in range(1, parts):
        total = total + product(a[..., i * n:(i + 1) * n], b[..., i * n:(i + 1) * n, :], **order)
    return total


def emulate_bwd_walk(q, k, v, do, lse, delta, seg, scale, causal, key_block=64, dkv_rows=64,
                     dq_rows=64, cols=None, dq_cols=None, parts=1, **order):
    """(dq, dk, dv) [B, T, H, D] as the two kernels walk them, each product
    in `product`'s order.  dK/dV: per block of `key_block` keys, S^T = K Q^T
    and dP^T = V dO^T (K and V the A operands), the query tiles of
    `dkv_rows` rows in turn (from the block's first key with `causal`), dV +=
    P^T dO and dK += dS^T Q over `cols` columns at a time.  dQ: per 64-query
    tile, S = Q K^T and dP = dO V^T, the key tiles of `dq_rows` rows up to
    the diagonal, dQ += dS K over `dq_cols` (default `cols`) columns at a
    time.  The score
    products are summed in `parts` parts along D (`split_product`).  A tile
    the kernels skip for its segment ids is walked here: its p is 0, which
    adds nothing."""
    b, t, h, d = q.shape
    cols = d if cols is None else cols
    dq_cols = cols if dq_cols is None else dq_cols
    bq, bk, bv, bo = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, do))
    f32 = np.float32
    dq, dk, dv = (np.zeros((b, h, t, d), f32) for _ in range(3))
    swap = lambda x: np.ascontiguousarray(np.swapaxes(x, -1, -2))
    for col0 in range(0, d, cols):
        out = slice(col0, col0 + cols)
        for k0 in range(0, t, key_block):
            keys = np.arange(k0, min(k0 + key_block, t))
            kt, vt = bk[..., keys, :], bv[..., keys, :]
            acc_dk = np.zeros((b, h, len(keys), cols), f32)
            acc_dv = np.zeros_like(acc_dk)
            for q0 in range(k0 if causal else 0, t, dkv_rows):
                qs = np.arange(q0, min(q0 + dkv_rows, t))
                qt, ot = bq[..., qs, :], bo[..., qs, :]
                st = split_product(kt, swap(qt), parts, **order)
                visible = swap(_tile_visible(seg, causal, qs, keys))
                p = np.where(visible, np.exp(st * f32(scale) - lse[:, :, None, qs]),
                             f32(0)).astype(f32)
                acc_dv = product(p, ot[..., out], init=acc_dv, **order)
                dpt = split_product(vt, swap(ot), parts, **order)
                ds = (p * (dpt - delta[:, :, None, qs]) * f32(scale)).astype(f32)
                acc_dk = product(ds, qt[..., out], init=acc_dk, **order)
            dv[..., keys, out] = acc_dv
            dk[..., keys, out] = acc_dk
    for col0 in range(0, d, dq_cols):
        out = slice(col0, col0 + dq_cols)
        for q0 in range(0, t, 64):
            qs = np.arange(q0, min(q0 + 64, t))
            qt, ot = bq[..., qs, :], bo[..., qs, :]
            acc = np.zeros((b, h, len(qs), dq_cols), f32)
            for k0 in range(0, min(t, q0 + 64) if causal else t, dq_rows):
                keys = np.arange(k0, min(k0 + dq_rows, t))
                kt, vt = bk[..., keys, :], bv[..., keys, :]
                s = split_product(qt, swap(kt), parts, **order)
                dp = split_product(ot, swap(vt), parts, **order)
                p = np.where(_tile_visible(seg, causal, qs, keys),
                             np.exp(s * f32(scale) - lse[..., qs, None]), f32(0)).astype(f32)
                ds = (p * (dp - delta[..., qs, None]) * f32(scale)).astype(f32)
                acc = product(ds, kt[..., out], init=acc, **order)
            dq[..., qs, out] = acc
    return tuple(x.transpose(0, 2, 1, 3) for x in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _draw(name: str):
    """Seeded fp32 q, k, v, do [B, T, H, D] of CASES[name], its valid-key
    mask [B, T] and its scale 1/sqrt(D)."""
    b, t, h, d, lens, _ = CASES[name]
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), bool) if lens is None else np.arange(t)[None] < np.array(lens)[:, None]
    return q, k, v, do, mask, 1.0 / np.sqrt(d)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """Seeded inputs of CASES[name], the plain fp32 forward's o and lse, and
    the plain fp32 backward (what the kernels are held against on the card)."""
    causal = CASES[name][-1]
    q, k, v, do, mask, scale = _draw(name)
    if not np.log2(scale).is_integer():
        # D 128's 2^-3.5: every side takes the same pre-scaled q with scale 1
        q, scale = (q * np.float32(scale)).astype(np.float32), 1.0
    tq, tk, tv, tdo = (torch.from_numpy(z) for z in (q, k, v, do))
    tmask = torch.from_numpy(mask)
    o, lse = fa.flash_self_attention_plain(tq, tk, tv, tmask, scale, True, causal)
    want = fa.flash_self_attention_bwd_plain(tq, tk, tv, tmask, scale, o, lse, tdo, causal)
    delta = (o * tdo).sum(-1).permute(0, 2, 1).numpy()
    inputs = dict(q=q, k=k, v=v, do=do, lse=lse.numpy(), delta=delta,
                  seg=(~mask).astype(np.int32), scale=scale, causal=causal)
    return inputs, o.numpy(), [w.numpy() for w in want]


@functools.lru_cache(maxsize=None)
def _emulated(name: str, three_terms: bool = True, flushed: bool = True):
    """The kernels' backward: at D 256 and 128 in their walks (`D256_WALK`,
    `D128_WALK`)."""
    inputs, _, _ = _case(name)
    walk = D256_WALK if name in D256_NAMES else D128_WALK if name in D128_NAMES else None
    if walk is not None:
        return emulate_bwd_walk(**inputs, **walk, three_terms=three_terms, flushed=flushed)
    return emulate_bwd(**inputs, three_terms=three_terms, flushed=flushed)


def _within_bar(got: np.ndarray, want: np.ndarray) -> bool:
    top = float(np.abs(want).max())
    return bool(np.all(np.abs(got - want) <= ATOL_REL * top + RTOL * np.abs(want)))


def _upstream_reference(name: str):
    """(dq, dk, dv) of upstream's `mha_reference_bwd` in fp32 with
    SegmentIds (and `causal`).  It takes sm_scale 1 only, so it is handed
    q * scale (exact: scale is 2^-3 at D 64, 2^-4 at D 256, and 1 at D 128,
    whose q comes pre-scaled from `_case`) and its dq is scaled back."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference_bwd

    inputs, o, _ = _case(name)
    q, k, v, do, seg = (inputs[n] for n in ("q", "k", "v", "do", "seg"))
    scale, causal, t = inputs["scale"], inputs["causal"], q.shape[1]
    assert scale in (1.0, 2.0 ** -3, 2.0 ** -4)
    qs = q * np.float32(scale)
    scores = np.einsum("bqhd,bkhd->bhqk", qs.astype(np.float64), k.astype(np.float64))
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        visible = visible & np.tril(np.ones((t, t), bool))
    scores = np.where(visible, scores, -np.inf)
    m = scores.max(-1)
    l = np.exp(scores - m[..., None]).sum(-1)
    ids = jnp.asarray(seg)
    bhtd = lambda z: jnp.asarray(np.swapaxes(np.asarray(z, np.float32), 1, 2))
    dq, dk, dv, _ = mha_reference_bwd(
        bhtd(qs), bhtd(k), bhtd(v), None, SegmentIds(q=ids, kv=ids), bhtd(o),
        jnp.asarray(l, jnp.float32), jnp.asarray(m, jnp.float32), bhtd(do), causal=causal,
        sm_scale=1.0)
    dq = np.asarray(dq) * np.float32(scale)
    return [np.swapaxes(np.asarray(x), 1, 2) for x in (dq, dk, dv)]


@pytest.mark.parametrize("against", ["plain", "upstream"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_order_holds_the_fp32_bar(name, against):
    """3xTF32, truncating `mma`, flushed per k-chunk: dq, dk and dv within
    1e-4 of the largest magnitude + rtol 1e-3 of the port's plain fp32
    backward and of upstream's reference."""
    want = _case(name)[2] if against == "plain" else _upstream_reference(name)
    for grad, got, w in zip(("dq", "dk", "dv"), _emulated(name), want):
        top = float(np.abs(w).max())
        torch.testing.assert_close(torch.tensor(got), torch.tensor(w), atol=ATOL_REL * top,
                                   rtol=RTOL, msg=lambda m: f"{grad}: {m}")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_tf32_fails_the_fp32_bar(name):
    """One TF32 product (big.big alone) misses the bar on every gradient, so
    the bar tells a kernel that dropped the small terms."""
    got = _emulated(name, three_terms=False, flushed=False)
    for grad, g, w in zip(("dq", "dk", "dv"), got, _case(name)[2]):
        assert not _within_bar(g, w), f"{grad}: plain TF32 passes the bar, the test cannot tell"


def test_flushed_sums_stay_at_fp32_level():
    """Against a float64 backward at the causal shape (dk and dv sum over up
    to 512 queries): the kernels' order errs within 3x of the plain fp32
    backward's own error; the truncating accumulator carried over the whole
    contraction errs over 5x of the flushed order on dk and dv."""
    inputs, _, want = _case("causal")
    t_in = {n: torch.from_numpy(inputs[n]).double() for n in ("q", "k", "v", "do")}
    mask = torch.from_numpy(inputs["seg"] == 0)
    o64, lse64 = fa.flash_self_attention_plain(t_in["q"], t_in["k"], t_in["v"], mask,
                                               inputs["scale"], True, True)
    exact = [x.numpy() for x in fa.flash_self_attention_bwd_plain(
        t_in["q"], t_in["k"], t_in["v"], mask, inputs["scale"], o64, lse64, t_in["do"], True)]

    def err(got):
        return [float(np.abs(g.astype(np.float64) - e).max() / np.abs(e).max())
                for g, e in zip(got, exact)]

    fp32, flushed = err(want), err(_emulated("causal"))
    carried = err(_emulated("causal", flushed=False))
    for i, grad in enumerate(("dq", "dk", "dv")):
        assert flushed[i] <= 3 * fp32[i], (grad, flushed[i], fp32[i])
    for i, grad in ((1, "dk"), (2, "dv")):
        assert carried[i] > 5 * flushed[i], (grad, carried[i], flushed[i])


@pytest.mark.parametrize("name", D256_NAMES)
def test_d256_walk_keeps_the_order_of_the_sums(name):
    """At D 256 the split kernels walk 32-key blocks over 32-query tiles
    (dK/dV) and 16-key tiles (dQ) and form 128 output columns a warp; the
    same sums in the same order come out of 64-row tiles and whole rows, bit
    for bit.  What changes the order is the split of S's and dP's
    contraction into two halves added in fp32: it is not the one-walk sum
    (some gradient differs from the unsplit walk's), and the split walk's
    dq, dk and dv sit within the fp32 bar of the matrix-level emulation
    (unsplit, its score products taking the operands the other way round);
    `test_kernel_order_holds_the_fp32_bar` holds them to the plain version
    and upstream's reference, and plain TF32 in the same walk fails there."""
    inputs, _, _ = _case(name)
    walked = _emulated(name)
    whole = emulate_bwd_walk(**inputs, parts=D256_WALK["parts"])
    unsplit = emulate_bwd_walk(**inputs)
    for grad, got, want, flat in zip(("dq", "dk", "dv"), walked, whole, emulate_bwd(**inputs)):
        np.testing.assert_array_equal(got, want, err_msg=grad)
        assert _within_bar(got, flat), grad
    assert any(not np.array_equal(a, u) for a, u in zip(walked, unsplit))


@pytest.mark.parametrize("name", D128_NAMES)
def test_d128_walk_keeps_the_order_of_the_sums(name):
    """At D 128 the pair kernels form each score tile whole (`parts` 1) and
    walk 64-key blocks over 64-query tiles (dK/dV, 128 output columns a
    warp) and 32-key tiles (dQ, 64 columns a warp): the same sums in the same
    order as 64-row tiles and whole rows give, bit for bit, and within the
    fp32 bar of the matrix-level emulation (whose score products take the
    operands the other way round).  `test_kernel_order_holds_the_fp32_bar`
    holds the walk to the plain version and upstream's reference, and plain
    TF32 in the same walk fails there."""
    inputs, _, _ = _case(name)
    walked = _emulated(name)
    whole = emulate_bwd_walk(**inputs)
    for grad, got, want, flat in zip(("dq", "dk", "dv"), walked, whole, emulate_bwd(**inputs)):
        np.testing.assert_array_equal(got, want, err_msg=grad)
        assert _within_bar(got, flat), grad


@pytest.mark.parametrize("seed", [0, 1])
def test_permuted_contraction_index(seed):
    """Lane by lane, as `acc_as_a` and `load_bt` of the kernels build them:
    the C fragment of a 16 x 8 score tile (c0, c1 at (g, 2t..2t+1), c2, c3 at
    (g+8, 2t..2t+1)) taken as A = {c0, c2, c1, c3}, and B read from rows
    k0 + 2t and k0 + 2t + 1, column 8 j + g of the other operand's tile.  Put
    where m16n8k8 reads them (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
    (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g)), their product is exactly
    C @ X[k0 : k0 + 8, 8 j : 8 j + 8]."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-8, 9, (16, 8)).astype(np.float64)  # a score tile's accumulator
    x = rng.integers(-8, 9, (64, 64)).astype(np.float64)  # the other side's staged tile
    k0, j = 8 * int(rng.integers(0, 8)), int(rng.integers(0, 8))
    a_hw, b_hw = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        frag_c = (c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1])
        a0, a1, a2, a3 = frag_c[0], frag_c[2], frag_c[1], frag_c[3]  # acc_as_a
        a_hw[g, t], a_hw[g + 8, t], a_hw[g, t + 4], a_hw[g + 8, t + 4] = a0, a1, a2, a3
        b0, b1 = x[k0 + 2 * t, 8 * j + g], x[k0 + 2 * t + 1, 8 * j + g]  # load_bt
        b_hw[t, g], b_hw[t + 4, g] = b0, b1
    np.testing.assert_array_equal(a_hw @ b_hw, c @ x[k0:k0 + 8, 8 * j:8 * j + 8])


# ---------------------------------------------------------------------------
# The forward (`flash_fwd_tf32_kernel` and, at D 128 and 256,
# `flash_fwd_tf32_split_kernel`, csrc/flash_attention_fwd.cu)

FWD_KEYS = 32  # keys of a staged K/V tile of the 4-warp forward (D 32 / 64)
# the forward's walks at D 256 and 128 (`flash_fwd_tf32_split_kernel`): 16-
# and 32-key tiles, S's contraction split into two halves of D / 2 that two
# warps form and add
FWD_D256_WALK = dict(keys=16, parts=2)
FWD_D128_WALK = dict(keys=32, parts=2)
LOG2E = np.float32(1.4426950408889634)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-3)  # chip_smoke.KERNEL_TOL: o and lse


def _exp2(x: np.ndarray) -> np.ndarray:
    """2^x of fp32 arguments, rounded to fp32 (the card's exp2f errs within 2
    ulp of this)."""
    return np.exp2(x.astype(np.float64)).astype(np.float32)


def emulate_fwd(q, k, v, seg, scale, causal, three_terms=True, flushed=True, exact_b=True,
                keys=FWD_KEYS, parts=1):
    """(o [B, T, H, D], lse [B, H, T]) as `flash_fwd_tf32_kernel` forms them
    from fp32 q, k, v [B, T, H, D] and segment ids [B, T]: S = q.k^T in
    `product`'s order, in `parts` parts along D added in fp32
    (`split_product`; the split kernel's two halves at D 128 and 256); per
    tile of `keys` keys, s = S * scale masked to -inf, the running maximum m,
    alpha = 2^((m_old - m) log2 e), p = 2^((s - m) log2 e) (exactly 1 at the
    row's largest), o = o * alpha + p.V with p split as the A operand and V
    split exactly (`exact_b`); the row sum in each lane's
    order (keys 8 n + 2 t + e of a tile for lane t, a quad's four sums added
    pairwise at the end), o / l and lse = m + log l.  A tile the kernel skips
    is all masked here, which changes nothing: alpha is 1 and p 0."""
    b, t, h, d = q.shape
    bq, bk, bv = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    order = dict(three_terms=three_terms, flushed=flushed)
    s = split_product(bq, bk.transpose(0, 1, 3, 2), parts, **order)
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        visible = visible & np.tril(np.ones((t, t), bool))
    f32 = np.float32
    x = np.where(visible, (s * f32(scale)).astype(f32), f32(-np.inf))
    pad = (-t) % keys
    x = np.concatenate([x, np.full((b, h, t, pad), -np.inf, f32)], -1)
    bv = np.concatenate([bv, np.zeros((b, h, pad, d), f32)], -2)
    m = np.full((b, h, t), -np.inf, f32)
    lanes = np.zeros((b, h, t, 4), f32)
    o = np.zeros((b, h, t, d), f32)
    for k0 in range(0, t + pad, keys):
        xt = x[..., k0:k0 + keys]
        m_new = np.maximum(m, xt.max(-1))
        m_use = np.where(m_new == -np.inf, f32(0), m_new)
        alpha = _exp2((m - m_use) * LOG2E)
        p = _exp2((xt - m_use[..., None]) * LOG2E)
        lanes = lanes * alpha[..., None]
        for n in range(keys // 8):
            for e in range(2):
                lanes = lanes + p[..., 8 * n + 2 * np.arange(4) + e]
        o = product(p, bv[..., k0:k0 + keys, :], init=o * alpha[..., None],
                    exact_b=exact_b, **order)
        m = m_new
    l = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    o = o * (f32(1) / l)[..., None]
    lse = m + np.log(l.astype(np.float64)).astype(f32)
    return o.transpose(0, 2, 1, 3), lse


@functools.lru_cache(maxsize=None)
def _fwd_case(name: str):
    """The forward's inputs of CASES[name] (q, k, v, segment ids, scale,
    causal) at the true scale 1/sqrt(D) on an unscaled q, where the
    backward's D 128 cases take a pre-scaled q with scale 1 (`_case`), and
    the plain fp32 forward's (o, lse): what the card holds the kernel
    against."""
    q, k, v, _, mask, scale = _draw(name)
    causal = CASES[name][-1]
    tq, tk, tv = (torch.from_numpy(z) for z in (q, k, v))
    o, lse = fa.flash_self_attention_plain(tq, tk, tv, torch.from_numpy(mask), scale, True,
                                           causal)
    inputs = dict(q=q, k=k, v=v, seg=(~mask).astype(np.int32), scale=scale, causal=causal)
    return inputs, o.numpy(), lse.numpy()


def _fwd_inputs(name: str) -> tuple:
    inputs, _, _ = _fwd_case(name)
    return tuple(inputs[n] for n in ("q", "k", "v", "seg", "scale", "causal"))


@functools.lru_cache(maxsize=None)
def _emulated_fwd(name: str, **order):
    """The kernels' forward: at D 256 and 128 in the split kernel's walks
    (`FWD_D256_WALK`, `FWD_D128_WALK`)."""
    walk = (FWD_D256_WALK if name in D256_NAMES else FWD_D128_WALK if name in D128_NAMES
            else {})
    return emulate_fwd(*_fwd_inputs(name), **walk, **order)


def _plain_fwd(name: str):
    """(o, lse) of the port's plain fp32 forward."""
    _, o, lse = _fwd_case(name)
    return o, lse


def _upstream_fwd(name: str):
    """(o, lse) of upstream's `mha_reference` in fp32 with SegmentIds (and
    `causal`) at the forward case's scale; lse = m + log l from its
    residuals."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference, mha_reference_no_custom_vjp)

    inputs, _, _ = _fwd_case(name)
    q, k, v = (jnp.asarray(np.swapaxes(inputs[n], 1, 2)) for n in ("q", "k", "v"))
    ids = jnp.asarray(inputs["seg"])
    how = dict(segment_ids=SegmentIds(q=ids, kv=ids), causal=inputs["causal"],
               sm_scale=float(inputs["scale"]))
    o = np.swapaxes(np.asarray(mha_reference(q, k, v, None, **how)), 1, 2)
    _, l, m = mha_reference_no_custom_vjp(q, k, v, None, save_residuals=True, **how)
    return o, np.asarray(m) + np.log(np.asarray(l))


FWD_NAMES = list(CASES)


def _fwd_within_bars(o, lse, want_o, want_lse) -> bool:
    """o within KERNEL_TOL and within 1e-4 of its largest magnitude + rtol
    1e-3 (`assert_flash_close` in fp32), lse within KERNEL_TOL."""
    top = float(np.abs(want_o).max())
    err = np.abs(o - want_o)
    return bool(np.all(err <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(want_o))
                and np.all(err <= ATOL_REL * top + RTOL * np.abs(want_o))
                and np.all(np.abs(lse - want_lse)
                           <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(want_lse)))


@pytest.mark.parametrize("against", ["plain", "upstream"])
@pytest.mark.parametrize("name", FWD_NAMES)
def test_forward_kernel_order_holds_the_fp32_bars(name, against):
    """S in 3xTF32 (at D 128 and 256 in two halves added in fp32) and P V
    with V split exactly, truncating `mma`, flushed per k-chunk, the online
    softmax per K/V tile (32 keys, 16 at D 256): o and lse
    within KERNEL_TOL (and o within `assert_flash_close`'s fp32 bar) of the
    port's plain fp32 forward and of upstream's `mha_reference`."""
    want_o, want_lse = _plain_fwd(name) if against == "plain" else _upstream_fwd(name)
    o, lse = _emulated_fwd(name)
    torch.testing.assert_close(torch.tensor(o), torch.tensor(want_o), **KERNEL_TOL)
    torch.testing.assert_close(torch.tensor(lse), torch.tensor(want_lse), **KERNEL_TOL)
    assert _fwd_within_bars(o, lse, want_o, want_lse)


@pytest.mark.parametrize("name", FWD_NAMES)
def test_forward_plain_tf32_fails_the_fp32_bars(name):
    """One TF32 product (big.big alone) in both products misses the bars, so
    they tell a forward that dropped the small terms."""
    o, lse = _emulated_fwd(name, three_terms=False, flushed=False)
    assert not _fwd_within_bars(o, lse, *_plain_fwd(name))


@pytest.mark.parametrize("name", FWD_NAMES)
def test_forward_single_key_rows_get_v_exactly(name):
    """A row that sees one key (the first causal row; the ragged case's row
    of length 1) has p = 1, and with V split exactly its o is that key's v to
    the bit, as the backward's dP - delta needs; a two-part split of V (3xTF32
    on both products) misses bits there."""
    inputs, _, _ = _fwd_case(name)
    rows = (slice(None), 0) if inputs["causal"] else (2, 0)  # (batch, token)
    v = inputs["v"][rows]
    exact = _emulated_fwd(name)[0][rows]
    two_part = _emulated_fwd(name, exact_b=False)[0][rows]
    np.testing.assert_array_equal(exact, v)
    assert not np.array_equal(two_part, v)


@pytest.mark.parametrize("name", D128_NAMES)
def test_forward_d128_walk_parts_from_the_whole_d_order_within_the_bar(name):
    """At D 128 the split kernel forms S in two halves of 64 columns added in
    fp32 per 32-key tile, at the true scale 2^-3.5 on an unscaled q; the
    4-warp kernel it replaced summed whole rows over 32-key tiles: o of the
    two orders is not the same bits, and the split walk's o and lse sit
    within the fp32 bars of the whole-D order's."""
    inputs = _fwd_inputs(name)
    assert np.float32(inputs[4]) == np.float32(2.0 ** -3.5)
    split = _emulated_fwd(name)
    whole = emulate_fwd(*inputs, keys=FWD_KEYS)
    assert _fwd_within_bars(*split, *whole)
    assert not np.array_equal(split[0], whole[0])


@pytest.mark.parametrize("name", D256_NAMES)
def test_forward_d256_walk_parts_from_the_whole_d_order_within_the_bar(name):
    """At D 256 the split kernel forms S in two halves of 128 columns added in
    fp32, over the 16-key tiles of the kernel it replaced, which summed
    whole rows: o of the two orders is not the same bits, and the split
    walk's o and lse sit within the fp32 bars of the whole-D order's."""
    split = _emulated_fwd(name)
    whole = emulate_fwd(*_fwd_inputs(name), keys=FWD_D256_WALK["keys"])
    assert _fwd_within_bars(*split, *whole)
    assert not np.array_equal(split[0], whole[0])
