"""The bf16 tensor-core dK/dV and dQ kernels' loop orders and roundings,
emulated on the CPU against the bar of `chip_smoke.assert_flash_close`.

The dK/dV kernel sums, for each key, the query chunks of 16 from its own key
tile's diagonal on; the dQ kernel sums, for each query, the key chunks of 16
up to its own query tile's diagonal.  Both take p and dS in fp32, round each
to bf16 before its product, and keep fp32 accumulators that are rounded once
at the end.  The emulations below sum every row's chunks in that order, all
rows together: a chunk outside a row's range of tiles adds exact zeros, since
the causal mask zeroes p and dS there.  Each order passes the bar against the
plain backward at (1, 1024, 2, 64); the same loop missing the diagonal tile
fails it.  Card-free: no `cuda` test here.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _bf16_bar_inputs():
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 1024, 2, 64)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    return q, k, v, do, 1.0 / 8.0


def _tiled_dkv_bf16(q, k, v, do, o, lse, scale, k_tile=64, chunk=16, skip_diagonal=False):
    """dK and dV of the causal attention as the tensor-core dK/dV kernel
    orders them: per key, the query chunks of 16 from its key tile's diagonal
    on, in turn; P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) *
    scale in fp32, each rounded to bf16 before its product, fp32 accumulators
    rounded once at the end.  `skip_diagonal` leaves out the query tile on the
    key tile's own diagonal, as a loop starting one tile late would."""
    b, t, h, d = q.shape
    q32, k32, v32, do32 = (z.float() for z in (q, k, v, do))
    delta = (o.float() * do32).sum(-1).permute(0, 2, 1)  # [B, H, T]
    keys = torch.arange(t)
    acc_dk = torch.zeros(b, h, t, d)
    acc_dv = torch.zeros(b, h, t, d)
    for c0 in range(0, t, chunk):
        rows = torch.arange(c0, min(c0 + chunk, t))
        st = torch.einsum("bkhd,bqhd->bhkq", k32, q32[:, rows])
        dpt = torch.einsum("bkhd,bqhd->bhkq", v32, do32[:, rows])
        pt = torch.exp(st * scale - lse[:, :, None, rows])
        hide = keys[:, None] > rows[None, :]
        if skip_diagonal:
            hide = hide | (keys[:, None] // k_tile == rows[None, :] // k_tile)
        pt = pt.masked_fill(hide, 0.0)
        dst = pt * (dpt - delta[:, :, None, rows]) * scale
        acc_dv += torch.einsum("bhkq,bqhd->bhkd", pt.bfloat16().float(), do32[:, rows])
        acc_dk += torch.einsum("bhkq,bqhd->bhkd", dst.bfloat16().float(), q32[:, rows])
    return (acc_dk.permute(0, 2, 1, 3).to(k.dtype), acc_dv.permute(0, 2, 1, 3).to(v.dtype))


@pytest.mark.parametrize("skip_diagonal", [False, True], ids=["kernel_order", "diagonal_skipped"])
def test_bf16_bar_takes_the_tensor_core_dkv_order(skip_diagonal):
    """The dK/dV kernel's loop order and roundings pass the bar against the
    plain backward at (1, 1024, 2, 64); the same loop starting one query tile
    late fails it."""
    close = _chip_smoke().assert_flash_close
    q, k, v, do, scale = _bf16_bar_inputs()
    o, lse = fa.flash_self_attention_plain(q, k, v, None, scale, True, causal=True)
    _, dk_w, dv_w = fa.flash_self_attention_bwd_plain(q, k, v, None, scale, o, lse, do, True)
    dk, dv = _tiled_dkv_bf16(q, k, v, do, o, lse, scale, skip_diagonal=skip_diagonal)
    for name, got, want in (("dk", dk, dk_w), ("dv", dv, dv_w)):
        if skip_diagonal:
            with pytest.raises(AssertionError):
                close(got, want, name)
        else:
            assert not torch.equal(got, want)
            errs = close(got, want, name)
            assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3


def _tiled_dq_bf16(q, k, v, do, o, lse, scale, q_tile=64, chunk=16, skip_diagonal=False):
    """dQ of the causal attention as the tensor-core dQ kernel orders it: per
    query, the key chunks of 16 up to its query tile's diagonal, in turn;
    P = exp(S * scale - lse) and dS = P (dP - delta) * scale in fp32 from the
    unrounded P, dS rounded to bf16 before dS K, fp32 accumulators rounded
    once at the end.  `skip_diagonal` leaves out the key tile on the query
    tile's own diagonal, as a loop ending one tile early would."""
    b, t, h, d = q.shape
    q32, k32, v32, do32 = (z.float() for z in (q, k, v, do))
    delta = (o.float() * do32).sum(-1).permute(0, 2, 1)  # [B, H, T]
    rows = torch.arange(t)
    acc = torch.zeros(b, h, t, d)
    for c0 in range(0, t, chunk):
        keys = torch.arange(c0, min(c0 + chunk, t))
        s_ = torch.einsum("bqhd,bkhd->bhqk", q32, k32[:, keys])
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32[:, keys])
        p = torch.exp(s_ * scale - lse[..., None])
        hide = keys[None, :] > rows[:, None]
        if skip_diagonal:
            hide = hide | (keys[None, :] // q_tile == rows[:, None] // q_tile)
        p = p.masked_fill(hide, 0.0)
        ds = p * (dp - delta[..., None]) * scale
        acc += torch.einsum("bhqk,bkhd->bhqd", ds.bfloat16().float(), k32[:, keys])
    return acc.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("skip_diagonal", [False, True], ids=["kernel_order", "diagonal_skipped"])
def test_bf16_bar_takes_the_tensor_core_dq_order(skip_diagonal):
    """The dQ kernel's loop order and roundings pass the bar against the
    plain backward at (1, 1024, 2, 64); the same loop ending one key tile
    early fails it."""
    close = _chip_smoke().assert_flash_close
    q, k, v, do, scale = _bf16_bar_inputs()
    o, lse = fa.flash_self_attention_plain(q, k, v, None, scale, True, causal=True)
    dq_w = fa.flash_self_attention_bwd_plain(q, k, v, None, scale, o, lse, do, True)[0]
    dq = _tiled_dq_bf16(q, k, v, do, o, lse, scale, skip_diagonal=skip_diagonal)
    if skip_diagonal:
        with pytest.raises(AssertionError):
            close(dq, dq_w, "dq")
    else:
        assert not torch.equal(dq, dq_w)
        errs = close(dq, dq_w, "dq")
        assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3
