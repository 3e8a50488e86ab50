"""Grouped 1-D conv of the port against the JAX package.

The port's plain forward, dX and dW (what a CPU tensor takes) and its
autograd Function against `grouped_conv1d_cf` in interpret mode (forward) and
against `jax.grad` of `lax.conv_general_dilated` (gradients; the JAX package's
own tests pin the Pallas kernel's VJP to that reference).  The one numpy
weight is flax's [k, Cin/G, Cout] on the JAX side and torch's [Cout, Cin/G, k]
on the port's.  jax is imported inside the tests that use it: the card's
machine, where the `cuda` test of this file runs, has none.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import grouped_conv as gk
from roar_tpu_torch.ops.grouped_conv import GroupedConv1dCF, grouped_conv1d_cf, out_len

# fp32 on both sides (the plain versions on the CPU); only the order of
# summation differs
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

SHAPES = [
    # (B, W, cin, cout, k, s, g, pad): the classes of tests/test_grouped_conv.py
    (2, 64, 8, 8, 5, 1, 4, 2),
    (2, 64, 8, 16, 5, 2, 4, 2),
    (2, 64, 16, 16, 9, 4, 4, 4),
    (2, 64, 8, 8, 5, 1, 1, 2),
    (2, 64, 8, 8, 5, 1, 4, 1),
    (1, 66, 8, 8, 9, 1, 2, 4),
    (3, 64, 8, 8, 41, 2, 4, 20),
    (2, 257, 16, 16, 9, 4, 4, 4),   # odd width, stride 4: tail positions with fewer taps
]
IDS = [str(s) for s in SHAPES]


def _jax_grads(x, w, cot, s, pad, g):
    """(dx, dw) of sum(conv(x, w) * cot) by `jax.grad` of the lax conv."""
    import jax
    import jax.numpy as jnp

    def loss(x, w):
        y = jax.lax.conv_general_dilated(
            x, w, window_strides=(s,), padding=[(pad, pad)], feature_group_count=g,
            dimension_numbers=("NCW", "WIO", "NCW"))
        return jnp.sum(y * cot)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _inputs(shape, seed):
    b, wid, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, wid)).astype(np.float32)
    w = (rng.standard_normal((k, cin // g, cout)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((b, cout, out_len(wid, k, s, pad))).astype(np.float32)
    return x, w, cot


def _torch_weight(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from roar_tpu.ops.grouped_conv import grouped_conv1d_cf as jax_grouped_conv1d_cf

    *_, s, g, pad = shape
    x, w, _ = _inputs(shape, 0)
    want = np.asarray(jax_grouped_conv1d_cf(jnp.asarray(x), jnp.asarray(w), s, pad, g, True))
    got = grouped_conv1d_cf(torch.from_numpy(x), _torch_weight(w), s, pad, g).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_dx_dw_match_jax_grad(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 1)
    gx, gw = _jax_grads(x, w, cot, s, pad, g)
    dx = gk.grouped_conv_dx_plain(torch.from_numpy(cot), _torch_weight(w), wid, s, pad, g)
    dw = gk.grouped_conv_dw_plain(torch.from_numpy(x), torch.from_numpy(cot), k, s, pad, g)
    np.testing.assert_allclose(dx.numpy(), gx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy().transpose(2, 1, 0), gw, **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_autograd_function_matches_jax_grad(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 2)
    gx, gw = _jax_grads(x, w, cot, s, pad, g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = _torch_weight(w).requires_grad_()
    (grouped_conv1d_cf(xt, wt, s, pad, g) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 1, 0), gw, **GRAD_TOL)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4], (2, 21, 4, 6, 5, 4, 2, 1)],
                         ids=["stride2", "small_pad", "odd_width_stride4"])
def test_gradcheck_float64(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, cin, wid))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((cout, cin // g, k))).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, w: GroupedConv1dCF.apply(x, w, s, pad, g), (x, w))


def test_backward_runs_only_the_gradients_asked_for(monkeypatch):
    calls = []
    monkeypatch.setattr(gk, "grouped_conv_dx", lambda *a: calls.append("dx") or torch.zeros(2, 8, 64))
    monkeypatch.setattr(gk, "grouped_conv_dw", lambda *a: calls.append("dw") or torch.zeros(8, 2, 5))
    x = torch.randn(2, 8, 64, requires_grad=True)
    w = torch.randn(8, 2, 5)
    grouped_conv1d_cf(x, w, 1, 2, 4).sum().backward()
    assert calls == ["dx"]  # a weight that needs no gradient: no dW
    calls.clear()
    grouped_conv1d_cf(x.detach(), w.requires_grad_(), 1, 2, 4).sum().backward()
    assert calls == ["dw"]


def test_wrappers_reject_bad_geometry_and_foreign_devices():
    x, w = torch.zeros(1, 8, 16), torch.zeros(8, 2, 5)
    with pytest.raises(ValueError, match="groups"):
        gk.grouped_conv_fwd(x, w, 1, 2, 3)
    with pytest.raises(ValueError, match="weight must be"):
        gk.grouped_conv_fwd(x, torch.zeros(8, 4, 5), 1, 2, 4)
    with pytest.raises(ValueError, match="does not belong"):
        gk.grouped_conv_dx(torch.zeros(1, 8, 9), w, 16, 1, 2, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.grouped_conv_fwd(x.to("meta"), w.to("meta"), 1, 2, 4)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, wid, cin, cout, k, s, g, pad = shape
        x, w, cot = (torch.from_numpy(a).to(dev) for a in _inputs(shape, 4))
        w = w.permute(2, 1, 0).contiguous()
        for got, want in (
            (gk.grouped_conv_fwd(x, w, s, pad, g), gk.grouped_conv_fwd_plain(x, w, s, pad, g)),
            (gk.grouped_conv_dx(cot, w, wid, s, pad, g),
             gk.grouped_conv_dx_plain(cot, w, wid, s, pad, g)),
            (gk.grouped_conv_dw(x, cot, k, s, pad, g),
             gk.grouped_conv_dw_plain(x, cot, k, s, pad, g)),
        ):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        # fixed summation orders, no atomics: two runs give the same bits
        assert torch.equal(gk.grouped_conv_fwd(x, w, s, pad, g),
                           gk.grouped_conv_fwd(x, w, s, pad, g))
        assert torch.equal(gk.grouped_conv_dx(cot, w, wid, s, pad, g),
                           gk.grouped_conv_dx(cot, w, wid, s, pad, g))
        assert torch.equal(gk.grouped_conv_dw(x, cot, k, s, pad, g),
                           gk.grouped_conv_dw(x, cot, k, s, pad, g))


# `ptxas -v` lines of one kernel instance, as nvcc prints them, with the
# mangled names of a K3 (dX view) and a K4 instance of csrc/grouped_conv.cu
_NAMESPACE = "_ZN54_GLOBAL__N__5d1e6a7c_15_grouped_conv_cu_8f3c2b1e"
K3_MANGLED = _NAMESPACE + "15conv_mma_kernelILi2ELi4ELi2ELb1EEEvPKfS2_PfNS_8ConvGeomEii"
K4_MANGLED = _NAMESPACE + "13dw_mma_kernelILi8ELi2EEEvPKfS2_PfNS_8ConvGeomENS_8DwLayoutE"


def _ptxas_entry(mangled: str, registers: int, spill: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, 404 bytes cmem[0]\n")


# and of K1 and K2 of csrc/pyin_viterbi.cu (template arguments: band width,
# lanes a bin)
_VITERBI_NAMESPACE = "_ZN48_GLOBAL__N__08a71874_15_pyin_viterbi_cu_44b51aa9"
K1_MANGLED = _VITERBI_NAMESPACE + "23pyin_viterbi_fwd_kernelILi101ELi4EEEvNS_9FwdParamsE"
K2_MANGLED = _VITERBI_NAMESPACE + "21pyin_backtrack_kernelEPKiS1_Piiiiii"


def _build_log(k4_spill: int = 0, drop_k4=None, k1_spill: int = 0) -> str:
    """A log with every instance `chip_smoke.phase_kernel_build` requires."""
    import chip_smoke as cs
    from roar_tpu_torch.kernels.flash_attention import HEAD_DIMS

    log = ""
    for kernels in cs.FLASH_MMA_KERNELS.values():
        for kernel in kernels:
            for d in HEAD_DIMS:
                log += _ptxas_entry(f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{d}EEEvv", 128)
    # the fp32 and the bf16 instances (last template argument 0 and 1)
    for bf16 in (0, 1):
        for view in ("fwd", "dx"):
            for wn, nt, mt in cs.CONV_MMA_TILES:
                log += _ptxas_entry(K3_MANGLED.replace(
                    "ILi2ELi4ELi2ELb1E", f"ILi{wn}ELi{nt}ELi{mt}ELb{int(view == 'dx')}ELb{bf16}E"),
                    100)
        for nt, mt in cs.DW_MMA_TILES:
            if (nt, mt) != drop_k4 or bf16:
                log += _ptxas_entry(K4_MANGLED.replace("ILi8ELi2E", f"ILi{nt}ELi{mt}ELb{bf16}E"),
                                    128, k4_spill if (nt, mt) == (8, 2) and not bf16 else 0)
    for width in (101, 0):
        for lanes in (1, 2, 4, 8):
            log += _ptxas_entry(K1_MANGLED.replace("ILi101ELi4E", f"ILi{width}ELi{lanes}E"), 64,
                                k1_spill if (width, lanes) == (101, 4) else 0)
    return log + _ptxas_entry(K2_MANGLED, 25)


def test_ptxas_parser_reads_k3_and_k4_instances():
    import chip_smoke as cs

    table = cs.parse_ptxas(_ptxas_entry(K3_MANGLED, 122) + _ptxas_entry(K4_MANGLED, 128, 8)
                           + _ptxas_entry(K3_MANGLED.replace("ELb1E", "ELb1ELb1E"), 90)
                           + _ptxas_entry(K4_MANGLED.replace("ILi8ELi2E", "ILi8ELi2ELb1E"), 96))
    assert set(table) == {("conv_mma_kernel", "dx", (2, 4, 2)), ("dw_mma_kernel", "dw", (8, 2)),
                          ("conv_mma_kernel", "dx_bf16", (2, 4, 2)),
                          ("dw_mma_kernel", "dw_bf16", (8, 2))}
    assert table[("conv_mma_kernel", "dx_bf16", (2, 4, 2))]["registers"] == 90
    assert table[("conv_mma_kernel", "dx", (2, 4, 2))]["registers"] == 122
    k4 = table[("dw_mma_kernel", "dw", (8, 2))]
    assert (k4["registers"], k4["spill_store_bytes"], k4["spill_load_bytes"]) == (128, 8, 8)


@pytest.mark.parametrize("fault", [None, "spill", "missing", "viterbi_spill"])
def test_kernel_build_lists_every_k4_instance_and_raises_on_a_fault(tmp_path, monkeypatch,
                                                                     fault):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "count_hmma", lambda lib: None)  # no cuobjdump on the CPU host
    log = _build_log(k4_spill=8 if fault == "spill" else 0,
                     drop_k4=(2, 4) if fault == "missing" else None,
                     k1_spill=8 if fault == "viterbi_spill" else 0)
    (tmp_path / "lib.log").write_text(log)
    if fault is None:
        line = cs.phase_kernel_build(tmp_path / "lib.so")
        k4 = [row for row in line["grouped_conv_instances"] if row["kernel"] == "dw_mma_kernel"]
        assert [tuple(row["nt_mt"]) for row in k4] == cs.DW_MMA_TILES * 2  # fp32, then bf16
        assert [row["view"] for row in k4] == ["dw"] * 4 + ["dw_bf16"] * 4
        assert len(line["grouped_conv_instances"]) == 4 * len(cs.CONV_MMA_TILES) + len(k4)
        assert len(line["viterbi_instances"]) == 9  # K1 at two widths x four splits, K2
    elif fault == "viterbi_spill":
        with pytest.raises(AssertionError, match="pyin_viterbi_fwd_kernel.*spills"):
            cs.phase_kernel_build(tmp_path / "lib.so")
    else:
        match = "spills" if fault == "spill" else "not in the ptxas log"
        with pytest.raises(AssertionError, match=f"dw_mma_kernel.*{match}"):
            cs.phase_kernel_build(tmp_path / "lib.so")
