"""GPT at the head sizes whose kernels the GPT recipe's tiny-llama (D 64)
does not run against the JAX package on the CPU, and the rules of the flash
wrappers' head sizes.

On the card the port runs D 256 and D 128 on kernels of their own (in bf16
the forward and the backward on wgmma at both) and D 80 / 100 on the D 128 kernels through
zero-padding (`kernels/flash_attention.py`, `kernel_head_dim`).  Here the wrappers take their plain versions, and the JAX
package its einsum route (`_flash_attention_available()` is false off the
TPU).  Narrow widths, 2 layers, `use_flash=true`, the JAX module's initial
parameters carried over by `load_gpt_params`, one numpy-seeded batch: logits
at atol 2e-4 / rtol 1e-3, the loss, every gradient and three AdamW steps at
rtol 3e-3 (the bars of tests/test_torch_gpt.py and test_torch_gpt_train.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
import jax.numpy as jnp

from roar_tpu.models.gpt_model import GPTLMModel as JaxGPTLMModel
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models.gpt_model import GPTLMModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import TrainState, to_device, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-5)
VOCAB, SEQ, N_STEPS = 70, 24, 3
OPTIM = {"name": "adamw", "lr": 3e-4, "weight_decay": 0.1, "betas": [0.9, 0.95],
         "sched": {"name": "CosineAnnealing", "warmup_ratio": 0.02, "min_lr": 3e-5,
                   "max_steps": 10}}
# (registry entry, overrides): the head size each gives
CASES = {
    "neox_d256": ("pythia-1b", dict(n_embd=512, n_head=2)),
    "gemma_d256_one_group": ("gemma-2b", dict(n_embd=64, n_head=2, head_dim=256,
                                              n_query_groups=1)),
    "phi_d80": ("phi-2", dict(n_embd=160, n_head=2, padded_vocab_size=None)),
    "llama_d100": ("open_llama_3b", dict(n_embd=200, n_head=2)),
    "llama_d128": ("llama-2-7b", dict(n_embd=256, n_head=2)),
}
HEAD_SIZES = {"neox_d256": 256, "gemma_d256_one_group": 256, "phi_d80": 80, "llama_d100": 100,
              "llama_d128": 128}


def _cfg(case):
    name, own = CASES[case]
    return {"config_name": name, "n_layer": 2, "intermediate_size": 96, "vocab_size": VOCAB,
            "padding_multiple": 1, "block_size": SEQ, "use_flash": True, **own}


def _batch_np():
    window = np.random.default_rng(0).integers(0, VOCAB, (2, SEQ + 1)).astype(np.int32)
    return {"input_ids": window[:, :-1], "labels": window[:, 1:]}


def _port_model(case, params):
    model = GPTLMModel(_cfg(case))
    convert.load_gpt_params(model.module, jax.device_get(params))
    return model


@pytest.fixture(scope="module", params=list(CASES))
def jax_side(request):
    """The JAX task's logits, loss, gradients and three AdamW steps."""
    case = request.param
    model = JaxGPTLMModel(_cfg(case))
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    params = model.init_params(jax.random.PRNGKey(0), batch)
    logits = model.module.apply(params, batch["input_ids"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, batch), has_aux=True))(params)
    optimizer = jax_build_optimizer(OPTIM, gradient_clip_val=1.0)
    step = make_train_step(lambda p, b, rng, epoch: model.loss_fn(p, b), optimizer,
                           donate=False)
    state = create_train_state(params, optimizer)
    trajectory = []
    for _ in range(N_STEPS):
        state, step_metrics = step(state, batch, jax.random.PRNGKey(0), 0)
        trajectory.append({k: float(v) for k, v in step_metrics.items()})
    return {"case": case, "params": jax.device_get(params), "logits": np.asarray(logits),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.device_get(grads), "trajectory": trajectory,
            "final": jax.device_get(state.params)}


def _assert_tree_close(got, want, what, rtol, atol):
    got_flat, want_flat = flatten_dict(got), flatten_dict(want)
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        np.testing.assert_allclose(got_flat[path], np.asarray(value), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def test_head_size_and_logits_match_jax(jax_side):
    model = _port_model(jax_side["case"], jax_side["params"])
    assert model.config.head_size == HEAD_SIZES[jax_side["case"]]
    with torch.no_grad():
        got = model.module(torch.from_numpy(_batch_np()["input_ids"]).long()).numpy()
    assert got.shape == jax_side["logits"].shape
    np.testing.assert_allclose(got, jax_side["logits"], **LOGIT_TOL)


def test_loss_and_every_gradient_match_jax(jax_side):
    model = _port_model(jax_side["case"], jax_side["params"])
    loss, metrics = model.loss_fn(to_device(_batch_np(), torch.device("cpu")))
    for k, v in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    loss.backward()
    with torch.no_grad():  # the gradients in the parameters' places, as a tree
        for p in model.module.parameters():
            p.copy_(p.grad)
    got = convert.gpt_to_jax_tree(model.module)
    scale = max(float(np.abs(v).max()) for v in flatten_dict(jax_side["grads"]).values())
    _assert_tree_close(got, jax_side["grads"], "grad", rtol=3e-3, atol=3e-6 * scale)


def test_three_adamw_steps_follow_the_jax_trajectory(jax_side):
    model = _port_model(jax_side["case"], jax_side["params"])
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=1.0)
    state = TrainState(model=model, opt=opt)
    batch = to_device(_batch_np(), torch.device("cpu"))
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    # AdamW moves a weight by about lr a step whatever its gradient's size:
    # atol 2e-4 covers entries whose gradient is near rounding level
    _assert_tree_close(convert.gpt_to_jax_tree(model.module), jax_side["final"], "params",
                       rtol=3e-3, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["segments", "causal"])
@pytest.mark.parametrize("d", [80, 100])
def test_zero_padding_to_the_kernel_head_size_changes_nothing(d, causal):
    """The padded route's arithmetic, in the plain versions: q, k, v, o and dO
    zero-padded to `kernel_head_dim(d)` (128) with the true-D scale give the
    true-D results in their first d columns, zeros after, and the same lse."""
    assert fa.kernel_head_dim(d, torch.float32, True) == 128
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 50, 2, d)).astype(np.float32))
                   for _ in range(4))
    mask = torch.arange(50)[None, :] < torch.tensor([50, 31])[:, None]
    scale = 1.0 / d ** 0.5
    o, lse = fa.flash_self_attention_plain(q, k, v, mask, scale, True, causal)
    grads = fa.flash_self_attention_bwd_plain(q, k, v, mask, scale, o, lse, do, causal)
    qp, kp, vp, op, dop = (fa._pad(x, 128) for x in (q, k, v, o, do))
    o_pad, lse_pad = fa.flash_self_attention_plain(qp, kp, vp, mask, scale, True, causal)
    grads_pad = fa.flash_self_attention_bwd_plain(qp, kp, vp, mask, scale, op, lse_pad, dop,
                                                  causal)
    torch.testing.assert_close(lse_pad, lse, rtol=1e-6, atol=1e-6)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o_pad, *grads_pad), (o, *grads)):
        assert got.shape[-1] == 128 and torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))
        scale_of = float(want.abs().max())
        torch.testing.assert_close(got[..., :d], want, rtol=1e-6, atol=1e-6 * scale_of,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_kernel_head_dim_maps_and_raises():
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert [fa.kernel_head_dim(d, dtype, backward) for d in (16, 32, 48, 64, 80, 100,
                                                                     128)] == \
                [32, 32, 64, 64, 128, 128, 128]
            for d in (129, 200, 255, 257, 512, 0):
                with pytest.raises(ValueError, match="not supported"):
                    fa.kernel_head_dim(d, dtype, backward)
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert fa.kernel_head_dim(256, dtype, backward) == 256


def test_chip_smoke_lists_and_parses_the_d256_instances():
    """`phase_kernel_build` requires the six D 256 forms (the bf16 forward,
    dK/dV and dQ on wgmma, the fp32 forward, dK/dV and dQ as the split
    kernels), reads their mangled names (as the card's nvcc wrote them) and
    their shared memory; the bf16 forward and backward at D 128 run the wgmma
    kernels too (the forward's `<128>` instance must not be serialised by
    ptxas), and the bf16 mma.sync forward and backward kernels are built up
    to D 64 only, with one template argument; the fp32 forward at D 128 is
    the split kernel's `<128>` instance, the 4-warp fp32 forward built up to
    D 64 only."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    d256 = sorted(i for i in cs.flash_instances() if i[2] == 256)
    assert d256 == [("flash_bwd_dkv_tf32_split_kernel", "float32", 256),
                    ("flash_bwd_dkv_wgmma_kernel", "bfloat16", 256),
                    ("flash_bwd_dq_tf32_split_kernel", "float32", 256),
                    ("flash_bwd_dq_wgmma_kernel", "bfloat16", 256),
                    ("flash_fwd_tf32_split_kernel", "float32", 256),
                    ("flash_fwd_wgmma_kernel", "bfloat16", 256)]
    # the D <= 128 fp32 and bf16 kernels are not built at 256
    assert not any(i[0] in ("flash_bwd_dkv_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                            "flash_fwd_tf32_kernel", "flash_fwd_mma_kernel",
                            "flash_bwd_dkv_mma_kernel",
                            "flash_bwd_dq_mma_kernel") for i in d256)
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dkv_mma_kernel") == \
        sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dq_mma_kernel") == \
        [32, 64]
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dkv_wgmma_kernel") == \
        sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dq_wgmma_kernel") == \
        [128, 256]
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_fwd_mma_kernel") == [32, 64]
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_fwd_wgmma_kernel") == \
        [128, 256]
    assert cs.FLASH_WGMMA_UNSERIALIZED == {("flash_fwd_wgmma_kernel", "bfloat16", 128)}
    bwd = "_ZN55_GLOBAL__N__bd9a39ae_22_flash_attention_bwd_cu_f7cbd94c"
    tail32 = "EEvPKfS2_S2_PKiS2_S2_S2_PfS5_iifii"
    assert cs._flash_instance(f"{bwd}31flash_bwd_dkv_tf32_split_kernelILi256{tail32}") == \
        ("flash_bwd_dkv_tf32_split_kernel", "float32", 256)
    assert cs._flash_instance(f"{bwd}25flash_bwd_dkv_tf32_kernelILi64{tail32}") == \
        ("flash_bwd_dkv_tf32_kernel", "float32", 64)
    assert cs._flash_instance(f"{bwd}30flash_bwd_dq_tf32_split_kernelILi256"
                              "EEvPKfS2_S2_PKiS2_S2_S2_Pfiifi") == \
        ("flash_bwd_dq_tf32_split_kernel", "float32", 256)
    # the wgmma backward kernels take four tensor maps by value
    maps = "EEEv14CUtensorMap_stS1_S1_S1_PKiPKfS5_P13__nv_bfloat16"
    assert cs._flash_instance(f"{bwd}26flash_bwd_dkv_wgmma_kernelILi256{maps}S7_iifi") == \
        ("flash_bwd_dkv_wgmma_kernel", "bfloat16", 256)
    assert cs._flash_instance(f"{bwd}25flash_bwd_dq_wgmma_kernelILi256{maps}iifi") == \
        ("flash_bwd_dq_wgmma_kernel", "bfloat16", 256)
    assert cs._flash_instance(f"{bwd}26flash_bwd_dkv_wgmma_kernelILi128{maps}S7_iifi") == \
        ("flash_bwd_dkv_wgmma_kernel", "bfloat16", 128)
    # the kernel each D 256 entry point must launch once a call is built there
    assert sorted((k, t) for t, entries in cs.FLASH_D256_KERNELS.items()
                  for k in entries.values()) == [(k, t) for k, t, _ in d256]
    # K, V (32 keys); Q and dO x 2 stages of 32 rows; 4096 words of partial tiles
    assert cs.flash_dynamic_smem("flash_bwd_dkv_tf32_split_kernel", "float32", 256) == \
        4 * (260 * 6 * 32 + 4096) == 216064
    assert cs.flash_dynamic_smem("flash_bwd_dq_tf32_split_kernel", "float32", 256) == 216064
    # the fp32 backward at D 128 runs the pair kernels (the 4-warp kernels are
    # built up to D 64): K, V; Q and dO x 2 stages of 64 rows; P^T of the 4 key
    # groups (4096 words); each stage's lse and delta rows; the dK warps' dS^T
    # of a half tile (2048 words).  dQ: Q, dO; K and V x 2 stages of 32 keys;
    # P and dP of the 4 query groups (4096 words)
    assert sorted(i for i in cs.flash_instances() if i[1:] == ("float32", 128)) == [
        ("flash_bwd_dkv_tf32_pair_kernel", "float32", 128),
        ("flash_bwd_dq_tf32_pair_kernel", "float32", 128),
        ("flash_fwd_tf32_split_kernel", "float32", 128)]
    # and the forward at D 128 the split kernel (the 4-warp forward is built
    # up to D 64)
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_fwd_tf32_kernel") == \
        [32, 64]
    assert sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dkv_tf32_kernel") == \
        sorted(d for k, t, d in cs.flash_instances() if k == "flash_bwd_dq_tf32_kernel") == \
        [32, 64]
    assert cs.flash_dynamic_smem("flash_bwd_dkv_tf32_pair_kernel", "float32", 128) == \
        4 * (132 * 6 * 64 + 4096 + 4 * 64 + 2048) == 228352
    assert cs.flash_dynamic_smem("flash_bwd_dq_tf32_pair_kernel", "float32", 128) == \
        4 * (132 * (2 * 64 + 4 * 32) + 4096) == 151552
    assert cs._flash_instance(f"{bwd}30flash_bwd_dkv_tf32_pair_kernelILi128{tail32}") == \
        ("flash_bwd_dkv_tf32_pair_kernel", "float32", 128)
    # six 64-row bf16 tiles, the exchange (P^T fp32; P fp32 + dS bf16), five
    # barriers, 1 KB to align
    assert cs.flash_dynamic_smem("flash_bwd_dkv_wgmma_kernel", "bfloat16", 256) == \
        2 * 64 * 256 * 6 + 4 * 64 * 64 + 40 + 1024 == 214056
    assert cs.flash_dynamic_smem("flash_bwd_dq_wgmma_kernel", "bfloat16", 256) == \
        2 * 64 * 256 * 6 + 6 * 64 * 64 + 40 + 1024 == 222248
    # D 128: two 128-row tiles, two 64-row tiles x 2 stages (dK/dV: with
    # their lse and delta rows), five barriers, 1 KB to align
    assert cs.flash_dynamic_smem("flash_bwd_dkv_wgmma_kernel", "bfloat16", 128) == \
        2 * 128 * (256 + 256) + 2 * 4 * 64 * 2 + 40 + 1024 == 133160
    assert cs.flash_dynamic_smem("flash_bwd_dq_wgmma_kernel", "bfloat16", 128) == \
        2 * 128 * (256 + 256) + 40 + 1024 == 132136
    # the kernel a call launches at D 128, where the profiler checks it
    assert cs.flash_kernels_of_a_call(128, "bfloat16") == {
        "fwd": "flash_fwd_wgmma_kernel", "dkv": "flash_bwd_dkv_wgmma_kernel",
        "dq": "flash_bwd_dq_wgmma_kernel"}
    assert cs.flash_kernels_of_a_call(128, "float32") == {
        "fwd": "flash_fwd_tf32_split_kernel", "dkv": "flash_bwd_dkv_tf32_pair_kernel",
        "dq": "flash_bwd_dq_tf32_pair_kernel"}
    assert cs.flash_kernels_of_a_call(64, "float32") is None
    space = "_ZN60_GLOBAL__N__5c1a7f2e_22_flash_attention_bwd_cu_9e8d7c6b"
    tail = "EEvPK13__nv_bfloat16S2_S2_PKiPKfS6_S2_PS0_S7_iifi"
    assert cs._flash_instance(f"{space}24flash_bwd_dkv_mma_kernelILi64{tail}") == \
        ("flash_bwd_dkv_mma_kernel", "bfloat16", 64)
    assert cs._flash_instance(f"{space}24flash_bwd_dkv_mma_kernelILi128{tail}") == \
        ("flash_bwd_dkv_mma_kernel", "bfloat16", 128)
    assert cs._flash_instance(f"{space}21flash_fwd_tf32_kernelILi64EEEvPKfS2_S2_PKiPfS5_iifi") \
        == ("flash_fwd_tf32_kernel", "float32", 64)
    assert cs._flash_instance(
        f"{space}27flash_fwd_tf32_split_kernelILi128EEEvPKfS2_S2_PKiPfS5_iifi") == \
        ("flash_fwd_tf32_split_kernel", "float32", 128)
    assert cs._flash_instance(
        f"{space}27flash_fwd_tf32_split_kernelILi256EEEvPKfS2_S2_PKiPfS5_iifi") == \
        ("flash_fwd_tf32_split_kernel", "float32", 256)
    assert cs._flash_instance(f"{space}20flash_fwd_mma_kernelILi64EEEvPK13__nv_bfloat16") == \
        ("flash_fwd_mma_kernel", "bfloat16", 64)
    assert cs._flash_instance(f"{space}22flash_fwd_wgmma_kernelILi256EEEv14CUtensorMap_st") == \
        ("flash_fwd_wgmma_kernel", "bfloat16", 256)
    # the forward's D 128 instance, an explicit specialisation of the same template
    fwd = "_ZN55_GLOBAL__N__bd9a39ae_22_flash_attention_fwd_cu_f7cbd94c"
    assert cs._flash_instance(f"{fwd}22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_"
                              "PKiP13__nv_bfloat16Pfiifi") == \
        ("flash_fwd_wgmma_kernel", "bfloat16", 128)
    for kernel, dtype, d in d256:
        assert cs.flash_dynamic_smem(kernel, dtype, d) <= cs.H100_SMEM_PER_BLOCK
    # Q (64 rows); K and V x 2 stages of 16 keys; 2048 words of S halves
    assert cs.flash_dynamic_smem("flash_fwd_tf32_split_kernel", "float32", 256) == \
        4 * (260 * (64 + 4 * 16) + 2048) == 141312
    # at D 128: Q's two halves (2 x 64 rows); K and V x 3 stages of 32 keys;
    # 4096 words of S halves
    assert cs.flash_dynamic_smem("flash_fwd_tf32_split_kernel", "float32", 128) == \
        4 * (132 * (2 * 64 + 6 * 32) + 4096) == 185344
    assert cs.flash_dynamic_smem("flash_fwd_tf32_kernel", "float32", 64) == 69632
    # Q of 128 rows, K and V x 2 stages of 64, five barriers, 1 KB to align
    assert cs.flash_dynamic_smem("flash_fwd_wgmma_kernel", "bfloat16", 256) == \
        2 * 256 * (128 + 4 * 64) + 40 + 1024 == 197672
    # at D 128: Q of 128 rows, K and V x 3 stages of 128 keys, ten barriers
    # (Q; K full, V full, empty a stage), 1 KB to align: one block a SM
    assert cs.flash_dynamic_smem("flash_fwd_wgmma_kernel", "bfloat16", 128) == \
        2 * 128 * (128 + 6 * 128) + 80 + 1024 == 230480 <= cs.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("shape, causal, lens", [
    ((1, 20, 2, 8), True, None),
    ((2, 30, 2, 8), True, [30, 14]),
    ((4, 20, 2, 8), False, [20, 1, 10, 17])])
def test_chip_smoke_finds_the_single_key_rows(shape, causal, lens):
    """`_single_key_rows` at the kinds of phase `kernel_flash_head_sizes`'s
    fp32 D 256 shapes, cut short: the first row of each batch row and, under
    a key mask, the first pad row with `causal`; the one valid row of a
    length-1 batch row without.  `_forward_exact_checks` holds them on the
    CPU, where the wrapper takes the plain forward: o equals v there."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from roar_tpu_torch.kernels import flash_attention as fa

    device = torch.device("cpu")
    key_mask = cs._key_mask(lens, shape[1], device)
    rows = cs._single_key_rows(key_mask, shape, causal, device)
    want = torch.zeros(shape[:2], dtype=torch.bool)
    if causal:
        want[:, 0] = True
        for b, n in enumerate(lens or []):
            if n < shape[1]:
                want[b, n] = True
    else:
        for b, n in enumerate(lens):
            want[b, 0] = n == 1
            want[b, shape[1] - 1] = shape[1] - n == 1
    assert torch.equal(rows, want)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=gen) for _ in range(3))
    scale = shape[3] ** -0.5
    out = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True, causal=causal)[0]
    found = cs._forward_exact_checks(q, k, v, key_mask, scale, causal, out)
    assert found["single_key_rows_o_equal_v"] == int(want.sum()) * shape[2]


@pytest.mark.parametrize("shape, causal, lens", [
    ((1, 20, 2, 128), True, None),
    ((2, 30, 2, 128), True, [30, 14]),
    ((4, 20, 2, 128), False, [20, 1, 10, 17])])
def test_chip_smoke_exact_forward_checks_hold_in_bf16(shape, causal, lens):
    """`_forward_exact_checks` as phase `kernel_flash_head_sizes` runs it on
    the bf16 forward at D 128, at those shapes' kinds cut short: a single-key
    row's p is 1 and its row sum 1, so its o is its bf16 v to the bit; two
    runs give the same bits.  On the CPU the wrapper takes the plain forward."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from roar_tpu_torch.kernels import flash_attention as fa

    device = torch.device("cpu")
    key_mask = cs._key_mask(lens, shape[1], device)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=gen).bfloat16() for _ in range(3))
    scale = shape[3] ** -0.5
    out = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True, causal=causal)[0]
    found = cs._forward_exact_checks(q, k, v, key_mask, scale, causal, out)
    rows = cs._single_key_rows(key_mask, shape, causal, device)
    assert found["single_key_rows_o_equal_v"] == int(rows.sum()) * shape[2] > 0
    # a row that sees two keys is not its v
    two = cs._single_key_rows(None, shape, True, device).roll(1, dims=1)
    assert not torch.equal(out[two], v[two])


def test_chip_smoke_head_size_phases_rehearse_on_the_cpu(capsys):
    """`phase_train_gpt` for pythia-1b and `phase_gpt_head_sizes` at
    rehearsal widths on the CPU: every check but the launch counts and the
    timing (pythia's fp32 check is a micro-batch, kernels against plain, at
    min(4, its layers) layers; phi-2, gemma-2b and llama-2-7b add an fp32
    micro-batch, whose launch counts, all and padded, come back zero here;
    Mixtral's plain passes are fed the kernel pass's expert choice, and on the
    CPU no token is routed differently)."""
    sys.path.insert(0, str(REPO))
    import json

    import chip_smoke as cs

    none = {"fwd": 0, "dkv": 0, "dq": 0}
    out = cs.phase_train_gpt(torch.device("cpu"), narrow=True, seq_length=128, vocab_size=300,
                             config_name="pythia-1b")  # its 8 updates (GPT_RUNS)
    assert out == {"launches": none, "launches_bf16": none, "per_micro_batch": none,
                   "fp32_check_launches": none}
    heads = cs.phase_gpt_head_sizes(torch.device("cpu"), seq_length=48, narrow=True)
    assert set(heads) == {name for name, _, _ in cs.GPT_HEAD_SIZE_RUNS}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    check = [line for line in lines if line.get("step") == "kernel_path_vs_plain_path"]
    assert len(check) == 1 and check[0]["config_name"] == "pythia-1b"
    assert check[0]["fp32"]["layers"] == 2 and check[0]["fp32"]["whole_grad_l2_rel_err"] == 0.0
    rows = {line["config_name"]: line for line in lines if line.get("phase") == "gpt_head_sizes"}
    assert {name: row["kernel_head_size"] for name, row in rows.items()} == \
        {"phi-2": 128, "open_llama_3b": 128, "gemma-2b": 256, "llama-2-7b": 128,
         "Mixtral-8x7B-v0.1": 128}
    assert all(row["bf16"]["whole_grad_l2_rel_err"] == 0.0 for row in rows.values())
    assert {name: row["fp32"] is not None for name, row in rows.items()} == \
        {"phi-2": True, "open_llama_3b": False, "gemma-2b": True, "llama-2-7b": True,
         "Mixtral-8x7B-v0.1": True}
    assert set(cs.GPT_HEAD_SIZE_FP32) == {"phi-2", "gemma-2b", "llama-2-7b",
                                          "Mixtral-8x7B-v0.1"}
    for dtype in ("bf16", "fp32"):
        moe = rows["Mixtral-8x7B-v0.1"][dtype]
        assert moe["tokens_routed_differently_fed"] == [0, 0] and moe["tokens"] == 48
        assert moe["plain_on_its_own_routing"]["tokens_routed_differently"] == [0, 0]
    # a rehearsal runs every entry at its own `seq_length`
    assert all(row["batch_shape"] == [1, 48] for row in rows.values())
    for name in cs.GPT_HEAD_SIZE_FP32:
        assert rows[name]["fp32"]["whole_grad_l2_rel_err"] == 0.0
        assert heads[name]["fp32"] == heads[name]["fp32_padded"] == none
        assert rows[name]["launches"]["fp32"] == none
