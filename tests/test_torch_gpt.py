"""The port's GPT (roar_tpu_torch/models/gpt.py) against roar_tpu/models/gpt.py
on the CPU: the same numpy-seeded tokens, the JAX module's own initial
parameters carried over by `load_gpt_params`.  The JAX side runs as its own
tests run it off the TPU: `use_flash` falls back to the einsum route there
(tests/test_gpt.py:101), while the port's `use_flash=True` takes the causal
flash wrapper's plain version.  fp32 on both sides: atol 2e-4 / rtol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roar_tpu.models import gpt as jgpt
from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models import gpt as tgpt
from roar_tpu_torch.training.convert import flatten_params, gpt_to_jax_tree, load_gpt_params

TOL = dict(atol=2e-4, rtol=1e-3)
NARROW = dict(n_layer=2, n_embd=64, n_head=4, intermediate_size=96, vocab_size=90,
              padded_vocab_size=None, padding_multiple=1, block_size=48)
# registry families at 2 layers and narrow widths: llama (RMSNorm, SwiGLU, GQA),
# neox (LayerNorm, biases, parallel residual, 0.25 rotary), phi (shared norm,
# lm_head bias, tanh gelu, partial rotary), falcon-7b (shared norm, MQA,
# head_dim override), gemma (GeGLU, scaled embeddings)
SHAPES = {
    "llama": ("tiny-llama-1.1b", dict(n_query_groups=2)),
    "neox": ("pythia-70m", {}),
    "phi": ("phi-2", {}),
    "falcon": ("falcon-7b", dict(head_dim=16, n_query_groups=1)),
    "gemma": ("gemma-2b", dict(n_query_groups=1, head_dim=32)),
}


def _configs(shape, **extra):
    name, own = SHAPES[shape]
    fields = {**NARROW, **own, **extra}
    return jgpt.config_from_name(name, **fields), tgpt.config_from_name(name, **fields)


def _tokens(seed, b=2, t=20, vocab=90):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _pair(shape, seed=0, **extra):
    """(JAX module, its initial params, the port's module filled from them)."""
    jcfg, tcfg = _configs(shape, **extra)
    jmodel = jgpt.GPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(_tokens(0)))
    tmodel = load_gpt_params(tgpt.GPT(tcfg), jax.device_get(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_logits_match_jax(shape, use_flash):
    jmodel, params, tmodel = _pair(shape, use_flash=use_flash)
    tokens = _tokens(1, t=37)  # no multiple of any tile
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape == (2, 37, 90)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_padding_mask_matches_jax_at_valid_positions(use_flash):
    """With a trailing pad mask the JAX einsum route lets a pad query see
    valid keys and the flash route does not (gpt.py:494-499): the valid
    positions agree either way."""
    jmodel, params, tmodel = _pair("llama", use_flash=use_flash)
    tokens = _tokens(2, t=30)
    mask = np.arange(30)[None, :] < np.array([30, 17])[:, None]
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens), mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens).long(), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[mask], want[mask], **TOL)


def test_return_hidden_is_the_lm_head_input():
    jmodel, params, tmodel = _pair("phi")
    tokens = _tokens(3)
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens), return_hidden=True))
    with torch.no_grad():
        hidden = tmodel(torch.from_numpy(tokens).long(), return_hidden=True)
        logits = tmodel(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(hidden.numpy(), want, **TOL)
    torch.testing.assert_close(tmodel.lm_head(hidden), logits)


@pytest.mark.parametrize("shape", ["llama", "phi"])
def test_cached_decode_equals_full_forward_and_jax(shape):
    jmodel, params, tmodel = _pair(shape)
    tokens = _tokens(4, t=12)
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        full = tmodel(tt)
        caches = tgpt.init_kv_caches(tmodel.config, 2)
        prefill, caches = tmodel(tt[:, :8], 0, caches)
        steps = [prefill]
        for i in range(8, 12):
            logits, caches = tmodel(tt[:, i:i + 1], i, caches)
            steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, atol=1e-5, rtol=1e-4)
    jcaches = jgpt.init_kv_caches(jmodel.config, 2)
    want, jcaches = jmodel.apply(params, jnp.asarray(tokens[:, :8]), 0, jcaches)
    np.testing.assert_allclose(prefill.numpy(), np.asarray(want), **TOL)
    # the caches hold the same rotated keys and values
    np.testing.assert_allclose(caches[1][0][:, :8].numpy(), np.asarray(jcaches[1][0])[:, :8],
                               **TOL)


@pytest.mark.parametrize("shape", ["llama", "neox", "gemma"])
def test_generate_greedy_tokens_equal_jax(shape):
    jmodel, params, tmodel = _pair(shape)
    prompt = _tokens(5, t=6)
    want = np.asarray(jgpt.generate(jmodel, params, jnp.asarray(prompt), 10, temperature=0.0))
    got = tgpt.generate(tmodel, torch.from_numpy(prompt), 10, temperature=0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_top_k_draws_from_the_k_best_with_an_explicit_generator():
    _, _, tmodel = _pair("llama")
    prompt = torch.from_numpy(_tokens(6, t=5))
    draw = lambda seed: tgpt.generate(tmodel, prompt, 8, temperature=0.8, top_k=3,
                                      generator=torch.Generator().manual_seed(seed))
    a, b = draw(7), draw(7)
    assert torch.equal(a, b) and a.shape == (2, 13) and torch.equal(a[:, :5], prompt)
    # each drawn token is among the three best of the logits that produced it
    with torch.no_grad():
        logits = tmodel(a[:, :-1].long())
    for i in range(5, 13):
        best = logits[:, i - 1].topk(3).indices
        assert all(int(a[r, i]) in best[r].tolist() for r in range(2))
    assert not torch.equal(draw(7), draw(8))
    with pytest.raises(ValueError, match="block_size"):
        tgpt.generate(tmodel, prompt, 44)


def _loss_and_grads(tmodel, tokens, weights):
    tmodel.zero_grad(set_to_none=True)
    loss = (tmodel(tokens) * weights).sum()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in tmodel.named_parameters()}


@pytest.mark.parametrize("shape", ["llama", "falcon"])
def test_remat_policies_give_the_same_gradients(shape, monkeypatch):
    """No remat, remat "nothing" and remat "flash" give bit-identical losses
    and gradients; the attention forward runs n_layer times under "flash"
    (its outputs are kept) and 2 * n_layer times under "nothing" (the JAX
    counterpart is tests/test_gpt.py test_flash_remat_policy)."""
    _, params, _ = _pair(shape, use_flash=True)
    _, tcfg = _configs(shape, use_flash=True)
    tokens = torch.from_numpy(_tokens(8, t=33)).long()
    weights = torch.from_numpy(
        np.random.default_rng(9).standard_normal((2, 33, 90)).astype(np.float32))
    calls = []
    real = fa.flash_self_attention

    def counted(*args, **kwargs):
        calls.append(kwargs.get("causal"))
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_self_attention", counted)
    results = {}
    for key, fields in (("none", dict(remat=False)),
                        ("nothing", dict(remat=True, remat_policy="nothing")),
                        ("flash", dict(remat=True, remat_policy="flash"))):
        model = load_gpt_params(tgpt.GPT(dataclasses.replace(tcfg, **fields)),
                                jax.device_get(params))
        calls.clear()
        results[key] = _loss_and_grads(model, tokens, weights)
        assert calls == [True] * (4 if key == "nothing" else 2), key
    for key in ("nothing", "flash"):
        assert torch.equal(results[key][0], results["none"][0])
        for name, g in results["none"][1].items():
            assert torch.equal(results[key][1][name], g), (key, name)


def test_remat_flash_without_the_flash_route_recomputes_whole_blocks():
    _, params, _ = _pair("llama")
    _, tcfg = _configs("llama", use_flash=False)
    tokens = torch.from_numpy(_tokens(10)).long()
    weights = torch.ones(2, 20, 90)
    plain = load_gpt_params(tgpt.GPT(tcfg), jax.device_get(params))
    remat = load_gpt_params(
        tgpt.GPT(dataclasses.replace(tcfg, remat=True, remat_policy="flash")),
        jax.device_get(params))
    (la, ga), (lb, gb) = (_loss_and_grads(m, tokens, weights) for m in (plain, remat))
    assert torch.equal(la, lb) and all(torch.equal(ga[n], gb[n]) for n in ga)


@pytest.mark.parametrize("scan_layers", [False, True], ids=["h_i", "h_scan"])
@pytest.mark.parametrize("shape", ["llama", "neox"])
def test_both_parameter_layouts_round_trip(shape, scan_layers):
    """The JAX module's own tree (unrolled, or stacked by `nn.scan`) fills the
    port, gives the JAX logits, and comes back leaf for leaf."""
    jmodel, params, tmodel = _pair(shape, scan_layers=scan_layers)
    tree = jax.device_get(params)
    assert ("h_scan" in tree["params"]) == scan_layers
    tokens = _tokens(11)
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    back = flatten_params(gpt_to_jax_tree(tmodel))
    orig = flatten_params(tree)
    assert set(back) == set(orig)
    for path, value in orig.items():
        assert back[path].shape == value.shape, path
        np.testing.assert_array_equal(back[path], value, err_msg=path)
    # the stacked tree also fills an unrolled module, and the reverse
    other = tgpt.GPT(dataclasses.replace(tmodel.config, scan_layers=not scan_layers))
    load_gpt_params(other, gpt_to_jax_tree(tmodel))
    for (n, a), b in zip(tmodel.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), n


def test_load_gpt_params_raises_on_unconsumed_and_unfilled():
    _, params, tmodel = _pair("llama")
    tree = jax.device_get(params)["params"]
    with pytest.raises(ValueError, match="not consumed"):
        load_gpt_params(tmodel, {**tree, "extra": {"kernel": np.zeros(3, np.float32)}})
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(KeyError, match="ln_f"):
        load_gpt_params(tmodel, missing)
    _, tcfg = _configs("llama", n_layer=3)
    with pytest.raises(KeyError, match="h_2"):
        load_gpt_params(tgpt.GPT(tcfg), tree)


def test_scan_layers_refuses_kv_cache_decode():
    _, tcfg = _configs("llama", scan_layers=True)
    model = tgpt.GPT(tcfg)
    with pytest.raises(ValueError, match="scan_layers"):
        model(torch.zeros(1, 4, dtype=torch.long), 0, tgpt.init_kv_caches(tcfg, 1))
    with pytest.raises(ValueError, match="block_size"):
        model(torch.zeros(1, 49, dtype=torch.long))


@pytest.mark.parametrize("name", sorted(jgpt.GPT_CONFIGS))
def test_config_from_name_resolves_every_registry_name_like_jax(name):
    want = dataclasses.asdict(jgpt.config_from_name(name))
    got = dataclasses.asdict(tgpt.config_from_name(name))
    assert got == want
    for prop in ("head_size", "groups", "rope_n_elem", "padded_vocab"):
        assert getattr(tgpt.GPT_CONFIGS[name], prop) == getattr(jgpt.GPT_CONFIGS[name], prop)


def test_config_registry_names_patterns_and_overrides():
    assert sorted(tgpt.GPT_CONFIGS) == sorted(jgpt.GPT_CONFIGS)
    assert [f.name for f in dataclasses.fields(tgpt.GPTConfig)] == \
        [f.name for f in dataclasses.fields(jgpt.GPTConfig)]
    for query in ("pythia-1*", "GEMMA-2b", "tiny-llama*", "*mixtral*"):
        assert dataclasses.asdict(tgpt.config_from_name(query)) == \
            dataclasses.asdict(jgpt.config_from_name(query))
    # overrides win over the registry entry (dataclasses.replace)
    cfg = tgpt.config_from_name("tiny-llama-1.1b", n_layer=6, block_size=4096)
    assert (cfg.n_layer, cfg.block_size, cfg.n_embd) == (6, 4096, 2048)
    with pytest.raises(ValueError, match="unknown GPT config"):
        tgpt.config_from_name("no-such-model")


def test_llama_moe_raises_not_implemented():
    """`mlp_class="LLaMAMoE"` builds the MoE MLP now; what the port still
    leaves out of it, expert parallelism, raises by name."""
    from roar_tpu_torch.models import moe

    cfg = tgpt.config_from_name("Mixtral-8x7B-v0.1", n_layer=1, n_embd=32, n_head=4,
                                n_query_groups=2, intermediate_size=64, vocab_size=50)
    assert isinstance(tgpt.GPT(cfg).h[0].mlp, moe.MoEMLP)
    with pytest.raises(NotImplementedError, match="expert_axis"):
        moe.MoEMLP(32, expert_axis="expert")
    with pytest.raises(NotImplementedError, match="expert_shardings"):
        moe.expert_shardings({}, None)


def test_bf16_compute_keeps_fp32_masters_and_gives_fp32_gradients():
    """`compute_dtype=bfloat16`: bf16 activations and logits from fp32 masters,
    fp32 gradients, close to JAX's bf16 cast of the same parameters.  The JAX
    einsum route takes its softmax in bf16 and the port's flash plain version
    in fp32, so the bar is a few bf16 steps of the largest logit."""
    jmodel, params, tmodel = _pair("llama", use_flash=True)
    tokens = _tokens(12)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = np.asarray(jmodel.apply(p16, jnp.asarray(tokens)).astype(jnp.float32))
    tmodel.compute_dtype = torch.bfloat16
    logits = tmodel(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().detach().numpy(), want,
                               atol=4 * 2.0 ** -8 * np.abs(want).max(), rtol=0)
    logits.float().sum().backward()
    for name, p in tmodel.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
