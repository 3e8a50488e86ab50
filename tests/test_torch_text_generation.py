"""The port's text generation (roar_tpu_torch/models/text_generation.py)
against roar_tpu/models/text_generation.py on the CPU: each logits transform
on the same numpy logits (ties included), and the KV-cached decode of a
narrow tiny-llama-shaped GPT whose parameters the converter carries over.
Greedy tokens are equal and `logprob` within atol 2e-4; sampled tokens are
held by their properties, since `jax.random` and `torch.multinomial` draw
different streams."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roar_tpu.models import gpt as jgpt
from roar_tpu.models import text_generation as jtg
from roar_tpu_torch.models import gpt as tgpt
from roar_tpu_torch.models import text_generation as ttg
from roar_tpu_torch.training.convert import load_gpt_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
VOCAB = 60
FIELDS = dict(n_layer=2, n_embd=64, n_head=4, n_query_groups=2, intermediate_size=96,
              vocab_size=VOCAB, padded_vocab_size=None, padding_multiple=1, block_size=48)


def _logits(seed, b=3, v=VOCAB, ties=True):
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3.0
    return np.round(x * 2.0) / 2.0 if ties else x  # steps of 0.5: many exact ties


def _pair_equal(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 10])
def test_top_k_keeps_every_logit_tied_with_the_kth(k):
    x = _logits(0)
    got = ttg.apply_top_k(torch.from_numpy(x), k)
    _pair_equal(got, jtg.apply_top_k(jnp.asarray(x), k))
    kept = torch.isfinite(got).sum(-1).numpy()
    kth = -np.sort(-x, axis=-1)[:, k - 1:k]
    np.testing.assert_array_equal(kept, (x >= kth).sum(-1))  # a tie with the k-th keeps more
    assert (kept >= k).all()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_keeps_the_crossing_token_and_ties_at_the_threshold(p):
    for ties in (True, False):
        x = _logits(1, ties=ties)
        got = ttg.apply_top_p(torch.from_numpy(x), p)
        _pair_equal(got, jtg.apply_top_p(jnp.asarray(x), p))
        # the kept mass reaches p
        probs = torch.softmax(torch.from_numpy(x), -1)
        assert (torch.where(torch.isfinite(got), probs, 0).sum(-1) >= p - 1e-6).all()


def test_temperature_and_repetition_penalty_equal_jax_and_token_0_counts_as_seen():
    """The seen set comes from `prev`, whose future positions hold zeros:
    token 0 is penalised whether or not it was generated (the JAX package's
    behaviour, kept)."""
    x = _logits(2)
    x[:, 0] = np.array([4.0, -4.0, 2.5])
    prev = np.array([[5, 7, 0, 0], [9, 9, 0, 0], [1, 2, 3, 0]], np.int32)
    got = ttg.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(prev), 2.0)
    _pair_equal(got, jtg.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(prev), 2.0))
    np.testing.assert_array_equal(got[:, 0].numpy(), [2.0, -8.0, 1.25])
    np.testing.assert_array_equal(got[0, 5].numpy(), x[0, 5] / 2 if x[0, 5] > 0 else x[0, 5] * 2)
    np.testing.assert_array_equal(got[0, 6].numpy(), x[0, 6])
    for t in (0.0, 0.7, 1.3):
        _pair_equal(ttg.apply_temperature(torch.from_numpy(x), t),
                    jtg.apply_temperature(jnp.asarray(x), t))


def test_sample_logits_greedy_equals_jax_argmax_with_ties():
    x = _logits(3)
    prev = torch.from_numpy(np.array([[1, 2], [3, 4], [5, 0]], np.int32))
    for kw in ({"use_greedy": True}, {"temperature": 0.0},
               {"use_greedy": True, "repetition_penalty": 1.5}):
        got = ttg.sample_logits(torch.from_numpy(x), None, prev_tokens=prev, **kw)
        want = jtg.sample_logits(jnp.asarray(x), jax.random.PRNGKey(0),
                                 prev_tokens=jnp.asarray(prev.numpy()), **kw)
        _pair_equal(got, want)


# ---------------------------------------------------------------------------
# decoding a GPT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.config_from_name("tiny-llama-1.1b", **FIELDS)
    tcfg = tgpt.config_from_name("tiny-llama-1.1b", **FIELDS, use_flash=True)
    jmodel = jgpt.GPT(jcfg)
    prompt = np.random.default_rng(4).integers(1, VOCAB, (3, 6)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(prompt))
    tmodel = load_gpt_params(tgpt.GPT(tcfg), jax.device_get(params))
    return jmodel, params, tmodel, prompt


def _jax(models, **kw):
    jmodel, params, _, prompt = models
    toks, logp = jtg.generate_tokens(jmodel, params, jnp.asarray(prompt), **kw)
    return np.asarray(toks), np.asarray(logp)


def _port(models, **kw):
    tmodel, prompt = models[2], models[3]
    toks, logp = ttg.generate_tokens(tmodel, torch.from_numpy(prompt), **kw)
    return toks.numpy(), logp.numpy()


@pytest.mark.parametrize("penalty", [1.0, 1.3], ids=["plain", "repetition_penalty"])
def test_greedy_tokens_equal_jax_and_logprob_within_2e_4(models, penalty):
    kw = dict(length_params={"max_length": 12},
              sampling_params={"use_greedy": True, "repetition_penalty": penalty})
    (jt, jl), (tt, tl) = _jax(models, **kw), _port(models, **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    assert tt.shape == (3, 18) and tt.dtype == np.int32 and (tl <= 0).all()


def test_end_id_and_min_length_as_jax(models):
    """An end token that greedy decoding emits early: suppressed before
    `min_length`, then repeated by every finished row; tokens and logprob
    as the JAX package gives them."""
    free, _ = _port(models, length_params={"max_length": 12})
    end_id = int(free[0, 6 + 1])
    for min_length in (0, 4):
        kw = dict(length_params={"max_length": 12, "min_length": min_length}, end_id=end_id)
        (jt, jl), (tt, tl) = _jax(models, **kw), _port(models, **kw)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
        new = tt[:, 6:]
        assert not (new[:, :min_length] == end_id).any()
        for row in new:
            hits = np.flatnonzero(row == end_id)
            if hits.size:
                assert (row[hits[0]:] == end_id).all()
        if min_length == 0:  # row 0 ends at its second token and repeats the end
            assert (new[0, 1:] == end_id).all()


def test_top_k_1_sampling_equals_greedy(models):
    greedy, _ = _port(models, length_params={"max_length": 10})
    sampled, _ = _port(models, length_params={"max_length": 10},
                       sampling_params={"use_greedy": False, "temperature": 0.8, "top_k": 1},
                       generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(sampled, greedy)


def test_sampled_tokens_stay_in_the_kept_set_and_repeat_under_one_seed(models):
    """Temperature, top-k, top-p and repetition penalty together: every drawn
    token survives the transforms of the logits it was drawn from, one seed
    gives one sequence, and another seed another."""
    tmodel, prompt = models[2], torch.from_numpy(models[3])
    sp = {"use_greedy": False, "temperature": 0.8, "top_k": 12, "top_p": 0.9,
          "repetition_penalty": 1.2}

    def draw(seed):
        return ttg.generate_tokens(tmodel, prompt, {"max_length": 16}, sp,
                                   generator=torch.Generator().manual_seed(seed),
                                   return_logits=True)

    toks, logp, logits = draw(5)
    again, _, _ = draw(5)
    assert torch.equal(toks, again) and not torch.equal(toks, draw(6)[0])
    for i in range(16):
        prev = torch.cat([toks[:, :6 + i], torch.zeros(3, 16 - i, dtype=toks.dtype)], 1)
        x = ttg.apply_repetition_penalty(logits[:, i], prev, 1.2)
        x = ttg.apply_top_p(ttg.apply_top_k(ttg.apply_temperature(x, 0.8), 12), 0.9)
        chosen = x.gather(1, toks[:, 6 + i:7 + i].long())
        assert torch.isfinite(chosen).all(), i
    # logprob is that of the raw logits, before any transform
    torch.testing.assert_close(
        logp, torch.log_softmax(logits, -1).gather(2, toks[:, 6:, None].long())[..., 0])


def test_cached_decode_logits_equal_one_full_forward(models):
    """What phase `generate_gpt` of chip_smoke.py checks on the card: the
    logits each token was drawn from, against one forward of the whole
    sequence without a cache (the flash route)."""
    tmodel, prompt = models[2], torch.from_numpy(models[3])
    toks, _, logits = ttg.generate_tokens(tmodel, prompt, {"max_length": 10},
                                          return_logits=True)
    with torch.no_grad():
        full = tmodel(toks[:, :-1].long())
    torch.testing.assert_close(full[:, 5:], logits, atol=1e-4, rtol=1e-4)


def test_text_generation_api_matches_jax():
    """TextGeneration over strings: the same token ids (right-padded
    prompts), logprob within 2e-4, and sentences through the tokenizer's
    `decode`."""
    jcfg = jgpt.config_from_name("tiny-llama-1.1b", **FIELDS)
    jmodel = jgpt.GPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    tmodel = load_gpt_params(tgpt.GPT(tgpt.config_from_name("tiny-llama-1.1b", **FIELDS)),
                             jax.device_get(params))

    class Tok:
        def __call__(self, s):
            return [1 + (ord(c) % (VOCAB - 1)) for c in s]

        def decode(self, ids):
            return "|".join(map(str, ids))

    texts = ["hello", "ab", "a longer one"]
    want = jtg.TextGeneration(jmodel, params, Tok(), end_id=7).generate(
        texts, {"max_length": 8, "min_length": 2})
    got = ttg.TextGeneration(tmodel, Tok(), end_id=7).generate(
        texts, {"max_length": 8, "min_length": 2})
    assert got["token_ids"] == want["token_ids"] and got["sentences"] == want["sentences"]
    np.testing.assert_allclose(got["logprob"], want["logprob"], atol=2e-4, rtol=0)
    assert ttg.TextGeneration(tmodel, Tok()).parse("abc").tolist() == [Tok()("abc")]
    with pytest.raises(ValueError, match="block_size"):
        ttg.generate_tokens(tmodel, torch.zeros(1, 40, dtype=torch.long), {"max_length": 9})


def test_generate_cli_samples_from_a_port_bundle(tmp_path):
    """examples/nlp/generate_torch.py on a bundle the port's GPT CLI saved,
    on the CPU: the prompt and its new words."""
    from roar_tpu_torch.data.lm_dataset import SimpleWordTokenizer
    from roar_tpu_torch.models.gpt_model import GPTLMModel
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.save_restore import save_to

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(" ".join(f"w{(i * 7 + j) % 30}" for j in range(12))
                                for i in range(20)) + "\n")
    tok = SimpleWordTokenizer([str(corpus)], max_vocab=8000)
    mcfg = {"config_name": "tiny-llama-1.1b", **{k: v for k, v in FIELDS.items()
                                                  if k != "padded_vocab_size"},
            "vocab_size": tok.vocab_size, "scan_layers": True}
    model = GPTLMModel(mcfg, generator=torch.Generator().manual_seed(0))
    bundle = tmp_path / "gpt.roar"
    save_to(str(bundle), {"model": mcfg}, convert.gpt_to_jax_tree(model.module))

    spec = importlib.util.spec_from_file_location(
        "generate_torch", REPO / "examples" / "nlp" / "generate_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    words = cli.generate_text(str(bundle), [str(corpus)], "w3 w10", max_new_tokens=5,
                              temperature=0.0, top_k=None, seed=0, device="cpu")
    assert len(words) == 5 and all(w in tok._ids for w in words)
    again = cli.generate_text(str(bundle), [str(corpus)], "w3 w10", max_new_tokens=5,
                              temperature=0.9, top_k=4, seed=1, device="cpu")
    assert again == cli.generate_text(str(bundle), [str(corpus)], "w3 w10", max_new_tokens=5,
                                      temperature=0.9, top_k=4, seed=1, device="cpu")
    with pytest.raises(SystemExit, match="vocab"):
        other = tmp_path / "other.txt"
        other.write_text("x y z\n")
        cli.generate_text(str(bundle), [str(other)], "x", 2, 0.0, None, 0, "cpu")


def test_chip_smoke_generate_phase_rehearsal(tmp_path, capsys):
    """Phases `train_gpt` (keeping its bundle) and `generate_gpt` of
    chip_smoke.py at a rehearsal width on the CPU: every check but the launch
    counts and the timing."""
    import json

    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_gpt(torch.device("cpu"), narrow=True, seq_length=128,
                                     vocab_size=300, keep_dir=str(tmp_path))
    assert Path(out["bundle"]["path"]).parent == tmp_path
    gen = chip_smoke.phase_generate_gpt(torch.device("cpu"), out["bundle"])
    assert gen == {"launches": {"fwd": 0, "dkv": 0, "dq": 0}, "timing": None}
    (line,) = [json.loads(text) for text in capsys.readouterr().out.splitlines()
               if text.startswith('{"phase": "generate_gpt"')]
    assert len(line["prompts"]) == 4 and line["prompt_tokens"] == 8
    for name in ("greedy", "sampled"):
        assert line["checks"][name]["rel_err"] <= chip_smoke.GENERATE_LOGITS_REL_TOL
        assert len(line["continuations"][name]) == 4
