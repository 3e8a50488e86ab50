"""Speaker embeddings and the global style token (GST), port against the JAX
package, on the CPU at small widths.

The same seeded numpy inputs go through `roar_tpu.models.submodules`'
`SpeakerLookupTable`, `SpeakerEncoder`, `ReferenceEncoder`, `StyleAttention`
and `GlobalStyleToken` and the port's, and through a `FastPitchModule` with
`use_gst` (the inputs of tests/test_fastpitch_module.py's GST test), forward
and `infer`, the weights carried across by training/convert.py.  Then the
task wrappers with `use_gst: true`: the JAX `FastPitchModel` hands it only to
`strip_inert_conditioning` and `JETSModel` ignores it, so the port's tasks
build the same parameter tree as the JAX tasks and give the same forward.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.models import submodules
from roar_tpu_torch.models.fastpitch import (
    AlignerConfig,
    FastPitchModule,
    FFTConfig,
    PredictorConfig,
)
from roar_tpu_torch.training import convert

FWD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-6)


def _jax_apply(module, *args, **kwargs):
    """(params, output) of a flax module initialised from PRNGKey(0)."""
    import jax

    params = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return jax.device_get(params), np.asarray(jax.device_get(module.apply(params, *args,
                                                                             **kwargs)))


def _ported(module, params):
    return convert.load_fastpitch_params(module, params).eval()


def test_speaker_lookup_table_and_encoder_match_jax():
    from roar_tpu.models import submodules as jax_sub

    speaker = np.array([2, 0, 1], np.int32)
    params, want = _jax_apply(jax_sub.SpeakerLookupTable(3, 8), speaker)
    port = _ported(submodules.SpeakerLookupTable(3, 8), params)
    np.testing.assert_array_equal(port(torch.from_numpy(speaker).long()).detach().numpy(), want)

    params, want = _jax_apply(jax_sub.SpeakerEncoder(lookup=jax_sub.SpeakerLookupTable(3, 8)),
                              3, speaker)
    port = _ported(submodules.SpeakerEncoder(lookup=submodules.SpeakerLookupTable(3, 8)), params)
    got = port(3, torch.from_numpy(speaker).long()).detach().numpy()
    assert got.shape == (3, 1, 8)
    np.testing.assert_array_equal(got, want)

    emb = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    params, want = _jax_apply(jax_sub.SpeakerEncoder(precomputed_embedding_dim=6,
                                                     embedding_dim=8), 3, None, emb)
    assert set(convert.flatten_params(params)) == {"Dense_0/kernel", "Dense_0/bias"}
    port = _ported(submodules.SpeakerEncoder(precomputed_embedding_dim=6, embedding_dim=8),
                   params)
    np.testing.assert_allclose(port(3, None, torch.from_numpy(emb)).detach().numpy(), want,
                               **FWD_TOL)
    assert submodules.SpeakerEncoder()(3) is None
    with pytest.raises(ValueError, match="speaker ids"):
        port_lookup = submodules.SpeakerEncoder(lookup=submodules.SpeakerLookupTable(3, 8))
        port_lookup(3)


# (T, n_mel, with lengths): odd and even sizes on both axes.  Flax's SAME pads
# an even axis 0 before and 1 after at stride 2, an odd one 1 and 1
REFERENCE_CASES = [(64, 20, True), (64, 20, False), (63, 21, True), (63, 21, False),
                   (50, 17, True)]


@pytest.mark.parametrize("t,n_mel,with_lens", REFERENCE_CASES)
def test_reference_encoder_matches_jax(t, n_mel, with_lens):
    from roar_tpu.models import submodules as jax_sub

    rng = np.random.default_rng(t + n_mel)
    spec = rng.standard_normal((2, t, n_mel)).astype(np.float32)
    lens = np.array([t, t - 15], np.int32) if with_lens else None
    params, want = _jax_apply(jax_sub.ReferenceEncoder(gru_rnn_units=16), spec, lens)
    port = _ported(submodules.ReferenceEncoder(n_mel, gru_rnn_units=16), params)
    got = port(torch.from_numpy(spec), None if lens is None else torch.from_numpy(lens))
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    # symmetric padding, as nn.Conv2d(padding=1) pads, gives other values
    if t % 2 == 0:
        sym = _ported(submodules.ReferenceEncoder(n_mel, gru_rnn_units=16), params)
        for conv in sym.convs:
            conv.padding = (1, 1)
        real = submodules._same_pad_2d
        submodules._same_pad_2d = lambda x, kernel, stride: x
        try:
            off = sym(torch.from_numpy(spec), None if lens is None else torch.from_numpy(lens))
        finally:
            submodules._same_pad_2d = real
        assert not np.allclose(off.detach().numpy(), want, **FWD_TOL)


def test_style_attention_and_global_style_token_match_jax():
    from roar_tpu.models import submodules as jax_sub

    rng = np.random.default_rng(1)
    ref_emb = rng.standard_normal((3, 16)).astype(np.float32)
    params, want = _jax_apply(jax_sub.StyleAttention(16, 10, 4), ref_emb)
    assert "style_tokens" in convert.flatten_params(params)
    assert "q_proj/bias" not in convert.flatten_params(params)
    port = _ported(submodules.StyleAttention(16, 10, 4), params)
    np.testing.assert_allclose(port(torch.from_numpy(ref_emb)).detach().numpy(), want, **FWD_TOL)

    spec = rng.standard_normal((2, 40, 20)).astype(np.float32)
    lens = np.array([40, 29], np.int32)
    params, want = _jax_apply(jax_sub.GlobalStyleToken(gst_size=16), spec, lens)
    port = _ported(submodules.GlobalStyleToken(20, 16), params)
    got = port(torch.from_numpy(spec), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    back = convert.flatten_params(convert.fastpitch_to_jax_tree(port))
    for k, v in convert.flatten_params(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _gst_modules():
    """tests/test_fastpitch_module.py's GST module in both packages."""
    from roar_tpu.models import fastpitch as jax_fp

    d = 32
    fft = dict(n_layer=1, n_head=1, d_model=d, d_head=16, d_inner=64, kernel_size=3,
               condition_types=("add",))
    kwargs = dict(symbols_embedding_dim=d, n_mel_channels=20, use_gst=True,
                  speaker_emb_condition_decoder=True)
    jax_module = jax_fp.FastPitchModule(
        n_symbols=40, encoder=jax_fp.FFTConfig(**fft), decoder=jax_fp.FFTConfig(**fft),
        duration_predictor=jax_fp.PredictorConfig(input_size=d, filter_size=16),
        pitch_predictor=jax_fp.PredictorConfig(input_size=d, filter_size=16),
        aligner=jax_fp.AlignerConfig(n_text_channels=d, n_att_channels=16), **kwargs)
    port = FastPitchModule(
        40, encoder=FFTConfig(**fft), decoder=FFTConfig(**fft),
        duration_predictor=PredictorConfig(input_size=d, filter_size=16),
        pitch_predictor=PredictorConfig(input_size=d, filter_size=16),
        aligner=AlignerConfig(n_text_channels=d, n_att_channels=16), **kwargs)
    return jax_module, port


@pytest.fixture(scope="module")
def gst_side():
    import jax
    import jax.numpy as jnp
    from test_fastpitch_module import make_batch

    jax_module, port = _gst_modules()
    rng = np.random.default_rng(7)
    text, text_lens, spec, mel_lens, pitch, prior = make_batch(rng)
    ref = rng.standard_normal((2, 64, 20)).astype(np.float32)
    ref2 = 3.0 * rng.standard_normal((2, 64, 20)).astype(np.float32)
    ref_lens = np.array([64, 48], np.int32)
    kwargs = dict(pitch=pitch, spec=spec, attn_prior=prior, mel_lens=mel_lens,
                  input_lens=text_lens, reference_spec=jnp.asarray(ref),
                  reference_spec_lens=jnp.asarray(ref_lens))
    params = jax.device_get(jax_module.init({"params": jax.random.PRNGKey(0)}, text, **kwargs))
    outs = [jax.device_get(jax_module.apply(params, text, **{**kwargs, "reference_spec": r}))
            for r in (jnp.asarray(ref), jnp.asarray(ref2))]
    infer = jax.device_get(jax_module.apply(
        params, text, max_mel_len=48, reference_spec=jnp.asarray(ref),
        reference_spec_lens=jnp.asarray(ref_lens), method=jax_module.infer))
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        text=text, input_lens=text_lens, spec=spec, mel_lens=mel_lens, pitch=pitch,
        attn_prior=prior, reference_spec=ref, reference_spec_lens=ref_lens).items()}
    inputs["text"] = inputs["text"].long()
    return {"params": params, "outs": outs, "infer": infer, "port": port, "inputs": inputs,
            "ref2": torch.from_numpy(ref2)}


def test_fastpitch_module_with_gst_matches_jax(gst_side):
    port = _ported(gst_side["port"], gst_side["params"])
    assert port.gst_module.style_attention.gst_size == 32  # gst_size 0: the embedding width
    inputs = gst_side["inputs"]
    with torch.no_grad():
        outs = [port(**inputs), port(**{**inputs, "reference_spec": gst_side["ref2"]})]
    for got, want in zip(outs, gst_side["outs"]):
        np.testing.assert_array_equal(got["attn_hard"].numpy(), want["attn_hard"])
        np.testing.assert_array_equal(got["num_frames"].numpy(), want["num_frames"])
        for key in ("spect", "log_durs_predicted", "pitch_predicted", "attn_soft", "pitch"):
            np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **FWD_TOL)
    # another reference, another mel
    assert not np.allclose(outs[0]["spect"].numpy(), outs[1]["spect"].numpy())
    # without a reference the decoder has no conditioning: as in JAX, it raises
    with pytest.raises(ValueError, match="conditioning required"):
        port(**{k: v for k, v in inputs.items() if not k.startswith("reference")})


def test_fastpitch_module_with_gst_infer_matches_jax(gst_side):
    port = _ported(gst_side["port"], gst_side["params"])
    inputs = gst_side["inputs"]
    want = gst_side["infer"]
    with torch.no_grad():
        got = port.infer(inputs["text"], max_mel_len=48, reference_spec=inputs["reference_spec"],
                         reference_spec_lens=inputs["reference_spec_lens"])
    np.testing.assert_array_equal(got["num_frames"].numpy(), want["num_frames"])
    for key in ("spect", "durs_predicted", "log_durs_predicted", "pitch_predicted"):
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **FWD_TOL)


def test_gst_parameters_round_trip_and_raise_when_missing(gst_side):
    port = _ported(gst_side["port"], gst_side["params"])
    flat = convert.flatten_params(convert.fastpitch_to_jax_tree(port))
    want = convert.flatten_params(gst_side["params"])
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    short = {k: v for k, v in want.items() if k != "gst_module/style_attention/style_tokens"}
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_fastpitch_params(_gst_modules()[1], convert._nest(
            {tuple(k.split("/")): v for k, v in short.items()}))


# ---------------------------------------------------------------------------
# use_gst on the task wrappers (the JAX tasks never build a GST module)
# ---------------------------------------------------------------------------


def test_fastpitch_task_with_use_gst_builds_and_runs_as_jax():
    import jax
    import jax.numpy as jnp
    import test_torch_fastpitch_train as fp_tests

    from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel

    cfg = {**fp_tests._cfg(), "use_gst": True}
    jax_model = JaxFastPitchModel(cfg)
    batch = {k: jnp.asarray(v) for k, v in fp_tests._batch_np().items()}
    params = jax.device_get(jax_model.init_params(jax.random.PRNGKey(0), batch))
    _, want = jax.device_get(jax.jit(lambda p: jax_model.loss_fn(
        p, batch, None, fp_tests.EPOCH, deterministic=True))(params))
    model = FastPitchModel(cfg)
    assert getattr(model.module, "gst_module", None) is None
    convert.load_fastpitch_params(model.module, params)
    assert set(convert.flatten_params(model.to_jax_tree())) == set(
        convert.flatten_params(params))
    _, got = model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **TOL)


def test_jets_task_with_use_gst_builds_and_runs_as_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    import test_torch_jets as jets_tests

    from roar_tpu.models.jets_model import JETSModel as JaxJETSModel
    from roar_tpu_torch.models.jets_model import JETSModel

    cfg = {**jets_tests._cfg(flavour="conditioned"), "use_gst": True}
    jax_model = JaxJETSModel(cfg)
    batch = {k: jnp.asarray(v) for k, v in jets_tests._batch_np("conditioned").items()}
    g, d, stats = jax.device_get(jax_model.init_params(jax.random.PRNGKey(0), batch))
    want = jax.device_get(jax.jit(lambda p: jax_model._forward(
        p, batch, jax.random.PRNGKey(2), deterministic=True))(g))
    model = JETSModel(cfg)
    convert.load_jets_bundle(model.module, model.mpd, model.msd,
                             {"g_params": g, "d_params": d, "d_stats": stats})
    assert set(convert.flatten_params(model.to_jax_tree()["g_params"])) == set(
        convert.flatten_params(g))
    jets_tests._starts(monkeypatch, want["z_start_idxs"])
    with torch.no_grad():
        got = model._forward(jets_tests._torch_batch("conditioned"), deterministic=True)
    np.testing.assert_array_equal(got["attn_hard"].numpy(), np.asarray(want["attn_hard"]))
    for k in ("wav", "log_durs_predicted", "pitch_predicted", "energy_pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **FWD_TOL)
