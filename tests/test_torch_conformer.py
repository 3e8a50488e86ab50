"""The Conformer stacks with RoPE attention, port against the JAX package, on
the CPU at a narrow size: d 32, 2 + 2 layers of two heads of 16, a conv
module of kernel 31, conditioning ["add", "layernorm"].

Weights come from the JAX modules and reach the port through
training/convert.py, inputs from a seeded numpy generator.  On the flash path
the JAX side reaches upstream's Pallas flash kernel, which runs only on a
TPU: here it runs upstream's plain reference of that kernel (`_mha_reference`
with the same segment ids), and the port the plain version of its flash
kernels.  The two paths differ on the valid rows too: the conv module reads
the padding rows, which each path fills by its own masking, so both paths
are held against JAX on every row.

Losses and gradients are taken on deterministic forwards on both sides: the
JAX Conformer draws its 0.1 attention-probability dropout in every training
forward, and no seed makes two frameworks draw the same mask.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_fastpitch as fp_parity
import test_torch_fastpitch_train as fp_tests
import test_torch_jets as jets_tests
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.experimental.pallas.ops.tpu import flash_attention as upstream_flash
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

import roar_tpu.models.transformer as jax_transformer
from roar_tpu.models.conformer import ConformerLayer as JaxConformerLayer
from roar_tpu.models.conformer import FFConformerDecoder as JaxConformerDecoder
from roar_tpu.models.conformer import FFConformerEncoder as JaxConformerEncoder
from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.models.jets_model import JETSModel as JaxJETSModel
from roar_tpu.models.transformer import MultiHeadAttn as JaxMultiHeadAttn
from roar_tpu.training.trainer import cast_floating
from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models import conformer
from roar_tpu_torch.models.fastpitch import make_decoder
from roar_tpu_torch.models.fastpitch_model import FastPitchModel, _fft_config, spec_from_batch
from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.models.transformer import MultiHeadAttn
from roar_tpu_torch.training import convert

COND = ("add", "layernorm")
D, N_HEAD, D_HEAD, D_INNER, KERNEL = 32, 2, 16, 64, 31
PATHS = ["einsum", "flash"]
# module outputs: fp32 on both sides, other summation orders; losses and
# gradients: the bars of tests/test_torch_fastpitch_train.py and
# tests/test_torch_jets.py
FWD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-6)
EPOCH = jets_tests.EPOCH
BF16_LOSS_RTOL = 2e-2  # tests/test_torch_bf16_tts.py's LOSS_RTOL


def _conformer_fft(use_flash=True, dropout=0.0, dropatt=0.0, n_layer=2):
    return {"encoder_type": "conformer", "n_layer": n_layer, "n_head": N_HEAD, "d_model": D,
            "d_head": D_HEAD, "d_inner": D_INNER, "kernel_size": KERNEL, "dropout": dropout,
            "dropatt": dropatt, "condition_types": list(COND), "use_rope": True,
            "use_flash": use_flash}


@contextlib.contextmanager
def jax_flash_as_reference():
    """The JAX package's flash path on the CPU: `flash_self_attention` taken
    (as on a TPU), upstream's kernel replaced by its plain reference (q
    scaled first: the reference's backward takes only `sm_scale` 1)."""
    def reference(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0,
                  block_sizes=None, debug=False):
        return upstream_flash._mha_reference(
            q * sm_scale, k, v, ab, segment_ids, causal=causal,
            mask_value=upstream_flash.DEFAULT_MASK_VALUE, sm_scale=1.0, save_residuals=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_transformer, "_flash_attention_available", lambda: True)
        mp.setattr(upstream_flash, "flash_attention", reference)
        yield


def _jax_path(path):
    return jax_flash_as_reference() if path == "flash" else contextlib.nullcontext()


def _inputs(seed=0, b=2, t=40):
    """x [B, T, D] and conditioning [B, 1, D]; the second row's last 13
    frames are padding, within the conv module's reach of the valid ones."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    lens = np.array([t, t - 13])
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    cond = rng.standard_normal((b, 1, D)).astype(np.float32)
    return x, mask, cond


def _grads_close(port_module, jax_grads, what):
    """The port parameters' gradients against the JAX tree's, at TOL with an
    atol that follows the largest gradient."""
    want = flatten_dict(jax.device_get(jax_grads))
    scale = max(float(np.abs(v).max()) for v in want.values())
    grads = convert.fastpitch_to_jax_tree(_grad_copy(port_module))
    got = flatten_dict(grads)
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=TOL["rtol"],
                                   atol=3e-6 * scale, err_msg=f"{what} {'/'.join(path)}")


def _grad_copy(module):
    import copy

    grads = copy.deepcopy(module)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), module.parameters()):
            dst.copy_(src.grad if src.grad is not None else torch.zeros_like(src))
    return grads


# --------------------------------------------------------------------------
# attention, layer and stacks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_multi_head_attn_with_rope_matches_jax(path):
    x, mask, cond = _inputs(1)
    key_mask = mask[..., 0] > 0
    with _jax_path(path):
        jmod = JaxMultiHeadAttn(N_HEAD, D, D_HEAD, 0.0, condition_types=COND, use_rope=True,
                                use_flash=path == "flash")
        params = fp_parity.randomize(jmod.init(jax.random.PRNGKey(0), x, key_mask, cond), 2)
        want = np.asarray(jax.jit(lambda p: jmod.apply(p, x, key_mask, cond))(params))
    port = convert.load_fastpitch_params(
        MultiHeadAttn(N_HEAD, D, D_HEAD, condition_types=COND, use_rope=True,
                      use_flash=path == "flash", dropatt=0.1), params).eval()
    assert port.attention_path() == path
    launches = fa.LAUNCHES.copy()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(key_mask), torch.from_numpy(cond))
    assert fa.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    # the rotation is seen: without it the output moves past the bar
    port.use_rope = False
    with torch.no_grad():
        unrotated = port(torch.from_numpy(x), torch.from_numpy(key_mask), torch.from_numpy(cond))
    assert np.abs(unrotated.numpy() - want).max() > 100 * FWD_TOL["atol"]


@pytest.mark.parametrize("path", PATHS)
def test_conformer_layer_matches_jax(path):
    x, mask, cond = _inputs(3)
    with _jax_path(path):
        jmod = JaxConformerLayer(N_HEAD, D, D_HEAD, D_INNER, conv_kernel_size=KERNEL,
                                 dropout=0.0, dropout_att=0.0, condition_types=COND,
                                 use_rope=True, use_flash=path == "flash")
        params = fp_parity.randomize(jmod.init(jax.random.PRNGKey(0), x, mask, cond), 4)
        want = np.asarray(jax.jit(lambda p: jmod.apply(p, x, mask, cond))(params))
    port = convert.load_fastpitch_params(conformer.ConformerLayer(
        N_HEAD, D, D_HEAD, D_INNER, KERNEL, 0.0, 0.0, COND, True, path == "flash"), params)
    assert port.self_attn.attention_path() == "einsum"  # training mode: p-dropout 0.1
    port.eval()
    assert port.self_attn.attention_path() == path
    assert port.self_attn.dropatt.rate == conformer.ATTN_PROB_DROPOUT
    with torch.no_grad():
        got = port(*(torch.from_numpy(z) for z in (x, mask, cond)))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    assert not got.numpy()[1, -13:].any()  # padding rows zeroed


@pytest.mark.parametrize("path", PATHS)
def test_conformer_stacks_and_their_gradients_match_jax(path):
    """FFConformerEncoder on tokens and FFConformerDecoder on embeddings:
    outputs, and the gradients of a seeded projection of the output with
    respect to every parameter and (decoder) the input."""
    x, mask, cond = _inputs(5)
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 40, (2, 40)).astype(np.int32)
    tokens[1, 27:] = 0
    probe = rng.standard_normal(x.shape).astype(np.float32)
    common = dict(kernel_size=KERNEL, dropout=0.0, dropatt=0.0, condition_types=COND,
                  use_rope=True, use_flash=path == "flash")
    with _jax_path(path):
        jenc = JaxConformerEncoder(2, N_HEAD, D, D_HEAD, D_INNER, n_embed=40, **common)
        jdec = JaxConformerDecoder(2, N_HEAD, D, D_HEAD, D_INNER, **common)
        enc_params = fp_parity.randomize(jenc.init(jax.random.PRNGKey(0), tokens, cond), 7)
        dec_params = fp_parity.randomize(jdec.init(jax.random.PRNGKey(0), x, mask, cond), 8)

        @jax.jit
        def run(enc_p, dec_p, x):
            enc_out, enc_mask = jenc.apply(enc_p, tokens, cond)

            def dec_loss(p, x):
                out, _ = jdec.apply(p, x, mask, cond)
                return jnp.sum(out * probe), out

            (_, dec_out), (dec_grads, x_grad) = jax.value_and_grad(
                dec_loss, argnums=(0, 1), has_aux=True)(dec_p, x)
            enc_grads = jax.grad(lambda p: jnp.sum(jenc.apply(p, tokens, cond)[0] * probe))(enc_p)
            return enc_out, enc_mask, dec_out, dec_grads, x_grad, enc_grads

        enc_out, enc_mask, dec_out, dec_grads, x_grad, enc_grads = jax.device_get(
            run(enc_params, dec_params, x))
    enc = convert.load_fastpitch_params(conformer.FFConformerEncoder(
        2, N_HEAD, D, D_HEAD, D_INNER, n_embed=40, **common), enc_params).eval()
    dec = convert.load_fastpitch_params(conformer.FFConformerDecoder(
        2, N_HEAD, D, D_HEAD, D_INNER, **common), dec_params).eval()
    assert enc.stack.attention_path() == dec.attention_path() == path
    got, got_mask = enc(torch.from_numpy(tokens).long(), torch.from_numpy(cond))
    np.testing.assert_array_equal(got_mask.numpy(), enc_mask)
    np.testing.assert_allclose(got.detach().numpy(), enc_out, **FWD_TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    _grads_close(enc, enc_grads, "encoder grad")

    xt = torch.from_numpy(x).requires_grad_(True)
    got, _ = dec(xt, torch.from_numpy(mask), torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), dec_out, **FWD_TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    _grads_close(dec, dec_grads, "decoder grad")
    np.testing.assert_allclose(xt.grad.numpy(), x_grad, rtol=TOL["rtol"],
                               atol=3e-6 * float(np.abs(x_grad).max()))


def test_the_two_paths_part_at_the_padding():
    """The JAX package's own einsum and flash paths give other valid rows
    where the conv module reads the padding: the port follows each."""
    x, mask, cond = _inputs(9)
    outs = {}
    for path in PATHS:
        with _jax_path(path):
            jmod = JaxConformerDecoder(2, N_HEAD, D, D_HEAD, D_INNER, kernel_size=KERNEL,
                                       dropout=0.0, dropatt=0.0, condition_types=COND,
                                       use_rope=True, use_flash=path == "flash")
            params = fp_parity.randomize(jmod.init(jax.random.PRNGKey(0), x, mask, cond), 10)
            outs[path] = np.asarray(jax.jit(lambda p: jmod.apply(p, x, mask, cond)[0])(params))
    valid = mask[..., 0] > 0
    apart = np.abs(outs["flash"] - outs["einsum"])[valid].max()
    assert apart > 100 * FWD_TOL["atol"]
    assert np.abs(outs["flash"] - outs["einsum"])[0].max() < FWD_TOL["atol"]  # no padding


# --------------------------------------------------------------------------
# FastPitch with Conformer stacks
# --------------------------------------------------------------------------

def _fp_cfg(use_flash=True):
    """tests/test_torch_fastpitch_train.py's configuration at d 32 with
    Conformer stacks (dropout 0: the deterministic forward on both sides)."""
    cfg = fp_tests._cfg(dropout=0.0, dropatt=0.0)
    cfg["symbols_embedding_dim"] = D
    cfg["input_fft"] = {**_conformer_fft(use_flash), "d_embed": D}
    cfg["output_fft"] = _conformer_fft(use_flash)
    cfg["alignment_module"] = {**cfg["alignment_module"], "n_text_channels": D}
    for k in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        cfg[k] = {**cfg[k], "input_size": D}
    cfg["speaker_encoder"] = {"lookup_module": {"n_speakers": 3, "embedding_dim": D}}
    return cfg


@pytest.fixture(scope="module")
def fastpitch_jax():
    """The JAX FastPitch-Conformer on the flash path: its initial parameters
    (the stacks redrawn), the deterministic forward, `infer`, the loss terms
    and the gradients."""
    batch = {k: jnp.asarray(v) for k, v in fp_tests._batch_np().items()}
    with jax_flash_as_reference():
        model = JaxFastPitchModel(_fp_cfg())
        params = jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))
        tree = dict(params["params"])
        for scope in ("encoder_module", "decoder_module"):
            tree[scope] = fp_parity.randomize(tree[scope], 11 + len(scope))
        tree["duration_predictor_module"]["fc"]["bias"] = np.full(1, np.log(4.0), np.float32)
        params = {"params": tree}

        @jax.jit
        def forward(params):
            spec, mel_lens = model._spec_from_batch(batch["audio"], batch["audio_len"], batch)
            return model.module.apply(
                params, batch["text"], pitch=batch["pitch"], energy=batch["energy"],
                speaker=batch["speaker_id"], spec=spec, attn_prior=batch["align_prior_matrix"],
                mel_lens=mel_lens, input_lens=batch["text_len"], deterministic=True)

        infer = jax.jit(lambda p: model.module.apply(
            p, batch["text"], speaker=batch["speaker_id"], max_mel_len=96,
            method=model.module.infer))
        loss_and_grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, None, fp_tests.EPOCH, deterministic=True),
            has_aux=True))
        (loss, metrics), grads = loss_and_grads(params)
        return {"params": params, "forward": jax.device_get(forward(params)),
                "infer": jax.device_get(infer(params)),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": jax.device_get(grads)}


def _fp_port(params):
    model = FastPitchModel(_fp_cfg())
    convert.load_fastpitch_params(model.module, params)
    return model


def test_fastpitch_conformer_forward_and_infer_match_jax(fastpitch_jax):
    model = _fp_port(fastpitch_jax["params"])
    module = model.module
    assert isinstance(module.encoder_module, conformer.FFConformerEncoder)
    assert isinstance(module.decoder_module, conformer.FFConformerDecoder)
    assert model.attention_paths() == {"input_fft": "flash", "output_fft": "flash"}
    batch = fp_tests._torch_batch()
    spec, mel_lens = spec_from_batch(batch, model.mel_cfg)
    with torch.no_grad():
        out = module(batch["text"].long(), pitch=batch["pitch"], energy=batch["energy"],
                     speaker=batch["speaker_id"].long(), spec=spec,
                     attn_prior=batch["align_prior_matrix"], mel_lens=mel_lens,
                     input_lens=batch["text_len"])
    want = fastpitch_jax["forward"]
    for key in ("attn_hard", "attn_hard_dur", "num_frames"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    for key in ("spect", "log_durs_predicted", "pitch_predicted", "energy_pred", "attn_soft"):
        np.testing.assert_allclose(out[key].numpy(), want[key], err_msg=key, **FWD_TOL)
    with torch.no_grad():
        got = module.infer(batch["text"].long(), speaker=batch["speaker_id"].long(),
                           max_mel_len=96)
    want = fastpitch_jax["infer"]
    np.testing.assert_array_equal(got["num_frames"].numpy(), want["num_frames"])
    assert int(got["num_frames"].min()) > 0
    for key in ("spect", "log_durs_predicted", "pitch_predicted"):
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **FWD_TOL)


def test_fastpitch_conformer_losses_and_gradients_match_jax(fastpitch_jax):
    model = _fp_port(fastpitch_jax["params"])
    loss, metrics = model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    assert set(metrics) == set(fastpitch_jax["metrics"])
    for k, want in fastpitch_jax["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, err_msg=k, **TOL)
    loss.backward()
    want = flatten_dict(fastpitch_jax["grads"])
    scale = max(float(np.abs(v).max()) for v in want.values())
    got = flatten_dict(convert.fastpitch_to_jax_tree(_grad_copy(model.module)))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=TOL["rtol"],
                                   atol=3e-6 * scale, err_msg="/".join(path))


# --------------------------------------------------------------------------
# JETS-Conformer
# --------------------------------------------------------------------------

def _jets_cfg(dropout=0.0, use_flash=True):
    cfg = jets_tests._cfg(flavour="conditioned", dropout=dropout)
    for k in ("input_fft", "output_fft"):
        cfg[k] = _conformer_fft(use_flash, dropout=dropout, dropatt=dropout)
    return cfg


@functools.lru_cache(maxsize=None)
def _jets_jax():
    """The JAX JETS-Conformer on the flash path: its initial parameters (the
    stacks redrawn, durations of 3 frames), the deterministic forward,
    `infer`, the D and G losses with their gradients, and one bf16 G loss."""
    batch = {k: jnp.asarray(v) for k, v in jets_tests._batch_np("conditioned").items()}
    rng = jax.random.PRNGKey(2)
    with jax_flash_as_reference():
        model = JaxJETSModel(_jets_cfg())
        g, d, stats = jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))
        tree = dict(g["params"])
        for scope in ("encoder_module", "decoder_module"):
            tree[scope] = fp_parity.randomize(tree[scope], 21 + len(scope))
        tree["duration_predictor_module"]["fc"]["bias"] = np.full(1, np.log(4.0), np.float32)
        init = {"g_params": {"params": tree}, "d_params": d, "d_stats": stats}

        def split_forward(gp, b):
            return model._split_out(model._forward(gp, b, rng, deterministic=True))

        @jax.jit
        def losses_and_grads(g_params, d_params, d_stats):
            diff_out, f_vjp, aux = jax.vjp(lambda gp: split_forward(gp, batch), g_params,
                                           has_aux=True)
            sg = jax.lax.stop_gradient(diff_out)
            (d_loss, (d_metrics, new_stats)), d_grads = jax.value_and_grad(
                lambda dp: model.d_loss_from_out(dp, d_stats, sg, aux, batch),
                has_aux=True)(d_params)
            (g_loss, g_metrics), out_bar = jax.value_and_grad(
                lambda do: model.g_loss_from_out(do, aux, d_params, new_stats, batch, EPOCH),
                has_aux=True)(diff_out)
            (g_grads,) = f_vjp(out_bar)
            return d_loss, d_metrics, d_grads, new_stats, g_loss, g_metrics, g_grads

        @jax.jit
        def bf16_g_loss(g_params, d_params, d_stats):
            cast = functools.partial(cast_floating, dtype=jnp.bfloat16)
            b16 = cast(batch)
            diff, aux = split_forward(cast(g_params), b16)
            loss, metrics = model.g_loss_from_out(diff, aux, cast(d_params), cast(d_stats), b16,
                                                  EPOCH)
            out = {**diff, **aux}
            return {"g_loss": loss, **metrics}, out["attn_hard"], out["z_start_idxs"]

        forward = jax.jit(lambda gp: model._forward(gp, batch, rng, deterministic=True))
        infer = jax.jit(lambda gp: model.module.apply(
            gp, batch["text"], speaker=batch["speaker_id"], max_mel_len=64,
            method=model.module.infer))
        first = jax.device_get(losses_and_grads(init["g_params"], d, stats))
        bf16 = jax.device_get(bf16_g_loss(init["g_params"], d, stats))
        return {"init": init, "forward": jax.device_get(forward(init["g_params"])),
                "infer": jax.device_get(infer(init["g_params"])), "first": first,
                "bf16": bf16}


@pytest.fixture(scope="module")
def jets_jax():
    return _jets_jax()


def _jets_port(tree, **cfg_kwargs):
    model = JETSModel(_jets_cfg(**cfg_kwargs))
    convert.load_jets_bundle(model.module, model.mpd, model.msd, tree)
    return model


def test_jets_conformer_parameter_tree_round_trips_and_strays_raise(jets_jax):
    tree = jets_jax["init"]
    model = _jets_port(tree)
    got, want = flatten_dict(model.to_jax_tree()), flatten_dict(tree)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))
    g = flatten_dict(tree["g_params"], sep="/")
    conv = "params/decoder_module/layers_1/convolutional_block"
    assert g[f"{conv}/Conv_1/kernel"].shape == (KERNEL, 1, D)  # depthwise, flax layout
    assert model.module.decoder_module.layers[1].convolutional_block.depthwise.weight.shape == (
        D, 1, KERNEL)
    assert not any(k.startswith("params/encoder_module/stack/cond_input") for k in g)
    stray = unflatten_dict({**g, f"{conv}/stray": np.zeros(1, np.float32)}, sep="/")
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_jets_params(JETSModel(_jets_cfg()).module, stray)
    missing = unflatten_dict({k: v for k, v in g.items() if not k.startswith(conv)}, sep="/")
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_jets_params(JETSModel(_jets_cfg()).module, missing)


def test_jets_conformer_forward_and_infer_match_jax(jets_jax, monkeypatch):
    want = jets_jax["forward"]
    port = _jets_port(jets_jax["init"])
    jets_tests._starts(monkeypatch, want["z_start_idxs"])
    launches = fa.LAUNCHES.copy()
    with torch.no_grad():
        got = port._forward(jets_tests._torch_batch("conditioned"), deterministic=True)
    assert fa.LAUNCHES == launches
    for k in jets_tests.EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("wav", "attn_soft", "attn_logprob", "log_durs_predicted", "durs_predicted",
              "pitch_predicted", "pitch", "energy_pred", "energy_tgt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **FWD_TOL)

    want = jets_jax["infer"]
    text = jets_tests._torch_batch("conditioned")["text"].long()
    out = port.module.eval().infer(text, speaker=torch.tensor(jets_tests.SPEAKERS),
                                   max_mel_len=64)
    np.testing.assert_array_equal(out["num_frames"].numpy(), np.asarray(want["num_frames"]))
    assert int(out["num_frames"].min()) > 0
    for k in ("wav", "durs_predicted", "log_durs_predicted"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **FWD_TOL)


def test_jets_conformer_d_and_g_losses_and_gradients_match_jax(jets_jax, monkeypatch):
    d_loss, d_metrics, d_grads, new_stats, g_loss, g_metrics, g_grads = jets_jax["first"]
    init, starts = jets_jax["init"], jets_jax["forward"]["z_start_idxs"]
    batch = jets_tests._torch_batch("conditioned")

    model = _jets_port(init)
    jets_tests._starts(monkeypatch, starts)
    out = model._forward(batch, deterministic=True)
    loss, metrics = model.d_loss_from_out({k: v.detach() for k, v in out.items()}, batch)
    np.testing.assert_allclose(float(loss.detach()), float(d_loss), **TOL)
    for k, v in d_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    got = jets_tests._grads_as_tree(model)
    jets_tests._assert_tree_close(got["d_params"], d_grads, "d grad", rtol=3e-3, atol=1e-6)

    model = _jets_port({**init, "d_stats": new_stats})
    for p in model.d_parameters():
        p.requires_grad_(False)
    jets_tests._starts(monkeypatch, starts)
    loss, metrics = model.g_loss_from_out(model._forward(batch, deterministic=True), batch,
                                          EPOCH)
    np.testing.assert_allclose(float(loss.detach()), float(g_loss), **TOL)
    assert set(metrics) == set(g_metrics) and "energy_loss" in metrics
    for k, v in g_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    scale = max(float(np.abs(v).max()) for v in flatten_dict(g_grads).values())
    jets_tests._assert_tree_close(jets_tests._grads_as_tree(model)["g_params"], g_grads,
                                  "g grad", rtol=3e-3, atol=1e-5 * scale)


def test_jets_conformer_bf16_g_loss_matches_jax(jets_jax, monkeypatch):
    from roar_tpu_torch.models import jets as jets_module

    want, hard, starts = jets_jax["bf16"]
    model = _jets_port(jets_jax["init"])
    model.set_compute_dtype(torch.bfloat16)
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in jets_tests._torch_batch("conditioned").items()}
    jets_tests._starts(monkeypatch, starts, starts)
    with torch.no_grad():
        out = model._forward(batch, deterministic=True)
    assert out["wav"].dtype == torch.bfloat16
    # MAS may part on a near-tie of bf16 scores (ROADMAP N4): the rest is
    # compared on the JAX run's hard alignment
    assert int((out["attn_hard"].numpy() != hard).any(-1).sum()) <= 1
    monkeypatch.setattr(jets_module, "binarize_attention",
                        lambda *args: torch.from_numpy(np.array(hard, np.float32)))
    with torch.no_grad():
        loss, metrics = model.g_loss_from_out(model._forward(batch, deterministic=True), batch,
                                              EPOCH)
    got = {"g_loss": loss, **metrics}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=BF16_LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------------------
# paths, dropout, config
# --------------------------------------------------------------------------

def test_training_takes_einsum_and_eval_with_use_flash_takes_flash():
    model = JETSModel(_jets_cfg(dropout=0.1), generator=torch.Generator().manual_seed(0))
    module = model.module
    stacks = (module.encoder_module.stack, module.decoder_module)
    assert model.attention_paths() == {"input_fft": "einsum", "output_fft": "einsum"}
    assert all(s.train().attention_path() == "einsum" for s in stacks)
    assert all(s.eval().attention_path() == "flash" for s in stacks)
    no_flash = JETSModel(_jets_cfg(dropout=0.1, use_flash=False))
    assert no_flash.module.decoder_module.eval().attention_path() == "einsum"
    fp = FastPitchModel(_fp_cfg())
    assert fp.attention_paths() == {"input_fft": "flash", "output_fft": "flash"}
    fp.module.train()
    assert fp.attention_paths() == {"input_fft": "einsum", "output_fft": "einsum"}

    calls = []
    real = fa.flash_self_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    batch = jets_tests._torch_batch("conditioned")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_self_attention", counting)
        with torch.no_grad():
            model.forward_split(batch)
            assert not calls
            model._forward(batch, deterministic=True)
    assert len(calls) == 4 and {s[2:] for s in calls} == {(N_HEAD, D_HEAD)}


def test_same_seed_same_dropout_and_training_differs_from_deterministic():
    batch = jets_tests._torch_batch("conditioned")
    outs = []
    for _ in range(2):
        model = JETSModel(_jets_cfg(dropout=0.1), generator=torch.Generator().manual_seed(0))
        model.set_dropout_generator(torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append([model.forward_split(batch) for _ in range(2)])
    for a, b in zip(*outs):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # two draws of one generator differ, and so does the deterministic forward
    assert not torch.equal(outs[0][0]["log_durs_predicted"], outs[0][1]["log_durs_predicted"])
    with torch.no_grad():
        det = model._forward(batch, deterministic=True)
    assert not torch.equal(outs[0][0]["log_durs_predicted"], det["log_durs_predicted"])


def test_fft_config_picks_the_stack_and_ignores_what_the_conformer_does_not_take():
    assert _fft_config({"_target_": "roar.modules.FFConformerEncoder"}).encoder_type == \
        "conformer"
    assert _fft_config({}).encoder_type == "transformer"
    cfg = _fft_config({**_conformer_fft(), "adapter_dim": 8, "remat": True, "pre_lnorm": True})
    assert cfg.encoder_type == "conformer" and cfg.use_rope
    assert _fft_config({"adapter_dim": 8}).adapter_dim == 8  # a transformer stack takes it
    # and remat (tests/test_torch_remat.py); the Conformer stack built from
    # `cfg` above ignores it
    assert _fft_config({"remat": True}).remat
    assert not hasattr(make_decoder(cfg), "remat")
