"""bf16 training of the TTS path (HiFi-GAN, JETS, FastPitch), port against the
JAX package's bf16 steps.

The JAX package trains in bf16 by casting the parameter tree and the batch to
bf16 and keeping fp32 masters (roar_tpu/training/gan.py:162-258,
trainer.py:152-174); the port's tasks take `set_compute_dtype(torch.bfloat16)`
and their layers cast each parameter where they use it.  Here, at the small
sizes of tests/test_torch_{gan_step,jets,fastpitch_train}.py, with the same
seeded weights (carried across by training/convert.py) and the same numpy
batch:

- leak guards, the port's counterparts of tests/test_mixed_precision_dtypes.py:
  the compute-heavy outputs are bf16, the aligner's and the targets' stay fp32;
- one bf16 step of each model against the JAX package's jitted bf16 step:
  every loss term at LOSS_RTOL, the hard alignments equal (JETS: see
  JETS_MAS_FRAMES_APART);
- after three steps the masters, the optimizer moments and the spectral
  norm's u and sigma are fp32;
- the shipped YAMLs select bf16 through the CLIs' config path.

On the CPU the grouped convs take their plain versions and attention its
plain path; the kernels are held against those on the card by
tests/test_torch_grouped_conv_bf16.py and chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_fastpitch_train as fp_tests
import test_torch_gan_step as hg_tests
import test_torch_jets as jets_tests
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu.config import load_config
from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.models.jets_model import JETSModel as JaxJETSModel
from roar_tpu.training.gan import create_gan_state
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.trainer import cast_floating, create_train_state, make_train_step
from roar_tpu_torch.models.fastpitch_model import FastPitchModel, spec_from_batch
from roar_tpu_torch.models.hifigan import SpectralNormConv
from roar_tpu_torch.models.hifigan_model import HifiGanModel
from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.training import run
from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, to_device, train_step

REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
# every loss term of a bf16 step, port against the JAX package: GPT's bf16
# loss bar.  Both sides round the same weights and batch to bf16 and run
# bf16 layers, but round their intermediates at other places (torch's bf16
# matmuls and convs sum in fp32 and round once; XLA's CPU ops may round
# between fused parts) and sum in other orders
LOSS_RTOL = 2e-2
N_STEPS = 3  # steps of the fp32-state checks


def _bf16(batch):
    return {k: v.to(BF16) if v.is_floating_point() else v for k, v in batch.items()}


def _jnp(batch_np):
    return {k: jnp.asarray(v) for k, v in batch_np.items()}


def _assert_losses_close(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=f"{what} {k}")


def _spectral_stats(msd):
    return [t for m in msd.modules() if isinstance(m, SpectralNormConv) for t in (m.u, m.sigma)]


# --------------------------------------------------------------------------
# leak guards
# --------------------------------------------------------------------------

def _jets_port(flavour="conditioned"):
    model = JETSModel(jets_tests._cfg(flavour=flavour),
                      generator=torch.Generator().manual_seed(0))
    model.set_compute_dtype(BF16)
    return model


def test_jets_forward_stays_bf16():
    model = _jets_port()
    with torch.no_grad():
        out = model._forward(_bf16(jets_tests._torch_batch("conditioned")), deterministic=True)
    for k in ("wav", "log_durs_predicted", "pitch_predicted", "energy_pred", "durs_predicted"):
        assert out[k].dtype == BF16, (k, out[k].dtype)
    # the aligner, MAS and the prosody targets stay fp32, as in the JAX package
    for k in ("attn_soft", "attn_logprob", "attn_hard", "pitch", "energy_tgt"):
        assert out[k].dtype == torch.float32, (k, out[k].dtype)


def test_jets_discriminators_stay_bf16():
    model = _jets_port()
    seg = model.segment_size * model.hop_length
    y = torch.randn(2, seg, generator=torch.Generator().manual_seed(1)).to(BF16)
    with torch.no_grad():
        mpd_out, msd_out = model._disc_all(y, y, update_stats=True)
    for name, out in (("MPD", mpd_out), ("MSD", msd_out)):
        tensors = [*out[0], *out[1], *(f for fm in out[2] + out[3] for f in fm)]
        assert {t.dtype for t in tensors} == {BF16}, f"{name} promoted"
    # the stored spectral-norm stats stay fp32 (and moved)
    assert {t.dtype for t in _spectral_stats(model.msd)} == {torch.float32}


def test_hifigan_generator_stays_bf16():
    model = HifiGanModel(hg_tests.CFG, generator=torch.Generator().manual_seed(0))
    model.set_compute_dtype(BF16)
    batch = _bf16({k: torch.from_numpy(v) for k, v in hg_tests._batch_np().items()})
    with torch.no_grad():
        fake = model.forward_split(batch)["fake"]
        # the mel front end computes in fp32; the generator's input is cast
        assert model._mel(batch["audio"], batch["audio_len"])[0].dtype == torch.float32
    assert fake.dtype == BF16


def test_fastpitch_forward_stays_bf16():
    model = FastPitchModel(fp_tests._cfg(), generator=torch.Generator().manual_seed(0))
    model.set_compute_dtype(BF16)
    batch = _bf16(fp_tests._torch_batch())
    spec, mel_lens = spec_from_batch(batch, model.mel_cfg)
    assert spec.dtype == torch.float32  # the mel front end; it feeds only the aligner
    with torch.no_grad():
        out = model.module(batch["text"].long(), pitch=batch["pitch"], energy=batch["energy"],
                           speaker=batch["speaker_id"].long(), spec=spec,
                           attn_prior=batch["align_prior_matrix"], mel_lens=mel_lens,
                           input_lens=batch["text_len"])
    for k in ("spect", "log_durs_predicted", "pitch_predicted", "energy_pred"):
        assert out[k].dtype == BF16, (k, out[k].dtype)
    for k in ("attn_soft", "attn_logprob", "attn_hard"):
        assert out[k].dtype == torch.float32, (k, out[k].dtype)


def test_compute_dtype_none_leaves_the_fp32_path_alone():
    """Switching bf16 on and off again gives the fp32 forward bit for bit."""
    batch = jets_tests._torch_batch("conditioned")
    model = JETSModel(jets_tests._cfg(flavour="conditioned"),
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.set_dropout_generator(torch.Generator().manual_seed(5))  # the segment starts
        before = model._forward(batch, deterministic=True)
        model.set_compute_dtype(BF16)
        model.set_compute_dtype(None)
        model.set_dropout_generator(torch.Generator().manual_seed(5))
        after = model._forward(batch, deterministic=True)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k


# --------------------------------------------------------------------------
# one bf16 step of each task against the JAX package's, then two more steps
# --------------------------------------------------------------------------

def _assert_fp32_state(params, opt, stats=()):
    """Masters, the optimizer's moments and the spectral norm's buffers fp32."""
    assert {p.dtype for p in params} == {torch.float32}
    moments = [t for s in opt.state_dict()["optimizer"]["state"].values() for t in s.values()
               if torch.is_tensor(t) and t.is_floating_point()]
    assert moments and {t.dtype for t in moments} == {torch.float32}
    assert {t.dtype for t in stats} <= {torch.float32}


def _gan_state(model, optim, max_steps):
    return GANTrainState(model=model,
                         g_opt=build_optimizer(model.g_parameters(), optim, max_steps=max_steps),
                         d_opt=build_optimizer(model.d_parameters(), optim, max_steps=max_steps))


def test_hifigan_bf16_step_matches_jax():
    model_j = JaxHifiGanModel(hg_tests.CFG)
    batch_np = hg_tests._batch_np()
    batch = _jnp(batch_np)
    g_opt = jax_build_optimizer(hg_tests.OPTIM, max_steps=hg_tests.MAX_STEPS)
    d_opt = jax_build_optimizer(hg_tests.OPTIM, max_steps=hg_tests.MAX_STEPS)
    state_j = model_j.init_state(jax.random.PRNGKey(0), batch, g_opt, d_opt)
    init = jax.device_get((state_j.g_params, state_j.d_params, state_j.d_stats))
    step = model_j.make_train_step(g_opt, d_opt, precision="bf16", shared_forward=True)
    _, want = step(state_j, batch, jax.random.PRNGKey(1), 0)

    model = hg_tests._port_model(*init)
    model.set_compute_dtype(BF16)
    state = _gan_state(model, hg_tests.OPTIM, hg_tests.MAX_STEPS)
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    state, metrics = gan_train_step(state, batch_t)
    _assert_losses_close(metrics, {k: float(v) for k, v in want.items()}, "HiFi-GAN")
    for _ in range(N_STEPS - 1):
        state, metrics = gan_train_step(state, batch_t)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    _assert_fp32_state(model.g_parameters(), state.g_opt)
    _assert_fp32_state(model.d_parameters(), state.d_opt, _spectral_stats(model.msd))


# At tests/test_torch_jets.py's conditioned inputs (batch seed 0, the JAX
# init at PRNGKey(0)) the bf16 graphs of the two frameworks give soft
# alignments whose MAS paths part at one frame of the 2 x 64 (ROADMAP queue
# 3): MAS's max over two near-equal path scores flips on bf16 rounding.  The
# step is then compared with the JAX run's hard alignment fed to the port.
JETS_MAS_FRAMES_APART = 1


def test_jets_bf16_step_matches_jax(monkeypatch):
    from roar_tpu_torch.models import jets as jets_module

    model_j, batch, tree = jets_tests._jax_init("conditioned")
    model_j = JaxJETSModel(jets_tests._cfg(flavour="conditioned"))
    rng = jax.random.PRNGKey(1)
    out_j = jax.device_get(jax.jit(lambda g, b: model_j._forward(
        cast_floating(g, jnp.bfloat16), cast_floating(b, jnp.bfloat16), rng,
        deterministic=True))(tree["g_params"], batch))
    g_opt = jax_build_optimizer(jets_tests.OPTIM, max_steps=jets_tests.MAX_STEPS)
    d_opt = jax_build_optimizer(jets_tests.OPTIM, max_steps=jets_tests.MAX_STEPS)
    state_j = create_gan_state(tree["g_params"], tree["d_params"], g_opt, d_opt, tree["d_stats"])
    step = model_j.make_train_step(g_opt, d_opt, precision="bf16", shared_forward=True)
    _, want = step(state_j, batch, rng, jets_tests.EPOCH)
    # the segment starts the step's (training-mode) forward drew
    starts = np.asarray(jax.jit(lambda g: model_j.forward_split(g, batch, rng, 0)[1][
        "z_start_idxs"])(tree["g_params"]))

    model = jets_tests._port_model(tree, "grouped", "conditioned")
    model.set_compute_dtype(BF16)
    batch_t = jets_tests._torch_batch("conditioned")
    jets_tests._starts(monkeypatch, out_j["z_start_idxs"], starts, *[starts] * (N_STEPS - 1))
    with torch.no_grad():
        out = model._forward(_bf16(batch_t), deterministic=True)
    np.testing.assert_allclose(out["attn_soft"].numpy(), out_j["attn_soft"], atol=2e-2)
    apart = int((out["attn_hard"].numpy() != out_j["attn_hard"]).any(-1).sum())
    assert apart <= JETS_MAS_FRAMES_APART
    np.testing.assert_array_equal(out["attn_hard_dur"].sum(-1).numpy(), out["mel_lens"].numpy())

    # downstream of MAS, with the JAX run's hard alignment
    hard = torch.from_numpy(np.array(out_j["attn_hard"]))
    monkeypatch.setattr(jets_module, "binarize_attention", lambda *args: hard)
    state = _gan_state(model, jets_tests.OPTIM, jets_tests.MAX_STEPS)
    state, metrics = gan_train_step(state, batch_t, epoch=jets_tests.EPOCH)
    _assert_losses_close(metrics, {k: float(v) for k, v in want.items()}, "JETS")
    assert float(metrics["bin_loss"]) > 0.0
    for _ in range(N_STEPS - 1):
        state, metrics = gan_train_step(state, batch_t, epoch=jets_tests.EPOCH)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    _assert_fp32_state(model.g_parameters(), state.g_opt)
    _assert_fp32_state(model.d_parameters(), state.d_opt, _spectral_stats(model.msd))


def test_fastpitch_bf16_step_matches_jax():
    model_j = JaxFastPitchModel(fp_tests._cfg(dropout=0.0, dropatt=0.0))
    batch_np = fp_tests._batch_np()
    batch = _jnp(batch_np)
    params = model_j.init_params(jax.random.PRNGKey(0), batch)

    @jax.jit
    def forward(p, b):
        p, b = cast_floating(p, jnp.bfloat16), cast_floating(b, jnp.bfloat16)
        spec, mel_lens = model_j._spec_from_batch(b["audio"], b["audio_len"], b)
        return model_j.module.apply(
            p, b["text"], pitch=b["pitch"], energy=b["energy"], speaker=b["speaker_id"],
            spec=spec, attn_prior=b["align_prior_matrix"], mel_lens=mel_lens,
            input_lens=b["text_len"], deterministic=True)

    out_j = jax.device_get(forward(params, batch))
    optimizer = jax_build_optimizer(fp_tests.OPTIM, gradient_clip_val=fp_tests.CLIP)
    step = make_train_step(
        lambda p, b, rng, epoch: model_j.loss_fn(p, b, None, epoch, deterministic=True),
        optimizer, donate=False, precision="bf16")
    _, want = step(create_train_state(params, optimizer), batch, jax.random.PRNGKey(0),
                   fp_tests.EPOCH)

    model = fp_tests._port_model(params, dropout=0.0, dropatt=0.0)
    opt = build_optimizer(model.parameters(), fp_tests.OPTIM, gradient_clip_val=fp_tests.CLIP)
    trainer = Trainer(model, opt, device="cpu", precision="bf16")
    state = trainer.init_state()
    # the trainer's batch: floating tensors in bf16
    batch_t = to_device(batch_np, torch.device("cpu"), trainer.compute_dtype)
    spec, mel_lens = spec_from_batch(batch_t, model.mel_cfg)
    with torch.no_grad():
        out = model.module(batch_t["text"].long(), pitch=batch_t["pitch"],
                           energy=batch_t["energy"], speaker=batch_t["speaker_id"].long(),
                           spec=spec, attn_prior=batch_t["align_prior_matrix"],
                           mel_lens=mel_lens, input_lens=batch_t["text_len"])
    np.testing.assert_array_equal(out["attn_hard"].numpy(), out_j["attn_hard"])
    state, metrics = train_step(state, batch_t, fp_tests.EPOCH)
    _assert_losses_close(metrics, {k: float(v) for k, v in want.items()}, "FastPitch")
    assert float(metrics["bin_loss"]) > 0.0
    for _ in range(N_STEPS - 1):
        state, metrics = train_step(state, batch_t, fp_tests.EPOCH)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    _assert_fp32_state(model.parameters(), opt)


# --------------------------------------------------------------------------
# the shipped configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name, want", [("jets_22050_align", "bf16-mixed"),
                                        ("fastpitch_22050_align", "bf16")])
def test_shipped_yamls_train_in_bf16_through_the_cli_config_path(name, want):
    """The YAML's own precision, with no `trainer.precision=32`, selects the
    bf16 step: the runner's mapping, and the task takes it."""
    cfg = load_config(REPO / "configs" / f"{name}.yaml", overrides=[
        "train_dataset=x", "validation_datasets=x", "sup_data_path=x", "pitch_mean=170.0",
        "pitch_std=60.0", "model.speaker_encoder.lookup_module.n_speakers=2"])
    assert cfg["trainer"]["precision"] == want
    assert run._map_precision(cfg["trainer"]["precision"]) == "bf16"
    if name.startswith("fastpitch"):
        model = FastPitchModel(fp_tests._cfg())
        trainer = Trainer(model, build_optimizer(model.parameters(), fp_tests.OPTIM),
                          device="cpu", precision=run._map_precision(cfg["trainer"]["precision"]))
        trainer.init_state()
        layers = [m for m in model.module.modules() if hasattr(m, "compute_dtype")]
    else:
        model = JETSModel(jets_tests._cfg())
        assert hasattr(model, "set_compute_dtype")  # what train_gan asks of a bf16 task
        model.set_compute_dtype(BF16)
        layers = [m for part in (model.module, model.mpd, model.msd) for m in part.modules()
                  if hasattr(m, "compute_dtype")]
    assert layers and {m.compute_dtype for m in layers} == {BF16}

