#!/usr/bin/env python3
"""Drive the PyTorch port (roar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: torch and CUDA versions and the card's `nvidia-smi` name and power
   limit; exits non-zero without a CUDA device;
2. build: compile the CUDA kernels from roar_tpu_torch/csrc/;
3. kernel: every kernel against its plain PyTorch version on the card at its
   main path's shapes, with the times of both, the kernel's bound on this
   card and, where there is one, the time of the one PyTorch call that
   computes the same function: flash attention (allclose), the pYIN Viterbi
   forward pass and backtrack (exactly equal, ties included), the grouped
   conv forward, input gradient and weight gradient (relative to the
   result's scale; the weight gradient bit-identical across two runs);
4. slice: full-size FastPitch (flash attention in all 12 layers) and HiFi-GAN
   v1 with seeded random weights, served through `SynthesisEngine.warmup`,
   `synthesize_batch` and the HTTP server; checks sample counts, WAV headers,
   the kernel's launch count and the kernel path's mel against the plain
   path's;
5. supdata: sup-data extraction at the widths of
   configs/ds_for_fastpitch_align.yaml: 16 seeded synthetic utterances of 2
   to 10 s written as WAVs with a manifest and run through
   `extract_sup_data_torch.run`; checks the cache files, finiteness, voicing
   and F0 against the synthesis truth, one launch of each Viterbi kernel per
   bucket, the kernel decode against the plain decode, and the numpy
   reference `pyin_cpu`; then one batch of 128 x 10 s for the throughput and
   the time split;
6. train_hifigan: HiFi-GAN training at the full width of
   configs/hifigan_22050.yaml (v1 generator, MPD, grouped MSD, batch 16 x
   8192, fp32): 64 seeded synthetic utterances written as WAVs with a
   manifest and run through the training CLI's `run` for 8 steps; checks
   finite losses, 30 / 30 / 15 grouped-conv kernel launches per step
   (forward / dX / dW), the spectral norm's stored u and sigma, the learning
   rate against the schedule, one D+G step with the kernels against one with
   their plain versions, and the saved `.roar` restored, folded and run; then
   the step time, its split and the kernels' share;
7. kernel_flash_bwd: the flash-attention backward kernels (dK/dV and dQ) and
   the forward's log-sum-exp against their plain versions at small ragged
   shapes and at (32, 160, 1, 64) and (32, 864, 1, 64) (batches of 20 s
   utterances, longer than phase 8 draws), two runs bit for bit, the
   forward's output unchanged by asking for the log-sum-exp, the autograd
   Function against autograd of the plain forward, and the times beside the
   bounds and autograd of SDPA;
8. train_fastpitch: FastPitch training with learned alignment at the full
   width of configs/fastpitch_22050_align.yaml (flash attention on, `dropatt`
   0, an energy predictor, 4 speakers, batch 32, fp32): 128 seeded synthetic
   utterances of 2 to 10 s with Tamil text, their sup-data extracted first
   through `extract_sup_data_torch.run`, then 8 steps through the training
   CLI's `run`; checks 12 / 12 / 12 flash launches per step (forward, dK/dV,
   dQ) and 12 forwards for the validation batch, finite losses with every
   term present, the learning rate against the Noam schedule, one step with
   the kernels against one with their plain versions, hard durations that
   sum to the mel lengths, the flash kernels held and timed as in phase 7 at
   the two shapes and key lengths that step gave them (the kernels line takes
   these), and the saved `.roar` served by `SynthesisEngine`; then the step
   time, its split and the kernels' share.

Then the kernels line, the card line, and last `{"ok": true, "device": ...}`.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
FRAMES_PER_TOKEN = 6  # every token lasts exactly this long (duration bias log 7)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-3)  # fp32 FMA kernel vs cuBLAS fp32 einsum
# kernel path vs plain path through 12 fp32 layers: the attention sums run in
# another order, and cuDNN may pick other conv algorithms for the two runs
MEL_TOL = dict(atol=5e-4, rtol=1e-3)
KERNEL_CASES = [  # (B, T, H, D): encoder and decoder buckets, a ragged T, H = 2
    (8, 256, 1, 64), (8, 3072, 1, 64), (1, 200, 1, 64), (2, 200, 2, 32),
]
# (B, T, N, W): the CLI's bucket and a batch of 128 at the production widths
# (10 s of 22050 Hz audio is T = 449 frames), the small test config, T = 2 and 1
VITERBI_CASES = [
    (16, 449, 601, 101), (128, 449, 601, 101), (3, 14, 279, 71), (1, 2, 601, 101),
    (1, 1, 601, 101),
]
# published peaks of one H100 SXM: device memory bytes/s, fp32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SUP_SAMPLE_RATE = 22050
# bars of tests/test_pyin.py GOLDEN_TOLERANCES for moving pitch: voicing
# agreement, voiced-F0 RMSE in cents, rate of errors over 100 cents
TRUTH_BARS = {"min_agree": 0.95, "max_rmse_cents": 50.0, "max_gross": 0.02}
TAMIL_SENTENCES = [
    "வணக்கம்.",
    "இன்று வானிலை மிகவும் நன்றாக இருக்கிறது.",
    "நான் காலையில் தேநீர் குடித்தேன், பிறகு அலுவலகத்திற்குச் சென்றேன்.",
    "தமிழ் ஒரு பழமையான மொழி.",
    "எங்கள் ஊரில் ஒரு பெரிய கோயில் உள்ளது, அதைப் பார்க்க நிறைய மக்கள் வருகிறார்கள்.",
    "நன்றி!",
    "புத்தகங்கள் படிப்பது அறிவை வளர்க்கும்; ஆகவே தினமும் சிறிது நேரம் படியுங்கள்.",
    "சென்னை தமிழ்நாட்டின் தலைநகரம்; இங்கு கடற்கரை, அருங்காட்சியகங்கள், பழைய கோயில்கள் "
    "மற்றும் பல்கலைக்கழகங்கள் உள்ளன, ஒவ்வொரு ஆண்டும் உலகம் முழுவதிலிருந்தும் பயணிகள் "
    "இந்த நகரத்தைக் காண வருகிறார்கள்.",
]


def fastpitch_config() -> dict:
    """The `model` block of configs/fastpitch_22050_align.yaml that the port
    reads, with `model.input_fft.use_flash=true model.output_fft.use_flash=true`
    and four speakers (tests/test_torch_serving.py holds it to the YAML)."""
    fft = {"n_layer": 6, "n_head": 1, "d_model": 384, "d_head": 64, "d_inner": 1536,
           "kernel_size": 3, "condition_types": ["add", "layernorm"], "use_flash": True}
    predictor = {"input_size": 384, "kernel_size": 3, "filter_size": 256, "n_layers": 2,
                 "condition_types": ["add", "layernorm"]}
    return {
        "learn_alignment": True,
        "max_token_duration": 75,
        "symbols_embedding_dim": 384,
        "pitch_embedding_kernel_size": 3,
        "n_mel_channels": 80,
        "text_tokenizer": {"_target_": "roar_tpu.data.tokenizers.TamilCharsTokenizer",
                           "punct": True, "apostrophe": True, "pad_with_space": True},
        "preprocessor": {"sample_rate": 22050, "features": 80},
        "input_fft": {**fft, "d_embed": 384},
        "output_fft": dict(fft),
        "alignment_module": {"n_text_channels": 384, "condition_types": ["add"]},
        "duration_predictor": dict(predictor),
        "pitch_predictor": dict(predictor),
        "speaker_encoder": {"lookup_module": {"n_speakers": 4, "embedding_dim": 384}},
        "speaker_emb_condition_prosody": True,
        "speaker_emb_condition_decoder": True,
        "speaker_emb_condition_aligner": True,
    }


def hifigan_config() -> dict:
    """The `model` block of configs/hifigan_22050.yaml that the port reads:
    the preprocessor and the v1 generator."""
    return {
        "preprocessor": {
            "nfilt": 80, "lowfreq": 0, "highfreq": 8000, "n_fft": 1024, "n_window_size": 1024,
            "n_window_stride": 256, "pad_to": 0, "pad_value": -11.52, "sample_rate": 22050,
            "window": "hann", "normalize": None, "preemph": None, "dither": 0.0, "log": True,
            "log_zero_guard_type": "clamp", "log_zero_guard_value": 1e-05, "mag_power": 1.0,
            "exact_pad": True,
        },
        "generator": {
            "resblock": 1, "upsample_rates": [8, 8, 2, 2],
            "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 512,
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        },
    }


def hifigan_train_config(manifest: str, exp_dir: str, device: str = "cuda", max_steps: int = 8,
                         batch_size: int = 16, n_segments: int = 8192, debug: bool = False) -> dict:
    """configs/hifigan_22050.yaml as the loader resolves it, for the keys the
    training CLI reads, with `trainer.max_steps`, `trainer.log_every_n_steps=1`
    `trainer.max_epochs` and `exp_manager.always_save_roar=true`
    (tests/test_torch_train_gan.py holds it to the YAML).  Two epochs of 64
    utterances are 8 steps.  No validation set: they end before epoch 20."""
    model = {
        **hifigan_config(),
        "train_ds": {
            "dataset": {"_target_": "roar_tpu.data.dataset.VocoderDataset",
                        "manifest_filepath": manifest, "sample_rate": 22050,
                        "n_segments": n_segments, "max_duration": None, "min_duration": 0.75},
            "dataloader_params": {"drop_last": False, "shuffle": True, "batch_size": batch_size,
                                  "num_workers": 4},
        },
        "optim": {"name": "adamw", "lr": 0.0002, "betas": [0.8, 0.99],
                  "sched": {"name": "CosineAnnealing", "min_lr": 1e-5, "warmup_ratio": 0.02}},
        "max_steps": 2500000, "l1_loss_factor": 45,
    }
    if debug:
        model["debug"] = True
    return {
        "name": "HifiGan", "model": model,
        "trainer": {"max_steps": max_steps, "max_epochs": 2, "log_every_n_steps": 1,
                    "check_val_every_n_epoch": 20, "seed": 0},
        "exp_manager": {"exp_dir": exp_dir, "name": "HifiGan", "resume_if_exists": False,
                        "always_save_roar": True},
        "device": device,
    }


def fastpitch_train_config(train_manifest: str, val_manifest: str, sup_dir: str, exp_dir: str,
                           pitch_mean: float, pitch_std: float, device: str = "cuda",
                           max_steps: int = 8, batch_size: int = 32) -> dict:
    """configs/fastpitch_22050_align.yaml as the loader resolves it, for the
    keys the training CLI reads, with the overrides of the configuration that
    runs the attention kernels: `model.{input_fft,output_fft}.use_flash=true`
    and `.dropatt=0.0` (every other dropout stays 0.1), 4 speakers,
    `+model.energy_predictor` (the pitch predictor's block) with `energy` in
    `sup_data_types`, `trainer.precision=32`, `trainer.max_steps`,
    `trainer.log_every_n_steps=1` and `exp_manager.always_save_roar=true`
    (tests/test_torch_train_supervised.py holds it to the YAML)."""
    model = fastpitch_config()
    for fft in ("input_fft", "output_fft"):
        model[fft].update(dropout=0.1, dropatt=0.0, dropemb=0.0)
    for predictor in ("duration_predictor", "pitch_predictor"):
        model[predictor]["dropout"] = 0.1
    model["energy_predictor"] = dict(model["pitch_predictor"])
    model["preprocessor"] = {
        "features": 80, "lowfreq": 0, "highfreq": 8000, "n_fft": 2048, "n_window_size": 2048,
        "n_window_stride": 512, "pad_to": 1, "pad_value": 0, "sample_rate": 22050,
        "window": "hann", "normalize": None, "preemph": None, "dither": 0.0, "log": True,
        "log_zero_guard_type": "add", "log_zero_guard_value": 1e-05, "mag_power": 1.0,
    }

    def dataset(manifest):
        return {"_target_": "roar_tpu.data.dataset.TTSDataset", "manifest_filepath": manifest,
                "sample_rate": 22050, "sup_data_path": sup_dir,
                "sup_data_types": ["align_prior_matrix", "pitch", "speaker_id", "energy"],
                "n_fft": 2048, "win_length": 2048, "hop_length": 512, "window": "hann",
                "n_mels": 80, "lowfreq": 0, "highfreq": 8000, "max_duration": None,
                "min_duration": 0.1, "ignore_file": None, "trim": False,
                "pitch_fmin": 65.40639132514966, "pitch_fmax": 2093.004522404789,
                "pitch_norm": True, "pitch_mean": pitch_mean, "pitch_std": pitch_std,
                "use_beta_binomial_interpolator": True}

    model.update({
        "bin_loss_warmup_epochs": 100,
        "train_ds": {"dataset": dataset(train_manifest),
                     "dataloader_params": {"drop_last": False, "shuffle": True,
                                           "batch_size": batch_size, "num_workers": 4}},
        "validation_ds": {"dataset": dataset(val_manifest),
                          "dataloader_params": {"drop_last": False, "shuffle": False,
                                                "batch_size": batch_size, "num_workers": 4}},
        "optim": {"name": "adamw", "lr": 0.001, "betas": [0.9, 0.999], "weight_decay": 1e-06,
                  "sched": {"name": "NoamAnnealing", "warmup_steps": 1000, "last_epoch": -1,
                            "d_model": 1}},
    })
    return {
        "name": "FastPitch", "model": model,
        "trainer": {"max_epochs": 1000, "precision": 32, "gradient_clip_val": 1000.0,
                    "log_every_n_steps": 1, "check_val_every_n_epoch": 1, "seed": 0,
                    "model_parallel_size": 1, "max_steps": max_steps},
        "exp_manager": {"exp_dir": exp_dir, "name": "FastPitch", "resume_if_exists": False,
                        "always_save_roar": True},
        "device": device,
    }


def seed_weights(module: torch.nn.Module, rng: np.random.Generator) -> None:
    """Fill every parameter from `rng`: matrices and kernels N(0, 1/fan_in),
    embeddings N(0, 1), biases 0, LayerNorm weights 1; conditional-LayerNorm
    projections start at identity plus a small speaker-dependent part."""
    from torch import nn

    from roar_tpu_torch.models.submodules import ConditionalLayerNorm

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * std))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                normal(m.weight, 1.0 / np.sqrt(m.weight[0].numel()))
            elif isinstance(m, nn.ConvTranspose1d):
                normal(m.weight, 1.0 / np.sqrt(m.weight.shape[0] * m.weight.shape[2] / m.stride[0]))
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 1.0)
            elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
                m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        for m in module.modules():
            if isinstance(m, ConditionalLayerNorm) and m.condition:
                m.scale_proj.weight.mul_(0.1)
                m.shift_proj.weight.mul_(0.1)
                m.scale_proj.bias.fill_(1.0)


def build_models(fp_cfg: dict, hg_cfg: dict, seed: int = SEED):
    """Port FastPitch and generator with seeded weights.  The duration
    predictor's fc is 0 with bias log(7): every token lasts exactly 6 frames."""
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel
    from roar_tpu_torch.models.hifigan_model import vocoder_from_config

    rng = np.random.default_rng(seed)
    fp = FastPitchModel(fp_cfg)
    seed_weights(fp.module, rng)
    with torch.no_grad():
        fc = fp.module.duration_predictor_module.fc
        fc.weight.zero_()
        fc.bias.fill_(float(np.log(FRAMES_PER_TOKEN + 1)))
    gen = vocoder_from_config(hg_cfg)
    seed_weights(gen, rng)  # audio stays well inside tanh's range
    return fp, gen


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps: int = 10) -> float:
    """Median per-call device time over `reps` calls, by CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernel(device: torch.device) -> dict:
    """Kernel vs plain version at the serving shapes; returns a summary."""
    from roar_tpu_torch.kernels import flash_attention as fa

    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(SEED)
    worst, decoder_times = 0.0, None
    for b, t, h, d in KERNEL_CASES:
        q, k, v = (torch.randn(b, t, h, d, device=device, generator=g) for _ in range(3))
        # ragged key lengths; every batch of 2+ rows has one with a single valid key
        lens = [t, 1, t // 2, t - 37, 5, t - 64, 65, 3 * t // 4][:b] if b > 1 else [t - 69]
        key_mask = (torch.arange(t, device=device)[None, :]
                    < torch.tensor(lens, device=device)[:, None])
        scale = 1.0 / d ** 0.5
        got = fa.flash_self_attention(q, k, v, key_mask, scale)
        want = fa.flash_self_attention_plain(q, k, v, key_mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel output not finite at {(b, t, h, d)}")
        err = (got - want).abs()
        rows = key_mask[:, :, None, None].expand_as(err)
        err_valid = float(err[rows].max())
        err_pad = float(err[~rows].max()) if (~rows).any() else 0.0
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        ms = _time_ms(lambda: fa.flash_self_attention(q, k, v, key_mask, scale))
        plain_ms = _time_ms(lambda: fa.flash_self_attention_plain(q, k, v, key_mask, scale))
        # the one PyTorch call that computes the same function: SDPA with the
        # segment mask (a yardstick only; the port never calls it)
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        visible = (key_mask[:, None, :, None] == key_mask[:, None, None, :])
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible, scale=scale)
        torch.testing.assert_close(lib_out.transpose(1, 2), want, **KERNEL_TOL)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=visible, scale=scale))
        # bound: a query sees only the keys of its segment, so the products
        # this data needs are len^2 + (T - len)^2 per row, 4 FLOP per product
        # and head-dim element (QK^T and PV); q, k, v read and out written once
        pairs = sum(n * n + (t - n) * (t - n) for n in lens)
        flops = 4.0 * pairs * h * d
        nbytes = 4.0 * (4 * b * t * h * d + b * t)
        bound = _bound(nbytes, flops)
        worst = max(worst, err_valid, err_pad)
        if (b, t) == (8, 3072):
            decoder_times = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}
        _emit({"phase": "kernel", "kernel": "flash_attention_fwd", "shape_bthd": [b, t, h, d],
               "key_lens": lens,
               "max_abs_err_valid_rows": err_valid, "max_abs_err_pad_rows": err_pad,
               "tol": KERNEL_TOL, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call": "F.scaled_dot_product_attention(attn_mask=segment mask)",
               **bound})
        del q, k, v, got, want, err, visible, lib_out
    return {"max_abs_err": worst, **decoder_times}


def _bound(nbytes: float, flops: float) -> dict:
    """The least time this card could take: the larger of bytes over the
    memory rate and operations over the fp32 (non-tensor) peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": flops}


def viterbi_log_obs(rng: np.random.Generator, b: int, t: int, n: int, ties: bool) -> np.ndarray:
    """Seeded log observations [B, T, 2N]: random rows normalised, log, -700
    floor.  With `ties`, one row is constant over states and frames and
    another repeats one frame, so whole bands of candidates are equal."""
    obs = rng.random((b, t, 2 * n)).astype(np.float32)
    obs[rng.random(obs.shape) < 0.3] = 0.0  # zero-probability states hit the floor
    obs /= obs.sum(-1, keepdims=True)
    log_obs = np.where(obs > 0, np.log(np.maximum(obs, 1e-37)), -700.0).astype(np.float32)
    if ties:
        log_obs[0] = np.float32(np.log(1.0 / (2 * n)))
        if b > 1:
            log_obs[1] = log_obs[1, :1]
    return log_obs


def phase_kernel_viterbi(device: torch.device) -> dict:
    """K1 and K2 against their plain versions: exact equality of pointers,
    final scores and states.  Returns each kernel's numbers at the CLI's
    bucket shape (16, 449, 601, 101)."""
    from roar_tpu_torch.kernels import pyin_viterbi as pv
    from roar_tpu_torch.ops.pyin import _band_tables

    rng = np.random.default_rng(SEED)
    summary = {}
    for case, (b, t, n, w) in enumerate(VITERBI_CASES):
        ties = case in (0, 2)
        log_obs = torch.from_numpy(viterbi_log_obs(rng, b, t, n, ties)).to(device)
        log_tri, log_norm = (torch.from_numpy(a).to(device) for a in _band_tables(n, w))
        if not torch.isfinite(log_tri).all():
            raise AssertionError("log-triangle weights not finite")
        log_stay, log_switch = float(np.log1p(-0.01)), float(np.log(0.01))
        args = (log_obs, log_tri, log_norm, log_stay, log_switch)
        ptrs, v_final = pv.viterbi_forward(*args)
        ptrs_p, v_final_p = pv.viterbi_forward_plain(*args)
        torch.cuda.synchronize()
        # additions and comparisons only, in one order: equality is the bar
        if not torch.equal(ptrs, ptrs_p):
            raise AssertionError(f"viterbi_fwd pointers differ at {(b, t, n, w)}: "
                                 f"{int((ptrs != ptrs_p).sum())} entries")
        if not torch.equal(v_final, v_final_p):
            raise AssertionError(f"viterbi_fwd final scores differ at {(b, t, n, w)}: max "
                                 f"{float((v_final - v_final_p).abs().max())}")
        last = torch.argmax(v_final, dim=-1).to(torch.int32)
        states = pv.viterbi_backtrack(ptrs, last)
        states_p = pv.viterbi_backtrack_plain(ptrs, last)
        torch.cuda.synchronize()
        if not torch.equal(states, states_p):
            raise AssertionError(f"backtrack states differ at {(b, t, n, w)}")
        fwd_ms = _time_ms(lambda: pv.viterbi_forward(*args))
        fwd_plain_ms = _time_ms(lambda: pv.viterbi_forward_plain(*args), reps=3)
        back_ms = _time_ms(lambda: pv.viterbi_backtrack(ptrs, last))
        back_plain_ms = _time_ms(lambda: pv.viterbi_backtrack_plain(ptrs, last), reps=3)
        # K1: per frame and source bin 10 add/max/compare operations, per
        # target state and offset one add and one compare, one add of the
        # observation; observations read and pointers written once
        fwd_ops = float(b) * (t - 1) * (10 * n + 2 * n * (2 * w + 1))
        fwd_bytes = 4.0 * (2 * b * t * 2 * n + b * 2 * n + n + w)
        # K2 follows one pointer per frame and row: the bytes this data needs
        # are those entries, the final states and the states written
        back_bytes = 4.0 * (b * (t - 1) + b + b * t)
        fwd = {"ms": fwd_ms, "plain_ms": fwd_plain_ms, **_bound(fwd_bytes, fwd_ops)}
        back = {"ms": back_ms, "plain_ms": back_plain_ms,
                **_bound(back_bytes, float(b) * (t - 1))}
        _emit({"phase": "kernel", "kernel": "pyin_viterbi_fwd", "shape_btnw": [b, t, n, w],
               "ties": ties, "pointers_equal": True, "final_scores_equal": True, **fwd})
        _emit({"phase": "kernel", "kernel": "pyin_backtrack", "shape_btnw": [b, t, n, w],
               "ties": ties, "states_equal": True, **back})
        if case == 0:
            summary = {"fwd": fwd, "backtrack": back}
        del log_obs, ptrs, ptrs_p, v_final, v_final_p, states, states_p
    return summary


# K3/K4 against the plain versions.  fp32 sums of up to 64 x 41 products
# (forward), 64 x 11 (dX per phase) and 32 x 4096 (dW) run in another order
# than cuBLAS's inside the plain einsum: the bar is the largest difference
# relative to the largest magnitude of the result
GROUPED_CONV_REL_TOL = 2e-4
# (B, W, cin, cout, k, s, g, pad): the shape classes of tests/test_grouped_conv.py
GROUPED_CONV_SMALL = [
    (2, 64, 8, 8, 5, 1, 4, 2), (2, 64, 8, 16, 5, 2, 4, 2), (2, 64, 16, 16, 9, 4, 4, 4),
    (2, 64, 8, 8, 5, 1, 1, 2), (2, 64, 8, 8, 5, 1, 4, 1), (1, 66, 8, 8, 9, 1, 2, 4),
    (3, 64, 8, 8, 41, 2, 4, 20), (2, 257, 16, 16, 9, 4, 4, 4), (2, 63, 12, 6, 5, 3, 2, 1),
]
MSD_GROUPED_LAYERS = [  # (cin, cout, stride, groups), all k 41 pad 20
    (128, 128, 2, 4), (128, 256, 2, 16), (256, 512, 4, 16), (512, 1024, 4, 16),
    (1024, 1024, 1, 16),
]


def msd_grouped_shapes(batch: int = 32, segment: int = 8192):
    """The 15 grouped-conv calls of one multi-scale discriminator pass on a
    joint real/fake batch: (B, W, cin, cout, k, s, g, pad) per scale and layer."""
    shapes, width = [], segment
    for scale in range(3):
        if scale:
            width = width // 2 + 1  # avg_pool1d(4, 2, padding=2)
        w = width
        for cin, cout, s, g in MSD_GROUPED_LAYERS:
            shapes.append((batch, w, cin, cout, 41, s, g, 20))
            w = (w + 40 - 41) // s + 1
    return shapes


def _chunked(fn, chunk: int = 4):
    """A plain version run in batch chunks, so its unfolded taps fit memory."""
    def run_cat(a, w, *rest):
        return torch.cat([fn(ac, w, *rest) for ac in a.split(chunk)])

    def run_sum(x, dy, *rest):
        return sum(fn(xc, dyc, *rest) for xc, dyc in zip(x.split(chunk), dy.split(chunk)))

    return run_sum if fn.__name__.endswith("dw_plain") else run_cat


def phase_kernel_grouped_conv(device: torch.device, batch: int = 32, segment: int = 8192) -> dict:
    """K3 forward, K3 dX and K4 against their plain versions at the small
    shape classes and at the 15 production shapes, two K4 runs bit for bit,
    the autograd Function against autograd of F.conv1d; returns per kernel
    the worst error and the times summed over the 15 production shapes."""
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import grouped_conv as gk
    from roar_tpu_torch.ops.grouped_conv import grouped_conv1d_cf

    gen = torch.Generator(device=device).manual_seed(SEED)
    names = ("fwd", "dx", "dw")
    summary = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "library_tf32_ms": 0.0, "bytes": 0.0, "operations": 0.0}
               for n in names}
    production = msd_grouped_shapes(batch, segment)
    for case in GROUPED_CONV_SMALL + production:
        b, width, cin, cout, k, s, g, pad = case
        timed = case in production
        wout = gk.out_len(width, k, s, pad)
        x = torch.randn(b, cin, width, device=device, generator=gen)
        w = torch.randn(cout, cin // g, k, device=device, generator=gen) / (k * cin // g) ** 0.5
        dy = torch.randn(b, cout, wout, device=device, generator=gen)
        calls = {
            "fwd": (lambda: gk.grouped_conv_fwd(x, w, s, pad, g),
                    lambda: _chunked(gk.grouped_conv_fwd_plain)(x, w, s, pad, g),
                    lambda: F.conv1d(x, w, stride=s, padding=pad, groups=g)),
            "dx": (lambda: gk.grouped_conv_dx(dy, w, width, s, pad, g),
                   lambda: _chunked(gk.grouped_conv_dx_plain)(dy, w, width, s, pad, g),
                   lambda: torch.nn.grad.conv1d_input(x.shape, w, dy, stride=s, padding=pad,
                                                      groups=g)),
            "dw": (lambda: gk.grouped_conv_dw(x, dy, k, s, pad, g),
                   lambda: _chunked(gk.grouped_conv_dw_plain)(x, dy, k, s, pad, g),
                   lambda: torch.nn.grad.conv1d_weight(x, w.shape, dy, stride=s, padding=pad,
                                                       groups=g)),
        }
        flops = 2.0 * b * cout * (cin // g) * k * wout
        nbytes = {"fwd": 4.0 * (x.numel() + w.numel() + dy.numel()),
                  "dx": 4.0 * (x.numel() + w.numel() + dy.numel()),
                  "dw": 4.0 * (x.numel() + w.numel() + dy.numel())}
        line = {"phase": "kernel", "kernel": "grouped_conv", "shape_bwiokSgp": list(case),
                "rel_tol": GROUPED_CONV_REL_TOL}
        for name in names:
            kernel, plain, library = calls[name]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"grouped_conv_{name} at {case}: shape {tuple(got.shape)} "
                                     f"vs {tuple(want.shape)} or not finite")
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            if rel > GROUPED_CONV_REL_TOL:
                raise AssertionError(f"grouped_conv_{name} at {case}: max abs err {err}, "
                                     f"relative {rel} > {GROUPED_CONV_REL_TOL}")
            lib_out = library()
            lib_rel = float((lib_out - want).abs().max()) / float(want.abs().max())
            if lib_rel > GROUPED_CONV_REL_TOL:
                raise AssertionError(f"library call for {name} at {case} disagrees: {lib_rel}")
            if name == "dw" and not torch.equal(got, kernel()):
                raise AssertionError(f"grouped_conv_dw at {case}: two runs differ")
            acc = summary[name]
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
            acc["max_rel_err"] = max(acc["max_rel_err"], rel)
            line[name] = {"max_abs_err": err, "rel_err": rel}
            del got, want, lib_out
            if timed:
                times = {"ms": _time_ms(kernel, reps=5), "plain_ms": _time_ms(plain, reps=2),
                         "library_ms": _time_ms(library, reps=5)}
                torch.backends.cudnn.allow_tf32 = True
                try:
                    times["library_tf32_ms"] = _time_ms(library, reps=5)
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                bound = _bound(nbytes[name], flops)
                line[name].update(times, **bound)
                for key, value in times.items():
                    acc[key] += value
                acc["bytes"] += bound["bytes"]
                acc["operations"] += bound["operations"]
        if timed:
            line["dw_bit_identical"] = True
        _emit(line)
        del x, w, dy
    torch.cuda.empty_cache()

    # the autograd Function against autograd of the library conv, float32
    for b, width, cin, cout, k, s, g, pad in [(2, 130, 16, 32, 41, 2, 4, 20), (3, 77, 8, 8, 7, 4, 2, 3)]:
        x = torch.randn(b, cin, width, device=device, generator=gen, requires_grad=True)
        w = torch.randn(cout, cin // g, k, device=device, generator=gen, requires_grad=True)
        cot = torch.randn(b, cout, gk.out_len(width, k, s, pad), device=device, generator=gen)
        gx, gw = torch.autograd.grad(grouped_conv1d_cf(x, w, s, pad, g), (x, w), cot)
        rx, rw = torch.autograd.grad(F.conv1d(x, w, stride=s, padding=pad, groups=g), (x, w), cot)
        for name, got, want in (("dx", gx, rx), ("dw", gw, rw)):
            rel = float((got - want).abs().max()) / float(want.abs().max())
            if rel > GROUPED_CONV_REL_TOL:
                raise AssertionError(f"GroupedConv1dCF {name} vs autograd of F.conv1d: {rel}")
    # a pass that needs no weight gradient must not run K4
    before = gk.LAUNCHES_DW
    x = torch.randn(2, 8, 64, device=device, generator=gen, requires_grad=True)
    w = torch.randn(8, 2, 5, device=device, generator=gen)
    grouped_conv1d_cf(x, w, 1, 2, 4).sum().backward()
    if gk.LAUNCHES_DW != before:
        raise AssertionError("K4 ran although the weight needs no gradient")
    for acc in summary.values():
        acc.update({k: v for k, v in _bound(acc["bytes"], acc["operations"]).items()
                    if k.startswith("bound")})
    # a D+G step runs each shape's forward and dX twice (D pass, G pass), dW once
    per_step = {key: 2 * summary["fwd"][key] + 2 * summary["dx"][key] + summary["dw"][key]
                for key in ("ms", "plain_ms", "library_ms", "library_tf32_ms", "bound_ms")}
    _emit({"phase": "kernel", "kernel": "grouped_conv", "step": "sum_over_production_shapes",
           "shapes": len(production), "batch": batch, "segment": segment, **summary,
           "per_train_step": per_step})
    return summary


# one D+G step with the kernels against one with their plain versions, same
# weights and batch, fp32, TF32 off: the sums inside 30 convs run in another
# order, and cuDNN may pick other algorithms for the convs around them
TRAIN_LOSS_RTOL = 1e-4
# per gradient tensor: |delta|_2 over |gradient|_2, and the largest single
# difference over the tensor's largest gradient (one element's rounding after
# some forty layers of forward and backward, so a wider bar).  cuDNN's weight
# gradients sum with atomics, so both vary from run to run: 6e-4 and 3e-3 at
# worst over three runs on an H100; a wrong tap or phase gives errors near 1
TRAIN_GRAD_L2_TOL = 5e-3
TRAIN_GRAD_MAX_TOL = 3e-2
TRAIN_LR = 2e-4
# AdamW's first update moves every weight by lr x sign(gradient): where a
# gradient is at rounding level its sign may differ between the two paths
TRAIN_PARAM_ATOL = 2.5 * TRAIN_LR


class _PlainGroupedConv:
    """While active, the grouped-conv wrappers take their plain versions
    whatever the device (in batch chunks, so the unfolded taps fit memory)."""

    NAMES = ("grouped_conv_fwd", "grouped_conv_dx", "grouped_conv_dw")

    def __enter__(self):
        from roar_tpu_torch.kernels import grouped_conv as gk

        self.saved = {n: getattr(gk, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(gk, n, _chunked(getattr(gk, n + "_plain"), chunk=8))

    def __exit__(self, *exc):
        from roar_tpu_torch.kernels import grouped_conv as gk

        for n, fn in self.saved.items():
            setattr(gk, n, fn)


def phase_train_hifigan(device: torch.device, card: str = "", n_utterances: int = 64,
                        steps: int = 8, batch_size: int = 16, n_segments: int = 8192,
                        debug: bool = False) -> dict:
    """HiFi-GAN training through the CLI's `run`; returns the grouped-conv
    launch counts of that run."""
    import copy

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "tts"))
    import hifigan_torch as cli

    from roar_tpu_torch.data.audio import write_wav
    from roar_tpu_torch.data.manifest import write_manifest
    from roar_tpu_torch.kernels import grouped_conv as gk
    from roar_tpu_torch.models.hifigan import SpectralNormConv
    from roar_tpu_torch.models.hifigan_model import HifiGanModel, vocoder_from_config
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
    from roar_tpu_torch.training.optim import build_optimizer, get_schedule
    from roar_tpu_torch.training.save_restore import restore_from

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 1)
    benchmark_was = torch.backends.cudnn.benchmark
    # training meets dozens of new conv shapes: no autotuning of each
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            entries = []
            for i in range(n_utterances):
                audio = synth_utterance(rng, float(rng.uniform(1.0, 2.0)))[0]
                path = os.path.join(tmp, f"utt{i:03d}.wav")
                write_wav(path, audio, SUP_SAMPLE_RATE)
                entries.append({"audio_filepath": path, "duration": len(audio) / SUP_SAMPLE_RATE})
            manifest = os.path.join(tmp, "train_manifest.json")
            write_manifest(manifest, entries)
            cfg = hifigan_train_config(manifest, os.path.join(tmp, "exp"), str(device), steps,
                                       batch_size, n_segments, debug)

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            gk.LAUNCHES_FWD = gk.LAUNCHES_DX = gk.LAUNCHES_DW = 0
            t0 = time.perf_counter()
            state = cli.run(cfg)
            sync()
            wall = time.perf_counter() - t0
            launches = {"fwd": gk.LAUNCHES_FWD, "dx": gk.LAUNCHES_DX, "dw": gk.LAUNCHES_DW}
            peak = torch.cuda.max_memory_allocated() if on_card else None
            model = state.model

            n_grouped = sum(1 for m in model.msd.modules() if getattr(m, "groups", 1) > 1)
            want = {"fwd": 2 * n_grouped * steps, "dx": 2 * n_grouped * steps,
                    "dw": n_grouped * steps}
            if n_grouped != 15 or state.step != steps:
                raise AssertionError(f"{n_grouped} grouped convs, {state.step} steps")
            if on_card and launches != want:
                raise AssertionError(f"grouped-conv launches {launches} != {want}: K4 ran in the "
                                     f"G pass, or a grouped conv went round its kernel")

            root = os.path.join(tmp, "exp", "HifiGan")
            with open(os.path.join(root, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f if line.strip()]
            if [r["step"] for r in records] != list(range(1, steps + 1)):
                raise AssertionError(f"logged steps {[r['step'] for r in records]}")
            for r in records:
                bad = [k for k in ("d_loss", "g_loss", "d_loss_mpd", "d_loss_msd", "g_mel_loss",
                                   "g_fm_loss", "g_adv_loss") if not np.isfinite(r[k])]
                if bad:
                    raise AssertionError(f"step {r['step']}: {bad} not finite")
            sched = cfg["model"]["optim"]["sched"]
            schedule = get_schedule(sched["name"], cfg["model"]["optim"]["lr"],
                                    max_steps=cfg["model"]["max_steps"], min_lr=sched["min_lr"],
                                    warmup_ratio=sched["warmup_ratio"])
            lrs = [r["lr"] for r in records]
            if not np.allclose(lrs, [schedule(i) for i in range(steps)], rtol=1e-9, atol=0.0):
                raise AssertionError(f"learning rates {lrs} are not the schedule's")

            # the spectral norm of scale 0 stored a new u and sigma
            fresh = HifiGanModel(cfg["model"], generator=torch.Generator().manual_seed(0))
            moved = []
            for (name, m), (_, m0) in zip(model.msd.named_modules(), fresh.msd.named_modules()):
                if isinstance(m, SpectralNormConv):
                    moved.append(not torch.equal(m.u.cpu(), m0.u) and float(m.sigma) != 1.0
                                 and bool(torch.isfinite(m.u).all()))
            if len(moved) != 8 or not all(moved):
                raise AssertionError(f"spectral-norm stats of scale 0 not updated: {moved}")
            _emit({"phase": "train_hifigan", "step": "cli", "card": card, "steps": steps,
                   "batch": batch_size, "segment": n_segments, "utterances": n_utterances,
                   "grouped_conv_launches": launches, "per_step": {k: v // steps for k, v in
                                                                   launches.items()},
                   "losses_first": {k: records[0][k] for k in ("d_loss", "g_loss", "g_mel_loss")},
                   "losses_last": {k: records[-1][k] for k in ("d_loss", "g_loss", "g_mel_loss")},
                   "lr": lrs, "spectral_norm_convs_updated": len(moved), "wall_s": wall,
                   "wall_includes": "model build, WAV reads, logging every step, checkpoint "
                                    "and bundle writes",
                   "peak_device_memory_bytes": peak})

            # the bundle: restored, folded, one mel through it
            path = os.path.join(root, "checkpoints", "HifiGan.roar")
            _, tree = restore_from(path)
            trainable = HifiGanModel(cfg["model"]).generator
            convert.load_generator_train_params(trainable, tree["g_params"])
            folded = trainable.fold_weight_norm().to(device)
            served = convert.load_generator_params(vocoder_from_config(cfg["model"]),
                                                   tree["g_params"]).to(device)
            mel = torch.from_numpy(rng.standard_normal((1, 64, 80)).astype(np.float32)).to(device)
            with torch.no_grad():
                audio = folded(mel)
                if not torch.equal(audio, served(mel)):
                    raise AssertionError("folded generator != the bundle loaded for serving")
                trained_audio = model.generator(mel)
            if tuple(audio.shape) != (1, 64 * 256) or not torch.isfinite(audio).all():
                raise AssertionError(f"vocoder output {tuple(audio.shape)} or not finite")
            fold_err = float((audio - trained_audio).abs().max())
            if fold_err > 1e-4:
                raise AssertionError(f"folded generator differs from the trained one: {fold_err}")
            _emit({"phase": "train_hifigan", "step": "bundle", "bundle_bytes": os.path.getsize(path),
                   "audio_shape": list(audio.shape), "folded_vs_trained_max_abs": fold_err,
                   "folded_equals_serving_load": True})

            # one D+G step, kernels against plain versions, same weights and batch
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(iter(_batches(cfg))).items()}
            optim_cfg = {"name": "adamw", "lr": TRAIN_LR, "betas": [0.8, 0.99]}

            def one_step(m):
                st = GANTrainState(model=m,
                                   g_opt=build_optimizer(m.g_parameters(), optim_cfg),
                                   d_opt=build_optimizer(m.d_parameters(), optim_cfg))
                _, metrics = gan_train_step(st, batch)
                sync()
                return {k: float(v) for k, v in metrics.items()}

            twin = copy.deepcopy(model)
            metrics_k = one_step(model)
            with _PlainGroupedConv():
                metrics_p = one_step(twin)
            worst = {"grad_l2": 0.0, "grad_max": 0.0, "param_abs": 0.0, "tensor": ""}
            for k in ("d_loss", "g_loss"):
                if abs(metrics_k[k] - metrics_p[k]) > TRAIN_LOSS_RTOL * abs(metrics_p[k]):
                    raise AssertionError(f"{k}: kernels {metrics_k[k]} vs plain {metrics_p[k]}")
            for part in ("generator", "mpd", "msd"):
                for (name, pk), (_, pp) in zip(getattr(model, part).named_parameters(),
                                                getattr(twin, part).named_parameters()):
                    delta = pk.grad - pp.grad
                    l2 = float(delta.norm()) / max(float(pp.grad.norm()), 1e-30)
                    top = float(delta.abs().max()) / max(float(pp.grad.abs().max()), 1e-30)
                    if top > worst["grad_max"]:
                        worst["tensor"] = f"{part}.{name}"
                    worst["grad_l2"] = max(worst["grad_l2"], l2)
                    worst["grad_max"] = max(worst["grad_max"], top)
                    worst["param_abs"] = max(worst["param_abs"],
                                             float((pk.detach() - pp.detach()).abs().max()))
                    if l2 > TRAIN_GRAD_L2_TOL or top > TRAIN_GRAD_MAX_TOL:
                        raise AssertionError(
                            f"{part}.{name}: gradient differs between kernel path and plain "
                            f"path by {l2} (L2, relative) and {top} (largest, relative)")
            if worst["param_abs"] > TRAIN_PARAM_ATOL:
                raise AssertionError(f"updated parameters differ by {worst['param_abs']}")
            _emit({"phase": "train_hifigan", "step": "kernel_path_vs_plain_path",
                   "kernels": metrics_k, "plain": metrics_p, "loss_rtol": TRAIN_LOSS_RTOL,
                   "max_grad_l2_rel_err": worst["grad_l2"], "grad_l2_tol": TRAIN_GRAD_L2_TOL,
                   "max_grad_max_rel_err": worst["grad_max"], "grad_max_tol": TRAIN_GRAD_MAX_TOL,
                   "worst_gradient_tensor": worst["tensor"],
                   "max_param_abs_diff": worst["param_abs"], "param_atol": TRAIN_PARAM_ATOL})
            del twin

            result = {"launches": launches}
            if on_card:
                result["timing"] = _time_train_step(model, batch, optim_cfg, card)
            return result
    finally:
        torch.backends.cudnn.benchmark = benchmark_was


def _batches(cfg: dict):
    """Collated training batches of `cfg`, as the runner reads them."""
    from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
    from roar_tpu_torch.training.run import batch_iterator, build_vocoder_dataset

    dataset = build_vocoder_dataset(cfg["model"]["train_ds"]["dataset"])
    params = cfg["model"]["train_ds"]["dataloader_params"]
    sampler = LengthBucketBatchSampler(dataset.lengths, batch_size=params["batch_size"],
                                       shuffle=False, drop_last=True)
    return batch_iterator(dataset, sampler)


def _time_train_step(model, batch, optim_cfg: dict, card: str) -> dict:
    """Step time (median of 5 after two warm steps, CUDA events), its split
    by the parts `gan_train_step` marks, and the grouped-conv kernels' time
    inside a step (events around every launch, in two further steps)."""
    from roar_tpu_torch.kernels import grouped_conv as gk
    from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
    from roar_tpu_torch.training.optim import build_optimizer

    state = GANTrainState(model=model, g_opt=build_optimizer(model.g_parameters(), optim_cfg),
                          d_opt=build_optimizer(model.d_parameters(), optim_cfg))
    parts = ("generator_forward", "d_pass", "d_optimizer", "g_pass", "g_optimizer")
    totals, splits = [], {p: [] for p in parts}
    torch.cuda.reset_peak_memory_stats()
    for i in range(7):
        events = {"start": torch.cuda.Event(enable_timing=True)}
        events["start"].record()

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        gan_train_step(state, batch, mark=mark)
        torch.cuda.synchronize()
        if i < 2:
            continue
        totals.append(events["start"].elapsed_time(events["g_optimizer"]))
        for before, name in zip(("start",) + parts, parts):
            splits[name].append(events[before].elapsed_time(events[name]))
    peak = torch.cuda.max_memory_allocated()

    spans = {"grouped_conv_fwd": [], "grouped_conv_dx": [], "grouped_conv_dw": []}
    saved = {n: getattr(gk, n) for n in spans}

    def timed(name):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved[name](*args)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    n_steps = 2
    try:
        for n in spans:
            setattr(gk, n, timed(n))
        for _ in range(n_steps):
            gan_train_step(state, batch)
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(gk, n, fn)
    kernel_ms = {n: sum(a.elapsed_time(b) for a, b in pairs) / n_steps
                 for n, pairs in spans.items()}
    step_ms = float(np.median(totals))
    timing = {"phase": "train_hifigan", "step": "timing", "card": card,
              "step_ms": step_ms, "step_ms_all": totals,
              "split_ms": {p: float(np.median(v)) for p, v in splits.items()},
              "grouped_conv_ms_per_step": kernel_ms,
              "grouped_conv_launches_per_step": {n: len(v) // n_steps for n, v in spans.items()},
              "grouped_conv_share_of_step": sum(kernel_ms.values()) / step_ms,
              "peak_device_memory_bytes": peak,
              "method": "CUDA events; median of 5 steps after 2 warm steps; cudnn.benchmark off, "
                        "TF32 off; batch already on the card"}
    _emit(timing)
    return timing


# K5-bwd against the plain versions: fp32 FMA sums inside the kernels against
# cuBLAS fp32 einsums over up to 864 keys, so each gradient is held to an
# absolute error of 1e-4 of its own largest magnitude plus rtol 1e-3 (the
# forward's KERNEL_TOL, made relative to the gradient's scale)
FLASH_BWD_ATOL_REL = 1e-4
FLASH_BWD_RTOL = 1e-3
# (B, T, H, D, key lengths): T no multiple of 64, all-valid rows, a row that is
# mostly padding, a single valid key, D = 32 / 128 / 64
FLASH_BWD_SMALL = [
    (3, 70, 2, 32, [70, 33, 1]), (2, 130, 2, 128, [130, 9]), (4, 200, 1, 64, [200, 200, 63, 5]),
]
# the text and mel buckets of 20 s utterances at batch 32: longer than any
# batch phase `train_fastpitch` draws from its 2 to 10 s corpus, so they stand
# beside the path's own shapes (which that phase holds and times) and are
# labelled so
FLASH_LONG_SHAPES = [(32, 160, 1, 64), (32, 864, 1, 64)]


def _assert_grad_close(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or not finite")
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=FLASH_BWD_ATOL_REL * top, rtol=FLASH_BWD_RTOL,
                               msg=lambda m: f"{what}: {m}")
    return {"max_abs_err": err, "rel_to_largest": err / max(top, 1e-30)}


def _flash_bwd_case(gen: torch.Generator, key_mask: torch.Tensor, h: int, d: int, timed: bool,
                    where: str) -> dict:
    """The forward with its log-sum-exp and the two backward kernels against
    the plain versions on seeded q, k, v and cotangent under `key_mask`
    [B, T]; with `timed`, also the times beside the bounds and SDPA.  Emits
    one line and returns its errors, times and bounds."""
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.ops.flash_attention import flash_self_attention

    device = key_mask.device
    (b, t), lens = key_mask.shape, [int(n) for n in key_mask.sum(1)]
    shape = (b, t, h, d)
    q, k, v, do = (torch.randn(b, t, h, d, device=device, generator=gen) for _ in range(4))
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True)
    if not torch.equal(out, fa.flash_self_attention(q, k, v, key_mask, scale)):
        raise AssertionError(f"asking for lse changed the forward's output at {shape}")
    out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, return_lse=True)
    torch.testing.assert_close(out, out_p, **KERNEL_TOL)
    torch.testing.assert_close(lse, lse_p, **KERNEL_TOL)
    errs = {"o": {"max_abs_err": float((out - out_p).abs().max())},
            "lse": {"max_abs_err": float((lse - lse_p).abs().max())}}
    # the cotangent holds garbage on the pad rows too: a pad query's
    # gradient must stay inside the pad segment
    got = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    again = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do)
    want = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, out_p, lse_p, do)
    torch.cuda.synchronize()
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, a2):
            raise AssertionError(f"flash bwd {name} at {shape}: two runs differ")
        errs[name] = _assert_grad_close(a, w, f"flash bwd {name} at {shape}")
    # a cotangent that is zero on the pad rows (what TransformerLayer's
    # mask makes it) leaves the pad keys' gradients exactly zero
    do_valid = do * key_mask[:, :, None, None]
    _, dk0, dv0 = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do_valid)
    pad_rows = ~key_mask[:, :, None, None].expand_as(dk0)
    if pad_rows.any() and (float(dk0[pad_rows].abs().max()) != 0.0
                           or float(dv0[pad_rows].abs().max()) != 0.0):
        raise AssertionError(f"pad keys got a gradient at {shape}")
    # the autograd Function against autograd of the plain forward
    qkv = [z.clone().requires_grad_(True) for z in (q, k, v)]
    g_fn = torch.autograd.grad(flash_self_attention(*qkv, key_mask, scale), qkv, do)
    g_plain = torch.autograd.grad(fa.flash_self_attention_plain(*qkv, key_mask, scale), qkv, do)
    for name, a, w in zip(("dq", "dk", "dv"), g_fn, g_plain):
        _assert_grad_close(a, w, f"Function {name} vs autograd of the plain forward")
    line = {"phase": "kernel_flash_bwd", "where": where, "shape_bthd": list(shape),
            "key_lens": lens if b <= 4 else {"min": min(lens), "max": max(lens),
                                             "mean": float(np.mean(lens))},
            "errors": errs, "tol": KERNEL_TOL,
            "atol_rel_to_largest": FLASH_BWD_ATOL_REL, "rtol": FLASH_BWD_RTOL,
            "bit_identical_across_two_runs": True, "forward_unchanged_by_lse": True,
            "function_vs_autograd_of_plain": True}
    case = {"errors": errs}
    if timed:
        delta = (out * do).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, key_mask, scale, out, lse, do)
        # the one PyTorch call that computes the same function: SDPA with
        # the segment mask and its autograd (a yardstick only; the port
        # never calls it); its backward gives dq, dk and dv together
        qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_(True) for z in (q, k, v))
        visible = (key_mask[:, None, :, None] == key_mask[:, None, None, :])
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible, scale=scale)
        lib_do = do.transpose(1, 2)
        lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)
        for name, a, w in zip(("dq", "dk", "dv"), lib_grads, want):
            _assert_grad_close(a.transpose(1, 2), w, f"SDPA autograd {name}")

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible, scale=scale)

        times = {
            "dkv_ms": _time_ms(lambda: fa.flash_self_attention_bwd(
                *args, need_dq=False, delta=delta)),
            "dq_ms": _time_ms(lambda: fa.flash_self_attention_bwd(
                *args, need_dkv=False, delta=delta)),
            "delta_ms": _time_ms(lambda: (out * do).sum(-1).permute(0, 2, 1).contiguous()),
            # delta, dkv and dq as a training step's backward calls them
            "backward_ms": _time_ms(lambda: fa.flash_self_attention_bwd(*args)),
            # the plain backward gives all three gradients at once
            "backward_plain_ms": _time_ms(lambda: fa.flash_self_attention_bwd_plain(
                q, k, v, key_mask, scale, out_p, lse_p, do), reps=5),
            "backward_library_ms": _time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), lib_do, retain_graph=True)),
            "fwd_ms": _time_ms(lambda: fa.flash_self_attention(q, k, v, key_mask, scale)),
            "fwd_with_lse_ms": _time_ms(lambda: fa.flash_self_attention(
                q, k, v, key_mask, scale, return_lse=True)),
            "fwd_plain_ms": _time_ms(lambda: fa.flash_self_attention_plain(
                q, k, v, key_mask, scale, return_lse=True), reps=5),
            "fwd_library_ms": _time_ms(lib_fwd),
        }
        # what this data needs: a query sees the keys of its segment, so
        # len^2 + (T - len)^2 pairs per row.  The backward as a function is
        # five products (10 operations per pair and head-dim element); of
        # them dkv does q.k^T, dO.v^T, p^T dO and dS^T q (8) and dq does
        # q.k^T, dO.v^T and dS k (6), so the split does seven products for
        # five.  The forward is two (4).  Bytes: q, k, v, (o,) dO read, the
        # results written, seg / lse / delta rows.
        pairs = float(sum(n * n + (t - n) * (t - n) for n in lens))
        elems, rows = float(b * t * h * d), float(b * h * t)
        bounds = {"backward": _bound(4.0 * (8 * elems + 2 * rows), 10.0 * pairs * h * d),
                  "dkv_own_work": _bound(4.0 * (6 * elems + 3 * rows), 8.0 * pairs * h * d),
                  "dq_own_work": _bound(4.0 * (5 * elems + 3 * rows), 6.0 * pairs * h * d),
                  "fwd_with_lse": _bound(4.0 * (4 * elems + 2 * rows), 4.0 * pairs * h * d)}
        line.update(times, bounds=bounds,
                    backward_share_of_fp32_peak=(bounds["backward"]["bound_ms"]
                                                 / times["backward_ms"]),
                    library_call="F.scaled_dot_product_attention(attn_mask=segment mask) and "
                                 "its autograd: dq, dk, dv together")
        case.update(times=times, bounds=bounds)
    _emit(line)
    return case


def phase_kernel_flash_bwd(device: torch.device) -> dict:
    """K5-bwd (dK/dV kernel, dQ kernel) and the forward's log-sum-exp against
    the plain versions at small ragged shapes and at two shapes longer than
    the training phase's own; returns the worst error per result."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    cases = [(*case, False, "small ragged shape") for case in FLASH_BWD_SMALL]
    for b, t, h, d in FLASH_LONG_SHAPES:
        lens = rng.integers(int(0.4 * t), t + 1, b)
        lens[0] = t  # one utterance fills the bucket
        cases.append((b, t, h, d, [int(n) for n in lens], True,
                      "batch 32 of utterances up to 20 s; not on the path of train_fastpitch"))
    worst = {}
    for b, t, h, d, lens, timed, where in cases:
        key_mask = (torch.arange(t, device=device)[None, :]
                    < torch.tensor(lens, device=device)[:, None])
        case = _flash_bwd_case(gen, key_mask, h, d, timed, where)
        for name, e in case["errors"].items():
            worst[name] = max(worst.get(name, 0.0), e["max_abs_err"])
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


class _PlainFlash:
    """While active, the flash-attention wrappers take their plain versions
    whatever the device."""

    def __enter__(self):
        from roar_tpu_torch.kernels import flash_attention as fa

        self.saved = (fa.flash_self_attention, fa.flash_self_attention_bwd)

        def bwd(q, k, v, key_mask, scale, o, lse, do, need_dq=True, need_dkv=True, delta=None):
            return fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do)

        fa.flash_self_attention, fa.flash_self_attention_bwd = fa.flash_self_attention_plain, bwd

    def __exit__(self, *exc):
        from roar_tpu_torch.kernels import flash_attention as fa

        fa.flash_self_attention, fa.flash_self_attention_bwd = self.saved


# one FastPitch step with the kernels against one with their plain versions,
# same weights, batch and dropout masks, fp32, TF32 off: the attention sums run
# in another order through 12 layers forward and backward, and the backwards of
# `F.ctc_loss`, of the embedding and of the gathers in length regulation add
# with atomics, so two runs of ONE path differ too.  Held: the whole gradient
# (|delta|_2 over |gradient|_2 across all tensors) and every tensor on its own.
# A small tensor's gradient is a sum that nearly cancels (a conditional
# LayerNorm projection read 1.3e-4 to 1.6e-3 over three runs on an H100), so
# the per-tensor bar is wider; a wrong tile or mask gives errors near 1
FP_TRAIN_LOSS_RTOL = 1e-4
FP_TRAIN_GRAD_L2_TOL = 1e-3
FP_TRAIN_TENSOR_L2_TOL = 2e-2
FP_LOSS_TERMS = ("loss", "mel_loss", "dur_loss", "pitch_loss", "energy_loss", "ctc_loss",
                 "bin_loss")


def _narrow_fastpitch(cfg: dict) -> None:
    """Shrink a FastPitch training config to a rehearsal width, in place."""
    model = cfg["model"]
    model["symbols_embedding_dim"] = 32
    for fft in ("input_fft", "output_fft"):
        model[fft].update(n_layer=2, d_model=32, d_head=16, n_head=2, d_inner=48)
    model["input_fft"]["d_embed"] = 32
    for predictor in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        model[predictor].update(input_size=32, filter_size=16)
    model["alignment_module"]["n_text_channels"] = 32
    model["speaker_encoder"]["lookup_module"]["embedding_dim"] = 32


def _fastpitch_batch(cfg: dict, tokenizer, device: torch.device) -> dict:
    """The collated training batch of `cfg` that holds the longest utterances
    (the largest buckets a step meets), on `device`."""
    from roar_tpu_torch.data.dataset import BucketSpec
    from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
    from roar_tpu_torch.training.run import batch_iterator, build_tts_dataset
    from roar_tpu_torch.training.trainer import to_device

    dataset = build_tts_dataset(cfg["model"]["train_ds"]["dataset"], tokenizer, device)
    batch_size = cfg["model"]["train_ds"]["dataloader_params"]["batch_size"]
    sampler = LengthBucketBatchSampler(dataset.lengths, batch_size=batch_size, shuffle=False,
                                       drop_last=True)
    longest = max(sampler, key=lambda idxs: max(dataset.lengths[i] for i in idxs))
    return to_device(next(iter(batch_iterator(dataset, [longest], BucketSpec()))), device)


def phase_train_fastpitch(device: torch.device, card: str = "", n_utterances: int = 128,
                          steps: int = 8, batch_size: int = 32, max_seconds: float = 10.0,
                          narrow: bool = False) -> dict:
    """FastPitch training with learned alignment: sup-data extraction, then
    the training CLI's `run`; returns the flash-attention launch counts of
    that run."""
    import copy

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "examples", "tts"))
    sys.path.insert(0, os.path.join(here, "scripts", "dataset_processing", "tts"))
    import extract_sup_data_torch as sup_cli
    import fastpitch_torch as cli

    from roar_tpu_torch.data.audio import write_wav
    from roar_tpu_torch.data.manifest import write_manifest
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel, make_tokenizer
    from roar_tpu_torch.models.hifigan_model import vocoder_from_config
    from roar_tpu_torch.serving import SynthesisEngine
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.optim import noam_annealing
    from roar_tpu_torch.training.save_restore import restore_from

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 2)
    tokenizer = make_tokenizer(fastpitch_config()["text_tokenizer"])
    n_tokens = [len(tokenizer(s)) for s in TAMIL_SENTENCES]
    benchmark_was = torch.backends.cudnn.benchmark
    # training meets a new conv shape per bucket: no autotuning of each (the
    # workspaces cuDNN tries would also count as this phase's peak memory)
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav_dir = os.path.join(tmp, "wavs")
            os.makedirs(wav_dir)
            seconds = rng.uniform(min(2.0, max_seconds / 2), max_seconds, n_utterances)
            seconds[0] = max_seconds
            entries = []
            for i, sec in enumerate(seconds):
                audio = synth_utterance(rng, float(sec))[0]
                frames = len(audio) // 512 + 1
                # a text its mel can hold: at least two frames per token
                fits = [j for j, n in enumerate(n_tokens) if 2 * n <= frames]
                if not fits:
                    raise AssertionError(f"no sentence fits {frames} mel frames")
                path = os.path.join(wav_dir, f"utt{i:03d}.wav")
                write_wav(path, audio, SUP_SAMPLE_RATE)
                entries.append({"audio_filepath": path, "duration": len(audio) / SUP_SAMPLE_RATE,
                                "text": TAMIL_SENTENCES[fits[int(rng.integers(len(fits)))]],
                                "speaker_id": i % 4})
            manifest = os.path.join(tmp, "train_manifest.json")
            val_manifest = os.path.join(tmp, "val_manifest.json")
            write_manifest(manifest, entries)
            write_manifest(val_manifest, entries[:batch_size])

            # stage 1 feeds stage 2: pitch, energy and the prior's lengths come from this cache
            sup_dir = os.path.join(tmp, "sup")
            stats = sup_cli.run(sup_data_config(manifest, sup_dir, str(device)))
            cfg = fastpitch_train_config(
                manifest, val_manifest, sup_dir, os.path.join(tmp, "exp"), stats["pitch_mean"],
                stats["pitch_std"], str(device), steps, batch_size)
            if narrow:
                _narrow_fastpitch(cfg)
            steps_per_epoch = n_utterances // batch_size
            # an epoch that ends before the last step is followed by validation
            val_epochs = -(-steps // steps_per_epoch) - 1
            val_batches = val_epochs * (min(batch_size, len(entries)) // batch_size)

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            fa.LAUNCHES = fa.LAUNCHES_BWD_DKV = fa.LAUNCHES_BWD_DQ = 0
            t0 = time.perf_counter()
            state = cli.run(cfg)
            sync()
            wall = time.perf_counter() - t0
            launches = {"fwd": fa.LAUNCHES, "dkv": fa.LAUNCHES_BWD_DKV, "dq": fa.LAUNCHES_BWD_DQ}
            peak = torch.cuda.max_memory_allocated() if on_card else None
            model = state.model
            module = model.module
            n_attn = len(module.encoder_module.stack.layers) + len(module.decoder_module.layers)
            want = {"fwd": n_attn * (steps + val_batches), "dkv": n_attn * steps,
                    "dq": n_attn * steps}
            if state.step != steps or n_attn != (4 if narrow else 12):
                raise AssertionError(f"{state.step} steps, {n_attn} attention layers")
            if model.attention_paths() != {"input_fft": "flash", "output_fft": "flash"}:
                raise AssertionError(f"attention paths {model.attention_paths()}")
            if on_card and launches != want:
                raise AssertionError(f"flash launches {launches} != {want}: an attention layer "
                                     f"went round its kernel, or validation ran a backward")

            root = os.path.join(tmp, "exp", "FastPitch")
            with open(os.path.join(root, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f if line.strip()]
            train = [r for r in records if "mel_loss" in r]
            val = [r for r in records if "val_mel_loss" in r]
            if [r["step"] for r in train] != list(range(1, steps + 1)):
                raise AssertionError(f"logged steps {[r['step'] for r in train]}")
            for r in train:
                bad = [k for k in FP_LOSS_TERMS + ("grad_norm",)
                       if not np.isfinite(r.get(k, np.nan))]
                if bad:
                    raise AssertionError(f"step {r['step']}: {bad} missing or not finite")
            if any(r["bin_loss"] != 0.0 for r in train[:steps_per_epoch]):
                raise AssertionError("bin_loss carries weight in epoch 0")
            if len(val) != (1 if val_batches else 0) or not all(
                    np.isfinite(r[f"val_{k}"]) for r in val for k in FP_LOSS_TERMS):
                raise AssertionError(f"validation records {val}")
            sched = cfg["model"]["optim"]["sched"]
            schedule = noam_annealing(cfg["model"]["optim"]["lr"], d_model=sched["d_model"],
                                      warmup_steps=sched["warmup_steps"])
            lrs = [r["lr"] for r in train]
            if not np.allclose(lrs, [schedule(i) for i in range(steps)], rtol=1e-9, atol=0.0):
                raise AssertionError(f"learning rates {lrs} are not the schedule's")
            _emit({"phase": "train_fastpitch", "step": "cli", "card": card, "steps": steps,
                   "batch": batch_size, "utterances": n_utterances,
                   "seconds_of_audio": float(seconds.sum()),
                   "sup_data": {k: stats[k] for k in ("pitch_mean", "pitch_std", "mel_frames",
                                                      "seconds")},
                   "flash_launches": launches, "attention_layers": n_attn,
                   "per_step": {k: launches[k] // steps for k in ("dkv", "dq")},
                   "validation_batches": val_batches,
                   "losses_first": {k: train[0][k] for k in FP_LOSS_TERMS},
                   "losses_last": {k: train[-1][k] for k in FP_LOSS_TERMS},
                   "val": {k: v for r in val for k, v in r.items() if k.startswith("val_")},
                   "grad_norm": [r["grad_norm"] for r in train], "lr": lrs, "wall_s": wall,
                   "wall_includes": "model build, WAV reads, cache reads, logging every step "
                                    "(a sync each), one validation batch, checkpoints, bundle",
                   "peak_device_memory_bytes": peak})

            # one step, kernels against plain versions: same weights, batch and dropout masks
            batch = _fastpitch_batch(cfg, model.tokenizer, device)
            epoch = 50  # half of the bin-loss warm-up: every term carries weight

            def one_step(m):
                m.set_dropout_generator(torch.Generator(device=device).manual_seed(7))
                m.module.train()
                m.module.zero_grad(set_to_none=True)
                seen = {}
                hook = m.module.register_forward_hook(
                    lambda mod, args, out: seen.update(durs=out["attn_hard_dur"]))
                try:
                    loss, metrics = m.loss_fn(batch, epoch)
                finally:
                    hook.remove()
                loss.backward()
                sync()
                return {k: float(v) for k, v in metrics.items()}, seen["durs"]

            twin = copy.deepcopy(model)
            before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
            # what this step hands the attention kernels: shape -> key mask
            given, forward = {}, fa.flash_self_attention

            def noting(q, k, v, key_mask, scale, **kwargs):
                given.setdefault(tuple(q.shape), key_mask)
                return forward(q, k, v, key_mask, scale, **kwargs)

            fa.flash_self_attention = noting
            try:
                metrics_k, durs_k = one_step(model)
            finally:
                fa.flash_self_attention = forward
            step_launches = tuple(b - a for a, b in zip(
                before, (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)))
            if on_card and step_launches != (n_attn, n_attn, n_attn):
                raise AssertionError(f"one step launched {step_launches}, not {n_attn} of each")
            with _PlainFlash():
                metrics_p, durs_p = one_step(twin)
            for k in FP_LOSS_TERMS:
                if abs(metrics_k[k] - metrics_p[k]) > FP_TRAIN_LOSS_RTOL * abs(metrics_p[k]):
                    raise AssertionError(f"{k}: kernels {metrics_k[k]} vs plain {metrics_p[k]}")
            if not torch.equal(durs_k, durs_p):
                raise AssertionError("hard alignments differ between the kernel and plain paths")
            if not torch.equal(durs_k.sum(1).long(), batch["mel_len"].long()):
                raise AssertionError(f"hard durations sum to {durs_k.sum(1).tolist()}, mel lengths "
                                     f"are {batch['mel_len'].tolist()}")
            worst = {"grad_l2": 0.0, "tensor": ""}
            delta_sq = total_sq = 0.0
            for (name, pk), (_, pp) in zip(model.module.named_parameters(),
                                            twin.module.named_parameters()):
                delta, norm = float((pk.grad - pp.grad).norm()), float(pp.grad.norm())
                delta_sq, total_sq = delta_sq + delta ** 2, total_sq + norm ** 2
                l2 = delta / max(norm, 1e-30)
                if l2 > worst["grad_l2"]:
                    worst = {"grad_l2": l2, "tensor": name}
                if l2 > FP_TRAIN_TENSOR_L2_TOL:
                    raise AssertionError(f"{name}: gradient differs between kernel path and plain "
                                         f"path by {l2} (L2, relative)")
            whole_l2 = (delta_sq / max(total_sq, 1e-60)) ** 0.5
            if whole_l2 > FP_TRAIN_GRAD_L2_TOL:
                raise AssertionError(f"the whole gradient differs between kernel path and plain "
                                     f"path by {whole_l2} (L2, relative)")
            _emit({"phase": "train_fastpitch", "step": "kernel_path_vs_plain_path", "epoch": epoch,
                   "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
                   "kernels": metrics_k, "plain": metrics_p, "loss_rtol": FP_TRAIN_LOSS_RTOL,
                   "whole_grad_l2_rel_err": whole_l2, "grad_l2_tol": FP_TRAIN_GRAD_L2_TOL,
                   "max_grad_l2_rel_err": worst["grad_l2"],
                   "tensor_l2_tol": FP_TRAIN_TENSOR_L2_TOL,
                   "worst_gradient_tensor": worst["tensor"], "hard_durations_equal": True,
                   "hard_durations_sum_to_mel_lens": True})
            del twin

            # the attention kernels against their plain versions at the shapes
            # and key lengths that step gave them: the encoder's (text bucket)
            # and the decoder's (mel bucket)
            if on_card:
                if len(given) != 2 or any(m is None for m in given.values()):
                    raise AssertionError(f"the step gave its attention {list(given)}")
                gen = torch.Generator(device=device).manual_seed(SEED)
                flash = {}
                for (_, t, h, d), key_mask in sorted(given.items()):
                    flash[t] = _flash_bwd_case(
                        gen, key_mask, h, d, True,
                        "the longest batch of train_fastpitch, its own key lengths")

            # the bundle: read back, loaded and served by the engine
            path = os.path.join(root, "checkpoints", "FastPitch.roar")
            bundle_cfg, tree = restore_from(path)
            # eight steps teach no durations (most tokens get 0 frames): a floor
            # of one frame per token gives the vocoder something to render
            bundle_cfg["model"]["min_token_duration"] = 1
            served = FastPitchModel(bundle_cfg["model"])
            convert.load_fastpitch_params(served.module, tree)
            for (name, a), (_, b) in zip(served.module.state_dict().items(),
                                         state.model.module.state_dict().items()):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"bundle parameter {name} is not the trained one")
            hg_cfg = hifigan_config()
            if narrow:
                hg_cfg["generator"]["upsample_initial_channel"] = 16
            vocoder = vocoder_from_config(hg_cfg)
            seed_weights(vocoder, np.random.default_rng(SEED))
            engine = SynthesisEngine(served, vocoder, device=device)
            try:
                sentence = TAMIL_SENTENCES[1]
                tokens = torch.from_numpy(served.parse(sentence)).long().to(device)
                mel, n_frames = served.generate_spectrogram(
                    tokens, torch.tensor([1], device=device), max_mel_len=1024)
                (wave,) = engine.synthesize_batch([sentence], [1])
            finally:
                engine.close()
            if tuple(mel.shape) != (1, 1024, 80) or not torch.isfinite(mel).all():
                raise AssertionError(f"mel of the trained bundle: {tuple(mel.shape)} or not finite")
            if wave.dtype != np.int16 or wave.size != int(n_frames[0]) * engine.hop \
                    or wave.size == 0:
                raise AssertionError(f"served audio: {wave.dtype}, {wave.size} samples for "
                                     f"{int(n_frames[0])} mel frames")
            _emit({"phase": "train_fastpitch", "step": "bundle",
                   "bundle_bytes": os.path.getsize(path),
                   "parameters_equal_trained": True, "mel_shape": list(mel.shape),
                   "mel_frames": int(n_frames[0]), "served_samples": int(wave.size)})

            result = {"launches": launches}
            if on_card:
                result["flash"] = flash
                result["timing"] = _time_fastpitch_step(model, batch, cfg, card)
            return result
    finally:
        torch.backends.cudnn.benchmark = benchmark_was


def _time_fastpitch_step(model, batch, cfg: dict, card: str) -> dict:
    """Step time (median of 5 after two warm steps, CUDA events), its split
    by forward hooks and the marks of `loss_fn` and `train_step`, and the time
    of forward-sum and of the flash kernels inside a step (events around
    every call, in two further steps)."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.models import fastpitch_model as fpm
    from roar_tpu_torch.training.optim import build_optimizer
    from roar_tpu_torch.training.trainer import TrainState, train_step

    device = batch["audio"].device
    generator = torch.Generator(device=device).manual_seed(0)
    model.set_dropout_generator(generator)
    model.module.zero_grad(set_to_none=True)
    state = TrainState(model=model, opt=build_optimizer(
        model.parameters(), cfg["model"]["optim"],
        gradient_clip_val=cfg["trainer"]["gradient_clip_val"]), dropout_generator=generator)
    module = model.module
    parts = ("mel_front_end", "encoder", "duration_predictor", "aligner", "mas",
             "prosody_and_length_regulation", "decoder", "model_forward", "losses", "backward",
             "optimizer")
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    hooks = [
        module.encoder_module.register_forward_hook(lambda *a: mark("encoder")),
        module.aligner_module.register_forward_pre_hook(lambda *a: mark("duration_predictor")),
        module.aligner_module.register_forward_hook(lambda *a: mark("aligner")),
        module.pitch_predictor_module.register_forward_pre_hook(lambda *a: mark("mas")),
        module.decoder_module.register_forward_pre_hook(
            lambda *a: mark("prosody_and_length_regulation")),
        module.decoder_module.register_forward_hook(lambda *a: mark("decoder")),
    ]
    totals, splits = [], {p: [] for p in parts}
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(7):
            events.clear()
            mark("start")
            train_step(state, batch, 0, mark=mark)
            torch.cuda.synchronize()
            if i < 2:
                continue
            totals.append(events["start"].elapsed_time(events["optimizer"]))
            for before, name in zip(("start",) + parts, parts):
                splits[name].append(events[before].elapsed_time(events[name]))
    finally:
        for hook in hooks:
            hook.remove()
    peak = torch.cuda.max_memory_allocated()

    spans = {"flash_fwd": [], "flash_bwd": [], "forward_sum": []}
    saved = (fa.flash_self_attention, fa.flash_self_attention_bwd, fpm.forward_sum_loss)

    def timed(name, fn):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    n_steps = 2
    try:
        fa.flash_self_attention = timed("flash_fwd", saved[0])
        fa.flash_self_attention_bwd = timed("flash_bwd", saved[1])
        fpm.forward_sum_loss = timed("forward_sum", saved[2])
        for _ in range(n_steps):
            train_step(state, batch, 0)
        torch.cuda.synchronize()
    finally:
        fa.flash_self_attention, fa.flash_self_attention_bwd, fpm.forward_sum_loss = saved
    inside = {n: sum(a.elapsed_time(b) for a, b in pairs) / n_steps for n, pairs in spans.items()}
    step_ms = float(np.median(totals))
    split = {p: float(np.median(v)) for p, v in splits.items()}
    split["mel_projection"] = split.pop("model_forward")
    timing = {"phase": "train_fastpitch", "step": "timing", "card": card,
              "batch_shapes": {k: list(batch[k].shape) for k in ("text", "audio", "pitch")},
              "step_ms": step_ms, "step_ms_all": totals, "split_ms": split,
              "forward_sum_forward_ms": inside["forward_sum"],
              "flash_ms_per_step": {"fwd": inside["flash_fwd"],
                                    "bwd_delta_dkv_dq": inside["flash_bwd"]},
              "flash_calls_per_step": {n: len(v) // n_steps for n, v in spans.items()},
              "flash_share_of_step": (inside["flash_fwd"] + inside["flash_bwd"]) / step_ms,
              "peak_device_memory_bytes": peak,
              "method": "CUDA events; median of 5 steps after 2 warm steps; TF32 off; batch "
                        "already on the card; `losses` holds the forward of forward-sum, "
                        "`backward` its backward"}
    _emit(timing)
    return timing


def _post(url: str, payload: dict, timeout: float = 300.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _wav_samples(blob: bytes) -> int:
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE" or blob[36:40] != b"data":
        raise AssertionError(f"not a WAV header: {blob[:44]!r}")
    return (len(blob) - 44) // 2


def _set_flash(module: torch.nn.Module, on: bool) -> None:
    from roar_tpu_torch.models.transformer import MultiHeadAttn

    for m in module.modules():
        if isinstance(m, MultiHeadAttn):
            m.use_flash = on


def phase_slice(device: torch.device, fp_cfg: dict, hg_cfg: dict, sentences,
                card: str = "") -> dict:
    """Serve the slice through the engine and the HTTP server; returns the
    flash launch count of that run.  `card` (name, power limit) is printed
    beside the timings."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.serving import SynthesisEngine, make_server

    fp, gen = build_models(fp_cfg, hg_cfg)
    engine = SynthesisEngine(fp, gen, device=device)
    n_attn = len(fp.module.encoder_module.stack.layers) + len(fp.module.decoder_module.layers)
    n_tokens = [len(fp.parse(s)[0]) for s in sentences]
    expect = [n * FRAMES_PER_TOKEN * engine.hop for n in n_tokens]
    speakers = [i % fp.module.n_speakers for i in range(len(sentences))]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fa.LAUNCHES, engine.programs_run = 0, 0
    t0 = time.perf_counter()
    n_programs = engine.warmup()
    sync()
    _emit({"phase": "slice", "step": "warmup", "programs": n_programs,
           "seconds": time.perf_counter() - t0})

    batch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        waves = engine.synthesize_batch(sentences, speakers)
        batch_s.append(time.perf_counter() - t0)
    got = [w.size for w in waves]
    if got != expect or not all(w.dtype == np.int16 for w in waves):
        raise AssertionError(f"batch samples {got} != {expect}")
    audio_s = sum(expect) / engine.sample_rate
    batch1_ms = {}
    for s, n in zip(sentences, n_tokens):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            (w,) = engine.synthesize_batch([s])
            times.append((time.perf_counter() - t0) * 1e3)
        batch1_ms[n] = float(np.median(times))
    _emit({"phase": "slice", "step": "engine", "card": card, "batch": len(sentences),
           "tokens": n_tokens,
           "batch_wall_s": batch_s, "audio_s": audio_s,
           "rtf": float(np.median(batch_s)) / audio_s,
           "batch1_latency_ms_by_tokens": batch1_ms,
           "batch1_latency_ms_median": float(np.median(list(batch1_ms.values())))})

    server = make_server(engine, host="127.0.0.1", port=0, max_wait_ms=20.0)
    url = f"http://127.0.0.1:{server.server_address[1]}/synthesize"
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    try:
        picks = [1, 3, 4, 6]
        results = [None] * len(picks)

        def ask(slot, i):
            results[slot] = _post(url, {"text": sentences[i], "speaker": speakers[i]})

        t0 = time.perf_counter()
        askers = [threading.Thread(target=ask, args=(j, i)) for j, i in enumerate(picks)]
        for a in askers:
            a.start()
        for a in askers:
            a.join(timeout=600)
        concurrent_s = time.perf_counter() - t0
        for i, res in zip(picks, results):
            if res is None or res[0] != 200 or res[1] != "audio/wav":
                raise AssertionError(f"request {i}: {res and res[:2]}")
            if _wav_samples(res[2]) != expect[i]:
                raise AssertionError(f"request {i}: {_wav_samples(res[2])} != {expect[i]}")
        story = " ".join(sentences[1:4])
        chunks = engine._split_text(story)
        n_x = int(engine.sample_rate * 8.0 / 1e3)
        want = sum(len(fp.parse(c)[0]) * FRAMES_PER_TOKEN * engine.hop for c in chunks)
        want -= (len(chunks) - 1) * n_x
        status, ctype, blob = _post(url, {"text": story, "stream": True})
        if status != 200 or ctype != "audio/wav" or _wav_samples(blob) != want:
            raise AssertionError(f"stream: {status} {ctype} {_wav_samples(blob)} != {want}")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        engine.close()
    sync()
    launches, programs = fa.LAUNCHES, engine.programs_run
    _emit({"phase": "slice", "step": "http", "concurrent_requests": len(picks),
           "concurrent_wall_s": concurrent_s, "batches_run": server.batcher.batches_run,
           "stream_chunks": len(chunks), "programs": programs, "flash_launches": launches})
    if device.type == "cuda" and (launches == 0 or launches != n_attn * programs):
        raise AssertionError(f"{launches} flash launches for {programs} programs x {n_attn} layers")

    # the kernel path's mel against the plain path's, same weights and tokens
    rows = [fp.parse(s)[0] for s in sentences]
    t_bucket = engine._text_bucket(max(map(len, rows)))
    tokens = torch.full((len(rows), t_bucket), fp.tokenizer.pad, dtype=torch.long)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = torch.from_numpy(r)
    tokens, spk = tokens.to(device), torch.tensor(speakers, device=device)
    cap = engine._mel_cap(t_bucket)
    with torch.inference_mode():
        out_k = fp.module.infer(tokens, speaker=spk, max_mel_len=cap)
        _set_flash(fp.module, False)
        try:
            out_p = fp.module.infer(tokens, speaker=spk, max_mel_len=cap)
        finally:
            _set_flash(fp.module, True)
    if not torch.isfinite(out_k["spect"]).all():
        raise AssertionError("mel not finite")
    if not torch.equal(out_k["num_frames"], out_p["num_frames"]):
        raise AssertionError(f"num_frames {out_k['num_frames']} != {out_p['num_frames']}")
    mel_err = float((out_k["spect"] - out_p["spect"]).abs().max())
    torch.testing.assert_close(out_k["spect"], out_p["spect"], **MEL_TOL)
    _emit({"phase": "slice", "step": "mel_vs_plain_path", "mel_shape": list(out_k["spect"].shape),
           "num_frames": out_k["num_frames"].tolist(), "max_abs_err": mel_err, "tol": MEL_TOL,
           "mel_abs_max": float(out_p["spect"].abs().max())})
    return {"launches": launches}


def sup_data_config(manifest: str, sup_dir: str, device: str = "cuda") -> dict:
    """configs/ds_for_fastpitch_align.yaml as the loader resolves it, for the
    keys the extraction script reads (tests/test_torch_sup_data.py holds it
    to the YAML)."""
    return {
        "dataset": {
            "manifest_filepath": manifest, "sup_data_path": sup_dir,
            "sample_rate": SUP_SAMPLE_RATE, "n_fft": 2048, "win_length": 2048,
            "hop_length": 512, "window": "hann", "n_mels": 80, "lowfreq": 0, "highfreq": 8000,
            "pitch_fmin": 65.40639132514966, "pitch_fmax": 2093.004522404789,
        },
        "batch_size": 16, "audio_pad_multiple": 16384, "device": device,
    }


def synth_utterance(rng: np.random.Generator, seconds: float, sr: int = SUP_SAMPLE_RATE,
                    frame_length: int = 2048):
    """One synthetic utterance whose F0 and voicing are known by construction:
    harmonic tones with vibrato or a glide (80 to 800 Hz) alternating with
    silences and noise bursts.  Returns (audio float32 [S], f0 [T], voiced
    [T], score [T]) per pYIN frame (hop frame_length // 4, centred); `score`
    leaves out frames whose window touches a segment boundary or a clip edge,
    where no estimator has a well-defined answer."""
    hop = frame_length // 4
    n_total = int(round(seconds * sr))
    audio, f_inst_all, bounds = [], [], []
    n_done, voiced_next = 0, bool(rng.integers(2))
    while n_done < n_total:
        n = min(int(rng.uniform(0.5, 1.5) * sr) if voiced_next else int(rng.uniform(0.3, 0.6) * sr),
                n_total - n_done)
        if n_total - n_done - n < 0.3 * sr:  # no sliver at the end
            n = n_total - n_done
        t = np.arange(n) / sr
        if voiced_next:
            f_a = float(np.exp(rng.uniform(np.log(80.0), np.log(800.0))))
            if rng.random() < 0.5:  # vibrato: up to +-50 cents at 4 to 7 Hz
                depth, rate = rng.uniform(10.0, 50.0), rng.uniform(4.0, 7.0)
                f_inst = f_a * 2.0 ** (depth * np.sin(2 * np.pi * rate * t) / 1200.0)
            else:  # glide of at most 600 cents/s, kept inside 80 to 800 Hz
                cents = rng.uniform(-600.0, 600.0) * n / sr
                f_b = float(np.clip(f_a * 2.0 ** (cents / 1200.0), 80.0, 800.0))
                f_inst = f_a * (f_b / f_a) ** (t / max(t[-1], 1e-9))
            phase = 2.0 * np.pi * np.cumsum(f_inst) / sr
            x = sum(a * np.sin((k + 1) * phase) for k, a in enumerate((1.0, 0.3, 0.15)))
            x = 0.4 * x / 1.45
        else:
            f_inst = np.zeros(n)
            x = rng.uniform(0.03, 0.1) * rng.standard_normal(n) if rng.random() < 0.5 \
                else np.zeros(n)
        audio.append(x)
        f_inst_all.append(f_inst)
        n_done += n
        bounds.append(n_done)
        voiced_next = not voiced_next
    audio = np.concatenate(audio).astype(np.float32)
    f_inst = np.concatenate(f_inst_all)
    centers = np.arange(n_total // hop + 1) * hop
    f0 = f_inst[np.minimum(centers, n_total - 1)].astype(np.float32)
    score = np.ones(len(centers), bool)
    for edge in [0, *bounds]:
        score &= np.abs(centers - edge) >= frame_length // 2 + hop
    return audio, f0, f0 > 0, score


def score_against_truth(f0s, voiceds, truths) -> dict:
    """Voicing agreement, voiced-F0 RMSE in cents and gross-error rate over
    the scoreable frames of all utterances."""
    agree, cents = [], []
    for f0, voiced, (true_f0, true_v, score) in zip(f0s, voiceds, truths):
        agree.append(voiced[score] == true_v[score])
        both = score & true_v & voiced & (f0 > 0)
        cents.append(1200.0 * np.log2(f0[both] / true_f0[both]))
    agree, cents = np.concatenate(agree), np.concatenate(cents)
    if cents.size == 0:
        raise AssertionError("no scoreable voiced frames")
    return {"frames_scored": int(agree.size), "voiced_frames_scored": int(cents.size),
            "voicing_agreement": float(agree.mean()),
            "f0_rmse_cents": float(np.sqrt(np.mean(cents ** 2))),
            "gross_error_rate": float((np.abs(cents) > 100.0).mean())}


def check_truth_bars(result: dict) -> None:
    if (result["voicing_agreement"] < TRUTH_BARS["min_agree"]
            or result["f0_rmse_cents"] > TRUTH_BARS["max_rmse_cents"]
            or result["gross_error_rate"] > TRUTH_BARS["max_gross"]):
        raise AssertionError(f"pitch against the synthesis truth: {result} outside {TRUTH_BARS}")


def phase_supdata(device: torch.device, card: str = "", n_utterances: int = 16,
                  big_batch: int = 128, max_seconds: float = 10.0) -> dict:
    """Sup-data extraction through the script's `run`, then one big batch
    through `SupDataExtractor.extract`; returns the Viterbi launch counts of
    the script's run."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "scripts", "dataset_processing", "tts"))
    import extract_sup_data_torch as cli

    from roar_tpu_torch.data.audio import write_wav
    from roar_tpu_torch.data.manifest import write_manifest
    from roar_tpu_torch.data.sup_data import CACHED_KINDS, SupDataConfig, SupDataExtractor
    from roar_tpu_torch.kernels import pyin_viterbi as pv
    from roar_tpu_torch.ops import pyin as pyin_ops
    from roar_tpu_torch.ops.pyin_reference import pyin_cpu
    from roar_tpu_torch.ops.spectrogram import frame_energy, log_mel_spectrogram

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED)
    seconds = np.linspace(2.0, max_seconds, n_utterances)[::-1]  # the first is the longest
    utterances = [synth_utterance(rng, float(sec)) for sec in seconds]
    sup_cfg = SupDataConfig()
    pyin_cfg, mel_cfg = sup_cfg.pyin_config(), sup_cfg.mel_config()

    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        entries = []
        for i, (audio, *_) in enumerate(utterances):
            path = os.path.join(wav_dir, f"utt{i:03d}.wav")
            write_wav(path, audio, SUP_SAMPLE_RATE)
            entries.append({"audio_filepath": path, "text": "", "duration": len(audio) / SUP_SAMPLE_RATE})
        manifest = os.path.join(tmp, "manifest.json")
        write_manifest(manifest, entries)
        cfg = sup_data_config(manifest, os.path.join(tmp, "sup"), str(device))
        n_buckets = -(-n_utterances // cfg["batch_size"])

        pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK = 0, 0
        stats = cli.run(cfg)
        sync()
        launches = {"fwd": pv.LAUNCHES_FWD, "backtrack": pv.LAUNCHES_BACKTRACK}
        if device.type == "cuda" and launches != {"fwd": n_buckets, "backtrack": n_buckets}:
            raise AssertionError(f"{launches} Viterbi launches for {n_buckets} bucket(s)")

        # once more into a fresh directory: the wall time without first-call
        # set-up (CUDA context, cuFFT plans, scipy's import, the static tables)
        warm = cli.run(sup_data_config(manifest, os.path.join(tmp, "sup_again"), str(device)))

        cached = []
        for entry, (audio, *_) in zip(entries, utterances):
            n_mel = len(audio) // 512 + 1
            n_pitch = pyin_cfg.num_frames(len(audio))
            item = {}
            for kind in CACHED_KINDS:
                path = os.path.join(cfg["dataset"]["sup_data_path"], kind,
                                    cli.file_id(entry) + ".npy")
                if not os.path.exists(path):
                    raise AssertionError(f"missing cache file {path}")
                item[kind] = np.load(path)
                want = n_mel if kind == "energy" else n_pitch
                if item[kind].shape != (want,):
                    raise AssertionError(f"{kind} of {entry['audio_filepath']}: shape "
                                         f"{item[kind].shape} != ({want},)")
                if not np.isfinite(item[kind].astype(np.float32)).all():
                    raise AssertionError(f"{kind} of {entry['audio_filepath']} not finite")
            cached.append(item)
    mel_frames = sum(len(u[0]) // 512 + 1 for u in utterances)
    if stats["mel_frames"] != mel_frames or not np.isfinite(stats["pitch_mean"]):
        raise AssertionError(f"run() returned {stats}, expected {mel_frames} mel frames")

    truth = score_against_truth([c["pitch"] for c in cached], [c["voiced_mask"] for c in cached],
                                [u[1:] for u in utterances])
    check_truth_bars(truth)
    _emit({"phase": "supdata", "step": "cli", "card": card, "utterances": n_utterances,
           "seconds_of_audio": float(seconds.sum()), "batch_size": cfg["batch_size"],
           "buckets": n_buckets, "viterbi_launches": launches, "mel_frames": mel_frames,
           "first_wall_s": stats["seconds"], "wall_s": warm["seconds"],
           "mel_frames_per_s": mel_frames / warm["seconds"],
           "wall_includes": "WAV reads, copies to and from the card, cache writes; "
                            "first_wall_s also first-call set-up",
           "pitch_mean": stats["pitch_mean"], "pitch_std": stats["pitch_std"],
           "truth": truth, "truth_bars": TRUTH_BARS})

    # the same bucket decoded by the kernels and by the plain versions: same
    # device, same log_obs, so equality is the bar
    lens = np.array([len(u[0]) for u in utterances], np.int32)
    pad_len = -(-int(lens.max()) // 16384) * 16384
    batch = np.zeros((n_utterances, pad_len), np.float32)
    for j, (audio, *_) in enumerate(utterances):
        # what the script read back from the 16-bit WAVs
        batch[j, : len(audio)] = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16) / 32768.0
    audio_d = torch.from_numpy(batch).to(device)
    with torch.no_grad():
        frames = pyin_ops.frame_audio(audio_d, pyin_cfg)
        yin = pyin_ops.cumulative_mean_normalized_difference(frames, pyin_cfg)
        log_obs, _ = pyin_ops.log_observations(yin, pyin_cfg)
        n_bins = pyin_cfg.n_pitch_bins
        log_tri, log_norm = (torch.from_numpy(a).to(device) for a in
                             pyin_ops._band_tables(n_bins, pyin_cfg.transition_width))
        states_k = pyin_ops.banded_viterbi_decode(log_obs, pyin_cfg).long()
        ptrs_p, v_final_p = pv.viterbi_forward_plain(
            log_obs, log_tri, log_norm, float(np.log1p(-pyin_cfg.switch_prob)),
            float(np.log(pyin_cfg.switch_prob)))
        states_p = pv.viterbi_backtrack_plain(
            ptrs_p, torch.argmax(v_final_p, dim=-1).to(torch.int32)).long()
    freqs = torch.from_numpy(pyin_cfg.freqs().astype(np.float32)).to(device)
    decoded = []
    for states in (states_k, states_p):
        voiced = states < n_bins
        decoded.append((torch.where(voiced, freqs[states % n_bins], 0.0), voiced))
    if not (torch.equal(decoded[0][0], decoded[1][0]) and torch.equal(decoded[0][1], decoded[1][1])):
        raise AssertionError("kernel decode and plain decode differ on the sup-data bucket")
    f0_k = decoded[0][0].cpu().numpy()
    for j, item in enumerate(cached):  # and it is what the script wrote
        n_pitch = len(item["pitch"])
        if not np.array_equal(f0_k[j, :n_pitch], item["pitch"]):
            raise AssertionError(f"utterance {j}: the cached pitch is not this decode")

    # the numpy reference on the two shortest utterances
    agreements = []
    for j in (n_utterances - 1, n_utterances - 2):
        _, voiced_ref, _ = pyin_cpu(batch[j, : lens[j]], pyin_cfg)
        agreements.append(float((voiced_ref == cached[j]["voiced_mask"]).mean()))
    if min(agreements) < 0.98:
        raise AssertionError(f"voicing agreement with pyin_cpu {agreements} < 0.98")
    _emit({"phase": "supdata", "step": "decode_checks", "bucket_shape_btn": list(log_obs.shape[:2])
           + [n_bins], "kernel_vs_plain_decode_equal": True, "cache_is_kernel_decode": True,
           "pyin_cpu_voicing_agreement": agreements, "pyin_cpu_bar": 0.98})
    del frames, yin, log_obs, ptrs_p, audio_d

    # one batch of `big_batch` utterances of the longest length, no files
    big = [synth_utterance(rng, max_seconds)[0] for _ in range(8)]
    audios = [big[i % len(big)] for i in range(big_batch)]
    extractor = SupDataExtractor(sup_cfg, batch_size=big_batch, audio_pad_multiple=16384,
                                 device=device)
    walls = []
    for _ in range(4):  # the first run is the warm-up
        t0 = time.perf_counter()
        items = extractor.extract(audios)
        walls.append(time.perf_counter() - t0)
    big_frames = sum(int(it["mel_len"]) for it in items)
    if not all(np.isfinite(it[k].astype(np.float32)).all() for it in items
               for k in ("log_mel", "energy", "pitch", "p_voiced")):
        raise AssertionError("big batch: output not finite")
    wall = float(np.median(walls[1:]))
    result = {"phase": "supdata", "step": "big_batch", "card": card, "batch": big_batch,
              "seconds_each": max_seconds, "mel_frames": big_frames, "wall_s": walls,
              "mel_frames_per_s": big_frames / wall,
              "wall_includes": "host padding, copies to and from the card"}
    if device.type == "cuda":
        lens_d = torch.tensor([len(a) for a in audios], device=device)
        pad_len = -(-max(len(a) for a in audios) // 16384) * 16384
        batch_d = torch.zeros((big_batch, pad_len), device=device)
        for j, a in enumerate(audios):
            batch_d[j, : len(a)] = torch.from_numpy(a).to(device)
        with torch.no_grad():
            def front():
                fr = pyin_ops.frame_audio(batch_d, pyin_cfg)
                return pyin_ops.log_observations(
                    pyin_ops.cumulative_mean_normalized_difference(fr, pyin_cfg), pyin_cfg)[0]

            log_obs = front()
            result["split_ms"] = {
                "log_mel_and_energy": _time_ms(lambda: (
                    log_mel_spectrogram(batch_d, lens_d, mel_cfg), frame_energy(batch_d, mel_cfg)),
                    reps=3),
                "pyin_front": _time_ms(front, reps=3),
                "viterbi": _time_ms(lambda: pyin_ops.banded_viterbi_decode(log_obs, pyin_cfg),
                                    reps=3),
            }
        result["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    _emit(result)
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": card})
    from roar_tpu_torch.kernels.library import build_library, load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = build_library()
    load_library()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "library": os.path.relpath(lib_path), "ptxas": ptxas})

    kern = phase_kernel(device)
    vit = phase_kernel_viterbi(device)
    conv = phase_kernel_grouped_conv(device)
    fbwd = phase_kernel_flash_bwd(device)
    run = phase_slice(device, fastpitch_config(), hifigan_config(), TAMIL_SENTENCES, card)
    sup = phase_supdata(device, card)
    train = phase_train_hifigan(device, card)
    fp_train = phase_train_fastpitch(device, card)

    def pick(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    # K5 on the training path: one encoder-layer launch (text bucket) plus
    # one decoder-layer launch (mel bucket) of the longest batch, summed; a
    # step makes six of each
    flash = fp_train["flash"]

    def over_shapes(get):
        return sum(get(case) for case in flash.values())

    def flash_errs(*names):
        return max(max(case["errors"][n]["max_abs_err"] for case in flash.values()) for n in names)

    flash_shapes = {str(t): {**case["times"],
                             **{k: v["bound_ms"] for k, v in case["bounds"].items()}}
                    for t, case in flash.items()}
    backward_bound = over_shapes(lambda c: c["bounds"]["backward"]["bound_ms"])
    kernels = [
        # `ms` and its neighbours: serving's decoder shape (8, 3072, 1, 64);
        # `train_fastpitch`: the same at the training step's two shapes, with
        # the log-sum-exp written
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "roar_tpu/models/transformer.py:72",
         "launches": run["launches"], "launches_train_fastpitch": fp_train["launches"]["fwd"],
         "max_abs_err": max(kern["max_abs_err"], fbwd["max_abs_err"]["o"], flash_errs("o")),
         **pick(kern), "library_ms": kern["library_ms"],
         "train_fastpitch": {
             "ms": over_shapes(lambda c: c["times"]["fwd_with_lse_ms"]),
             "plain_ms": over_shapes(lambda c: c["times"]["fwd_plain_ms"]),
             "bound_ms": over_shapes(lambda c: c["bounds"]["fwd_with_lse"]["bound_ms"]),
             "bound_by": flash[max(flash)]["bounds"]["fwd_with_lse"]["bound_by"],
             "library_ms": over_shapes(lambda c: c["times"]["fwd_library_ms"]),
             "lse_max_abs_err": max(fbwd["max_abs_err"]["lse"], flash_errs("lse")),
             "by_mel_or_text_bucket": flash_shapes}},
        # K5-bwd: `bound_ms` is that of the whole backward (five products),
        # which the two kernels and the delta reduction share; `backward_ms`
        # times them together; plain and library give dq, dk and dv in one
        # call too.  `own_work_bound_ms` counts the products this kernel does
        # itself (the split recomputes q.k^T and dO.v^T)
        *[{"name": f"flash_attention_bwd_{name}", "route": "cuda",
           "source": "roar_tpu_torch/csrc/flash_attention_bwd.cu", "replaces": replaces,
           "launches": fp_train["launches"][name],
           "max_abs_err": max(*(fbwd["max_abs_err"][g] for g in grads), flash_errs(*grads)),
           "ms": over_shapes(lambda c: c["times"][f"{name}_ms"]),
           "backward_ms": over_shapes(lambda c: c["times"]["backward_ms"]),
           "plain_ms": over_shapes(lambda c: c["times"]["backward_plain_ms"]),
           "bound_ms": backward_bound,
           "bound_by": flash[max(flash)]["bounds"]["backward"]["bound_by"],
           "own_work_bound_ms": over_shapes(
               lambda c: c["bounds"][f"{name}_own_work"]["bound_ms"]),
           "library_ms": over_shapes(lambda c: c["times"]["backward_library_ms"])}
          for name, grads, replaces in (
              ("dkv", ("dk", "dv"), "roar_tpu/models/transformer.py:110"),
              ("dq", ("dq",), "roar_tpu/models/transformer.py:110"))],
        {"name": "pyin_viterbi_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/pyin_viterbi.cu",
         "replaces": "roar_tpu/ops/pyin_pallas.py:34",
         "launches": sup["launches"]["fwd"], "max_abs_err": 0.0,
         **pick(vit["fwd"]), "library_ms": None},
        {"name": "pyin_backtrack", "route": "cuda",
         "source": "roar_tpu_torch/csrc/pyin_viterbi.cu",
         "replaces": "roar_tpu/ops/pyin_pallas.py:279",
         "launches": sup["launches"]["backtrack"], "max_abs_err": 0.0,
         **pick(vit["backtrack"]), "library_ms": None},
        # K3 and K4: times and bounds summed over the 15 grouped-conv shapes
        # of one discriminator pass (B = 32); library = cuDNN with TF32 off
        *[{"name": f"grouped_conv_{name}", "route": "cuda",
           "source": "roar_tpu_torch/csrc/grouped_conv.cu", "replaces": replaces,
           "launches": train["launches"][name], "max_abs_err": conv[name]["max_abs_err"],
           "max_rel_err": conv[name]["max_rel_err"], **pick(conv[name]),
           "library_ms": conv[name]["library_ms"],
           "library_tf32_ms": conv[name]["library_tf32_ms"]}
          for name, replaces in (("fwd", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dx", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dw", "roar_tpu/ops/grouped_conv.py:272"))],
    ]
    if not all(k["launches"] > 0 for k in kernels) or fp_train["launches"]["fwd"] == 0:
        raise AssertionError(f"a kernel was launched no time on its path: {kernels}")
    _emit({"kernels": kernels})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
