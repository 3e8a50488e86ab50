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
   result's scale; each bit-identical across two runs), these at the 15
   discriminator shapes of HiFi-GAN's 32 x 8192 samples and of JETS's
   32 x 16384;
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
   Function's gradients the kernels' own and close to autograd of the plain
   forward, and the times beside the bounds and autograd of SDPA;
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
9. train_jets: JETS (the FastPitch graph + the HiFi-GAN v1 generator,
   end-to-end text->wav) at the full width and depth of
   configs/jets_22050_align.yaml (flash attention on, `dropatt` 0, 4
   speakers, MPD and the grouped MSD, batch 16, segments of 64 frames =
   16384 samples, fp32): 64 seeded synthetic utterances of 2 to 10 s with
   Bengali text and 16 for validation, their sup-data extracted first through
   `extract_sup_data_torch.run` at the model's hop of 256 (K1 and K2, one
   launch per bucket), then 8 steps through the training CLI's `run`; checks
   12 / 12 / 12 flash launches per step and 12 forwards per validation
   batch, 30 / 30 / 15 grouped-conv launches per step (forward / dX / dW) and
   15 forwards per validation batch, finite losses with every term present,
   the bin loss's warm-up by epoch, the learning rate against the cosine
   schedule, the spectral norm's stored u and sigma, the saved `.roar`
   loaded into a fresh model and synthesising one text and a batch of 8
   (12 flash forwards a call, the kernel path's audio against the plain
   path's), one D+G step with the kernels against one with their plain
   versions (same weights, batch, segment starts and dropout masks; hard
   durations that sum to the mel lengths, segment starts inside the valid
   frames), the flash kernels held and timed at the step's two shapes; then
   the step time, its split, the kernels' and MAS's time in it and peak
   memory.

10. kernel_flash_causal: the causal flash-attention kernels (forward with and
   without the log-sum-exp, dK/dV, dQ) against their plain versions in fp32
   and in bf16 at small shapes (ragged T, D 32 / 64 / 128, a trailing pad
   mask, B 4 x T 2048, T 1) and at the GPT path's (1, 4096, 32, 64), by the
   same routine as phase 7 (bf16 element by element at a bar that follows each
   row's own scale), and at the path's shape the times beside the bounds and
   `F.scaled_dot_product_attention(is_causal=True)` with its autograd;
11. train_gpt: GPT causal-LM training at the full width and depth of
   tiny-llama-1.1b (22 layers, d 2048, 32 heads of 64 in 4 KV groups, SwiGLU
   5632, vocabulary 32000, 1.1 B parameters), S 4096, bf16 compute from fp32
   master parameters, `remat` with `remat_policy=flash`, the fused cross
   entropy, 4 micro-batches of one sequence per update: a seeded synthetic
   corpus of 31,994 distinct words run through the training CLI's `run` for 3
   updates and a validation pass; checks 22 / 22 / 22 causal flash launches
   per micro-batch (forward, dK/dV, dQ), 22 forwards per validation batch and
   no non-causal launch, a finite loss that falls over the updates, the
   learning rate against the cosine schedule, the saved `.roar` loaded back
   equal to the masters, one micro-batch under `remat_policy=nothing` (44
   forwards, the same gradients), one micro-batch with the kernels against one
   with their plain versions in bf16 at full depth (loss, whole gradient and
   each attention projection's gradient) and in fp32 at 4 layers;
   then the update's time, its split, tokens/s and peak memory.

Then the kernels line, the card line, and last `{"ok": true, "device": ...}`.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from typing import Optional

import numpy as np
import torch

SEED = 0
FRAMES_PER_TOKEN = 6  # every token lasts exactly this long (duration bias log 7)
# fp32 kernel (3xTF32 products on the tensor cores, fp32 sums) vs cuBLAS fp32 einsum
KERNEL_TOL = dict(atol=1e-4, rtol=1e-3)
# kernel path vs plain path through 12 fp32 layers: the attention sums run in
# another order, and cuDNN may pick other conv algorithms for the two runs
MEL_TOL = dict(atol=5e-4, rtol=1e-3)
KERNEL_CASES = [  # (B, T, H, D): encoder and decoder buckets, a ragged T, H = 2
    (8, 256, 1, 64), (8, 3072, 1, 64), (1, 200, 1, 64), (2, 200, 2, 32),
]
# (B, T, N, W): the CLI's bucket and a batch of 128 at the production widths
# (10 s of 22050 Hz audio is T = 449 frames at hop 512), the small test
# config, T = 2 and 1, and JETS's bucket (10 s at hop 256 is 862 frames, in a
# bucket of 864)
VITERBI_CASES = [
    (16, 449, 601, 101), (128, 449, 601, 101), (3, 14, 279, 71), (1, 2, 601, 101),
    (1, 1, 601, 101), (16, 864, 601, 101),
]
# the cases held with their ties planted and with every admissible cluster
# size forced, and the key of each in the summary
VITERBI_TIES = (0, 2, 5)
VITERBI_SWEPT = {0: "", 5: "_jets"}
# published peaks of one H100 SXM: device memory bytes/s, fp32 FLOP/s outside
# the tensor cores, dense bf16 FLOP/s in them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12  # H100 SXM dense TF32, NVIDIA's data sheet
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
BENGALI_SENTENCES = [
    "নমস্কার.",
    "আজ আবহাওয়া খুব ভালো.",
    "আমি সকালে চা খেয়েছি, তারপর অফিসে গিয়েছি.",
    "বাংলা একটি সুন্দর ভাষা.",
    "আমাদের গ্রামে একটি বড় নদী আছে, সেখানে অনেক মানুষ মাছ ধরতে যায়.",
    "ধন্যবাদ!",
    "বই পড়া জ্ঞান বাড়ায়; তাই প্রতিদিন কিছুক্ষণ পড়ুন.",
    "ঢাকা বাংলাদেশের রাজধানী; এখানে অনেক পুরনো মসজিদ, জাদুঘর, বিশ্ববিদ্যালয় এবং ব্যস্ত "
    "বাজার রয়েছে, আর প্রতি বছর সারা পৃথিবী থেকে মানুষ এই শহর দেখতে আসে.",
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
                         batch_size: int = 16, n_segments: int = 8192, debug: bool = False,
                         precision=None) -> dict:
    """configs/hifigan_22050.yaml as the loader resolves it, for the keys the
    training CLI reads, with `trainer.max_steps`, `trainer.log_every_n_steps=1`
    `trainer.max_epochs` and `exp_manager.always_save_roar=true`
    (tests/test_torch_train_gan.py holds it to the YAML), and with `precision`
    `trainer.precision` (the YAML sets none: fp32).  Two epochs of 64
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
    trainer = {"max_steps": max_steps, "max_epochs": 2, "log_every_n_steps": 1,
               "check_val_every_n_epoch": 20, "seed": 0}
    if precision is not None:
        trainer["precision"] = precision
    return {
        "name": "HifiGan", "model": model, "trainer": trainer,
        "exp_manager": {"exp_dir": exp_dir, "name": "HifiGan", "resume_if_exists": False,
                        "always_save_roar": True},
        "device": device,
    }


def fastpitch_train_config(train_manifest: str, val_manifest: str, sup_dir: str, exp_dir: str,
                           pitch_mean: float, pitch_std: float, device: str = "cuda",
                           max_steps: int = 8, batch_size: int = 32, precision=32) -> dict:
    """configs/fastpitch_22050_align.yaml as the loader resolves it, for the
    keys the training CLI reads, with the overrides of the configuration that
    runs the attention kernels: `model.{input_fft,output_fft}.use_flash=true`
    and `.dropatt=0.0` (every other dropout stays 0.1), 4 speakers,
    `+model.energy_predictor` (the pitch predictor's block) with `energy` in
    `sup_data_types`, `trainer.precision=32` (or the YAML's own `bf16` with
    `precision="bf16"`), `trainer.max_steps`,
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
        "trainer": {"max_epochs": 1000, "precision": precision, "gradient_clip_val": 1000.0,
                    "log_every_n_steps": 1, "check_val_every_n_epoch": 1, "seed": 0,
                    "model_parallel_size": 1, "max_steps": max_steps},
        "exp_manager": {"exp_dir": exp_dir, "name": "FastPitch", "resume_if_exists": False,
                        "always_save_roar": True},
        "device": device,
    }


JETS_HOP = 256


def jets_sup_data_config(manifest: str, sup_dir: str, device: str = "cuda") -> dict:
    """configs/ds_for_jets_ben_align.yaml as the loader resolves it, for the
    keys the extraction script reads, at the STFT of the JETS model
    (configs/jets_22050_align.yaml: n_fft 1024, win_length 1024, hop 256):
    the YAML's hop of 512 would give frames that the model, at hop 256, does
    not read."""
    cfg = sup_data_config(manifest, sup_dir, device)
    cfg["dataset"].update(n_fft=1024, win_length=1024, hop_length=JETS_HOP)
    return cfg


def jets_train_config(train_manifest: str, val_manifest: str, sup_dir: str, exp_dir: str,
                      pitch_mean: float, pitch_std: float, device: str = "cuda",
                      max_steps: int = 8, batch_size: int = 16, precision=32) -> dict:
    """configs/jets_22050_align.yaml as the loader resolves it, for the keys
    the training CLI reads, with only the overrides of the configuration that
    runs the attention kernels: `model.{input_fft,output_fft}.use_flash=true`
    and `.dropatt=0.0` (every other dropout stays 0.1), 4 speakers, the
    extraction's `pitch_mean` and `pitch_std`, `trainer.precision=32` (or the
    YAML's own `bf16-mixed` with `precision="bf16-mixed"`),
    `trainer.max_steps`, `trainer.log_every_n_steps=1` and
    `exp_manager.always_save_roar=true` (tests/test_torch_train_jets.py holds
    it to the YAML).  Full width and depth: d 384, 6 + 6 FFT layers of one
    head of 64, predictors 256 wide, the HiFi-GAN v1 generator from 384
    channels, MPD and the grouped MSD at full channels, segments of 64
    frames."""
    cond = ["add", "layernorm"]
    fft = {"n_layer": 6, "n_head": 1, "d_model": 384, "d_head": 64, "d_inner": 1536,
           "kernel_size": 3, "dropout": 0.1, "dropatt": 0.0, "condition_types": cond,
           "use_flash": True}
    predictor = {"input_size": 384, "kernel_size": 3, "filter_size": 256, "dropout": 0.1,
                 "n_layers": 2, "condition_types": cond}
    pitch = {"pitch_fmin": 65.40639132514966, "pitch_fmax": 2093.004522404789,
             "pitch_mean": pitch_mean, "pitch_std": pitch_std}
    stft = {"n_fft": 1024, "lowfreq": 0, "highfreq": 8000, "window": "hann"}

    def data(manifest, train):
        dataset = {"_target_": "roar_tpu.data.dataset.TTSDataset", "manifest_filepath": manifest,
                   "sample_rate": 22050, "sup_data_path": sup_dir,
                   "sup_data_types": ["align_prior_matrix", "pitch", "energy", "speaker_id"],
                   "win_length": 1024, "hop_length": JETS_HOP, "n_mels": 80, **stft, **pitch,
                   "pitch_norm": True, "use_beta_binomial_interpolator": True}
        if train:
            dataset.update(max_duration=None, min_duration=0.1)
        return {"dataset": dataset,
                "dataloader_params": {"drop_last": False, "shuffle": train,
                                      "batch_size": batch_size, "num_workers": 4}}

    model = {
        "learn_alignment": True, "bin_loss_warmup_epochs": 100, "max_token_duration": 75,
        "symbols_embedding_dim": 384, "pitch_embedding_kernel_size": 3,
        "energy_embedding_kernel_size": 3, "segment_size": 64, "mel_loss_scale": 45.0,
        "feature_loss_scale": 2.0, "adv_loss_scale": 1.0, "aligner_loss_scale": 2.0, **pitch,
        "sample_rate": 22050, "n_mel_channels": 80, "n_window_size": 1024,
        "n_window_stride": JETS_HOP, **stft,
        "text_tokenizer": {"_target_": "roar_tpu.data.tokenizers.BengaliCharsTokenizer",
                           "punct": True, "apostrophe": True, "pad_with_space": True},
        "train_ds": data(train_manifest, True), "validation_ds": data(val_manifest, False),
        "preprocessor": {"nfilt": 80, "n_window_size": 1024, "n_window_stride": JETS_HOP,
                         "pad_to": 0, "pad_value": -11.52, "sample_rate": 22050, **stft,
                         "normalize": None, "preemph": None, "dither": 0.0, "log": True,
                         "log_zero_guard_type": "clamp", "log_zero_guard_value": 1e-05,
                         "mag_power": 1.0, "exact_pad": True},
        "input_fft": dict(fft), "output_fft": dict(fft),
        "alignment_module": {"n_text_channels": 384, "condition_types": ["add"]},
        "duration_predictor": dict(predictor), "pitch_predictor": dict(predictor),
        "energy_predictor": dict(predictor),
        "waveform_generator": {**hifigan_config()["generator"], "initial_input_size": 384},
        "speaker_encoder": {"lookup_module": {"n_speakers": 4, "embedding_dim": 384}},
        "speaker_emb_condition_prosody": True, "speaker_emb_condition_decoder": True,
        "speaker_emb_condition_aligner": True,
        "optim": {"name": "adamw", "lr": 0.0002, "betas": [0.8, 0.99],
                  "sched": {"name": "CosineAnnealing", "min_lr": 1e-5, "warmup_ratio": 0.02}},
        "max_steps": 2500000,
    }
    return {
        "name": "JETS", "model": model,
        "trainer": {"max_steps": max_steps, "precision": precision, "max_epochs": 1000,
                    "gradient_clip_val": 1000.0, "log_every_n_steps": 1, "seed": 0,
                    "model_parallel_size": 1},
        "exp_manager": {"exp_dir": exp_dir, "name": "JETS", "resume_if_exists": False,
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
        # and head-dim element (QK^T and PV), each three TF32 products (3xTF32)
        # against the dense TF32 rate, the fp32 FMA pipe's bound beside; q, k,
        # v read and out written once
        pairs = sum(n * n + (t - n) * (t - n) for n in lens)
        flops = 4.0 * pairs * h * d
        nbytes = 4.0 * (4 * b * t * h * d + b * t)
        bound = {**_bound(nbytes, flops, TF32_FLOPS / 3),
                 "bound_fp32_fma_ms": _bound(nbytes, flops)["bound_ms"]}
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


def _bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS) -> dict:
    """The least time this card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type (fp32
    outside the tensor cores unless `peak_flops` says otherwise)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": flops}


# the flash kernels on the tensor cores, bf16 and fp32 (3xTF32): they must
# not spill, and their SASS must hold HMMA instructions
FLASH_MMA_KERNELS = {"bfloat16": ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel",
                                  "flash_bwd_dq_mma_kernel"),
                     "float32": ("flash_fwd_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
                                 "flash_bwd_dq_tf32_kernel")}


def flash_dynamic_smem(kernel: str, dtype: str, d: int) -> int:
    """Dynamic shared memory per block that the launch functions of
    csrc/flash_attention_{fwd,bwd}.cu ask for (ptxas reports static only)."""
    tile, stride4 = 64 * d, 64 * (d + 4)
    if kernel == "flash_fwd_mma_kernel":
        return 2 * tile * 5
    if kernel == "flash_fwd_tf32_kernel":  # Q tile 64 rows, K/V tiles 32
        return 4 * (d + 4) * (2 * 64 + 4 * 32)
    if kernel == "flash_bwd_dkv_mma_kernel":
        return 2 * tile * 6 + 4 * 64 * 4
    if kernel == "flash_bwd_dq_mma_kernel":
        return 2 * tile * 6
    if kernel == "flash_bwd_dkv_tf32_kernel":
        return 4 * stride4 * 6 + 4 * 64 * 2
    if kernel == "flash_bwd_dq_tf32_kernel":
        return 4 * stride4 * 6
    raise ValueError(f"unknown flash kernel {kernel}")


def _flash_instance(mangled: str) -> Optional[tuple]:
    """(kernel, dtype, D) of a flash kernel's mangled name, else None.

    The name is a length-prefixed `<n>flash_..._kernel` followed by its
    template arguments `I...E` (the head dim); the anonymous namespace before
    it may hold the source's name (`flash_attention_fwd_cu`) and end in
    digits, so each split of the digit run into namespace tail and length is
    tried.  The `_mma_` kernels take bf16, the others (`_tf32_`: 3xTF32
    products on the tensor cores) fp32."""
    for found in re.finditer(r"(\d+)(?=flash_)", mangled):
        digits, start = found.group(1), found.end()
        for cut in range(len(digits)):
            n = int(digits[cut:])
            name, args = mangled[start:start + n], mangled[start + n:]
            if name.endswith("_kernel") and args.startswith("I"):
                dim = re.search(r"Li(\d+)E", args)
                dtype = "bfloat16" if "_mma_" in name else "float32"
                return name, dtype, int(dim.group(1)) if dim else 0
    return None


def _conv_instance(mangled: str) -> Optional[tuple]:
    """("conv_mma_kernel", view, (WN, NT, MT)) of a K3 instance's mangled
    name (template arguments: warps along the output channels, n-tiles and
    m-tiles per warp, dX, bf16), view "fwd" or "dx", or ("dw_mma_kernel",
    "dw", (NT, MT)) of a K4 instance's (n-tiles of the block, m-tiles per
    warp, bf16), else None.  A bf16 instance's view ends in "_bf16"; a name
    without the bf16 argument is an fp32 instance."""
    found = re.search(r"(conv_mma_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E(?:Lb([01])E)?",
                      mangled)
    if found is not None:
        view = ("dx" if found.group(5) == "1" else "fwd") + (
            "_bf16" if found.group(6) == "1" else "")
        return found.group(1), view, tuple(int(found.group(i)) for i in (2, 3, 4))
    found = re.search(r"(dw_mma_kernel)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?", mangled)
    if found is not None:
        return (found.group(1), "dw_bf16" if found.group(4) == "1" else "dw",
                (int(found.group(2)), int(found.group(3))))
    return None


# the K3 instances `dispatch_conv_mma` of csrc/grouped_conv.cu can launch,
# and the K4 instances of `roar_grouped_conv_dw` (`dw_tiles`)
CONV_MMA_TILES = [(wn, nt, mt) for wn, nt in ((1, 1), (1, 2), (1, 4), (2, 4)) for mt in (1, 2)]
DW_MMA_TILES = [(1, 4), (2, 4), (4, 4), (8, 2)]


def _viterbi_instance(mangled: str) -> Optional[tuple]:
    """("pyin_viterbi_fwd_kernel", W, P) of a K1 instance's mangled name
    (template arguments: band width, 0 for the run-time one; lanes a bin),
    ("pyin_backtrack_kernel",) of K2's, else None."""
    found = re.search(r"(pyin_viterbi_fwd_kernel)ILi(\d+)ELi(\d+)E", mangled)
    if found is not None:
        return found.group(1), int(found.group(2)), int(found.group(3))
    if "pyin_backtrack_kernel" in mangled:
        return ("pyin_backtrack_kernel",)
    return None


def _any_instance(mangled: str) -> Optional[tuple]:
    return _flash_instance(mangled) or _conv_instance(mangled) or _viterbi_instance(mangled)


def parse_ptxas(log: str) -> dict:
    """{instance key: registers, spill bytes, stack, static shared memory} of
    every flash kernel instance (keyed (kernel, dtype, D)), K3 and K4
    instance (keyed (kernel, view, tiles)) and K1 and K2 instance (keyed
    (kernel, W, P) and (kernel,)) in a `ptxas -v` log."""
    out, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = _any_instance(entry.group(1))
            if current is not None:
                out[current] = {"registers": None, "spill_store_bytes": None,
                                "spill_load_bytes": None, "stack_bytes": None,
                                "static_smem_bytes": 0}
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            out[current].update(stack_bytes=int(frame.group(1)),
                                spill_store_bytes=int(frame.group(2)),
                                spill_load_bytes=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[current]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                out[current]["static_smem_bytes"] = int(smem.group(1))
    return out


def count_hmma(lib_path) -> Optional[dict]:
    """{instance key: HMMA instructions in its SASS} of every flash and K3
    instance, from `cuobjdump -sass`, or None where the tool is not
    installed.  TF32 products show as `HMMA.1684.F32.TF32`."""
    import shutil

    tool = shutil.which("cuobjdump")
    if tool is None:
        candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                 "cuobjdump")
        tool = candidate if os.path.exists(candidate) else None
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _any_instance(line.split("Function :", 1)[1].strip())
            if current is not None:
                counts[current] = 0
        elif current is not None and "HMMA" in line:
            counts[current] += 1
    return counts


def phase_kernel_build(lib_path) -> dict:
    """Registers, shared memory and spills of every flash kernel instance,
    every K3 and K4 instance and every K1 and K2 instance from the build's
    `ptxas -v` log, and where `cuobjdump` is installed the HMMA count of each
    tensor-core kernel; raises if a tensor-core kernel (every flash kernel,
    bf16 and fp32 in 3xTF32, K3 and K4) spills or has no HMMA, or if a K1 or
    K2 instance spills or is missing."""
    from roar_tpu_torch.kernels.flash_attention import HEAD_DIMS

    everything = parse_ptxas(lib_path.with_suffix(".log").read_text())
    table = {key: info for key, info in everything.items() if key[0].startswith("flash_")}
    hmma = count_hmma(lib_path)
    rows = []
    for (kernel, dtype, d), info in sorted(table.items()):
        row = {"kernel": kernel, "dtype": dtype, "head_dim": d, **info,
               "dynamic_smem_bytes": flash_dynamic_smem(kernel, dtype, d)}
        if hmma is not None:
            row["hmma"] = hmma.get((kernel, dtype, d), 0)
        rows.append(row)
    for dtype, kernels in FLASH_MMA_KERNELS.items():
        for kernel in kernels:
            for d in HEAD_DIMS:
                info = table.get((kernel, dtype, d))
                if info is None or info["registers"] is None:
                    raise AssertionError(f"{kernel}<{d}> is not in the ptxas log")
                if info["spill_store_bytes"] or info["spill_load_bytes"]:
                    raise AssertionError(f"{kernel}<{d}> spills: {info}")
                if hmma is not None and hmma.get((kernel, dtype, d), 0) == 0:
                    raise AssertionError(f"{kernel}<{d}> has no HMMA instruction in its SASS")
    # K3 and K4 in fp32 (3xTF32 products) and in bf16 (one exact TF32
    # product of the widened operands, fp32 sums; y and dX written in bf16,
    # dW in fp32): one dynamic shared memory size per launch
    # (csrc/grouped_conv.cu `k3_smem`, `launch_dw`), so none is listed here
    conv_rows = []
    for kernel, view, tiles in ([("conv_mma_kernel", view + sfx, tiles)
                                 for sfx in ("", "_bf16") for view in ("fwd", "dx")
                                 for tiles in CONV_MMA_TILES]
                                + [("dw_mma_kernel", "dw" + sfx, tiles)
                                   for sfx in ("", "_bf16") for tiles in DW_MMA_TILES]):
        key = (kernel, view, tiles)
        info = everything.get(key)
        if info is None or info["registers"] is None:
            raise AssertionError(f"{kernel}<{tiles}, {view}> is not in the ptxas log")
        if info["spill_store_bytes"] or info["spill_load_bytes"]:
            raise AssertionError(f"{kernel}<{tiles}, {view}> spills: {info}")
        row = {"kernel": kernel, "view": view,
               ("nt_mt" if view.startswith("dw") else "wn_nt_mt"): list(tiles),
               "dtype": ("bfloat16 (one TF32 product of widened operands)"
                         if view.endswith("_bf16") else "float32 (3xTF32 products)"), **info}
        if hmma is not None:
            row["hmma"] = hmma.get(key, 0)
            if row["hmma"] == 0:
                raise AssertionError(f"{kernel}<{tiles}, {view}> has no HMMA instruction in "
                                     "its SASS")
        conv_rows.append(row)
    # K1 (one instance per band width, 101 and the run-time one, and lanes a
    # bin, 1 / 2 / 4 / 8) and K2: dynamic shared memory depends on the launch
    viterbi_rows = []
    for key, info in sorted(everything.items()):
        if key[0] not in ("pyin_viterbi_fwd_kernel", "pyin_backtrack_kernel"):
            continue
        if info["registers"] is None:
            raise AssertionError(f"{key} has no register count in the ptxas log")
        if info["spill_store_bytes"] or info["spill_load_bytes"]:
            raise AssertionError(f"{key} spills: {info}")
        names = ("kernel", "band_width", "lanes_per_bin")[:len(key)]
        viterbi_rows.append({**dict(zip(names, key)), **info})
    # the lanes a bin `pick_lanes` of csrc/pyin_viterbi.cu can return, at
    # both band widths
    fwd_splits = {(row["band_width"], row["lanes_per_bin"]) for row in viterbi_rows
                  if row["kernel"] == "pyin_viterbi_fwd_kernel"}
    if fwd_splits != {(w, p) for w in (101, 0) for p in (1, 2, 4, 8)} or not any(
            row["kernel"] == "pyin_backtrack_kernel" for row in viterbi_rows):
        raise AssertionError(f"K1/K2 instances missing from the ptxas log: {viterbi_rows}")
    line = {"phase": "kernel_build", "instances": rows, "grouped_conv_instances": conv_rows,
            "viterbi_instances": viterbi_rows, "cuobjdump": hmma is not None}
    _emit(line)
    return line


def viterbi_log_obs(rng: np.random.Generator, b: int, t: int, n: int, ties: bool) -> np.ndarray:
    """Seeded log observations [B, T, 2N]: random rows normalised, log, -700
    floor.  With `ties`, one row is constant over states and frames, another
    repeats one frame, and a third (where B > 2) is a comb of equal peaks 20
    bins apart in every frame, so whole bands of candidates are equal and a
    bin midway between two peaks has its two best offsets in different
    sub-ranges of K1's split."""
    obs = rng.random((b, t, 2 * n)).astype(np.float32)
    obs[rng.random(obs.shape) < 0.3] = 0.0  # zero-probability states hit the floor
    obs /= obs.sum(-1, keepdims=True)
    log_obs = np.where(obs > 0, np.log(np.maximum(obs, 1e-37)), -700.0).astype(np.float32)
    if ties:
        log_obs[0] = np.float32(np.log(1.0 / (2 * n)))
        if b > 1:
            log_obs[1] = log_obs[1, :1]
        if b > 2:
            log_obs[2] = -700.0
            log_obs[2, :, ::20] = np.float32(np.log(0.05))
    return log_obs


def viterbi_bounds(b: int, t: int, n: int, w: int) -> tuple:
    """(K1's, K2's) least time on this card, `_bound` dicts.  K1: per frame
    and source bin 10 add/max/compare operations, per target state and
    offset one add and one compare, one add of the observation; observations
    read and pointers written once.  K2 follows one pointer per frame and
    row: the bytes this data needs are those entries, the final states and
    the states written."""
    fwd_ops = float(b) * (t - 1) * (10 * n + 2 * n * (2 * w + 1))
    fwd_bytes = 4.0 * (2 * b * t * 2 * n + b * 2 * n + n + w)
    back_bytes = 4.0 * (b * (t - 1) + b + b * t)
    return _bound(fwd_bytes, fwd_ops), _bound(back_bytes, float(b) * (t - 1))


def phase_kernel_viterbi(device: torch.device) -> dict:
    """K1 and K2 against their plain versions: exact equality of pointers,
    final scores and states, at every `VITERBI_CASES` shape with the cluster
    size K1 picks, and at the CLI's bucket shape (16, 449, 601, 101) and
    JETS's (16, 864, 601, 101) with every admissible cluster size forced.
    Returns each kernel's numbers at those two shapes with the picked size,
    their sweeps, and B 128's."""
    from roar_tpu_torch.kernels import pyin_viterbi as pv
    from roar_tpu_torch.ops.pyin import _band_tables

    rng = np.random.default_rng(SEED)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    log_stay, log_switch = float(np.log1p(-0.01)), float(np.log(0.01))
    summary = {"sweep": [], "sweep_jets": []}
    for case, (b, t, n, w) in enumerate(VITERBI_CASES):
        ties = case in VITERBI_TIES
        log_obs = torch.from_numpy(viterbi_log_obs(rng, b, t, n, ties)).to(device)
        log_tri, log_norm = (torch.from_numpy(a).to(device) for a in _band_tables(n, w))
        if not torch.isfinite(log_tri).all():
            raise AssertionError("log-triangle weights not finite")
        args = (log_obs, log_tri, log_norm, log_stay, log_switch)
        ptrs_p, v_final_p = pv.viterbi_forward_plain(*args)
        fwd_plain_ms = _time_ms(lambda: pv.viterbi_forward_plain(*args), reps=3)
        picked = pv.cluster_size(b, n, w, sm_count)
        forced = ([c for c in (1, 2, 4, 8) if pv.cluster_admissible(n, w, c)]
                  if case in VITERBI_SWEPT else [])
        for cluster in [None] + forced:
            c = picked if cluster is None else cluster
            ptrs, v_final = pv.viterbi_forward(*args, cluster=cluster)
            torch.cuda.synchronize()
            # additions and comparisons only, in one order: equality is the bar
            where = f"{(b, t, n, w)}, cluster {c}"
            if not torch.equal(ptrs, ptrs_p):
                raise AssertionError(f"viterbi_fwd pointers differ at {where}: "
                                     f"{int((ptrs != ptrs_p).sum())} entries")
            if not torch.equal(v_final, v_final_p):
                raise AssertionError(f"viterbi_fwd final scores differ at {where}: max "
                                     f"{float((v_final - v_final_p).abs().max())}")
            last = torch.argmax(v_final, dim=-1).to(torch.int32)
            states = pv.viterbi_backtrack(ptrs, last)
            states_p = pv.viterbi_backtrack_plain(ptrs, last)
            torch.cuda.synchronize()
            if not torch.equal(states, states_p):
                raise AssertionError(f"backtrack states differ at {where}")
            fwd_bound, back_bound = viterbi_bounds(b, t, n, w)
            fwd = {"ms": _time_ms(lambda: pv.viterbi_forward(*args, cluster=cluster)),
                   "plain_ms": fwd_plain_ms, **fwd_bound, "cluster": c,
                   "max_active_clusters": pv.max_active_clusters(b, n, w, c)}
            fwd["bound_share"] = fwd["bound_ms"] / fwd["ms"]
            _emit({"phase": "kernel", "kernel": "pyin_viterbi_fwd", "shape_btnw": [b, t, n, w],
                   "ties": ties, "cluster_forced": cluster is not None, "pointers_equal": True,
                   "final_scores_equal": True, **fwd})
            if cluster is not None:
                summary["sweep" + VITERBI_SWEPT[case]].append(
                    {"cluster": c, "ms": fwd["ms"],
                     "max_active_clusters": fwd["max_active_clusters"]})
                continue
            back = {"ms": _time_ms(lambda: pv.viterbi_backtrack(ptrs, last)),
                    "plain_ms": _time_ms(lambda: pv.viterbi_backtrack_plain(ptrs, last), reps=3),
                    **back_bound}
            _emit({"phase": "kernel", "kernel": "pyin_backtrack", "shape_btnw": [b, t, n, w],
                   "ties": ties, "states_equal": True, **back})
            suffix = {0: "", 1: "_b128", 5: "_jets"}.get(case)
            if suffix is not None:
                summary["fwd" + suffix] = fwd
                summary["backtrack" + suffix] = back
        del log_obs, ptrs, ptrs_p, v_final, v_final_p, states, states_p
    return summary


# K3/K4 against the plain versions.  fp32 sums of up to 64 x 41 products
# (forward), 64 x 11 (dX per phase) and 32 x 4096 (dW) run in another order
# than cuBLAS's inside the plain einsum, and both kernels form their products
# in 3xTF32 (K3 up to about 2.6e-6 of the scale on an H100; one TF32 product
# alone would read about 3e-4): the bar is the largest difference relative
# to the largest magnitude of the result
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


# the peak rate of each grouped-conv kernel's operations: K3 and K4 do three
# TF32 products on the tensor cores for each fp32 multiply-add
GROUPED_CONV_PEAK_FLOPS = {"fwd": TF32_FLOPS / 3, "dx": TF32_FLOPS / 3, "dw": TF32_FLOPS / 3}
# bf16 K3/K4 against their plain versions (tests/test_torch_grouped_conv_bf16.py
# holds the plain versions to the Pallas kernels at the same bars): each
# element within 2^-6 of its value plus 2^-7 of its row's largest magnitude,
# the whole within 1e-2 relative L2.  Both sides sum the same exact products
# in fp32 in another order and round y and dX once to bf16
BF16_ELEM_REL = 2.0 ** -6
BF16_ROW_REL = 2.0 ** -7
BF16_L2_REL = 1e-2


def bf16_errors(got: torch.Tensor, want: torch.Tensor, row: int) -> dict:
    """The bf16 bars above, rows of `row` elements: the largest excess over
    the per-element bar (<= 0 passes), the relative L2, the largest
    difference and the largest difference over its row's magnitude."""
    g = got.float().reshape(-1, row)
    w = want.float().reshape(-1, row)
    err = (g - w).abs()
    row_max = w.abs().amax(dim=1, keepdim=True)
    excess = float((err - BF16_ELEM_REL * w.abs() - BF16_ROW_REL * row_max).max())
    return {"excess": excess, "l2": _rel_l2(g, w), "max_abs_err": float(err.max()),
            "rel_err": float((err / row_max.clamp_min(1e-30)).max())}


def grouped_conv_inputs(case, gen, device) -> tuple:
    """Seeded x [B, Cin, W], w [Cout, Cin/G, k] (scaled by 1/sqrt(fan in)) and
    dy [B, Cout, Wout] of a (B, W, cin, cout, k, s, g, pad) case."""
    from roar_tpu_torch.kernels import grouped_conv as gk

    b, width, cin, cout, k, s, g, pad = case
    x = torch.randn(b, cin, width, device=device, generator=gen)
    w = torch.randn(cout, cin // g, k, device=device, generator=gen) / (k * cin // g) ** 0.5
    dy = torch.randn(b, cout, gk.out_len(width, k, s, pad), device=device, generator=gen)
    return x, w, dy


def grouped_conv_calls(case, x, w, dy) -> dict:
    """{"fwd" | "dx" | "dw": (kernel, plain version, library call)} on a
    case's inputs; the library calls are cuDNN's."""
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import grouped_conv as gk

    b, width, cin, cout, k, s, g, pad = case
    return {
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


def grouped_conv_bound(name: str, nbytes: float, flops: float) -> dict:
    """`_bound` at the kernel's own peak (`GROUPED_CONV_PEAK_FLOPS`), and
    `bound_fp32_fma_ms`, the same work on the fp32 FMA pipe, which compares
    with the times of the FMA kernels these replaced."""
    return {**_bound(nbytes, flops, GROUPED_CONV_PEAK_FLOPS[name]),
            "bound_fp32_fma_ms": _bound(nbytes, flops)["bound_ms"]}


def grouped_conv_case_bound(name: str, case, x, w, dy) -> dict:
    """`grouped_conv_bound` of one case: each input read and the output
    written once (the three tensors), 2 k Cg FLOP per output element.  In
    bf16 every tensor is 2 bytes an element but K4's fp32 dW, and the bound
    is at the dense bf16 rate (989 TFLOP/s)."""
    b, width, cin, cout, k, s, g, pad = case
    flops = 2.0 * b * cout * (cin // g) * k * dy.shape[-1]
    if x.dtype == torch.bfloat16:
        nbytes = 2.0 * (x.numel() + w.numel() + dy.numel()) + (2.0 * w.numel() if name == "dw"
                                                                 else 0.0)
        return _bound(nbytes, flops, BF16_FLOPS)
    return grouped_conv_bound(name, 4.0 * (x.numel() + w.numel() + dy.numel()), flops)


def time_grouped_conv(kernel, library, plain=None, tf32: bool = True) -> dict:
    """Median of 5 by CUDA events of the kernel and of its library call with
    TF32 off and, with `tf32`, on; of the plain version too (median of 2)
    when given."""
    times = {"ms": _time_ms(kernel, reps=5)}
    if plain is not None:
        times["plain_ms"] = _time_ms(plain, reps=2)
    times["library_ms"] = _time_ms(library, reps=5)
    if not tf32:
        return times
    torch.backends.cudnn.allow_tf32 = True
    try:
        times["library_tf32_ms"] = _time_ms(library, reps=5)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return times


def phase_kernel_grouped_conv(device: torch.device, batch: int = 32, segment: int = 8192,
                              dtype: torch.dtype = torch.float32) -> dict:
    """K3 forward, K3 dX and K4 against their plain versions at the small
    shape classes and at the 15 production shapes, two runs of each kernel
    bit for bit, the autograd Function against autograd of F.conv1d; returns
    per kernel the worst error and the times summed over the 15 production
    shapes, with `grouped_conv_bound` (`bound_ms` on the tensor cores' 3xTF32
    rate, `bound_fp32_fma_ms` beside it).  With `dtype=torch.bfloat16` the
    bf16 kernels on bf16 inputs, held at the bf16 bars (`bf16_errors`), the
    library calls cuDNN's in bf16, the bound at the dense bf16 rate, and no
    autograd or TF32 check."""
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import grouped_conv as gk
    from roar_tpu_torch.ops.grouped_conv import grouped_conv1d_cf

    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED)
    names = ("fwd", "dx", "dw")
    summary = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "bytes": 0.0, "operations": 0.0,
                   **({"max_l2_rel_err": 0.0, "max_excess_over_bar": -1.0} if bf16
                      else {"library_tf32_ms": 0.0})}
               for n in names}
    production = msd_grouped_shapes(batch, segment)
    for case in GROUPED_CONV_SMALL + production:
        timed = case in production
        x, w, dy = (t.to(dtype) for t in grouped_conv_inputs(case, gen, device))
        calls = grouped_conv_calls(case, x, w, dy)
        line = {"phase": "kernel", "kernel": "grouped_conv", "dtype": str(dtype).split(".")[1],
                "shape_bwiokSgp": list(case),
                **({"elem_rel": BF16_ELEM_REL, "row_rel": BF16_ROW_REL, "l2_rel": BF16_L2_REL}
                   if bf16 else {"rel_tol": GROUPED_CONV_REL_TOL})}
        for name in names:
            kernel, plain, library = calls[name]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all() or (
                    bf16 and got.dtype != (torch.float32 if name == "dw" else dtype)):
                raise AssertionError(f"grouped_conv_{name} at {case}: shape {tuple(got.shape)} "
                                     f"vs {tuple(want.shape)}, {got.dtype}, or not finite")
            lib_out = library()
            if bf16:
                row = got[0].numel() if name == "dw" else got.shape[-1]
                errs = bf16_errors(got, want, row)
                err, rel = errs["max_abs_err"], errs["rel_err"]
                if errs["excess"] > 0.0 or errs["l2"] > BF16_L2_REL:
                    raise AssertionError(f"grouped_conv_{name} bf16 at {case}: {errs}")
                lib_errs = bf16_errors(lib_out, want, row)
                if lib_errs["excess"] > 0.0 or lib_errs["l2"] > BF16_L2_REL:
                    raise AssertionError(f"library call for {name} bf16 at {case} disagrees: "
                                         f"{lib_errs}")
            else:
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                if rel > GROUPED_CONV_REL_TOL:
                    raise AssertionError(f"grouped_conv_{name} at {case}: max abs err {err}, "
                                         f"relative {rel} > {GROUPED_CONV_REL_TOL}")
                lib_rel = float((lib_out - want).abs().max()) / float(want.abs().max())
                if lib_rel > GROUPED_CONV_REL_TOL:
                    raise AssertionError(f"library call for {name} at {case} disagrees: "
                                         f"{lib_rel}")
            if not torch.equal(got, kernel()):
                raise AssertionError(f"grouped_conv_{name} at {case}: two runs differ")
            acc = summary[name]
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
            acc["max_rel_err"] = max(acc["max_rel_err"], rel)
            line[name] = {"max_abs_err": err, "rel_err": rel}
            if bf16:
                acc["max_l2_rel_err"] = max(acc["max_l2_rel_err"], errs["l2"])
                acc["max_excess_over_bar"] = max(acc["max_excess_over_bar"], errs["excess"])
                line[name].update(l2_rel_err=errs["l2"], excess_over_bar=errs["excess"])
            del got, want, lib_out
            if timed:
                times = time_grouped_conv(kernel, library, plain, tf32=not bf16)
                bound = grouped_conv_case_bound(name, case, x, w, dy)
                line[name].update(times, **bound)
                for key, value in times.items():
                    acc[key] += value
                acc["bytes"] += bound["bytes"]
                acc["operations"] += bound["operations"]
        if timed:
            line["bit_identical"] = True
        _emit(line)
        del x, w, dy, calls
    torch.cuda.empty_cache()
    if bf16:
        for name, acc in summary.items():
            acc.update(_bound(acc["bytes"], acc["operations"], BF16_FLOPS))
        per_step = {key: 2 * summary["fwd"][key] + 2 * summary["dx"][key] + summary["dw"][key]
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        _emit({"phase": "kernel", "kernel": "grouped_conv", "dtype": "bfloat16",
               "step": "sum_over_production_shapes", "shapes": len(production), "batch": batch,
               "segment": segment, **summary, "per_train_step": per_step})
        return summary

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
    for name, acc in summary.items():
        acc.update({k: v for k, v in grouped_conv_bound(name, acc["bytes"],
                                                        acc["operations"]).items()
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


# a bf16 step (phases train_*_bf16), kernel path against plain path: the
# bars of GPT's bf16 step, each loss term within 2e-3 relative and the whole
# gradient within 2e-2 relative L2.  The terms the step holds in bf16 (the
# discriminators' LSGAN means and the feature-matching and adversarial sums)
# cannot agree closer than their own rounding: they are held within two bf16
# steps of their value (`_loss_close`)
BF16_STEP_LOSS_RTOL = 2e-3
BF16_STEP_GRAD_L2_TOL = 2e-2
# The JETS module's bf16 gradient: on one hard alignment an H100 read 3.6e-2
# to 3.7e-2 relative L2 between the kernel and plain bf16 steps (four
# runs), 4.1e-4 between two runs of the kernel step, and 4.2e-2 to 4.4e-2
# between the plain step in bf16 and in fp32, where the kernel step was
# 4.3e-2 to 4.4e-2 from fp32 (ratios 0.98 and 1.04): two bf16 roundings of
# one fp32 step, each as far from it, apart where they round differently.
# So a part whose kernel and plain bf16 gradients differ by more than 2e-2
# is held by the fp32 step (run in the same phase): the kernel step's
# gradient no further from it than BF16_TO_FP32_RATIO times the plain bf16
# step's.  A kernel that computed a wrong value would stand far off both
BF16_TO_FP32_RATIO = 1.25
BF16_LOSS_TERMS = frozenset({"d_loss", "d_loss_mpd", "d_loss_msd", "g_fm_loss", "g_adv_loss"})


def _loss_close(got: float, want: float, rtol: float, bf16_term: bool = False) -> bool:
    """|got - want| within rtol of |want|, or for a term held in bf16 within
    two bf16 rounding steps (2^(e - 7) each, e the exponent of |want|)."""
    bar = rtol * abs(want)
    if bf16_term and want != 0.0:
        bar = max(bar, 2.0 * 2.0 ** (math.floor(math.log2(abs(want))) - 7))
    return abs(got - want) <= bar


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
                        debug: bool = False, precision=None) -> dict:
    """HiFi-GAN training through the CLI's `run`; returns the grouped-conv
    launch counts of that run.  With `precision="bf16"` (phase
    `train_hifigan_bf16`) the run trains with `trainer.precision=bf16`: every
    grouped conv of a step is a bf16 launch, and the kernel step is held to
    the plain step at the bf16 step's bars."""
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
    bf16 = precision is not None
    phase = "train_hifigan_bf16" if bf16 else "train_hifigan"

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
                                       batch_size, n_segments, debug, precision)

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            t0 = time.perf_counter()
            state = cli.run(cfg)
            sync()
            wall = time.perf_counter() - t0
            every, every_bf16 = _launch_counts()
            launches = {k: every[f"grouped_conv_{k}"] for k in ("fwd", "dx", "dw")}
            launches_bf16 = {k: every_bf16[f"grouped_conv_{k}"] for k in ("fwd", "dx", "dw")}
            peak = torch.cuda.max_memory_allocated() if on_card else None
            model = state.model

            n_grouped = sum(1 for m in model.msd.modules() if getattr(m, "groups", 1) > 1)
            want = {"fwd": 2 * n_grouped * steps, "dx": 2 * n_grouped * steps,
                    "dw": n_grouped * steps}
            if n_grouped != 15 or state.step != steps:
                raise AssertionError(f"{n_grouped} grouped convs, {state.step} steps")
            if model.compute_dtype != (torch.bfloat16 if bf16 else None):
                raise AssertionError(f"the run trained in {model.compute_dtype}")
            if on_card and (launches != want
                            or launches_bf16 != (want if bf16 else dict.fromkeys(want, 0))):
                raise AssertionError(f"grouped-conv launches {launches} (bf16 {launches_bf16}) "
                                     f"!= {want}: K4 ran in the G pass, a grouped conv went "
                                     f"round its kernel, or a step ran in the wrong type")

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
            _emit({"phase": phase, "step": "cli", "card": card, "steps": steps,
                   "precision": precision, "batch": batch_size, "segment": n_segments,
                   "utterances": n_utterances, "grouped_conv_launches": launches,
                   "grouped_conv_launches_bf16": launches_bf16,
                   "per_step": {k: v // steps for k, v in launches.items()},
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
                model.set_compute_dtype(None)  # the fp32 masters, as the bundle holds them
                trained_audio = model.generator(mel)
                model.set_compute_dtype(torch.bfloat16 if bf16 else None)
            if tuple(audio.shape) != (1, 64 * 256) or not torch.isfinite(audio).all():
                raise AssertionError(f"vocoder output {tuple(audio.shape)} or not finite")
            fold_err = float((audio - trained_audio).abs().max())
            if fold_err > 1e-4:
                raise AssertionError(f"folded generator differs from the trained one: {fold_err}")
            _emit({"phase": phase, "step": "bundle", "bundle_bytes": os.path.getsize(path),
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
            loss_rtol = BF16_STEP_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
            for k in ("d_loss", "g_loss"):
                if not _loss_close(metrics_k[k], metrics_p[k], loss_rtol, bf16 and k == "d_loss"):
                    raise AssertionError(f"{k}: kernels {metrics_k[k]} vs plain {metrics_p[k]}")
            pairs = [(f"{part}.{name}", pk, pp) for part in ("generator", "mpd", "msd")
                     for (name, pk), (_, pp) in zip(getattr(model, part).named_parameters(),
                                                    getattr(twin, part).named_parameters())]
            # bf16: the whole gradient is held (the bar of the bf16 JETS step);
            # AdamW's first update moves a weight by lr on its gradient's sign
            # alone, which bf16 rounding flips where a gradient is near zero
            grads = (_grad_errors(pairs, float("inf")) if bf16
                     else _grad_errors(pairs, TRAIN_GRAD_L2_TOL, TRAIN_GRAD_MAX_TOL))
            if grads["failures"]:
                raise AssertionError(grads["failures"][0])
            if bf16 and grads["whole_l2"] > BF16_STEP_GRAD_L2_TOL:
                raise AssertionError(f"whole gradient differs by {grads['whole_l2']}")
            if not bf16 and grads["param_abs"] > TRAIN_PARAM_ATOL:
                raise AssertionError(f"updated parameters differ by {grads['param_abs']}")
            _emit({"phase": phase, "step": "kernel_path_vs_plain_path",
                   "kernels": metrics_k, "plain": metrics_p, "loss_rtol": loss_rtol,
                   "whole_grad_l2_rel_err": grads["whole_l2"],
                   "whole_grad_l2_tol": BF16_STEP_GRAD_L2_TOL if bf16 else None,
                   "max_grad_l2_rel_err": grads["worst_l2"][0],
                   "grad_l2_tol": None if bf16 else TRAIN_GRAD_L2_TOL,
                   "max_grad_max_rel_err": grads["worst_max"][0],
                   "grad_max_tol": None if bf16 else TRAIN_GRAD_MAX_TOL,
                   "worst_gradient_tensor": grads["worst_max"][1],
                   "max_param_abs_diff": grads["param_abs"],
                   "param_atol": None if bf16 else TRAIN_PARAM_ATOL})
            del twin

            result = {"launches": launches}
            if bf16:
                result["launches_bf16"] = launches_bf16
            if on_card:
                timing_state = GANTrainState(
                    model=model, g_opt=build_optimizer(model.g_parameters(), optim_cfg),
                    d_opt=build_optimizer(model.d_parameters(), optim_cfg))
                result["timing"] = _time_gan_step(timing_state, batch, card, phase,
                                                  {n: (gk, n) for n in _PlainGroupedConv.NAMES})
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


def _grad_errors(pairs, l2_tol: float, max_tol: float = float("inf")) -> dict:
    """Kernel path against plain path after one step, over `pairs` ((name,
    kernel-path parameter, plain-path parameter)): per tensor the relative
    L2 and the largest difference of the gradients (over the plain one's
    largest magnitude), the whole gradient's relative L2, the worst tensor of
    each, the largest difference of the parameters, and a failure line for
    each tensor over `l2_tol` or `max_tol`."""
    out = {"tensors": {}, "failures": [], "param_abs": 0.0}
    delta_sq = total_sq = 0.0
    for name, pk, pp in pairs:
        gk, gp = pk.grad, pp.grad
        if gk is None and gp is None:
            continue
        if gk is None or gp is None:
            out["failures"].append(f"{name}: a gradient on one path only")
            continue
        delta = gk - gp
        d, n = float(delta.norm()), float(gp.norm())
        delta_sq, total_sq = delta_sq + d ** 2, total_sq + n ** 2
        l2 = d / max(n, 1e-30)
        top = float(delta.abs().max()) / max(float(gp.abs().max()), 1e-30)
        out["tensors"][name] = (l2, top)
        out["param_abs"] = max(out["param_abs"], float((pk.detach() - pp.detach()).abs().max()))
        if l2 > l2_tol or top > max_tol:
            out["failures"].append(f"{name}: gradient differs between kernel path and plain "
                                   f"path by {l2} (L2, relative) and {top} (largest, relative)")
    out["whole_l2"] = (delta_sq / max(total_sq, 1e-60)) ** 0.5
    out["worst_l2"] = max(((v[0], k) for k, v in out["tensors"].items()), default=(0.0, ""))
    out["worst_max"] = max(((v[1], k) for k, v in out["tensors"].items()), default=(0.0, ""))
    return out


def _time_inside(timed: dict, step, n_steps: int = 2) -> tuple:
    """Run `step()` `n_steps` times with CUDA events around every call of
    each function of `timed` (name -> (module, attribute)).  Returns (ms per
    step, calls per step), by name."""
    spans = {n: [] for n in timed}
    saved = {n: getattr(mod, attr) for n, (mod, attr) in timed.items()}
    try:
        for n, (mod, attr) in timed.items():
            setattr(mod, attr, _timed(spans[n], saved[n]))
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    finally:
        for n, (mod, attr) in timed.items():
            setattr(mod, attr, saved[n])
    return ({n: sum(a.elapsed_time(b) for a, b in pairs) / n_steps
             for n, pairs in spans.items()},
            {n: len(pairs) // n_steps for n, pairs in spans.items()})


def _time_gan_step(state, batch, card: str, phase: str, timed: dict, epoch: int = 0) -> dict:
    """Step time of `gan_train_step` on `state` (median of 5 after two warm
    steps, CUDA events), its split by the parts the step marks, peak memory,
    and inside two further steps the time of each function of `timed` (name
    -> (module, attribute); events around every call)."""
    from roar_tpu_torch.training.gan import gan_train_step

    parts = ("generator_forward", "d_pass", "d_optimizer", "g_pass", "g_optimizer")
    totals, splits = [], {p: [] for p in parts}
    torch.cuda.reset_peak_memory_stats()
    for i in range(7):
        events = {"start": torch.cuda.Event(enable_timing=True)}
        events["start"].record()

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        gan_train_step(state, batch, mark=mark, epoch=epoch)
        torch.cuda.synchronize()
        if i < 2:
            continue
        totals.append(events["start"].elapsed_time(events["g_optimizer"]))
        for before, name in zip(("start",) + parts, parts):
            splits[name].append(events[before].elapsed_time(events[name]))
    peak = torch.cuda.max_memory_allocated()

    inside, calls = _time_inside(timed, lambda: gan_train_step(state, batch, epoch=epoch))
    step_ms = float(np.median(totals))
    timing = {"phase": phase, "step": "timing", "card": card,
              "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
              "step_ms": step_ms, "step_ms_all": totals,
              "split_ms": {p: float(np.median(v)) for p, v in splits.items()},
              "ms_per_step": inside,
              "calls_per_step": calls,
              "share_of_step": {n: inside[n] / step_ms for n in inside},
              "peak_device_memory_bytes": peak,
              "method": "CUDA events; median of 5 steps after 2 warm steps; cudnn.benchmark off, "
                        "TF32 off; batch already on the card"}
    _emit(timing)
    return timing


# K5-bwd and K5-causal against the plain versions.
# fp32: the kernels' 3xTF32 sums, forward and backward (flushed per k-chunk
# into a round-to-nearest fp32 sum, at fp32's level) against cuBLAS fp32
# einsums over up to 4096 keys, so `o` and `lse` are held to KERNEL_TOL and
# each gradient to an absolute error of 1e-4 of its own largest magnitude plus
# rtol 1e-3 (the forward's KERNEL_TOL, made relative to the gradient's scale).
FLASH_BWD_ATOL_REL = 1e-4
FLASH_BWD_RTOL = 1e-3
# bf16: the plain versions round where the kernels do, so what is left is the
# order of the fp32 sums and the forward's rounding of p against a running
# maximum (the plain version's against the final one).  Before the result is
# stored the two differ by a few 1e-3 of the row's own scale (each of n keys
# adds an independent 2^-9 of its term), and the store rounds each side to
# bf16, whose step is 2^-8 to 2^-7 of the value.  So every element is held
# within 2^-6 of its own magnitude plus 2^-7 of the largest magnitude in its
# row (the D values of one token and head), and every tensor within 1e-2 in
# relative L2.  The bar follows each row's scale: a causal row that sees n
# keys has values near 1 / sqrt(n), so a bar tied to the tensor's largest
# value would pass a late row that is all zeros; this one fails a dropped
# tile, a wrong mask or a zeroed row wherever it lies.  The floor stands in
# for a row's largest magnitude where the row is zero but for rounding (dq
# and dk of a query that sees one key).
FLASH_BF16_RTOL = 2.0 ** -6
FLASH_BF16_ROW_ATOL = 2.0 ** -7
FLASH_BF16_L2_TOL = 1e-2
FLASH_ROW_FLOOR = 1e-2
# SDPA is a yardstick, not under test: in bf16 it rounds at places of its own,
# so it is only held to compute the same function
FLASH_LIBRARY_BF16_L2_TOL = 2e-2
# (B, T, H, D, valid lengths): T no multiple of 64, all-valid rows, a row that
# is mostly padding, a single valid key, D = 32 / 128 / 64
FLASH_BWD_SMALL = [
    (3, 70, 2, 32, [70, 33, 1]), (2, 130, 2, 128, [130, 9]), (4, 200, 1, 64, [200, 200, 63, 5]),
]
# the text and mel buckets of 20 s utterances at batch 32: longer than any
# batch phase `train_fastpitch` draws from its 2 to 10 s corpus, so they stand
# beside the path's own shapes (which that phase holds and times) and are
# labelled so
FLASH_LONG_SHAPES = [(32, 160, 1, 64), (32, 864, 1, 64)]
# (B, T, H, D, valid lengths or None): ragged T, D 32 / 128 / 64, a trailing
# pad mask, B 4 x T 2048, T 1
FLASH_CAUSAL_SMALL = [
    (2, 70, 2, 32, None), (2, 130, 2, 128, [130, 41]), (1, 200, 1, 64, None),
    (2, 1000, 2, 64, [1000, 333]), (4, 2048, 2, 64, None), (2, 1, 2, 64, None),
]
GPT_FLASH_SHAPE = (1, 4096, 32, 64)  # tiny-llama-1.1b at S 4096, GQA expanded


def _rel_l2(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """|got - want|_2 over |want|_2; `floor` stands in for a root mean square
    of `want` below it."""
    got, want = got.detach().float(), want.detach().float()
    norm = max(float(want.norm()), floor * want.numel() ** 0.5, 1e-30)
    return float((got - want).norm()) / norm


def assert_flash_close(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Hold a result [B, T, H, D] of an attention kernel against the plain
    version's.  fp32: within 1e-4 of `want`'s largest magnitude + rtol 1e-3.
    bf16: every element within 2^-6 of its own magnitude + 2^-7 of the largest
    magnitude in its row, and the tensor within 1e-2 in relative L2.  Returns
    the errors measured."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, type {got.dtype} or not finite")
    bf16 = want.dtype == torch.bfloat16
    got, want = got.detach().float(), want.detach().float()
    top = max(float(want.abs().max()), FLASH_ROW_FLOOR)
    err = (got - want).abs()
    out = {"max_abs_err": float(err.max()), "rel_to_largest": float(err.max()) / top}
    if not bf16:
        torch.testing.assert_close(got, want, atol=FLASH_BWD_ATOL_REL * top, rtol=FLASH_BWD_RTOL,
                                   msg=lambda m: f"{what}: {m}")
        return out
    row = want.abs().amax(-1, keepdim=True).clamp_min(FLASH_ROW_FLOOR)
    share = err / (FLASH_BF16_RTOL * want.abs() + FLASH_BF16_ROW_ATOL * row)
    out.update(worst_share_of_bar=float(share.max()),
               rel_l2=_rel_l2(got, want, FLASH_ROW_FLOOR))
    if out["worst_share_of_bar"] > 1.0:
        at = [int(i) for i in np.unravel_index(int(share.argmax()), share.shape)]
        raise AssertionError(f"{what}: at {at} got {float(got[tuple(at)])}, want "
                             f"{float(want[tuple(at)])}: {out['worst_share_of_bar']} of the bar "
                             f"(2^-6 of the value + 2^-7 of its row's largest)")
    if out["rel_l2"] > FLASH_BF16_L2_TOL:
        raise AssertionError(f"{what}: relative L2 error {out['rel_l2']} > {FLASH_BF16_L2_TOL}")
    return out


def _flash_bounds(pairs: float, shape, elem_bytes: float, peak_flops: float) -> dict:
    """Bounds of the attention functions over `pairs` visible (query, key)
    pairs per head at `shape` (B, T, H, D).  The backward as a function is
    five products (10 operations per pair and head-dim element); of them dkv
    does q.k^T, dO.v^T, p^T dO and dS^T q (8) and dq does q.k^T, dO.v^T and
    dS k (6), so the split does seven products for five.  The forward is two
    (4).  Bytes: q, k, v, (o,) dO read and the results written at
    `elem_bytes` each, seg / lse / delta rows at four.  Operations are held
    against `peak_flops`."""
    b, t, h, d = shape
    elems, rows, ops = elem_bytes * b * t * h * d, 4.0 * b * h * t, pairs * h * d
    return {"backward": _bound(8 * elems + 2 * rows, 10.0 * ops, peak_flops),
            "dkv_own_work": _bound(6 * elems + 3 * rows, 8.0 * ops, peak_flops),
            "dq_own_work": _bound(5 * elems + 3 * rows, 6.0 * ops, peak_flops),
            "fwd_with_lse": _bound(4 * elems + 2 * rows, 4.0 * ops, peak_flops)}


def _flash_case(gen: torch.Generator, shape, key_mask: Optional[torch.Tensor], timed: bool,
                where: str, phase: str = "kernel_flash_bwd", causal: bool = False,
                dtype: torch.dtype = torch.float32) -> dict:
    """The forward (with and without its log-sum-exp) and the two backward
    kernels against the plain versions on seeded q, k, v and cotangent of
    `shape` (B, T, H, D) and `dtype` under `key_mask` [B, T] (None: all valid)
    and `causal`; with `timed`, also the times beside the bounds and SDPA with
    its autograd.  Emits one line and returns its errors, times and bounds."""
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.ops.flash_attention import flash_self_attention

    device = gen.device
    b, t, h, d = shape
    bf16 = dtype == torch.bfloat16
    lens = [t] * b if key_mask is None else [int(n) for n in key_mask.sum(1)]
    q, k, v, do = (torch.randn(b, t, h, d, device=device, generator=gen).to(dtype)
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True, causal=causal)
    if not torch.equal(out, fa.flash_self_attention(q, k, v, key_mask, scale, causal=causal)):
        raise AssertionError(f"asking for lse changed the forward's output at {shape}")
    out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal)
    if bf16:
        errs = {"o": assert_flash_close(out, out_p, f"o at {shape} {dtype}")}
    else:
        torch.testing.assert_close(out, out_p, **KERNEL_TOL)
        errs = {"o": {"max_abs_err": float((out - out_p).abs().max())}}
    torch.testing.assert_close(lse, lse_p, **KERNEL_TOL)
    errs["lse"] = {"max_abs_err": float((lse - lse_p).abs().max())}
    # the cotangent holds garbage on the pad rows too: a pad query's
    # gradient must stay inside the pad segment
    args = (q, k, v, key_mask, scale, out, lse, do)
    got = fa.flash_self_attention_bwd(*args, causal=causal)
    again = fa.flash_self_attention_bwd(*args, causal=causal)
    want = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, out_p, lse_p, do, causal)
    torch.cuda.synchronize()
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, a2):
            raise AssertionError(f"flash bwd {name} at {shape}: two runs differ")
        errs[name] = assert_flash_close(a, w, f"flash bwd {name} at {shape} {dtype}")
    if key_mask is not None:
        # a cotangent that is zero on the pad rows (what TransformerLayer's
        # mask makes it) leaves the pad keys' gradients exactly zero
        do_valid = do * key_mask[:, :, None, None]
        _, dk0, dv0 = fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do_valid,
                                                  causal=causal)
        pad_rows = ~key_mask[:, :, None, None].expand_as(dk0)
        if pad_rows.any() and (float(dk0[pad_rows].abs().max()) != 0.0
                               or float(dv0[pad_rows].abs().max()) != 0.0):
            raise AssertionError(f"pad keys got a gradient at {shape}")
    # the autograd Function launches these same kernels, and in fp32 agrees
    # with autograd of the plain forward
    qkv = [z.clone().requires_grad_(True) for z in (q, k, v)]
    g_fn = torch.autograd.grad(flash_self_attention(*qkv, key_mask, scale, causal=causal), qkv, do)
    if not all(torch.equal(a, w) for a, w in zip(g_fn, got)):
        raise AssertionError(f"the Function's gradients are not the kernels' at {shape}")
    if not bf16:
        g_plain = torch.autograd.grad(
            fa.flash_self_attention_plain(*qkv, key_mask, scale, causal=causal), qkv, do)
        for name, a, w in zip(("dq", "dk", "dv"), g_fn, g_plain):
            assert_flash_close(a, w, f"Function {name} vs autograd of the plain forward")
        del g_plain
    del again, g_fn, qkv
    line = {"phase": phase, "where": where, "shape_bthd": list(shape), "causal": causal,
            "dtype": str(dtype).replace("torch.", ""),
            "key_lens": lens if b <= 4 else {"min": min(lens), "max": max(lens),
                                             "mean": float(np.mean(lens))},
            "errors": errs, "tol": KERNEL_TOL,
            "bit_identical_across_two_runs": True, "forward_unchanged_by_lse": True,
            "function_launches_the_kernels": True, "function_vs_autograd_of_plain": not bf16}
    if bf16:
        line.update(rtol=FLASH_BF16_RTOL, atol_rel_to_row_largest=FLASH_BF16_ROW_ATOL,
                    rel_l2_tol=FLASH_BF16_L2_TOL)
    else:
        line.update(rtol=FLASH_BWD_RTOL, atol_rel_to_largest=FLASH_BWD_ATOL_REL)
    case = {"errors": errs}
    if timed:
        if causal and key_mask is not None:
            raise AssertionError("the timed causal case has no padding mask: "
                                 "SDPA(is_causal) takes none")
        delta = (out.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
        # the one PyTorch call that computes the same function: SDPA with
        # is_causal or the segment mask, and its autograd (a yardstick only;
        # the port never calls it); its backward gives dq, dk and dv together
        qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_(True) for z in (q, k, v))
        if causal:
            how, library_call = {"is_causal": True}, "is_causal=True"
        else:
            how = {"attn_mask": key_mask[:, None, :, None] == key_mask[:, None, None, :]}
            library_call = "attn_mask=segment mask"
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, **how)
        lib_do = do.transpose(1, 2)
        lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)
        for name, a, w in zip(("o", "dq", "dk", "dv"), (lib_out, *lib_grads), (out_p, *want)):
            a = a.transpose(1, 2).contiguous()
            if not bf16:
                assert_flash_close(a, w, f"SDPA {name}")
            elif _rel_l2(a, w) > FLASH_LIBRARY_BF16_L2_TOL:
                raise AssertionError(f"SDPA {name} is {_rel_l2(a, w)} (relative L2) from the "
                                     f"plain version")

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, scale=scale, **how)

        def bwd(**kwargs):
            return fa.flash_self_attention_bwd(*args, causal=causal, **kwargs)

        times = {
            "dkv_ms": _time_ms(lambda: bwd(need_dq=False, delta=delta)),
            "dq_ms": _time_ms(lambda: bwd(need_dkv=False, delta=delta)),
            "delta_ms": _time_ms(
                lambda: (out.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()),
            # delta, dkv and dq as a training step's backward calls them
            "backward_ms": _time_ms(bwd),
            # the plain backward gives all three gradients at once
            "backward_plain_ms": _time_ms(lambda: fa.flash_self_attention_bwd_plain(
                q, k, v, key_mask, scale, out_p, lse_p, do, causal), reps=5),
            "backward_library_ms": _time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), lib_do, retain_graph=True)),
            "fwd_ms": _time_ms(lambda: fa.flash_self_attention(q, k, v, key_mask, scale,
                                                               causal=causal)),
            "fwd_with_lse_ms": _time_ms(lambda: fa.flash_self_attention(
                q, k, v, key_mask, scale, return_lse=True, causal=causal)),
            "fwd_plain_ms": _time_ms(lambda: fa.flash_self_attention_plain(
                q, k, v, key_mask, scale, True, causal), reps=5),
            "fwd_library_ms": _time_ms(lib_fwd),
        }
        # what this data needs: a query sees the keys of its segment, and with
        # `causal` those at or before it, so n^2 or n (n + 1) / 2 pairs for a
        # segment of n.  A bf16 element is two bytes and its products are held
        # against the tensor cores' dense bf16 peak.  In fp32 every product is
        # three TF32 products, held against the dense TF32 rate over three,
        # with the FMA pipe's bounds beside (`bounds_fp32_fma`).
        pairs = float(sum(n * (n + 1) // 2 if causal else n * n
                          for valid in lens for n in (valid, t - valid)))
        peak = BF16_FLOPS if bf16 else TF32_FLOPS / 3
        bounds = _flash_bounds(pairs, shape, 2.0 if bf16 else 4.0, peak)
        if not bf16:
            case["bounds_fp32_fma"] = _flash_bounds(pairs, shape, 4.0, FP32_FLOPS)
            line["bounds_fp32_fma"] = case["bounds_fp32_fma"]
        line.update(times, bounds=bounds, visible_pairs_per_head=pairs, peak_flops=peak,
                    achieved_tflops={"fwd": 4.0 * pairs * h * d / times["fwd_with_lse_ms"] / 1e9,
                                     "dkv": 8.0 * pairs * h * d / times["dkv_ms"] / 1e9,
                                     "dq": 6.0 * pairs * h * d / times["dq_ms"] / 1e9},
                    library_call=f"F.scaled_dot_product_attention({library_call}) and its "
                                 f"autograd: dq, dk, dv together")
        case.update(times=times, bounds=bounds)
    _emit(line)
    return case


def _key_mask(lens, t: int, device) -> Optional[torch.Tensor]:
    """[B, T] bool, True on the first `lens[b]` positions; None for None."""
    if lens is None:
        return None
    return torch.arange(t, device=device)[None, :] < torch.tensor(lens, device=device)[:, None]


def phase_kernel_flash_bwd(device: torch.device) -> dict:
    """K5-bwd (dK/dV kernel, dQ kernel) and the forward's log-sum-exp against
    the plain versions at small ragged shapes and at two shapes longer than
    the training phase's own, in fp32 and in bf16; returns the worst error
    per result (fp32 under "max_abs_err") and the bf16 times."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    gen16 = torch.Generator(device=device).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED)
    cases = [(*case, False, "small ragged shape") for case in FLASH_BWD_SMALL]
    for b, t, h, d in FLASH_LONG_SHAPES:
        lens = rng.integers(int(0.4 * t), t + 1, b)
        lens[0] = t  # one utterance fills the bucket
        cases.append((b, t, h, d, [int(n) for n in lens], True,
                      "batch 32 of utterances up to 20 s; not on the path of train_fastpitch"))
    worst, worst_bf16, bf16_times = {}, {}, {}
    for b, t, h, d, lens, timed, where in cases:
        case = _flash_case(gen, (b, t, h, d), _key_mask(lens, t, device), timed, where)
        for name, e in case["errors"].items():
            worst[name] = max(worst.get(name, 0.0), e["max_abs_err"])
        # the bf16 form of the same shapes: the tensor-core forward, dK/dV
        # and dQ kernels under ragged segment masks
        case = _flash_case(gen16, (b, t, h, d), _key_mask(lens, t, device), timed, where,
                           dtype=torch.bfloat16)
        for name, e in case["errors"].items():
            worst_bf16[name] = max(worst_bf16.get(name, 0.0), e["max_abs_err"])
        if timed:
            bf16_times[str((b, t, h, d))] = {**case["times"], **{
                k: v["bound_ms"] for k, v in case["bounds"].items()}}
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "bfloat16": {"max_abs_err": worst_bf16, "times": bf16_times}}


def phase_kernel_flash_causal(device: torch.device) -> dict:
    """K5-causal (forward, dK/dV, dQ) against the plain versions in fp32 and
    bf16 at small shapes, and at the GPT path's shape with the times; returns
    the worst error per result and type, and the path shape's times."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst, path = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        cases = [(c[:4], c[4], False, "small shape") for c in FLASH_CAUSAL_SMALL]
        cases.append((GPT_FLASH_SHAPE, None, True,
                      "one layer of train_gpt: tiny-llama-1.1b, one sequence of 4096"))
        for shape, lens, timed, where in cases:
            case = _flash_case(gen, shape, _key_mask(lens, shape[1], device), timed, where,
                               "kernel_flash_causal", causal=True, dtype=dtype)
            for key, e in case["errors"].items():
                slot = worst.setdefault(name, {})
                slot[key] = max(slot.get(key, 0.0), e["max_abs_err"])
            if timed:
                path[name] = case
            torch.cuda.empty_cache()
    return {"max_abs_err": worst, "path": path}


class _PlainFlash:
    """While active, the flash-attention wrappers take their plain versions
    whatever the device."""

    def __enter__(self):
        from roar_tpu_torch.kernels import flash_attention as fa

        self.saved = (fa.flash_self_attention, fa.flash_self_attention_bwd)

        def bwd(q, k, v, key_mask, scale, o, lse, do, need_dq=True, need_dkv=True, delta=None,
                causal=False):
            return fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do, causal)

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


def _longest_tts_batch(cfg: dict, tokenizer, device: torch.device) -> dict:
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
                          narrow: bool = False, precision=32) -> dict:
    """FastPitch training with learned alignment: sup-data extraction, then
    the training CLI's `run`; returns the flash-attention launch counts of
    that run.  With `precision="bf16"` (phase `train_fastpitch_bf16`, the
    YAML's own precision) every launch is a bf16 one, and the kernel step is
    held to the plain step at the bf16 step's bars; a hard alignment that MAS
    flips between the two paths is counted, then fed from the kernel path to
    the plain path before the rest is compared."""
    import copy

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "examples", "tts"))
    sys.path.insert(0, os.path.join(here, "scripts", "dataset_processing", "tts"))
    import extract_sup_data_torch as sup_cli
    import fastpitch_torch as cli

    from roar_tpu_torch.data.audio import write_wav
    from roar_tpu_torch.data.manifest import write_manifest
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.models import fastpitch as fastpitch_mod
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel, make_tokenizer
    from roar_tpu_torch.models.hifigan_model import vocoder_from_config
    from roar_tpu_torch.serving import SynthesisEngine
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.optim import noam_annealing
    from roar_tpu_torch.training.save_restore import restore_from

    on_card = device.type == "cuda"
    bf16 = precision != 32
    phase = "train_fastpitch_bf16" if bf16 else "train_fastpitch"

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
                stats["pitch_std"], str(device), steps, batch_size, precision)
            if narrow:
                _narrow_fastpitch(cfg)
            steps_per_epoch = n_utterances // batch_size
            # an epoch that ends before the last step is followed by validation
            val_epochs = -(-steps // steps_per_epoch) - 1
            val_batches = val_epochs * (min(batch_size, len(entries)) // batch_size)

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            t0 = time.perf_counter()
            state = cli.run(cfg)
            sync()
            wall = time.perf_counter() - t0
            launches = {k: fa.LAUNCHES[k] for k in ("fwd", "dkv", "dq")}
            launches_bf16 = {k: fa.LAUNCHES_BF16[k] for k in ("fwd", "dkv", "dq")}
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
            # bf16: the trainer's validation computes in bf16 too, as the JAX
            # package's evaluation does
            if on_card and (launches != want
                            or launches_bf16 != (want if bf16 else dict.fromkeys(want, 0))):
                raise AssertionError(f"flash launches {launches} (bf16 {launches_bf16}) != "
                                     f"{want}: an attention layer went round its kernel, "
                                     f"validation ran a backward, or a step ran in the wrong type")

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
            _emit({"phase": phase, "step": "cli", "card": card, "steps": steps,
                   "precision": precision, "flash_launches_bf16": launches_bf16,
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
            batch = _longest_tts_batch(cfg, model.tokenizer, device)
            if bf16:  # the trainer's batch: floating tensors in bf16
                batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                         for k, v in batch.items()}
            epoch = 50  # half of the bin-loss warm-up: every term carries weight

            def one_step(m):
                m.set_dropout_generator(torch.Generator(device=device).manual_seed(7))
                m.module.train()
                m.module.zero_grad(set_to_none=True)
                seen = {}
                hook = m.module.register_forward_hook(
                    lambda mod, args, out: seen.update(durs=out["attn_hard_dur"],
                                                       hard=out["attn_hard"]))
                try:
                    loss, metrics = m.loss_fn(batch, epoch)
                finally:
                    hook.remove()
                loss.backward()
                sync()
                return {k: float(v) for k, v in metrics.items()}, seen

            twin = copy.deepcopy(model)
            spare = copy.deepcopy(model) if bf16 else None
            before = fa.LAUNCHES.copy()
            # what this step hands the attention kernels: shape -> key mask
            given, forward = {}, fa.flash_self_attention

            def noting(q, k, v, key_mask, scale, **kwargs):
                given.setdefault(tuple(q.shape), key_mask)
                return forward(q, k, v, key_mask, scale, **kwargs)

            fa.flash_self_attention = noting
            try:
                metrics_k, seen_k = one_step(model)
            finally:
                fa.flash_self_attention = forward
            step_launches = dict(fa.LAUNCHES - before)
            if on_card and step_launches != dict.fromkeys(("fwd", "dkv", "dq"), n_attn):
                raise AssertionError(f"one step launched {step_launches}, not {n_attn} of each")
            with _PlainFlash():
                metrics_p, seen_p = one_step(twin)
            frames_apart = int((seen_k["hard"] != seen_p["hard"]).any(-1).sum())
            if bf16 and frames_apart:
                # MAS took another path on a near-tie of bf16 scores: the plain
                # path again, fed the kernel path's hard alignment
                hard, mas = seen_k["hard"], fastpitch_mod.binarize_attention
                fastpitch_mod.binarize_attention = lambda *args: hard
                try:
                    with _PlainFlash():
                        twin = spare
                        metrics_p, seen_p = one_step(twin)
                finally:
                    fastpitch_mod.binarize_attention = mas
            del spare
            durs_k, durs_p = seen_k["durs"], seen_p["durs"]
            loss_rtol = BF16_STEP_LOSS_RTOL if bf16 else FP_TRAIN_LOSS_RTOL
            for k in FP_LOSS_TERMS:
                if not _loss_close(metrics_k[k], metrics_p[k], loss_rtol):
                    raise AssertionError(f"{k}: kernels {metrics_k[k]} vs plain {metrics_p[k]}")
            if not torch.equal(durs_k, durs_p):
                raise AssertionError("hard alignments differ between the kernel and plain paths")
            if not torch.equal(durs_k.sum(1).long(), batch["mel_len"].long()):
                raise AssertionError(f"hard durations sum to {durs_k.sum(1).tolist()}, mel lengths "
                                     f"are {batch['mel_len'].tolist()}")
            # bf16: the whole gradient is held; each tensor's error is reported
            grads = _grad_errors(
                [(name, pk, pp) for (name, pk), (_, pp) in zip(model.module.named_parameters(),
                                                               twin.module.named_parameters())],
                float("inf") if bf16 else FP_TRAIN_TENSOR_L2_TOL)
            if grads["failures"]:
                raise AssertionError(grads["failures"][0])
            whole_l2 = grads["whole_l2"]
            whole_tol = BF16_STEP_GRAD_L2_TOL if bf16 else FP_TRAIN_GRAD_L2_TOL
            if whole_l2 > whole_tol:
                raise AssertionError(f"the whole gradient differs between kernel path and plain "
                                     f"path by {whole_l2} (L2, relative)")
            _emit({"phase": phase, "step": "kernel_path_vs_plain_path", "epoch": epoch,
                   "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
                   "kernels": metrics_k, "plain": metrics_p, "loss_rtol": loss_rtol,
                   "whole_grad_l2_rel_err": whole_l2, "grad_l2_tol": whole_tol,
                   "max_grad_l2_rel_err": grads["worst_l2"][0],
                   "tensor_l2_tol": None if bf16 else FP_TRAIN_TENSOR_L2_TOL,
                   "worst_gradient_tensor": grads["worst_l2"][1],
                   "mas_frames_apart_before_feeding": frames_apart, "hard_durations_equal": True,
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
                for shape, key_mask in sorted(given.items()):
                    t = shape[1]
                    flash[t] = _flash_case(
                        gen, shape, key_mask, True,
                        f"the longest batch of {phase}, its own key lengths", phase=phase,
                        dtype=torch.bfloat16 if bf16 else torch.float32)

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
            _emit({"phase": phase, "step": "bundle",
                   "bundle_bytes": os.path.getsize(path),
                   "parameters_equal_trained": True, "mel_shape": list(mel.shape),
                   "mel_frames": int(n_frames[0]), "served_samples": int(wave.size)})

            result = {"launches": launches}
            if bf16:
                result.update(launches_bf16=launches_bf16, mas_frames_apart=frames_apart)
            if on_card:
                result["flash"] = flash
                result["timing"] = _time_fastpitch_step(model, batch, cfg, card, phase)
            return result
    finally:
        torch.backends.cudnn.benchmark = benchmark_was


def _timed(spans: list, fn):
    """`fn` with a pair of CUDA events around every call, appended to `spans`."""
    def call(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out
    return call


def _time_fastpitch_step(model, batch, cfg: dict, card: str,
                         phase: str = "train_fastpitch") -> dict:
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

    inside, calls = _time_inside({"flash_fwd": (fa, "flash_self_attention"),
                                  "flash_bwd": (fa, "flash_self_attention_bwd"),
                                  "forward_sum": (fpm, "forward_sum_loss")},
                                 lambda: train_step(state, batch, 0))
    step_ms = float(np.median(totals))
    split = {p: float(np.median(v)) for p, v in splits.items()}
    split["mel_projection"] = split.pop("model_forward")
    timing = {"phase": phase, "step": "timing", "card": card,
              "batch_shapes": {k: list(batch[k].shape) for k in ("text", "audio", "pitch")},
              "step_ms": step_ms, "step_ms_all": totals, "split_ms": split,
              "forward_sum_forward_ms": inside["forward_sum"],
              "flash_ms_per_step": {"fwd": inside["flash_fwd"],
                                    "bwd_delta_dkv_dq": inside["flash_bwd"]},
              "flash_calls_per_step": calls,
              "flash_share_of_step": (inside["flash_fwd"] + inside["flash_bwd"]) / step_ms,
              "peak_device_memory_bytes": peak,
              "method": "CUDA events; median of 5 steps after 2 warm steps; TF32 off; batch "
                        "already on the card; `losses` holds the forward of forward-sum, "
                        "`backward` its backward"}
    _emit(timing)
    return timing


# one JETS D+G step with the kernels against one with their plain versions:
# same weights, batch, segment starts and dropout masks, fp32, TF32 off.  Every
# loss term is held to rtol 1e-4 (phases 6 and 8), each gradient tensor to
# phase 6's bars (relative L2 TRAIN_GRAD_L2_TOL, largest difference
# TRAIN_GRAD_MAX_TOL), the whole gradient of each part to phase 8's
# FP_TRAIN_GRAD_L2_TOL.  The hard alignment must be the same on both paths:
# the aligner reads the encoder output, which passed through six attention
# layers, and a flipped MAS decision would change every later gradient
JETS_G_TERMS = ("g_mel_loss", "dur_loss", "pitch_loss", "energy_loss", "ctc_loss", "bin_loss",
                "g_fm_loss", "g_adv_loss")
JETS_LOSS_TERMS = ("d_loss", "g_loss", "d_loss_mpd", "d_loss_msd") + JETS_G_TERMS
# synthesis from the bundle, kernel path against plain path: twelve fp32
# attention layers (the kernels' 3xTF32 sums against cuBLAS fp32) held at
# MEL_TOL in phase 4, then the generator's 22 convs over 384 to 32 channels and
# tanh.  The bar is the largest difference over the valid samples relative to
# the plain path's RMS there: an H100 read 1.2e-5 to 1.9e-5 of an RMS of
# 0.044 at batch 1 and 8.  The same call with the key mask dropped (every
# padding key visible) must move the audio by more than JETS_WAV_PLANTED_MIN
# times the bar, so the bar is known to see a masking fault at these shapes
# (it read 3.6 to 4.4 times the RMS)
JETS_WAV_REL_TOL = 1e-4
JETS_WAV_PLANTED_MIN = 10.0
def _zero_launch_counts() -> None:
    """Every flash-attention and grouped-conv launch count to 0."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.kernels import grouped_conv as gk

    fa.LAUNCHES.clear()
    fa.LAUNCHES_BF16.clear()
    for name in ("FWD", "DX", "DW"):
        setattr(gk, f"LAUNCHES_{name}", 0)
        setattr(gk, f"LAUNCHES_{name}_BF16", 0)


def _launch_counts() -> tuple:
    """(all launches, the bf16 ones) of the non-causal flash kernels and of
    K3/K4 since `_zero_launch_counts`."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.kernels import grouped_conv as gk

    names = {"grouped_conv_fwd": "FWD", "grouped_conv_dx": "DX", "grouped_conv_dw": "DW"}
    bf16 = {**{k: fa.LAUNCHES_BF16[k] for k in ("fwd", "dkv", "dq")},
            **{k: getattr(gk, f"LAUNCHES_{n}_BF16") for k, n in names.items()}}
    every = {**{k: fa.LAUNCHES[k] for k in ("fwd", "dkv", "dq")},
             **{k: getattr(gk, f"LAUNCHES_{n}") + bf16[k] for k, n in names.items()}}
    return every, bf16


def _narrow_jets(cfg: dict) -> None:
    """Shrink a JETS training config to a rehearsal width, in place: d 32,
    2 + 2 layers of two heads of 16, predictors 16 wide, a generator from 32
    channels (still upsampling 256), debug discriminators, 16-frame segments."""
    model = cfg["model"]
    model.update(symbols_embedding_dim=32, segment_size=16, debug=True)
    for fft in ("input_fft", "output_fft"):
        model[fft].update(n_layer=2, d_model=32, d_head=16, n_head=2, d_inner=48)
    for predictor in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        model[predictor].update(input_size=32, filter_size=16)
    model["alignment_module"]["n_text_channels"] = 32
    model["speaker_encoder"]["lookup_module"]["embedding_dim"] = 32
    model["waveform_generator"].update(upsample_initial_channel=32, initial_input_size=32,
                                       resblock_kernel_sizes=[3],
                                       resblock_dilation_sizes=[[1, 3]])


def phase_train_jets(device: torch.device, card: str = "", n_utterances: int = 64,
                     n_val: int = 16, steps: int = 8, batch_size: int = 16,
                     max_seconds: float = 10.0, narrow: bool = False, precision=32) -> dict:
    """JETS training: sup-data extraction at the model's STFT, then the
    training CLI's `run`; the kernel step against the plain step; the
    `.roar` loaded and synthesised from.  Returns the launch counts of that
    run (K1/K2 of the extraction, K3/K4/K5 of the training), the synthesis
    numbers and, on the card, the flash kernels held at the step's two shapes
    and the step's timing.

    `precision="bf16-mixed"` (phase `train_jets_bf16`) trains at the YAML's
    own precision: the steps launch the bf16 K3/K4/K5 kernels (validation
    stays fp32, as the JAX runner's), the kernel step is held to the plain
    step at the bf16 bars (BF16_STEP_*), and a hard alignment that MAS flips
    between the two paths is counted, then fed from the kernel path to the
    plain path before the rest is compared."""
    import copy

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "examples", "tts"))
    sys.path.insert(0, os.path.join(here, "scripts", "dataset_processing", "tts"))
    import extract_sup_data_torch as sup_cli
    import jets_torch as cli

    from roar_tpu_torch.data.audio import write_wav
    from roar_tpu_torch.data.manifest import write_manifest
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.kernels import grouped_conv as gk
    from roar_tpu_torch.kernels import pyin_viterbi as pv
    from roar_tpu_torch.models import jets as jets_mod
    from roar_tpu_torch.models.fastpitch_model import make_tokenizer
    from roar_tpu_torch.models.hifigan import SpectralNormConv
    from roar_tpu_torch.models.jets_model import JETSModel
    from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
    from roar_tpu_torch.training.optim import build_optimizer, get_schedule

    on_card = device.type == "cuda"
    bf16 = precision != 32
    phase = "train_jets_bf16" if bf16 else "train_jets"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 3)
    tokenizer = make_tokenizer({"_target_": "roar_tpu.data.tokenizers.BengaliCharsTokenizer",
                                "punct": True, "apostrophe": True, "pad_with_space": True})
    n_tokens = [len(tokenizer(s)) for s in BENGALI_SENTENCES]
    benchmark_was = torch.backends.cudnn.benchmark
    # training meets a new conv shape per bucket: no autotuning of each
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav_dir = os.path.join(tmp, "wavs")
            os.makedirs(wav_dir)
            total = n_utterances + n_val
            seconds = rng.uniform(min(2.0, max_seconds / 2), max_seconds, total)
            seconds[0] = max_seconds
            entries = []
            for i, sec in enumerate(seconds):
                audio = synth_utterance(rng, float(sec))[0]
                frames = len(audio) // JETS_HOP + 1
                # a text its mel can hold: at least two frames per token
                fits = [j for j, n in enumerate(n_tokens) if 2 * n <= frames]
                if not fits:
                    raise AssertionError(f"no sentence fits {frames} mel frames")
                path = os.path.join(wav_dir, f"utt{i:03d}.wav")
                write_wav(path, audio, SUP_SAMPLE_RATE)
                entries.append({"audio_filepath": path, "duration": len(audio) / SUP_SAMPLE_RATE,
                                "text": BENGALI_SENTENCES[fits[int(rng.integers(len(fits)))]],
                                "speaker_id": i % 4})
            manifest = os.path.join(tmp, "train_manifest.json")
            val_manifest = os.path.join(tmp, "val_manifest.json")
            all_manifest = os.path.join(tmp, "all_manifest.json")
            write_manifest(manifest, entries[:n_utterances])
            write_manifest(val_manifest, entries[n_utterances:])
            write_manifest(all_manifest, entries)

            # stage 1 feeds stage 2: pitch, energy and the prior's lengths come
            # from this cache, at the model's hop of 256
            sup_dir = os.path.join(tmp, "sup")
            sup_cfg = jets_sup_data_config(all_manifest, sup_dir, str(device))
            pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK = 0, 0
            stats = sup_cli.run(sup_cfg)
            sync()
            sup_launches = {"fwd": pv.LAUNCHES_FWD, "backtrack": pv.LAUNCHES_BACKTRACK}
            n_buckets = -(-total // sup_cfg["batch_size"])
            if on_card and sup_launches != {"fwd": n_buckets, "backtrack": n_buckets}:
                raise AssertionError(f"{sup_launches} Viterbi launches for {n_buckets} buckets")
            cfg = jets_train_config(
                manifest, val_manifest, sup_dir, os.path.join(tmp, "exp"), stats["pitch_mean"],
                stats["pitch_std"], str(device), steps, batch_size, precision)
            if narrow:
                _narrow_jets(cfg)
            steps_per_epoch = n_utterances // batch_size
            epochs = -(-steps // steps_per_epoch)
            # validation follows every epoch, the last one too
            val_batches = epochs * (n_val // batch_size)

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            t0 = time.perf_counter()
            state = cli.run(cfg)
            sync()
            wall = time.perf_counter() - t0
            launches, launches_bf16 = _launch_counts()
            peak = torch.cuda.max_memory_allocated() if on_card else None
            model = state.model
            module = model.module
            n_attn = len(module.encoder_module.stack.layers) + len(module.decoder_module.layers)
            n_grouped = sum(1 for m in model.msd.modules() if getattr(m, "groups", 1) > 1)
            # a step: every attention layer forward, dK/dV and dQ once; each
            # grouped conv forward and dX in the D pass and in the G pass, dW
            # in the D pass only; a validation batch: the forwards of the
            # generator graph and of the G pass's discriminators
            want = {"fwd": n_attn * (steps + val_batches), "dkv": n_attn * steps,
                    "dq": n_attn * steps,
                    "grouped_conv_fwd": n_grouped * (2 * steps + val_batches),
                    "grouped_conv_dx": 2 * n_grouped * steps, "grouped_conv_dw": n_grouped * steps}
            # under bf16 every launch of the steps is a bf16 one, validation's fp32
            want_bf16 = ({**want, "fwd": n_attn * steps, "grouped_conv_fwd": 2 * n_grouped * steps}
                         if bf16 else dict.fromkeys(want, 0))
            if state.step != steps or n_attn != (4 if narrow else 12) or n_grouped != 15:
                raise AssertionError(f"{state.step} steps, {n_attn} attention layers, "
                                     f"{n_grouped} grouped convs")
            if model.attention_paths() != {"input_fft": "flash", "output_fft": "flash"}:
                raise AssertionError(f"attention paths {model.attention_paths()}")
            if model.compute_dtype != (torch.bfloat16 if bf16 else None):
                raise AssertionError(f"the run trained in {model.compute_dtype}, not {precision}")
            if on_card and (launches != want or launches_bf16 != want_bf16):
                raise AssertionError(f"launches {launches} (bf16 {launches_bf16}) != {want} "
                                     f"(bf16 {want_bf16}): a layer went round its kernel, K4 ran "
                                     f"in the G pass, validation ran a backward, or a step ran "
                                     f"in the wrong type")

            root = os.path.join(tmp, "exp", "JETS")
            with open(os.path.join(root, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f if line.strip()]
            train = [r for r in records if "d_loss" in r]
            val = [r for r in records if "val_g_mel_loss" in r]
            if [r["step"] for r in train] != list(range(1, steps + 1)):
                raise AssertionError(f"logged steps {[r['step'] for r in train]}")
            for r in train:
                bad = [k for k in JETS_LOSS_TERMS if not np.isfinite(r.get(k, np.nan))]
                if bad:
                    raise AssertionError(f"step {r['step']}: {bad} missing or not finite")
            if any(r["bin_loss"] != 0.0 for r in train[:steps_per_epoch]) or \
                    any(r["bin_loss"] == 0.0 for r in train[steps_per_epoch:]):
                raise AssertionError("bin_loss does not follow the epoch's warm-up weight")
            if len(val) != epochs or not all(np.isfinite(r[f"val_{k}"]) for r in val
                                              for k in JETS_G_TERMS):
                raise AssertionError(f"validation records {val}")
            sched = cfg["model"]["optim"]["sched"]
            schedule = get_schedule(sched["name"], cfg["model"]["optim"]["lr"],
                                    max_steps=cfg["model"]["max_steps"], min_lr=sched["min_lr"],
                                    warmup_ratio=sched["warmup_ratio"])
            lrs = [r["lr"] for r in train]
            if not np.allclose(lrs, [schedule(i) for i in range(steps)], rtol=1e-9, atol=0.0):
                raise AssertionError(f"learning rates {lrs} are not the schedule's")
            # the spectral norm of scale 0 stored a new u and sigma
            fresh = JETSModel(cfg["model"], generator=torch.Generator().manual_seed(0))
            moved = [not torch.equal(m.u.cpu(), m0.u) and float(m.sigma) != 1.0
                     and bool(torch.isfinite(m.u).all())
                     for m, m0 in zip(model.msd.modules(), fresh.msd.modules())
                     if isinstance(m, SpectralNormConv)]
            if len(moved) != 8 or not all(moved):
                raise AssertionError(f"spectral-norm stats of scale 0 not updated: {moved}")
            del fresh
            _emit({"phase": phase, "step": "cli", "card": card, "steps": steps,
                   "precision": precision, "launches_bf16": launches_bf16,
                   "batch": batch_size, "utterances": n_utterances, "validation_utterances": n_val,
                   "seconds_of_audio": float(seconds[:n_utterances].sum()),
                   "sup_data": {**{k: stats[k] for k in ("pitch_mean", "pitch_std",
                                                         "mel_frames", "seconds")},
                                "hop_length": JETS_HOP, "viterbi_launches": sup_launches},
                   "launches": launches, "attention_layers": n_attn, "grouped_convs": n_grouped,
                   "per_step": {"flash_dkv": launches["dkv"] // steps,
                                "flash_dq": launches["dq"] // steps,
                                "grouped_conv_dx": launches["grouped_conv_dx"] // steps,
                                "grouped_conv_dw": launches["grouped_conv_dw"] // steps},
                   "validation_batches": val_batches,
                   "losses_first": {k: train[0][k] for k in JETS_LOSS_TERMS},
                   "losses_last": {k: train[-1][k] for k in JETS_LOSS_TERMS},
                   "val": {k: v for k, v in val[-1].items() if k.startswith("val_")},
                   "lr": lrs, "spectral_norm_convs_updated": len(moved), "wall_s": wall,
                   "wall_includes": "model build, WAV and cache reads, logging every step (a "
                                    "sync each), two validation batches, checkpoints, bundle",
                   "peak_device_memory_bytes": peak})

            synth = _jets_bundle_synthesis(state, root, device, n_attn,
                                           max_mel_len=128 if narrow else 1024, phase=phase)

            # one D+G step, kernels against plain versions: same weights, batch,
            # segment starts and dropout masks
            batch = _longest_tts_batch(cfg, model.tokenizer, device)
            epoch = 50  # half of the bin-loss warm-up: every term carries weight
            optim_cfg = {"name": "adamw", "lr": TRAIN_LR, "betas": [0.8, 0.99]}

            def one_step(m):
                m.set_dropout_generator(torch.Generator(device=device).manual_seed(7))
                st = GANTrainState(model=m, g_opt=build_optimizer(m.g_parameters(), optim_cfg),
                                   d_opt=build_optimizer(m.d_parameters(), optim_cfg))
                seen, forward = {}, m.forward_split

                def noting(b, e):
                    seen.update(forward(b, e))
                    return seen

                m.forward_split = noting
                try:
                    _, metrics = gan_train_step(st, batch, epoch=epoch)
                finally:
                    del m.forward_split
                sync()
                return {k: float(v) for k, v in metrics.items()}, seen

            model.set_dropout_generator(None)  # the generators stay out of the copy
            twin = copy.deepcopy(model)
            # bf16: a second plain copy, for a rerun if MAS parts the paths, and
            # one that takes the plain step in fp32 (bf16's own effect)
            spare = copy.deepcopy(model) if bf16 else None
            ref32 = copy.deepcopy(model) if bf16 else None
            before = fa.LAUNCHES.copy()
            before_bf16 = fa.LAUNCHES_BF16.copy()
            # what this step hands the attention kernels: shape -> key mask
            given, flash_forward = {}, fa.flash_self_attention

            def noting_flash(q, k, v, key_mask, scale, **kwargs):
                given.setdefault(tuple(q.shape), key_mask)
                return flash_forward(q, k, v, key_mask, scale, **kwargs)

            fa.flash_self_attention = noting_flash
            try:
                metrics_k, out_k = one_step(model)
            finally:
                fa.flash_self_attention = flash_forward
            step_launches = dict(fa.LAUNCHES - before)
            step_bf16 = dict(fa.LAUNCHES_BF16 - before_bf16)
            if on_card and (step_launches != dict.fromkeys(("fwd", "dkv", "dq"), n_attn)
                            or step_bf16 != (step_launches if bf16 else {})):
                raise AssertionError(f"one step launched {step_launches} (bf16 {step_bf16}), not "
                                     f"{n_attn} of each")
            with _PlainFlash(), _PlainGroupedConv():
                metrics_p, out_p = one_step(twin)
            frames_apart = int((out_k["attn_hard"] != out_p["attn_hard"]).any(-1).sum())
            if bf16 and frames_apart:
                # MAS took another path on a near-tie of bf16 scores: the plain
                # path again, fed the kernel path's hard alignment
                hard, mas = out_k["attn_hard"], jets_mod.binarize_attention
                jets_mod.binarize_attention = lambda *args: hard
                try:
                    with _PlainFlash(), _PlainGroupedConv():
                        twin = spare
                        metrics_p, out_p = one_step(twin)
                finally:
                    jets_mod.binarize_attention = mas
            del spare
            if bf16:
                # the plain step in fp32 on the kernel step's hard alignment
                ref32.set_compute_dtype(None)
                hard, mas = out_k["attn_hard"], jets_mod.binarize_attention
                jets_mod.binarize_attention = lambda *args: hard
                try:
                    with _PlainFlash(), _PlainGroupedConv():
                        one_step(ref32)
                finally:
                    jets_mod.binarize_attention = mas
            durs = out_k["attn_hard_dur"]
            if not torch.equal(durs.sum(1).long(), out_k["mel_lens"].long()):
                raise AssertionError(f"hard durations sum to {durs.sum(1).tolist()}, mel lengths "
                                     f"are {out_k['mel_lens'].tolist()}")
            z = out_k["z_start_idxs"].long()
            if not bool(((z >= 0) & (z + model.segment_size <= out_k["mel_lens"])
                         | ((z == 0) & (out_k["mel_lens"] < model.segment_size))).all()):
                raise AssertionError(f"segment starts {z.tolist()} outside the valid frames "
                                     f"{out_k['mel_lens'].tolist()}")
            for k in ("attn_hard", "z_start_idxs", "num_frames"):
                if not torch.equal(out_k[k], out_p[k]):
                    raise AssertionError(f"{k} differs between the kernel and plain paths")
            loss_rtol = BF16_STEP_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
            failures = [f"{k}: kernels {metrics_k[k]} vs plain {metrics_p[k]}"
                        for k in JETS_LOSS_TERMS
                        if not _loss_close(metrics_k[k], metrics_p[k], loss_rtol,
                                           bf16 and k in BF16_LOSS_TERMS)]
            def whole_l2(a, b, part):
                return _grad_errors([(n, pa, pb) for (n, pa), (_, pb) in zip(
                    getattr(a, part).named_parameters(), getattr(b, part).named_parameters())],
                    float("inf"))["whole_l2"]

            whole_tol = BF16_STEP_GRAD_L2_TOL if bf16 else FP_TRAIN_GRAD_L2_TOL
            grads, to_fp32 = {}, {}
            for part in ("module", "mpd", "msd"):
                pairs = [(f"{part}.{name}", pk, pp) for (name, pk), (_, pp) in zip(
                    getattr(model, part).named_parameters(), getattr(twin, part).named_parameters())]
                # bf16: the whole gradient is held; each tensor's error is reported
                grads[part] = (_grad_errors(pairs, float("inf")) if bf16 else
                               _grad_errors(pairs, TRAIN_GRAD_L2_TOL, TRAIN_GRAD_MAX_TOL))
                held = grads[part]["whole_l2"] <= whole_tol
                if bf16:
                    to_fp32[part] = {"kernel_bf16": whole_l2(model, ref32, part),
                                     "plain_bf16": whole_l2(twin, ref32, part)}
                    held = held or (to_fp32[part]["kernel_bf16"]
                                    <= BF16_TO_FP32_RATIO * to_fp32[part]["plain_bf16"])
                if not held:
                    failures.append(f"{part}: whole gradient differs by {grads[part]['whole_l2']}"
                                    + (f", from the fp32 step's by {to_fp32[part]}" if bf16
                                       else ""))
                failures += grads[part]["failures"]
            del ref32
            worst_l2 = max(g["worst_l2"] for g in grads.values())
            worst_top = max(g["worst_max"] for g in grads.values())
            _emit({"phase": phase, "step": "kernel_path_vs_plain_path", "epoch": epoch,
                   "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
                   "kernels": metrics_k, "plain": metrics_p, "loss_rtol": loss_rtol,
                   "bf16_terms_within_two_bf16_steps": sorted(BF16_LOSS_TERMS) if bf16 else [],
                   "whole_grad_l2_rel_err": {p: g["whole_l2"] for p, g in grads.items()},
                   "whole_grad_l2_tol": whole_tol,
                   "whole_grad_l2_to_plain_fp32_step": to_fp32,
                   "to_fp32_ratio_tol": BF16_TO_FP32_RATIO if bf16 else None,
                   "max_grad_l2_rel_err": worst_l2,
                   "grad_l2_tol": None if bf16 else TRAIN_GRAD_L2_TOL,
                   "max_grad_max_rel_err": worst_top,
                   "grad_max_tol": None if bf16 else TRAIN_GRAD_MAX_TOL,
                   "mas_frames_apart_before_feeding": frames_apart,
                   "hard_alignment_equal": True, "hard_durations_sum_to_mel_lens": True,
                   "z_start_idxs": z.tolist(), "mel_lens": out_k["mel_lens"].tolist(),
                   "failures": failures})
            if failures:
                raise AssertionError(f"kernel path vs plain path: {failures[:8]}")
            del twin, out_k, out_p

            # the attention kernels against their plain versions at the shapes
            # and key lengths that step gave them: the encoder's (text bucket)
            # and the decoder's (mel bucket)
            flash = {}
            if on_card:
                if len(given) != 2 or any(m is None for m in given.values()):
                    raise AssertionError(f"the step gave its attention {list(given)}")
                gen = torch.Generator(device=device).manual_seed(SEED)
                for shape, key_mask in sorted(given.items()):
                    flash[shape[1]] = _flash_case(
                        gen, shape, key_mask, True,
                        f"the longest batch of {phase}, its own key lengths", phase=phase,
                        dtype=torch.bfloat16 if bf16 else torch.float32)

            result = {"launches": launches, "sup_launches": sup_launches, "flash": flash,
                      "synthesis": synth}
            if bf16:
                result.update(launches_bf16=launches_bf16, mas_frames_apart=frames_apart)
            if on_card:
                # the runner's optimizers: the schedule and the clip
                model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
                opt_kwargs = dict(max_steps=cfg["model"]["max_steps"],
                                  gradient_clip_val=cfg["trainer"]["gradient_clip_val"])
                timing_state = GANTrainState(
                    model=model, g_opt=build_optimizer(model.g_parameters(),
                                                       cfg["model"]["optim"], **opt_kwargs),
                    d_opt=build_optimizer(model.d_parameters(), cfg["model"]["optim"],
                                          **opt_kwargs))
                # `flash_bwd` holds the delta reduction, dK/dV and dQ; `mas` the
                # device DP and its backtrack
                timed = {**{n: (gk, n) for n in _PlainGroupedConv.NAMES},
                         "flash_fwd": (fa, "flash_self_attention"),
                         "flash_bwd": (fa, "flash_self_attention_bwd"),
                         "mas": (jets_mod, "binarize_attention")}
                result["timing"] = _time_gan_step(timing_state, batch, card, phase, timed,
                                                  epoch=1)
            return result
    finally:
        torch.backends.cudnn.benchmark = benchmark_was


def _jets_bundle_synthesis(state, root: str, device: torch.device, n_attn: int,
                           max_mel_len: int = 1024, phase: str = "train_jets") -> dict:
    """The saved `.roar` loaded into a fresh JETSModel (its parameters the
    trained ones), then `convert_text_to_waveform` into a `max_mel_len`
    bucket on one Bengali text and on a batch of 8: the flash forwards per
    call, the samples per frame, and the kernel path's audio against the
    plain path's and against a planted masking fault.  Returns the synthesis
    numbers (wall time and real-time factor on the card)."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.models.jets_model import JETSModel
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.save_restore import restore_from

    on_card = device.type == "cuda"
    path = os.path.join(root, "checkpoints", "JETS.roar")
    bundle_cfg, tree = restore_from(path)
    served = JETSModel(bundle_cfg["model"])
    convert.load_jets_bundle(served.module, served.mpd, served.msd, tree)
    for part, trained in state.model.state_modules().items():
        for (name, a), (_, b) in zip(served.state_modules()[part].state_dict().items(),
                                     trained.state_dict().items()):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"bundle parameter {part}.{name} is not the trained one")
    served.to(device)
    hop = served.hop_length
    texts = {1: BENGALI_SENTENCES[2:3], 8: BENGALI_SENTENCES}
    synth = {"bundle_bytes": os.path.getsize(path), "parameters_equal_trained": True,
             "max_mel_len": max_mel_len, "wav_rel_tol": JETS_WAV_REL_TOL,
             "planted_min": JETS_WAV_PLANTED_MIN,
             "bar": "largest difference over the valid samples / RMS of the plain path's"}
    flash_forward = fa.flash_self_attention

    def unmasked(q, k, v, key_mask, scale, **kwargs):
        return flash_forward(q, k, v, None if key_mask is None else torch.ones_like(key_mask),
                             scale, **kwargs)

    for n, sentences in texts.items():
        ids = [served.parse(s)[0] for s in sentences]
        tokens = torch.zeros(n, max(len(t) for t in ids), dtype=torch.long)
        for j, t in enumerate(ids):
            tokens[j, :len(t)] = torch.from_numpy(t)
        tokens = tokens.to(device)
        speaker = torch.arange(n, device=device) % 4

        def call():
            return served.convert_text_to_waveform(tokens, speaker, max_mel_len=max_mel_len)

        before = fa.LAUNCHES["fwd"]
        wav, frames = call()
        if on_card:
            torch.cuda.synchronize()
            if fa.LAUNCHES["fwd"] - before != n_attn:
                raise AssertionError(f"{fa.LAUNCHES['fwd'] - before} flash forwards for one "
                                     f"synthesis call, not {n_attn}")
        with _PlainFlash():
            wav_p, frames_p = call()
        fa.flash_self_attention = unmasked
        try:
            wav_x, _ = call()
        finally:
            fa.flash_self_attention = flash_forward
        if tuple(wav.shape) != (n, max_mel_len * hop) or not torch.isfinite(wav).all():
            raise AssertionError(f"synthesised audio {tuple(wav.shape)} or not finite")
        if not torch.equal(frames, frames_p) or int(frames.max()) > max_mel_len \
                or int(frames.sum()) == 0:
            raise AssertionError(f"frames {frames.tolist()} (plain path {frames_p.tolist()})")
        lens = [int(f) * hop for f in frames]
        valid = torch.cat([wav_p[j, :m] for j, m in enumerate(lens)])
        rms = float(valid.square().mean().sqrt())
        err, planted = (max(float((w[j, :m] - wav_p[j, :m]).abs().max())
                            for j, m in enumerate(lens) if m) for w in (wav, wav_x))
        if not rms > 0.0 or err > JETS_WAV_REL_TOL * rms:
            raise AssertionError(f"batch {n}: kernel-path audio differs from the plain path's "
                                 f"by {err}, RMS {rms}, bar {JETS_WAV_REL_TOL} of the RMS")
        if on_card and planted <= JETS_WAV_PLANTED_MIN * JETS_WAV_REL_TOL * rms:
            raise AssertionError(f"batch {n}: dropping the key mask moves the audio by only "
                                 f"{planted / rms} of its RMS")
        line = {"batch": n, "num_frames": frames.tolist(), "samples": lens,
                "samples_per_frame": hop, "wav_rms": rms, "max_abs_err_vs_plain": err,
                "rel_err_vs_plain": err / rms, "planted_unmasked_rel_err": planted / rms}
        if on_card:
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            line.update(wall_s=wall, audio_s=sum(lens) / served.sample_rate,
                        real_time_factor=wall / (sum(lens) / served.sample_rate),
                        method="host wall clock around one call, synchronised; median of 3 "
                               "after one warm call; the whole bucket is vocoded")
        synth[f"batch_{n}"] = line
    _emit({"phase": phase, "step": "bundle_synthesis", **synth})
    return synth


# one micro-batch of the GPT step, kernels against plain versions, same weights
# and tokens.  fp32 (4 layers, full width, TF32 off): only the attention sums
# run in another order, so the loss is held to rtol 1e-4 and the whole gradient
# (|delta|_2 over |gradient|_2 across all tensors) to 1e-3.  bf16 (full depth):
# both paths round at the same places but sum in another order, and an output
# that lands on the other side of a bf16 rounding boundary moves by 2^-8 of its
# value; through 22 layers the loss (an fp32 mean over 4096 tokens, near
# log 32000 = 10.4 whatever the attention does, so it says little) is held to
# rtol 2e-3, and the whole gradient and the gradient of each layer's two
# attention projections (the tensors next to the kernels: a wrong tile, mask
# or product in one layer moves them by tenths) to 2e-2 each; an H100 read
# 3.9e-3 for the whole and 5.1e-3 for the worst projection (layer 0's qkv).
GPT_FP32_LOSS_RTOL = 1e-4
GPT_FP32_GRAD_L2_TOL = 1e-3
GPT_BF16_LOSS_RTOL = 2e-3
GPT_BF16_GRAD_L2_TOL = 2e-2
GPT_BF16_ATTN_TENSOR_L2_TOL = 2e-2
GPT_SCHEDULE_STEPS = 1000
GPT_NARROW = {"n_layer": 2, "n_embd": 64, "n_head": 4, "n_query_groups": 2,
              "intermediate_size": 96}


def gpt_train_config(train_file: str, val_file: str, exp_dir: str, device: str = "cuda",
                     seq_length: int = 4096, vocab_size: int = 32000) -> dict:
    """The config phase `train_gpt` trains at, as a dict: the model block
    holds `config_name` and only the overrides it means (any other GPTConfig
    field there would override tiny-llama's own), the optimizer, schedule,
    clip and logger blocks are those of configs/gpt_pretraining.yaml
    (tests/test_torch_gpt_train.py holds them to the YAML), with
    `trainer.precision=bf16`, `trainer.accumulate_grad_batches=4`, batch 1,
    `trainer.max_steps=1000` (the schedule's horizon: 20 warm-up updates, of
    which the phase's one epoch takes the first three; from the YAML's peak
    rate at once, a model of this width loses ground on its first updates),
    `trainer.log_every_n_steps=1` and `exp_manager.always_save_roar=true`."""
    model = {
        "config_name": "tiny-llama-1.1b", "block_size": seq_length, "seq_length": seq_length,
        "vocab_size": vocab_size, "use_flash": True, "scan_layers": True, "remat": True,
        "remat_policy": "flash", "fused_ce": True,
        "train_ds": {"dataloader_params": {"batch_size": 1, "shuffle": True}},
        "optim": {"name": "adamw", "lr": 3e-4, "weight_decay": 0.1, "betas": [0.9, 0.95],
                  "sched": {"name": "CosineAnnealing", "warmup_ratio": 0.02, "min_lr": 3e-5}},
    }
    return {
        "name": "GPTPretraining", "train_dataset": train_file, "validation_dataset": val_file,
        "model": model,
        "trainer": {"max_epochs": 1, "max_steps": GPT_SCHEDULE_STEPS, "gradient_clip_val": 1.0,
                    "log_every_n_steps": 1, "model_parallel_size": 1, "precision": "bf16",
                    "accumulate_grad_batches": 4, "seed": 0},
        "exp_manager": {"exp_dir": exp_dir, "name": "GPTPretraining",
                        "create_tensorboard_logger": True, "always_save_roar": True},
        "device": device,
    }


def write_lm_corpus(rng: np.random.Generator, train_file: str, val_file: str, n_words: int,
                    train_tokens: int) -> None:
    """A seeded synthetic corpus, one document per line.  The training file
    draws `train_tokens` words from a Zipf law over `n_words` distinct words
    (a learnable unigram distribution); the validation file holds every word
    once in a seeded order, so the two files together give the tokenizer
    `n_words` distinct words."""
    words = np.array([f"w{i}" for i in range(n_words)])
    weights = 1.0 / np.arange(1, n_words + 1)
    drawn = rng.choice(n_words, size=train_tokens, p=weights / weights.sum())
    for path, ids in ((train_file, drawn), (val_file, rng.permutation(n_words))):
        with open(path, "w", encoding="utf-8") as f:
            at = 0
            while at < len(ids):
                n = int(rng.integers(40, 200))  # a line's EOS counts as a token too
                f.write(" ".join(words[ids[at:at + n]]) + "\n")
                at += n


def _set_gpt_config(module, **fields) -> None:
    """Replace fields of the (frozen, shared) GPTConfig on a built GPT and
    every sub-module that holds it."""
    import dataclasses

    config = dataclasses.replace(module.config, **fields)
    for m in module.modules():
        if hasattr(m, "config"):
            m.config = config


def _gpt_micro_batch(model, batch: dict):
    """(loss, gradients of every parameter) of one micro-batch in training mode."""
    model.module.train()
    loss, _ = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, model.parameters())
    return float(loss.detach()), grads


def _grad_l2_rel(got, want, names=None):
    """|got - want|_2 over |want|_2 across all tensors; with `names`, also
    the same of each tensor by its name."""
    delta = [float((a.float() - b.float()).square().sum()) for a, b in zip(got, want)]
    total = [float(b.float().square().sum()) for b in want]
    whole = (sum(delta) / max(sum(total), 1e-60)) ** 0.5
    if names is None:
        return whole
    return whole, {n: (d / max(t, 1e-60)) ** 0.5 for n, d, t in zip(names, delta, total)}


def phase_train_gpt(device: torch.device, card: str = "", narrow: bool = False,
                    seq_length: int = 4096, vocab_size: int = 32000, updates: int = 3) -> dict:
    """GPT causal-LM training through the CLI's `run` at the full width and
    depth of tiny-llama-1.1b (`narrow`: a rehearsal width); returns the causal
    flash launch counts of that run and, on the card, the step's timing."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "examples", "nlp"))
    import gpt_pretraining_torch as cli

    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.models.gpt_model import GPTLMModel
    from roar_tpu_torch.training import convert
    from roar_tpu_torch.training.optim import cosine_annealing
    from roar_tpu_torch.training.save_restore import restore_from
    from roar_tpu_torch.training.trainer import to_device

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def since(before):
        """The launches after `before`, by kernel: all must be causal."""
        new = fa.LAUNCHES - before
        if on_card and any(not k.startswith("causal_") for k in new):
            raise AssertionError(f"a non-causal flash kernel was launched: {dict(new)}")
        return {k: new[f"causal_{k}"] for k in ("fwd", "dkv", "dq")}

    rng = np.random.default_rng(SEED + 4)
    accumulate = 4
    micro_batches = updates * accumulate
    n_words = vocab_size - 6  # the tokenizer's six specials fill the rest
    with tempfile.TemporaryDirectory() as tmp:
        train_file, val_file = os.path.join(tmp, "train.txt"), os.path.join(tmp, "val.txt")
        # `micro_batches` packed blocks exactly: the epoch ends, so validation runs
        write_lm_corpus(rng, train_file, val_file, n_words,
                        train_tokens=micro_batches * seq_length + seq_length // 2)
        cfg = gpt_train_config(train_file, val_file, os.path.join(tmp, "exp"), str(device),
                               seq_length, vocab_size)
        if narrow:
            cfg["model"].update(GPT_NARROW)

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = cli.run(cfg)
        sync()
        wall = time.perf_counter() - t0
        launches = since(Counter())
        peak = torch.cuda.max_memory_allocated() if on_card else None
        tokenizer = cli.SimpleWordTokenizer([train_file, val_file], max_vocab=vocab_size)
        dataset = cli.CausalLMDataset(tokenizer, train_file, seq_length=seq_length)
        n_val = len(cli.CausalLMDataset(tokenizer, val_file, seq_length=seq_length))
        if len(dataset) != micro_batches or n_val < 1:
            raise AssertionError(f"{len(dataset)} training blocks, {n_val} validation blocks")
        model, module = state.model, state.model.module
        config = module.config
        n_layer = config.n_layer
        n_params = sum(p.numel() for p in module.parameters())
        if not narrow and (n_layer, config.n_embd, config.n_head, config.groups,
                           config.intermediate_size, config.padded_vocab, config.block_size,
                           n_params) != (22, 2048, 32, 4, 5632, 32000, 4096, 1100048384):
            raise AssertionError(f"not tiny-llama-1.1b at S 4096: {config}, {n_params} parameters")
        if config.vocab_size != vocab_size:
            raise AssertionError(f"the corpus gave {config.vocab_size} tokens, not {vocab_size}")
        if state.step != micro_batches or state.opt.count != updates:
            raise AssertionError(f"{state.step} micro-batches, {state.opt.count} updates")
        if module.compute_dtype != torch.bfloat16 or any(
                p.dtype != torch.float32 for p in module.parameters()):
            raise AssertionError("not bf16 compute from fp32 master parameters")

        root = os.path.join(tmp, "exp", "GPTPretraining")
        with open(os.path.join(root, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        train = [r for r in records if "loss" in r]
        val = [r for r in records if "val_loss" in r]
        if [r["step"] for r in train] != list(range(1, micro_batches + 1)):
            raise AssertionError(f"logged steps {[r['step'] for r in train]}")
        if not all(np.isfinite(r[k]) for r in train for k in ("loss", "ppl", "token_acc",
                                                              "grad_norm")):
            raise AssertionError(f"a training metric is not finite: {train}")
        if len(val) != 1 or not all(np.isfinite(v) for k, v in val[0].items()):
            raise AssertionError(f"validation records {val}")
        # the mean loss of each update's micro-batches: the first is taken
        # before any update, each later one after one more
        by_update = [float(np.mean([r["loss"] for r in train[i:i + accumulate]]))
                     for i in range(0, micro_batches, accumulate)]
        if not by_update[-1] < by_update[0]:
            raise AssertionError(f"the loss does not fall over the updates: {by_update}")
        sched = cfg["model"]["optim"]["sched"]
        horizon = cfg["trainer"]["max_steps"]
        schedule = cosine_annealing(cfg["model"]["optim"]["lr"], max_steps=horizon,
                                    warmup_steps=int(sched["warmup_ratio"] * horizon),
                                    min_lr=sched["min_lr"])
        lrs = [r["lr"] for r in train]
        if not np.allclose(lrs, [schedule(i // accumulate) for i in range(micro_batches)],
                           rtol=1e-9, atol=0.0):
            raise AssertionError(f"learning rates {lrs} are not the schedule's")
        # every attention of the run went through the causal kernels: a
        # forward, a dkv and a dq per layer and micro-batch (`remat_policy=
        # flash` keeps the forward's results), a forward per layer and
        # validation batch, and nothing through the non-causal ones
        want = {"fwd": n_layer * (micro_batches + n_val), "dkv": n_layer * micro_batches,
                "dq": n_layer * micro_batches}
        if on_card and launches != want:
            raise AssertionError(f"causal flash launches {launches} != {want}")
        _emit({"phase": "train_gpt", "step": "cli", "card": card,
               "config": {k: v for k, v in cfg["model"].items()
                          if k not in ("train_ds", "optim")},
               "parameters": n_params, "layers": n_layer, "micro_batches": micro_batches,
               "updates": updates, "tokens_per_update": accumulate * seq_length,
               "causal_flash_launches": launches,
               "per_micro_batch": {"fwd": (launches["fwd"] - n_layer * n_val) // micro_batches,
                                   "dkv": launches["dkv"] // micro_batches,
                                   "dq": launches["dq"] // micro_batches},
               "validation_batches": n_val, "loss_by_micro_batch": [r["loss"] for r in train],
               "loss_by_update": by_update, "token_acc_last": train[-1]["token_acc"],
               "val": {k: v for k, v in val[0].items() if k.startswith("val_")},
               "grad_norm": [r["grad_norm"] for r in train], "lr": lrs, "wall_s": wall,
               "wall_includes": "tokenizer, model build, logging every micro-batch (a sync "
                                "each), validation, the checkpoint of masters and moments, "
                                "the bundle",
               "peak_device_memory_bytes": peak})

        # the bundle: read back and loaded by the converter, equal to the masters
        path = os.path.join(root, "checkpoints", "GPTPretraining.roar")
        bundle_cfg, tree = restore_from(path)
        with device:
            loaded = GPTLMModel(bundle_cfg["model"])
        convert.load_gpt_params(loaded.module, tree)
        flat = convert.flatten_params(tree)
        if "h_scan/attn/attn/kernel" not in flat or len(flat["h_scan/attn/attn/kernel"]) != n_layer:
            raise AssertionError("the bundle is not in the stacked h_scan layout")
        for (name, a), b in zip(loaded.module.state_dict().items(),
                                module.state_dict().values()):
            if a.dtype != torch.float32 or not torch.equal(a, b):
                raise AssertionError(f"bundle parameter {name} is not the trained master")
        _emit({"phase": "train_gpt", "step": "bundle", "bundle_bytes": os.path.getsize(path),
               "layout": "h_scan", "parameters_equal_trained": True})
        del loaded, tree, flat

    # one micro-batch under each remat policy
    batch = to_device(dataset.collate([dataset[0]]), device)
    state.opt.zero_grad()

    def under_policy(name):
        _set_gpt_config(module, remat_policy=name)
        before = fa.LAUNCHES.copy()
        loss, grads = _gpt_micro_batch(model, batch)
        sync()
        return {"loss": loss, "grads": grads, "launches": since(before)}

    policy = {name: under_policy(name) for name in ("flash", "nothing")}
    _set_gpt_config(module, remat_policy="flash")
    want = {"flash": {"fwd": n_layer, "dkv": n_layer, "dq": n_layer},
            "nothing": {"fwd": 2 * n_layer, "dkv": n_layer, "dq": n_layer}}
    if on_card and {k: v["launches"] for k, v in policy.items()} != want:
        raise AssertionError(f"launches per micro-batch {policy} != {want}")
    policy_l2 = _grad_l2_rel(policy["nothing"]["grads"], policy["flash"]["grads"])
    identical = all(torch.equal(a, b) for a, b in zip(policy["nothing"]["grads"],
                                                       policy["flash"]["grads"]))
    if policy["flash"]["loss"] != policy["nothing"]["loss"] or policy_l2 > 1e-6:
        raise AssertionError(f"the two remat policies disagree: losses "
                             f"{policy['flash']['loss']} / {policy['nothing']['loss']}, "
                             f"gradients by {policy_l2}")
    _emit({"phase": "train_gpt", "step": "remat_policies",
           "launches_per_micro_batch": {k: v["launches"] for k, v in policy.items()},
           "loss": policy["flash"]["loss"], "losses_equal": True,
           "gradients_bit_identical": identical, "grad_l2_rel_diff": policy_l2})
    grads_k, loss_k = policy["flash"]["grads"], policy["flash"]["loss"]
    per_micro_batch = policy["flash"]["launches"]
    del policy

    # bf16 at full depth: the trained model, kernels against plain versions
    with _PlainFlash():
        loss_p, grads_p = _gpt_micro_batch(model, batch)
    sync()
    bf16_l2, by_tensor = _grad_l2_rel(grads_k, grads_p,
                                      [n for n, _ in module.named_parameters()])
    del grads_k, grads_p
    if abs(loss_k - loss_p) > GPT_BF16_LOSS_RTOL * abs(loss_p) or bf16_l2 > GPT_BF16_GRAD_L2_TOL:
        raise AssertionError(f"bf16, kernels vs plain: loss {loss_k} vs {loss_p}, whole "
                             f"gradient differs by {bf16_l2}")
    attn = {n: e for n, e in by_tensor.items() if ".attn." in n}
    if len(attn) != 2 * n_layer:
        raise AssertionError(f"attention projections: {sorted(attn)}")
    worst_attn, worst_any = max(attn, key=attn.get), max(by_tensor, key=by_tensor.get)
    if attn[worst_attn] > GPT_BF16_ATTN_TENSOR_L2_TOL:
        raise AssertionError(f"bf16, kernels vs plain: the gradient of {worst_attn} differs by "
                             f"{attn[worst_attn]} (L2, relative)")
    bf16_line = {"layers": n_layer, "loss_kernels": loss_k, "loss_plain": loss_p,
                 "loss_rtol": GPT_BF16_LOSS_RTOL, "whole_grad_l2_rel_err": bf16_l2,
                 "grad_l2_tol": GPT_BF16_GRAD_L2_TOL,
                 "attn_projection_grad_l2_rel_err": {
                     "worst": attn[worst_attn], "tensor": worst_attn,
                     "median": float(np.median(list(attn.values()))),
                     "tol": GPT_BF16_ATTN_TENSOR_L2_TOL},
                 "worst_tensor_grad_l2_rel_err": {"tensor": worst_any,
                                                  "err": by_tensor[worst_any]}}

    # fp32 at full width and 4 layers: a model of its own, seeded on the device
    fp32_cfg = {k: v for k, v in cfg["model"].items() if k not in ("train_ds", "optim")}
    fp32_cfg.update(n_layer=min(4, n_layer), vocab_size=config.vocab_size)
    with device:
        small = GPTLMModel(fp32_cfg)
    small.module.to(device)
    small.init_parameters(torch.Generator(device=device).manual_seed(SEED))
    before = fa.LAUNCHES.copy()
    loss_k32, grads_k32 = _gpt_micro_batch(small, batch)
    sync()
    step32 = since(before)
    with _PlainFlash():
        loss_p32, grads_p32 = _gpt_micro_batch(small, batch)
    sync()
    fp32_l2 = _grad_l2_rel(grads_k32, grads_p32)
    n32 = small.config.n_layer
    del grads_k32, grads_p32, small
    if on_card and step32 != {"fwd": n32, "dkv": n32, "dq": n32}:
        raise AssertionError(f"the fp32 micro-batch launched {step32}")
    if abs(loss_k32 - loss_p32) > GPT_FP32_LOSS_RTOL * abs(loss_p32) \
            or fp32_l2 > GPT_FP32_GRAD_L2_TOL:
        raise AssertionError(f"fp32, kernels vs plain: loss {loss_k32} vs {loss_p32}, whole "
                             f"gradient differs by {fp32_l2}")
    _emit({"phase": "train_gpt", "step": "kernel_path_vs_plain_path",
           "batch_shape": list(batch["input_ids"].shape), "bf16": bf16_line,
           "fp32": {"layers": n32, "loss_kernels": loss_k32, "loss_plain": loss_p32,
                    "loss_rtol": GPT_FP32_LOSS_RTOL, "whole_grad_l2_rel_err": fp32_l2,
                    "grad_l2_tol": GPT_FP32_GRAD_L2_TOL}})
    if on_card:
        torch.cuda.empty_cache()

    result = {"launches": launches, "per_micro_batch": per_micro_batch,
              "fp32_check_launches": step32}
    if on_card:
        result["timing"] = _time_gpt_step(state, batch, accumulate, card)
    return result


def _time_gpt_step(state, batch: dict, accumulate: int, card: str) -> dict:
    """The time of one optimizer update (`accumulate` micro-batches of
    `batch`; median of 3 after 1 warm, CUDA events), its split by the marks of
    `GPT.forward`, `loss_fn` and `train_step` summed over the micro-batches,
    and the time inside the attention kernels' wrappers (events around every
    call, in one further update)."""
    from roar_tpu_torch.kernels import flash_attention as fa
    from roar_tpu_torch.training.trainer import train_step

    parts = ("embedding", "blocks_forward", "model_forward", "loss", "backward", "optimizer")
    state.step = 0
    state.opt.zero_grad()
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    totals, splits = [], {p: [] for p in parts}
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        begin.record()
        split = dict.fromkeys(parts, 0.0)
        for _ in range(accumulate):
            events.clear()
            mark("start")
            train_step(state, batch, 0, accumulate, mark=mark)
            torch.cuda.synchronize()
            for before, name in zip(("start",) + parts, parts):
                split[name] += events[before].elapsed_time(events[name])
        if i:
            totals.append(begin.elapsed_time(events["optimizer"]))
            for name in parts:
                splits[name].append(split[name])
    peak = torch.cuda.max_memory_allocated()

    def update():
        for _ in range(accumulate):
            train_step(state, batch, 0, accumulate)

    inside, calls = _time_inside({"flash_fwd": (fa, "flash_self_attention"),
                                  "flash_bwd": (fa, "flash_self_attention_bwd")},
                                 update, n_steps=1)
    step_ms = float(np.median(totals))
    tokens = accumulate * int(batch["input_ids"].numel())
    split = {p: float(np.median(v)) for p, v in splits.items()}
    split["final_norm"], split["fused_ce"] = split.pop("model_forward"), split.pop("loss")
    timing = {"phase": "train_gpt", "step": "timing", "card": card,
              "micro_batch_shape": list(batch["input_ids"].shape), "micro_batches": accumulate,
              "step_ms": step_ms, "step_ms_all": totals, "tokens_per_update": tokens,
              "tokens_per_s": tokens / step_ms * 1e3,
              "split_ms": split,
              "flash_ms_per_step": {"fwd": inside["flash_fwd"],
                                    "bwd_delta_dkv_dq": inside["flash_bwd"]},
              "flash_calls_per_step": calls,
              "flash_share_of_step": (inside["flash_fwd"] + inside["flash_bwd"]) / step_ms,
              "peak_device_memory_bytes": peak,
              "method": "CUDA events; one step = one optimizer update = 4 micro-batches of one "
                        "sequence; median of 3 updates after 1 warm; the split sums each part "
                        "over the micro-batches (a sync after each, so the parts' sum is below "
                        "step_ms by the host's gaps); `blocks_forward` holds the attention "
                        "forward kernels, `backward` the recomputation of each block's two "
                        "halves and the attention backward kernels; batch already on the card"}
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

    fa.LAUNCHES.clear()
    engine.programs_run = 0
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
    launches, programs = fa.LAUNCHES["fwd"], engine.programs_run
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
    phase_kernel_build(lib_path)

    kern = phase_kernel(device)
    vit = phase_kernel_viterbi(device)
    conv = phase_kernel_grouped_conv(device)
    # the JETS discriminators' widths: 16 segments of 16384 samples, real and fake joined
    conv16k = phase_kernel_grouped_conv(device, batch=32, segment=16384)
    conv_bf16 = phase_kernel_grouped_conv(device, dtype=torch.bfloat16)
    conv16k_bf16 = phase_kernel_grouped_conv(device, batch=32, segment=16384,
                                             dtype=torch.bfloat16)
    fbwd = phase_kernel_flash_bwd(device)
    fcausal = phase_kernel_flash_causal(device)
    run = phase_slice(device, fastpitch_config(), hifigan_config(), TAMIL_SENTENCES, card)
    sup = phase_supdata(device, card)
    train = phase_train_hifigan(device, card)
    train_bf16 = phase_train_hifigan(device, card, n_utterances=32, steps=4, precision="bf16")
    fp_train = phase_train_fastpitch(device, card)
    fp_train_bf16 = phase_train_fastpitch(device, card, n_utterances=64, steps=4,
                                          precision="bf16")
    torch.cuda.empty_cache()
    jets = phase_train_jets(device, card)
    torch.cuda.empty_cache()
    # configs/jets_22050_align.yaml at its shipped precision, full width and depth
    jets_bf16 = phase_train_jets(device, card, precision="bf16-mixed")
    torch.cuda.empty_cache()
    gpt = phase_train_gpt(device, card)

    def pick(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    def flash_rows(cases):
        """The forward's numbers and those of the dkv and dq kernels, summed
        over `cases` (one `_flash_case` result per shape a step hands the
        kernels).  For the two backward kernels `bound_ms`, `plain_ms` and
        `library_ms` are those of the whole backward (five products), which
        the two kernels and the delta reduction share: plain and library give
        dq, dk and dv in one call; `backward_ms` times them together, and
        `own_work_bound_ms` counts the products this kernel does itself (the
        split recomputes q.k^T and dO.v^T).  `bound_share` (forward) and
        `own_work_bound_share` (dkv, dq) are bound over time.  In fp32 the
        bounds are at the 3xTF32 rate, with the FMA pipe's beside
        (`bound_fp32_fma_ms`, `own_work_bound_fp32_fma_ms`)."""
        def total(get):
            return sum(get(case) for case in cases)

        def bound(which):
            return total(lambda c: c["bounds"][which]["bound_ms"])

        fwd = {"ms": total(lambda c: c["times"]["fwd_with_lse_ms"]),
               "plain_ms": total(lambda c: c["times"]["fwd_plain_ms"]),
               "bound_ms": bound("fwd_with_lse"),
               "bound_by": cases[-1]["bounds"]["fwd_with_lse"]["bound_by"],
               "library_ms": total(lambda c: c["times"]["fwd_library_ms"])}
        fwd["bound_share"] = fwd["bound_ms"] / fwd["ms"]
        if "bounds_fp32_fma" in cases[-1]:
            fwd["bound_fp32_fma_ms"] = total(
                lambda c: c["bounds_fp32_fma"]["fwd_with_lse"]["bound_ms"])
        bwd = {name: {"ms": total(lambda c: c["times"][f"{name}_ms"]),
                      "backward_ms": total(lambda c: c["times"]["backward_ms"]),
                      "plain_ms": total(lambda c: c["times"]["backward_plain_ms"]),
                      "bound_ms": bound("backward"),
                      "bound_by": cases[-1]["bounds"]["backward"]["bound_by"],
                      "own_work_bound_ms": bound(f"{name}_own_work"),
                      "library_ms": total(lambda c: c["times"]["backward_library_ms"])}
               for name in ("dkv", "dq")}
        for name, row in bwd.items():
            row["own_work_bound_share"] = row["own_work_bound_ms"] / row["ms"]
            if "bounds_fp32_fma" in cases[-1]:
                row["bound_fp32_fma_ms"] = total(
                    lambda c: c["bounds_fp32_fma"]["backward"]["bound_ms"])
                row["own_work_bound_fp32_fma_ms"] = total(
                    lambda c: c["bounds_fp32_fma"][f"{name}_own_work"]["bound_ms"])
        return fwd, bwd

    def worst(errors, *names):
        return max(e[n]["max_abs_err"] if isinstance(e[n], dict) else e[n]
                   for e in errors for n in names)

    # K5 on the training path: one encoder-layer launch (text bucket) plus
    # one decoder-layer launch (mel bucket) of the longest batch, summed; a
    # step makes six of each
    flash = fp_train["flash"]
    flash_fwd, flash_bwd = flash_rows([flash[t] for t in sorted(flash)])
    jets_flash = jets["flash"]
    jets_fwd, jets_bwd = flash_rows([jets_flash[t] for t in sorted(jets_flash)])
    # the bf16 non-causal K5 on the bf16 JETS and FastPitch steps, at their shapes
    fp16_flash, jets16_flash = fp_train_bf16["flash"], jets_bf16["flash"]
    fp16_fwd, fp16_bwd = flash_rows([fp16_flash[t] for t in sorted(fp16_flash)])
    jets16_fwd, jets16_bwd = flash_rows([jets16_flash[t] for t in sorted(jets16_flash)])
    bf16_flash_errors = ([case["errors"] for case in fp16_flash.values()]
                         + [case["errors"] for case in jets16_flash.values()])
    flash_errors = ([case["errors"] for case in flash.values()]
                    + [case["errors"] for case in jets_flash.values()] + [fbwd["max_abs_err"]])

    def by_bucket(cases):
        return {str(t): {**case["times"], **{k: v["bound_ms"] for k, v in case["bounds"].items()},
                         **{f"{k}_fp32_fma": v["bound_ms"]
                            for k, v in case["bounds_fp32_fma"].items()}}
                for t, case in cases.items()}
    # K5-causal: every launch of phase `train_gpt`'s run is causal and bf16,
    # at (1, 4096, 32, 64); `ms` and its neighbours are one layer's call at
    # that shape and type, `fp32` the same call in fp32 (its launches: those
    # of the fp32 micro-batch at 4 layers that phase `train_gpt` checks);
    # `launches_per_micro_batch` is the count of one micro-batch under
    # `remat_policy=flash`
    causal_fwd, causal_bwd = flash_rows([fcausal["path"]["bfloat16"]])
    causal_fwd32, causal_bwd32 = flash_rows([fcausal["path"]["float32"]])
    causal_errors = list(fcausal["max_abs_err"].values())
    backward_kernels = (("dkv", ("dk", "dv")), ("dq", ("dq",)))
    kernels = [
        # fp32 (3xTF32) on both of its paths: `launches` is serving's,
        # `launches_train_fastpitch` the FastPitch run's; `ms` and its
        # neighbours: serving's decoder shape (8, 3072, 1, 64);
        # `train_fastpitch`: the same at the training step's two shapes, with
        # the log-sum-exp written
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
         "kernel": "flash_fwd_tf32_kernel", "dtype": "float32",
         "replaces": "roar_tpu/models/transformer.py:72", "causal": False,
         "launches": run["launches"], "launches_train_fastpitch": fp_train["launches"]["fwd"],
         "launches_train_jets": jets["launches"]["fwd"],
         "max_abs_err": max(kern["max_abs_err"], worst(flash_errors, "o")),
         **pick(kern), "library_ms": kern["library_ms"],
         "bound_fp32_fma_ms": kern["bound_fp32_fma_ms"],
         "train_fastpitch": {**flash_fwd, "lse_max_abs_err": worst(flash_errors, "lse"),
                             "by_mel_or_text_bucket": by_bucket(flash)},
         "train_jets": {**jets_fwd, "by_mel_or_text_bucket": by_bucket(jets_flash)}},
        # `launches` and the times: the FastPitch step's; `train_jets`: the
        # JETS step's two shapes
        *[{"name": f"flash_attention_bwd_{name}", "route": "cuda",
           "source": "roar_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": "roar_tpu/models/transformer.py:110", "causal": False,
           "launches": fp_train["launches"][name],
           "launches_train_jets": jets["launches"][name],
           "max_abs_err": worst(flash_errors, *grads), **flash_bwd[name],
           "train_jets": jets_bwd[name]}
          for name, grads in backward_kernels],
        {"name": "flash_attention_causal_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "roar_tpu/models/gpt.py:491", "causal": True, "dtype": "bfloat16",
         "kernel": "flash_fwd_mma_kernel", "launches": gpt["launches"]["fwd"],
         "launches_per_micro_batch": gpt["per_micro_batch"]["fwd"],
         "max_abs_err": worst(causal_errors, "o"),
         "lse_max_abs_err": worst(causal_errors, "lse"), **causal_fwd,
         "fp32": {**causal_fwd32, "kernel": "flash_fwd_tf32_kernel",
                  "launches": gpt["fp32_check_launches"]["fwd"]}},
        *[{"name": f"flash_attention_causal_bwd_{name}", "route": "cuda",
           "source": "roar_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": "roar_tpu/models/gpt.py:491", "causal": True, "dtype": "bfloat16",
           "launches": gpt["launches"][name],
           "launches_per_micro_batch": gpt["per_micro_batch"][name],
           "max_abs_err": worst(causal_errors, *grads), **causal_bwd[name],
           "fp32": causal_bwd32[name]}
          for name, grads in backward_kernels],
        {"name": "pyin_viterbi_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/pyin_viterbi.cu",
         "replaces": "roar_tpu/ops/pyin_pallas.py:34",
         "launches": sup["launches"]["fwd"],
         "launches_train_jets": jets["sup_launches"]["fwd"], "max_abs_err": 0.0,
         **pick(vit["fwd"]), "library_ms": None, "cluster": vit["fwd"]["cluster"],
         "max_active_clusters": vit["fwd"]["max_active_clusters"],
         "cluster_sweep": vit["sweep"], "b128": pick(vit["fwd_b128"]),
         "train_jets": {**pick(vit["fwd_jets"]), "shape_btnw": list(VITERBI_CASES[5]),
                        "cluster": vit["fwd_jets"]["cluster"],
                        "cluster_sweep": vit["sweep_jets"]}},
        {"name": "pyin_backtrack", "route": "cuda",
         "source": "roar_tpu_torch/csrc/pyin_viterbi.cu",
         "replaces": "roar_tpu/ops/pyin_pallas.py:279",
         "launches": sup["launches"]["backtrack"],
         "launches_train_jets": jets["sup_launches"]["backtrack"], "max_abs_err": 0.0,
         **pick(vit["backtrack"]), "library_ms": None, "b128": pick(vit["backtrack_b128"]),
         "train_jets": {**pick(vit["backtrack_jets"]), "shape_btnw": list(VITERBI_CASES[5])}},
        # K3 and K4: times and bounds summed over the 15 grouped-conv shapes
        # of one discriminator pass (B = 32) at HiFi-GAN's 8192 samples, and
        # in `train_jets` at JETS's 16384; library = cuDNN with TF32 off;
        # bounds on the tensor cores (3xTF32), the fp32 FMA bound beside
        *[{"name": f"grouped_conv_{name}", "route": "cuda",
           "source": "roar_tpu_torch/csrc/grouped_conv.cu", "replaces": replaces,
           "launches": train["launches"][name],
           "launches_train_jets": jets["launches"][f"grouped_conv_{name}"],
           "max_abs_err": max(conv[name]["max_abs_err"], conv16k[name]["max_abs_err"]),
           "max_rel_err": max(conv[name]["max_rel_err"], conv16k[name]["max_rel_err"]),
           **pick(conv[name]), "library_ms": conv[name]["library_ms"],
           "library_tf32_ms": conv[name]["library_tf32_ms"],
           "bound_fp32_fma_ms": conv[name]["bound_fp32_fma_ms"],
           "train_jets": {**pick(conv16k[name]), "segment": 16384, "batch": 32,
                          **{k: conv16k[name][k] for k in ("library_ms", "library_tf32_ms",
                                                           "bound_fp32_fma_ms", "max_rel_err")}}}
          for name, replaces in (("fwd", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dx", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dw", "roar_tpu/ops/grouped_conv.py:272"))],
        # K3 and K4 in bf16 (bf16 in, fp32 sums; y and dX bf16, dW fp32):
        # `launches` is the bf16 JETS run's (configs/jets_22050_align.yaml as
        # shipped), `launches_train_hifigan_bf16` the bf16 HiFi-GAN run's; the
        # times and bounds summed over the 15 shapes at JETS's 32 x 16384, and
        # in `train_hifigan` at 32 x 8192; library = cuDNN in bf16; bounds at
        # the dense bf16 rate
        *[{"name": f"grouped_conv_{name}_bf16", "route": "cuda",
           "source": "roar_tpu_torch/csrc/grouped_conv.cu", "replaces": replaces,
           "dtype": "bfloat16", "launches": jets_bf16["launches_bf16"][f"grouped_conv_{name}"],
           "launches_train_hifigan_bf16": train_bf16["launches_bf16"][name],
           "max_abs_err": max(conv_bf16[name]["max_abs_err"],
                              conv16k_bf16[name]["max_abs_err"]),
           "max_rel_err": max(conv_bf16[name]["max_rel_err"],
                              conv16k_bf16[name]["max_rel_err"]),
           "max_l2_rel_err": max(conv_bf16[name]["max_l2_rel_err"],
                                 conv16k_bf16[name]["max_l2_rel_err"]),
           **pick(conv16k_bf16[name]), "library_ms": conv16k_bf16[name]["library_ms"],
           "segment": 16384, "batch": 32,
           "train_hifigan": {**pick(conv_bf16[name]), "segment": 8192, "batch": 32,
                             "library_ms": conv_bf16[name]["library_ms"]}}
          for name, replaces in (("fwd", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dx", "roar_tpu/ops/grouped_conv.py:208"),
                                 ("dw", "roar_tpu/ops/grouped_conv.py:272"))],
        # the non-causal K5 in bf16 on its first paths: `launches` the bf16
        # JETS run's, `launches_train_fastpitch_bf16` the bf16 FastPitch run's;
        # the times at the bf16 JETS step's two shapes (summed), and in
        # `train_fastpitch` at the bf16 FastPitch step's
        {"name": "flash_attention_fwd_bf16", "route": "cuda",
         "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
         "kernel": "flash_fwd_mma_kernel", "dtype": "bfloat16",
         "replaces": "roar_tpu/models/transformer.py:72", "causal": False,
         "launches": jets_bf16["launches_bf16"]["fwd"],
         "launches_train_fastpitch_bf16": fp_train_bf16["launches_bf16"]["fwd"],
         "max_abs_err": worst(bf16_flash_errors, "o"), **jets16_fwd,
         "train_fastpitch": fp16_fwd},
        *[{"name": f"flash_attention_bwd_{name}_bf16", "route": "cuda",
           "source": "roar_tpu_torch/csrc/flash_attention_bwd.cu", "dtype": "bfloat16",
           "replaces": "roar_tpu/models/transformer.py:110", "causal": False,
           "launches": jets_bf16["launches_bf16"][name],
           "launches_train_fastpitch_bf16": fp_train_bf16["launches_bf16"][name],
           "max_abs_err": worst(bf16_flash_errors, *grads), **jets16_bwd[name],
           "train_fastpitch": fp16_bwd[name]}
          for name, grads in backward_kernels],
    ]
    if not all(k["launches"] > 0 for k in kernels) or fp_train["launches"]["fwd"] == 0 \
            or not all(k.get("launches_train_jets", 1) > 0 for k in kernels) \
            or not all(k.get(f"launches_{p}_bf16", 1) > 0 for k in kernels
                       for p in ("train_hifigan", "train_fastpitch")):
        raise AssertionError(f"a kernel was launched no time on its path: {kernels}")
    _emit({"kernels": kernels})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
