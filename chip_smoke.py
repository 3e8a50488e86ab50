#!/usr/bin/env python3
"""Drive the PyTorch port (roar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: torch and CUDA versions and the card's `nvidia-smi` name and power
   limit; exits non-zero without a CUDA device;
2. build: compile the CUDA kernels from roar_tpu_torch/csrc/;
3. kernel: every kernel against its plain PyTorch version on the card at its
   main path's shapes, with the times of both, the kernel's bound on this
   card and, for attention, the time of the one PyTorch call that computes
   the same function: flash attention (allclose), the pYIN Viterbi forward
   pass and backtrack (exactly equal, ties included);
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
   the time split.

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
    the preprocessor's mel width and rate, and the v1 generator."""
    return {
        "preprocessor": {"nfilt": 80, "sample_rate": 22050, "n_window_stride": 256},
        "generator": {
            "resblock": 1, "upsample_rates": [8, 8, 2, 2],
            "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 512,
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        },
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
    run = phase_slice(device, fastpitch_config(), hifigan_config(), TAMIL_SENTENCES, card)
    sup = phase_supdata(device, card)

    def pick(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    _emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "roar_tpu/models/transformer.py:72",
         "launches": run["launches"], "max_abs_err": kern["max_abs_err"],
         **pick(kern), "library_ms": kern["library_ms"]},
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
    ]})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
