#!/usr/bin/env python3
"""Drive the PyTorch port (roar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: torch and CUDA versions and the card's `nvidia-smi` name and power
   limit; exits non-zero without a CUDA device;
2. build: compile the CUDA kernels from roar_tpu_torch/csrc/;
3. kernel: the flash-attention kernel against its plain PyTorch version on the
   card at the serving path's shapes, with times of both;
4. slice: full-size FastPitch (flash attention in all 12 layers) and HiFi-GAN
   v1 with seeded random weights, served through `SynthesisEngine.warmup`,
   `synthesize_batch` and the HTTP server; checks sample counts, WAV headers,
   the kernel's launch count and the kernel path's mel against the plain
   path's.

Then the kernels line, the card line, and last `{"ok": true, "device": ...}`.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
        worst = max(worst, err_valid, err_pad)
        if (b, t) == (8, 3072):
            decoder_times = (ms, plain_ms)
        _emit({"phase": "kernel", "shape_bthd": [b, t, h, d], "key_lens": lens,
               "max_abs_err_valid_rows": err_valid, "max_abs_err_pad_rows": err_pad,
               "tol": KERNEL_TOL, "ms": ms, "plain_ms": plain_ms})
        del q, k, v, got, want, err
    return {"max_abs_err": worst, "ms": decoder_times[0], "plain_ms": decoder_times[1]}


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
    run = phase_slice(device, fastpitch_config(), hifigan_config(), TAMIL_SENTENCES, card)

    _emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "roar_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "roar_tpu/models/transformer.py:72",
        "launches": run["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
    }]})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
