"""Serving slice of the port against the JAX package, end to end on the CPU.

tokenizer ids -> FastPitch infer -> HiFi-GAN -> int16 PCM through the port's
`SynthesisEngine`, HTTP server and `.roar` bundle reader, compared with
`roar_tpu.serving` on the tiny models of tests/test_serving.py.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import warnings
import wave
from io import BytesIO
from pathlib import Path

import jax
import numpy as np
import pytest

from roar_tpu.serving import SynthesisEngine as JaxSynthesisEngine
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.models.hifigan_model import vocoder_from_config
from roar_tpu_torch.serving import SynthesisEngine, engine_from_bundles, make_server
from roar_tpu_torch.training.convert import load_fastpitch_params, load_generator_params
from test_serving import _tiny_models

REPO = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(text_buckets=(16, 32), batch_buckets=(1, 2, 4), frames_per_token=4)
TEXTS = ["hi there", "a much longer sentence here", "abc"]
# fp32 on both sides; 2 LSB of int16 covers a last-bit difference in the
# float waveform on either side of a rounding boundary
PCM_LSB = 2


@pytest.fixture(scope="module")
def jax_side():
    fp, fp_params, hg, voc_params = _tiny_models()
    engine = JaxSynthesisEngine(fp, fp_params, hg, voc_params, **ENGINE_KW)
    return fp, jax.device_get(fp_params), hg, jax.device_get(voc_params), engine


def _port_engine(fp_cfg, fp_params, hg_cfg, voc_params, use_flash=False):
    cfg = {**fp_cfg, **{k: {**fp_cfg[k], "use_flash": use_flash}
                        for k in ("input_fft", "output_fft")}}
    fp = FastPitchModel(cfg)
    load_fastpitch_params(fp.module, fp_params)
    gen = load_generator_params(vocoder_from_config(hg_cfg), voc_params)
    return SynthesisEngine(fp, gen, device="cpu", **ENGINE_KW)


def _assert_pcm_close(got, want):
    assert [w.shape for w in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= PCM_LSB


@pytest.mark.parametrize("name,kwargs,text", [
    ("TamilCharsTokenizer", dict(punct=True, apostrophe=True, pad_with_space=True),
     "வணக்கம்! இன்று வானிலை  நன்றாக உள்ளது; it's 42 degrees."),
    ("TamilCharsTokenizer", dict(punct=False, apostrophe=False), "தமிழ் - ஒரு 'பழமையான' மொழி"),
    ("EnglishCharsTokenizer", dict(pad_with_space=True), "Hello, World! It’s 3 o'clock."),
    ("EnglishCharsTokenizer", dict(punct=False), "a  much (longer) sentence?"),
])
def test_tokenizer_ids_match_jax(name, kwargs, text):
    from roar_tpu.data import tokenizers as jax_tok
    from roar_tpu_torch.data import tokenizers as port_tok

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn alike on skipped characters
        want = getattr(jax_tok, name)(**kwargs)(text)
        got = getattr(port_tok, name)(**kwargs)(text)
    assert got == want and len(got) > 5


@pytest.mark.parametrize("use_flash", [False, True])
def test_engine_pcm_matches_jax_engine(jax_side, use_flash):
    fp, fp_params, hg, voc_params, jengine = jax_side
    engine = _port_engine(fp.cfg, fp_params, hg.cfg, voc_params, use_flash)
    _assert_pcm_close(engine.synthesize_batch(TEXTS), jengine.synthesize_batch(TEXTS))
    assert engine.programs_run == 1
    # an oversized group splits into max_batch programs, as in JAX
    assert len(engine.synthesize_batch(["abc"] * 6)) == 6 and engine.programs_run == 3


def test_http_roundtrip(jax_side):
    fp, fp_params, hg, voc_params, _ = jax_side
    engine = _port_engine(fp.cfg, fp_params, hg.cfg, voc_params, use_flash=True)
    server = make_server(engine, host="127.0.0.1", port=0, max_wait_ms=20.0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def post(payload):
        req = urllib.request.Request(f"{base}/synthesize", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers, r.read()

    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["sample_rate"] == engine.sample_rate
        headers, blob = post({"text": "hello world"})
        assert headers["Content-Type"] == "audio/wav"
        (direct,) = engine.synthesize_batch(["hello world"])
        with wave.open(BytesIO(blob)) as f:
            assert f.getframerate() == engine.sample_rate
            assert np.array_equal(np.frombuffer(f.readframes(f.getnframes()), "<i2"), direct)
        story = "hello there. how are you. fine."
        headers, blob = post({"text": story, "stream": True})
        assert headers.get("Transfer-Encoding") == "chunked" and blob[:4] == b"RIFF"
        np.testing.assert_array_equal(np.frombuffer(blob[44:], "<i2"),
                                      np.concatenate(list(engine.synthesize_stream(story))))
        bad = urllib.request.Request(f"{base}/synthesize", data=b"not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()


def test_engine_from_jax_bundles(jax_side, tmp_path):
    from roar_tpu.training.save_restore import save_to

    fp, fp_params, hg, voc_params, jengine = jax_side
    save_to(str(tmp_path / "fp.roar"), {"model": fp.cfg}, fp_params)
    # a vocoder bundle may hold the whole GAN state
    save_to(str(tmp_path / "voc.roar"), hg.cfg,
            {"g_params": voc_params, "d_params": {"unused": np.zeros(3, np.float32)}})
    engine = engine_from_bundles(str(tmp_path / "fp.roar"), str(tmp_path / "voc.roar"),
                                 device="cpu", **ENGINE_KW)
    _assert_pcm_close(engine.synthesize_batch(TEXTS), jengine.synthesize_batch(TEXTS))


def test_port_imports_no_jax():
    """The whole package and a tiny slice run without jax, flax, optax or
    roar_tpu ever being imported."""
    code = """
import pkgutil, sys, importlib
import numpy as np, torch
import roar_tpu_torch
for m in pkgutil.walk_packages(roar_tpu_torch.__path__, "roar_tpu_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, ".")
import chip_smoke as cs
cfg = cs.fastpitch_config()
for k in ("input_fft", "output_fft"):
    cfg[k].update(n_layer=1, d_model=32, d_head=16, n_head=2, d_inner=48)
cfg["input_fft"]["d_embed"] = cfg["symbols_embedding_dim"] = 32
for k in ("duration_predictor", "pitch_predictor"):
    cfg[k].update(input_size=32, filter_size=16)
hg = cs.hifigan_config()
hg["generator"]["upsample_initial_channel"] = 16
fp, gen = cs.build_models(cfg, hg)
from roar_tpu_torch.serving import SynthesisEngine
engine = SynthesisEngine(fp, gen, device="cpu", text_buckets=(16,), batch_buckets=(1,))
(w,) = engine.synthesize_batch([cs.TAMIL_SENTENCES[0]])
assert w.size == 6 * len(fp.parse(cs.TAMIL_SENTENCES[0])[0]) * 256
banned = ("jax", "jaxlib", "flax", "optax", "roar_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_port_sources_name_no_banned_import():
    """Every .py of the port, chip_smoke.py and the port's scripts and examples: no
    `import` statement, at any depth, names jax, flax, optax or roar_tpu."""
    import ast

    files = [p for p in sorted((REPO / "roar_tpu_torch").rglob("*.py"))
             if "build" not in p.relative_to(REPO).parts]  # build outputs are not sources
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "scripts").rglob("*_torch.py"))
    files += sorted((REPO / "examples").rglob("*_torch.py"))
    names = {p.name for p in files}
    assert {"serve_tts_torch.py", "extract_sup_data_torch.py", "chip_smoke.py", "pyin.py",
            "pyin_viterbi.py", "sup_data.py", "hifigan_torch.py", "grouped_conv.py", "gan.py",
            "run.py", "optim.py", "exp_manager.py", "fastpitch_torch.py", "trainer.py", "mas.py",
            "forward_sum.py", "aligner.py", "fastpitch_losses.py", "flash_attention.py",
            "dataset.py", "gpt.py", "gpt_model.py", "fused_ce.py", "rope.py", "lm_dataset.py",
            "gpt_pretraining_torch.py"} <= names
    banned = {"jax", "jaxlib", "flax", "optax", "roar_tpu"}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                modules = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                modules = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {m}" for m in modules
                    if m.split(".")[0] in banned]
    assert not bad, bad


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_configs_match_yaml():
    from roar_tpu.config import load_config

    sys.path.insert(0, str(REPO))
    import chip_smoke

    data = ["train_dataset=t.json", "validation_datasets=v.json"]
    fp_yaml = load_config(REPO / "configs/fastpitch_22050_align.yaml", overrides=data + [
        "sup_data_path=s", "pitch_mean=0.0", "pitch_std=1.0",
        "model.input_fft.use_flash=true", "model.output_fft.use_flash=true",
        "model.speaker_encoder.lookup_module.n_speakers=4"])["model"]
    _assert_subdict(chip_smoke.fastpitch_config(), fp_yaml)
    hg_yaml = load_config(REPO / "configs/hifigan_22050.yaml", overrides=data)["model"]
    _assert_subdict(chip_smoke.hifigan_config(), hg_yaml)
    assert hg_yaml["generator"]["_target_"].endswith("hifigan.Generator")


def test_msgpack_restore_matches_flax(monkeypatch):
    """The flax-free bundle reader decodes what flax writes: ndarray and
    numpy-scalar ext types, bfloat16 leaves, and chunked large arrays."""
    import jax.numpy as jnp
    from flax import serialization

    from roar_tpu_torch.training.save_restore import msgpack_restore

    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "step": np.int32(7)},
            "b": np.asarray(jnp.asarray(rng.standard_normal(5), jnp.bfloat16)),
            "big": rng.standard_normal(1000).astype(np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)  # chunk "big"
    blob = serialization.msgpack_serialize(tree)
    got = msgpack_restore(blob)
    np.testing.assert_array_equal(got["a"]["kernel"], tree["a"]["kernel"])
    assert got["a"]["step"] == 7
    np.testing.assert_array_equal(got["b"], tree["b"].astype(np.float32))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_parse_applies_the_normalizer_like_jax(jax_side):
    from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel

    fp = jax_side[0]
    spell = {"text_normalizer": lambda t, **kw: t.replace("2", " two"),
             "text_normalizer_call_kwargs": {"verbose": False}}
    for cfg in ({**fp.cfg, **spell},
                {**fp.cfg, "text_normalizer": {"_target_": "no_such_package.Normalizer"}}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # both warn when the target is missing
            want = JaxFastPitchModel(cfg).parse("room 2, please")
            got = FastPitchModel(cfg).parse("room 2, please")
        np.testing.assert_array_equal(got, want)
