"""TTS serving on a CUDA device: bucketed synthesis engine, dynamic
micro-batching, HTTP.

Port of roar_tpu/serving.py with the same buckets and the same HTTP protocol.
One request batch is one device program: FastPitch `infer`, then the HiFi-GAN
generator, then int16 PCM made on the device, under `torch.inference_mode()`.
Only the live rows of the padded batch, as int16, go back to the host.

Token lengths round up to `text_buckets` and request groups to
`batch_buckets`, so the device sees a few fixed shapes.  PyTorch compiles
nothing per shape; `warmup()` runs every bucket once so that the CUDA kernels
are built and loaded and cuDNN has autotuned each conv shape
(`torch.backends.cudnn.benchmark` is turned on for a CUDA engine) before the
first request.  Every device program runs on the engine's one device thread,
whoever calls: PyTorch keeps cuDNN's autotuning results per thread (on an
H100, one batch of 4 requests warmed on another thread took 9.2 s, against
0.34 s on the warmed thread), and one thread also keeps programs from
interleaving on the device.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import queue
import threading
import wave
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class SynthesisEngine:
    """Bucketed text->wav synthesis over FastPitch + a HiFi-GAN generator.

    Args:
      fastpitch: port FastPitchModel (tokenizer + module).
      generator: port HiFi-GAN Generator.
      device: where the models run; they are moved there.
      text_buckets: allowed padded token lengths.
      batch_buckets: allowed padded batch sizes.
      frames_per_token: decoder mel budget per input token; sets the
        decoder length `max_mel_len` of each text bucket (rounded up to 16).
      pace: default duration-regulation pace.
    """

    def __init__(self, fastpitch, generator, device="cuda",
                 text_buckets: Sequence[int] = (32, 64, 128, 256),
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 frames_per_token: int = 12, pace: float = 1.0):
        self.device = torch.device(device)
        self.fastpitch = fastpitch
        self.module = fastpitch.module.to(self.device).eval()
        self.generator = generator.to(self.device).eval()
        self.text_buckets = tuple(sorted(text_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.frames_per_token = int(frames_per_token)
        self.default_pace = float(pace)
        self.hop = generator.upsample_factor
        self.sample_rate = fastpitch.sample_rate
        self.multispeaker = self.module.n_speakers > 1
        self._pad_id = fastpitch.tokenizer.pad if fastpitch.tokenizer else 0
        self._device_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="roar-synth")
        self.programs_run = 0  # device programs (request batches) run so far
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True

    # -- shape bookkeeping ------------------------------------------------
    def _text_bucket(self, n: int) -> int:
        for b in self.text_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"text of {n} tokens exceeds the largest bucket "
            f"{self.text_buckets[-1]}; raise text_buckets")

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _mel_cap(self, text_bucket: int) -> int:
        return _round_up(text_bucket * self.frames_per_token, 16)

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    # -- the device program -----------------------------------------------
    @torch.inference_mode()
    def _synth(self, tokens: np.ndarray, speaker: Optional[np.ndarray], pace: float,
               mel_cap: int, n_live: int):
        """Padded tokens -> (int16 PCM [n_live, mel_cap * hop], frames [n_live])
        on the host."""
        tokens_d = torch.from_numpy(tokens).to(self.device, non_blocking=True)
        speaker_d = (torch.from_numpy(speaker).to(self.device, non_blocking=True)
                     if speaker is not None else None)
        out = self.module.infer(tokens_d, speaker=speaker_d, pace=pace, max_mel_len=mel_cap)
        audio = self.generator(out["spect"])
        pcm = torch.round(torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        self.programs_run += 1
        # only the live rows travel to the host
        return pcm[:n_live].cpu().numpy(), out["num_frames"][:n_live].cpu().numpy()

    # -- synthesis --------------------------------------------------------
    def synthesize_batch(self, texts: Sequence[str],
                         speakers: Optional[Sequence[Optional[int]]] = None,
                         pace: Optional[float] = None) -> List[np.ndarray]:
        """Synthesize a list of texts in one device program per `max_batch`
        group.  Returns one int16 PCM waveform per text, trimmed to its
        predicted length, at `self.sample_rate`."""
        if not texts:
            return []
        if len(texts) > self.max_batch:
            out: List[np.ndarray] = []
            for i in range(0, len(texts), self.max_batch):
                out.extend(self.synthesize_batch(
                    texts[i: i + self.max_batch],
                    speakers[i: i + self.max_batch] if speakers else None, pace))
            return out

        token_rows = [self.fastpitch.parse(t)[0] for t in texts]
        t_bucket = self._text_bucket(max(len(r) for r in token_rows))
        b_bucket = self._batch_bucket(len(texts))
        tokens = np.full((b_bucket, t_bucket), self._pad_id, np.int64)
        for i, row in enumerate(token_rows):
            tokens[i, : len(row)] = row
        speaker = None
        if self.multispeaker:
            ids = [(speakers[i] if speakers else None) or 0 for i in range(len(texts))]
            speaker = np.pad(np.asarray(ids, np.int64), (0, b_bucket - len(ids)))
        audio, n_frames = self._device_thread.submit(
            self._synth, tokens, speaker, self.default_pace if pace is None else float(pace),
            self._mel_cap(t_bucket), len(texts)).result()
        return [audio[i, : int(n_frames[i]) * self.hop] for i in range(len(texts))]

    def _split_text(self, text: str) -> List[str]:
        """Sentence-split `text` into chunks that each fit the largest text
        bucket: split at sentence punctuation (., !, ?, ;, the devanagari
        danda, and newlines), then hard-split any oversized piece at the last
        space under the limit, checked with a real parse."""
        import re

        limit = self.text_buckets[-1]
        pieces = [p.strip() for p in re.split(r"(?<=[.!?;।\n])\s*", text) if p.strip()]
        chunks: List[str] = []
        for piece in pieces or [text]:
            while len(self.fastpitch.parse(piece)[0]) > limit:
                cut = piece.rfind(" ", 0, limit)
                cut = cut if cut > 0 else limit
                head, tail = piece[:cut].strip(), piece[cut:].strip()
                # normalization can expand text, so shrink the cut until the
                # head's tokens fit
                while head and len(self.fastpitch.parse(head)[0]) > limit:
                    c = head.rfind(" ")
                    if c <= 0:
                        break
                    head, tail = head[:c].strip(), (head[c:] + " " + tail).strip()
                if head:
                    chunks.append(head)
                if tail == piece:  # no progress possible
                    break
                piece = tail
            if piece:
                chunks.append(piece)
        return chunks

    def synthesize_long(self, text: str, speaker: Optional[int] = None,
                        pace: Optional[float] = None, gap_ms: float = 0.0) -> np.ndarray:
        """Synthesize arbitrarily long text as one waveform: sentence chunks
        run batched and join with `gap_ms` of silence."""
        chunks = self._split_text(text)
        waves = self.synthesize_batch(
            chunks, [speaker] * len(chunks) if speaker is not None else None, pace)
        if len(waves) == 1 and gap_ms <= 0:
            return waves[0]
        gap = np.zeros(int(self.sample_rate * gap_ms / 1e3), waves[0].dtype)
        out: List[np.ndarray] = []
        for i, w in enumerate(waves):
            if i:
                out.append(gap)
            out.append(w)
        return np.concatenate(out)

    def synthesize_stream(self, text: str, speaker: Optional[int] = None,
                          pace: Optional[float] = None, xfade_ms: float = 8.0):
        """Yield int16 PCM chunks of `text` as each is synthesized: the first
        sentence runs alone in the smallest batch bucket, the rest in batches
        of up to `max_batch`; joins are raised-cosine crossfaded over
        `xfade_ms`."""
        chunks = self._split_text(text)
        spk = [speaker] if speaker is not None else None
        n_x = int(self.sample_rate * xfade_ms / 1e3)
        fade_in = (0.5 - 0.5 * np.cos(np.pi * (np.arange(1, n_x + 1) / (n_x + 1)))
                   if n_x else np.zeros(0))

        def waves():
            yield self.synthesize_batch(chunks[:1], spk, pace)[0]
            for i in range(1, len(chunks), self.max_batch):
                group = chunks[i: i + self.max_batch]
                yield from self.synthesize_batch(
                    group, [speaker] * len(group) if speaker is not None else None, pace)

        tail: Optional[np.ndarray] = None
        last = len(chunks) - 1
        for i, w in enumerate(waves()):
            w = w.astype(np.float32)
            if tail is not None:
                k = min(len(tail), len(w))
                head = w[:k] * fade_in[:k] + tail[:k] * (1.0 - fade_in[:k])
                w = np.concatenate([head, tail[k:] * (1.0 - fade_in[k:]), w[k:]])
            if i < last and len(w) > n_x:
                w, tail = w[: len(w) - n_x], w[len(w) - n_x:]
            else:
                tail = None
            yield np.clip(w, -32768, 32767).astype(np.int16)

    def warmup(self, batch_buckets: Optional[Sequence[int]] = None) -> int:
        """Run every (text_bucket, batch_bucket) shape once; returns how many."""
        n = 0
        for b in batch_buckets or self.batch_buckets:
            for t in self.text_buckets:
                self.synthesize_batch(["a" * max(1, t // 2)] * b)
                n += 1
        return n

    def close(self) -> None:
        """Stop the device thread once the programs already queued are done."""
        self._device_thread.shutdown()

    def wav_stream_header(self) -> bytes:
        """WAV header for a stream of unknown length (RIFF and data sizes
        0xFFFFFFFF); raw little-endian int16 chunks follow."""
        import struct

        return b"".join([
            b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
            b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, self.sample_rate,
                                 self.sample_rate * 2, 2, 16),
            b"data", struct.pack("<I", 0xFFFFFFFF),
        ])

    def to_wav_bytes(self, waveform: np.ndarray) -> bytes:
        """int16 PCM (engine output) or float32 in [-1, 1] -> WAV bytes."""
        if waveform.dtype == np.int16:
            pcm = waveform.astype("<i2", copy=False)
        else:
            pcm = (np.clip(waveform, -1.0, 1.0) * 32767.0).astype("<i2")
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            w.writeframes(pcm.tobytes())
        return buf.getvalue()


def engine_from_bundles(fastpitch_path: str, vocoder_path: str, device="cuda",
                        **engine_kwargs) -> SynthesisEngine:
    """Build a SynthesisEngine from two `.roar` bundles written by the JAX
    package's training CLIs: a FastPitch task and a HiFi-GAN vocoder task.
    The vocoder's tree may be the generator's alone or the full GAN state's
    `{'g_params': ..., 'd_params': ...}`."""
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel
    from roar_tpu_torch.models.hifigan_model import vocoder_from_config
    from roar_tpu_torch.training.convert import load_fastpitch_params, load_generator_params
    from roar_tpu_torch.training.save_restore import restore_from

    fp_cfg, fp_params = restore_from(fastpitch_path)
    voc_cfg, voc_params = restore_from(vocoder_path)
    fp = FastPitchModel(fp_cfg.get("model", fp_cfg))
    load_fastpitch_params(fp.module, fp_params)
    gen = vocoder_from_config(voc_cfg.get("model", voc_cfg))
    if "g_params" in voc_params:
        voc_params = voc_params["g_params"]
    load_generator_params(gen, voc_params)
    return SynthesisEngine(fp, gen, device=device, **engine_kwargs)


class DynamicBatcher:
    """Coalesce concurrent single-text requests into engine batches.

    A background worker takes the first queued request, then keeps accepting
    more until `max_wait_ms` elapses or `max_batch` requests are pending, and
    runs them as one `synthesize_batch` call.
    """

    def __init__(self, engine: SynthesisEngine, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, text: str, speaker: Optional[int] = None, pace: Optional[float] = None):
        """Enqueue a request; returns a Future whose result is the waveform
        (or raises the synthesis error)."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._q.put((text, speaker, pace, fut))
        return fut

    def _run(self):
        import time

        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.monotonic() + self.max_wait
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            # pace is per batch: requests asking for another pace go back to
            # the queue and form their own batch next round
            pace = group[0][2]
            same = [g for g in group if g[2] == pace]
            for d in (g for g in group if g[2] != pace):
                self._q.put(d)
            try:
                waves = self.engine.synthesize_batch(
                    [g[0] for g in same], [g[1] for g in same], pace)
                for (_, _, _, fut), w in zip(same, waves):
                    fut.set_result(w)
                self.batches_run += 1
                self.requests_served += len(same)
            except Exception as e:  # the worker must survive: hand it to every waiter
                for _, _, _, fut in same:
                    if not fut.done():
                        fut.set_exception(e)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)


def make_server(engine: SynthesisEngine, host: str = "127.0.0.1", port: int = 8000,
                max_batch: Optional[int] = None, max_wait_ms: float = 5.0,
                request_timeout_s: float = 60.0):
    """Build (but do not start) a ThreadingHTTPServer serving:

    - `POST /synthesize` with JSON `{"text": ..., "speaker": int?, "pace": float?}`
      -> `audio/wav` (16-bit PCM at the model's sample rate);
    - `POST /synthesize` with `"stream": true` -> chunked `audio/wav`: a
      streaming header, then one body chunk per synthesized sentence chunk;
    - `GET /healthz` -> `{"status": "ok", ...counters}`.

    The server owns a DynamicBatcher (`server.batcher`); call
    `server.shutdown()`, `server.server_close()` and `server.batcher.close()`
    to stop it.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = DynamicBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

        def log_message(self, *a):
            pass

        def _json(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "sample_rate": engine.sample_rate,
                    "batches_run": batcher.batches_run,
                    "requests_served": batcher.requests_served,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except Exception as e:  # any malformed body is the client's error
                self._json(400, {"error": f"bad request: {e}"})
                return
            if req.get("stream"):
                try:
                    gen = engine.synthesize_stream(
                        text, req.get("speaker"), req.get("pace"),
                        xfade_ms=float(req.get("xfade_ms", 8.0)))
                    first = next(gen)  # synthesize before committing a 200
                except Exception as e:  # reported to the client as a 500
                    self._json(500, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(b: bytes):
                    self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                    self.wfile.flush()

                # after the 200 an error cannot become a status; without the
                # terminating chunk a keep-alive client would wait for its
                # timeout, so drop the connection instead
                terminated = False
                try:
                    chunk(engine.wav_stream_header() + first.astype("<i2").tobytes())
                    for w in gen:
                        chunk(w.astype("<i2").tobytes())
                    self.wfile.write(b"0\r\n\r\n")
                    terminated = True
                finally:
                    if not terminated:
                        self.close_connection = True
                return
            try:
                if len(engine.fastpitch.parse(text)[0]) > engine.text_buckets[-1]:
                    # long-form text runs outside the micro-batch queue, where
                    # it would stall short requests
                    wavf = engine.synthesize_long(
                        text, req.get("speaker"), req.get("pace"),
                        gap_ms=float(req.get("gap_ms", 0.0)))
                else:
                    wavf = batcher.submit(text, req.get("speaker"), req.get("pace")).result(
                        timeout=request_timeout_s)
                body = engine.to_wav_bytes(wavf)
            except Exception as e:  # reported to the client as a 500
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server
