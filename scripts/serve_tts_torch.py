#!/usr/bin/env python
"""Serve text->wav synthesis over HTTP on a CUDA card with the PyTorch port.

    python scripts/serve_tts_torch.py --fastpitch fp.roar --vocoder hifigan.roar \
        [--host 127.0.0.1] [--port 8000] [--max-batch 8] [--max-wait-ms 5] \
        [--text-buckets 32,64,128,256] [--frames-per-token 12] [--no-warmup]

The same flags and protocol as scripts/serve_tts.py, served by roar_tpu_torch:
the bundles are the JAX package's `.roar` archives (training/save_restore.py),
read without jax or flax and converted to the port's weights.
`POST /synthesize` with `{"text": "...", "speaker": 0, "pace": 1.0}` returns
16-bit PCM WAV; `GET /healthz` returns serving counters.  `warmup()` runs every
(text-bucket, batch-bucket) shape once before the socket opens, which builds
the CUDA kernels and lets cuDNN autotune each shape.
"""

import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fastpitch", required=True, help=".roar FastPitch bundle")
    p.add_argument("--vocoder", required=True, help=".roar HiFi-GAN bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--text-buckets", default="32,64,128,256")
    p.add_argument("--batch-buckets", default="1,2,4,8")
    p.add_argument("--frames-per-token", type=int, default=12)
    p.add_argument("--pace", type=float, default=1.0)
    p.add_argument("--no-warmup", action="store_true")
    args = p.parse_args()

    from roar_tpu_torch.serving import engine_from_bundles, make_server

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("serve_tts_torch")
    engine = engine_from_bundles(
        args.fastpitch,
        args.vocoder,
        device="cuda",
        text_buckets=tuple(int(x) for x in args.text_buckets.split(",")),
        batch_buckets=tuple(int(x) for x in args.batch_buckets.split(",")),
        frames_per_token=args.frames_per_token,
        pace=args.pace,
    )
    if not args.no_warmup:
        n = engine.warmup()
        log.info(f"warmed up {n} (text-bucket x batch-bucket) programs")
    server = make_server(engine, host=args.host, port=args.port,
                         max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    log.info(
        f"serving text->wav on http://{args.host}:{args.port} "
        f"(sample_rate={engine.sample_rate}, max_batch={args.max_batch}, "
        f"max_wait={args.max_wait_ms}ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        engine.close()


if __name__ == "__main__":
    main()
