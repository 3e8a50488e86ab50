#!/usr/bin/env python3
"""Time the port's causal flash-attention kernels of one checkout on the card.

    python3 scripts/flash_kernel_times_torch.py [--repo DIR] [--shape B T H D]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then times at `--shape`
(default the GPT path's (1, 4096, 32, 64)) in bf16 with `causal=True`: the
forward with its log-sum-exp, the dK/dV kernel and the dQ kernel, each the
median of 20 calls by CUDA events after 3 warm-up calls.  Prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--shape", type=int, nargs=4, default=[1, 4096, 32, 64])
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))

    import numpy as np
    import torch

    from roar_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_kernel_times_torch: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    b, t, h, d = args.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_self_attention(q, k, v, None, scale, return_lse=True, causal=True)
    delta = (out.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()

    def timed(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def bwd(**kw):
        return fa.flash_self_attention_bwd(q, k, v, None, scale, out, lse, do, delta=delta,
                                           causal=True, **kw)

    result = {
        "repo": str(Path(args.repo).resolve()), "shape_bthd": [b, t, h, d], "dtype": "bfloat16",
        "card": card,
        "fwd_with_lse_ms": timed(lambda: fa.flash_self_attention(
            q, k, v, None, scale, return_lse=True, causal=True)),
        "dkv_ms": timed(lambda: bwd(need_dq=False)),
        "dq_ms": timed(lambda: bwd(need_dkv=False)),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
