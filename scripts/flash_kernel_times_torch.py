#!/usr/bin/env python3
"""Time the port's bf16 flash-attention kernels of one checkout on the card.

    python3 scripts/flash_kernel_times_torch.py [--repo DIR] [--shape B T H D [--non-causal]]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then times in bf16, with no
padding mask, the GPT path's (1, 4096, 32, 64) with `causal=True` and the
20 s FastPitch bucket's (32, 864, 1, 64) without it (or only `--shape`): the
forward with its log-sum-exp, the dK/dV kernel, the dQ kernel, the whole
backward as the autograd Function calls it (delta + dK/dV + dQ) and, as a
yardstick, autograd of `F.scaled_dot_product_attention`, each the median of
20 calls by CUDA events after 3 warm-up calls.  Beside them the dQ kernel's
own bound: its three T x T x D products (6 pairs D operations per head and
batch row) over the 989 TFLOP/s dense bf16 peak.  Prints one JSON line per
shape with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA's data sheet
CASES = (((1, 4096, 32, 64), True), ((32, 864, 1, 64), False))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--shape", type=int, nargs=4, default=None)
    parser.add_argument("--non-causal", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from roar_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_kernel_times_torch: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cases = CASES if args.shape is None else ((tuple(args.shape), not args.non_causal),)

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

    for (b, t, h, d), causal in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_self_attention(q, k, v, None, scale, return_lse=True, causal=causal)
        delta = (out.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()

        def bwd(**kw):
            return fa.flash_self_attention_bwd(q, k, v, None, scale, out, lse, do,
                                               causal=causal, **kw)

        qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_(True) for z in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, is_causal=causal)
        lib_do = do.transpose(1, 2)
        pairs = t * (t + 1) // 2 if causal else t * t
        result = {
            "repo": str(Path(args.repo).resolve()), "shape_bthd": [b, t, h, d],
            "causal": causal, "dtype": "bfloat16", "card": card,
            "fwd_with_lse_ms": timed(lambda: fa.flash_self_attention(
                q, k, v, None, scale, return_lse=True, causal=causal)),
            "dkv_ms": timed(lambda: bwd(need_dq=False, delta=delta)),
            "dq_ms": timed(lambda: bwd(need_dkv=False, delta=delta)),
            "backward_ms": timed(bwd),
            "backward_library_ms": timed(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), lib_do, retain_graph=True)),
            "dq_own_bound_ms": 6.0 * pairs * b * h * d / BF16_FLOPS * 1e3,
        }
        result["dq_own_bound_share"] = result["dq_own_bound_ms"] / result["dq_ms"]
        print(json.dumps(result), flush=True)
        del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
