#!/usr/bin/env python3
"""Time the port's flash-attention kernels of one checkout on the card.

    python3 scripts/flash_kernel_times_torch.py [--repo DIR] [--dtype {bfloat16,float32}]
        [--shape B T H D [--shape B T H D ...] [--non-causal [--ragged]]]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then times in `--dtype`
(default bf16), with no padding mask, the GPT path's (1, 4096, 32, 64) with
`causal=True` and the 20 s FastPitch bucket's (32, 864, 1, 64) without it (or
only the `--shape`s, causal unless `--non-causal`): the forward with its
log-sum-exp, the dK/dV kernel, the dQ kernel, the whole backward as the
autograd Function calls it (delta + dK/dV + dQ) and, as yardsticks,
`F.scaled_dot_product_attention` and its autograd, each the median of 20
calls by CUDA events after 3 warm-up calls.  With `--ragged` (non-causal only) each batch
row has a seeded valid length in [0.4 T, T] (the first T) and the segment
mask of padding, as FastPitch's batches have, and SDPA takes that mask.
Beside them each kernel's own bound, from the visible (query, key) pairs:
the forward's two T x T x D products (4 pairs D operations per head and
batch row), the dQ kernel's three (6 pairs D) and the dK/dV kernel's four
(8 pairs D), in bf16 over the 989 TFLOP/s dense bf16 peak; in fp32 over the
3xTF32 rate (494.7 TFLOP/s dense TF32 over three products), with the same
work over the 67 TFLOP/s of the fp32 FMA pipe beside.  In fp32 also the
largest difference of o, lse and each gradient from the plain versions
(`flash_self_attention_plain`, `flash_self_attention_bwd_plain`) over its
largest magnitude.  `bits` holds a short SHA-256 of each kernel's result,
the backward's taken from the plain forward's o and lse, so that two
checkouts' kernels can be shown bit-identical (or not) on the same inputs.
In bf16 without a mask, `streamed_tile_gb` reckons from the shape the bytes
of the other side's 64-row tiles that the dK/dV kernel (Q and dO) and the dQ
kernel (K and V) read a call, mostly from L2, at the kernel's head size,
when a block owns 64 rows (the mma.sync kernels at D <= 64, the wgmma ones at
D 256) or 128 (the wgmma ones at D 128).  Prints one JSON line per shape with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

# H100 SXM, NVIDIA's data sheet: dense bf16, dense TF32, fp32 outside the tensor cores
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
FP32_FLOPS = 67e12
CASES = (((1, 4096, 32, 64), True), ((32, 864, 1, 64), False))
TILE = 64  # rows of a streamed tile


def streamed_tile_gb(b: int, t: int, h: int, d: int, causal: bool, rows: int) -> dict:
    """GB of streamed 64-row bf16 tiles (two tensors each) that the dK/dV and
    the dQ kernel read a call when a block owns `rows` rows, no mask: with
    `causal` a dK/dV block walks the tiles from its own first row on and a dQ
    block those up to its last row; without, every tile."""
    tiles = -(-t // TILE)
    walked = {"dkv": 0, "dq": 0}
    for r0 in range(0, t, rows):
        walked["dkv"] += tiles - r0 // TILE if causal else tiles
        walked["dq"] += -(-min(t, r0 + rows) // TILE) if causal else tiles
    return {name: n * b * h * 2 * TILE * d * 2 / 1e9 for name, n in walked.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--shape", type=int, nargs=4, action="append", default=None)
    parser.add_argument("--non-causal", action="store_true")
    parser.add_argument("--ragged", action="store_true")
    args = parser.parse_args()
    if args.ragged and not args.non_causal:
        parser.error("--ragged takes --non-causal")
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
    cases = CASES if args.shape is None else [(tuple(s), not args.non_causal) for s in args.shape]
    dtype = getattr(torch, args.dtype)

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
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        scale = 1.0 / d ** 0.5
        key_mask, how, pairs = None, {"is_causal": causal}, t * (t + 1) // 2 if causal else t * t
        if args.ragged:
            lens = np.random.default_rng(0).integers(int(0.4 * t), t + 1, b)
            lens[0] = t
            key_mask = (torch.arange(t, device="cuda")[None, :]
                        < torch.tensor(lens, device="cuda")[:, None])
            how = {"attn_mask": key_mask[:, None, :, None] == key_mask[:, None, None, :]}
            pairs = float(np.mean([n * n + (t - n) * (t - n) for n in lens]))
        out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True, causal=causal)
        delta = (out.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()

        def bwd(**kw):
            return fa.flash_self_attention_bwd(q, k, v, key_mask, scale, out, lse, do,
                                               causal=causal, **kw)

        qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_(True) for z in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, **how)
        lib_do = do.transpose(1, 2)
        result = {
            "repo": str(Path(args.repo).resolve()), "shape_bthd": [b, t, h, d],
            "causal": causal, "ragged": args.ragged, "dtype": args.dtype, "card": card,
            "fwd_with_lse_ms": timed(lambda: fa.flash_self_attention(
                q, k, v, key_mask, scale, return_lse=True, causal=causal)),
            "fwd_library_ms": timed(lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), scale=scale, **how)),
            "dkv_ms": timed(lambda: bwd(need_dq=False, delta=delta)),
            "dq_ms": timed(lambda: bwd(need_dkv=False, delta=delta)),
            "backward_ms": timed(bwd),
            "backward_library_ms": timed(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), lib_do, retain_graph=True)),
        }
        peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS / 3
        for name, per_pair, timed_as in (("fwd", 4.0, "fwd_with_lse"), ("dkv", 8.0, "dkv"),
                                         ("dq", 6.0, "dq")):
            ops = per_pair * pairs * b * h * d
            result[f"{name}_own_bound_ms"] = ops / peak * 1e3
            result[f"{name}_own_bound_share"] = (result[f"{name}_own_bound_ms"]
                                                 / result[f"{timed_as}_ms"])
            if dtype == torch.float32:
                result[f"{name}_own_bound_fp32_fma_ms"] = ops / FP32_FLOPS * 1e3
        if dtype == torch.float32:
            got = (out, lse, *bwd())
            out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal)
            want = (out_p, lse_p, *fa.flash_self_attention_bwd_plain(
                q, k, v, key_mask, scale, out, lse, do, causal))
            result["rel_to_largest"] = {
                name: float((a - w).abs().max() / w.abs().max())
                for name, a, w in zip(("o", "lse", "dq", "dk", "dv"), got, want)}
            del got, want, out_p, lse_p
        out_p, lse_p = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal)
        results = (out, lse, *fa.flash_self_attention_bwd(q, k, v, key_mask, scale,
                                                          out_p.contiguous(), lse_p, do,
                                                          causal=causal))
        if dtype == torch.bfloat16 and not args.ragged:
            kernel_d = fa.kernel_head_dim(d, dtype, True)  # the padded route's tiles
            result["streamed_tile_gb"] = {
                f"{rows}_row_blocks": streamed_tile_gb(b, t, h, kernel_d, causal, rows)
                for rows in (64, 128)}
        result["bits"] = {name: hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy()
                                               .tobytes()).hexdigest()[:16]
                          for name, x in zip(("o", "lse", "dq", "dk", "dv"), results)}
        del out_p, lse_p, results
        print(json.dumps(result), flush=True)
        del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out, key_mask, how
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
