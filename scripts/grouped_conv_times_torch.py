#!/usr/bin/env python3
"""Time the port's grouped-conv kernels K3 (forward and dX) and K4 (dW) of
one checkout on the card.

    python3 scripts/grouped_conv_times_torch.py [--repo DIR] [--dtype bfloat16]
        [--segment 16384]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then times, at the 15
grouped-conv shapes of one multi-scale discriminator pass on a joint
real/fake batch of 32 (`--segment` 8192, configs/hifigan_22050.yaml: scales
8192 / 4097 / 2049; 16384, configs/jets_22050_align.yaml: 16384 / 8193 /
4097; k 41, pad 20), the forward (`grouped_conv_fwd`), the input gradient
(`grouped_conv_dx`) and the weight gradient (`grouped_conv_dw`), and beside
them the PyTorch calls that compute the same functions (cuDNN:
`F.conv1d(groups=g)`, `torch.nn.grad.conv1d_input` and
`torch.nn.grad.conv1d_weight`), in fp32 with TF32 off and on, or with
`--dtype bfloat16` on bf16 inputs (the bf16 kernels; cuDNN in bf16).  The
inputs, calls, timing (median of 5 by CUDA events after 2 warm-up calls) and
bounds are those of `chip_smoke.phase_kernel_grouped_conv`, from this
checkout's `chip_smoke.py`; the JSON line carries the sums over the 15
shapes, each shape's own times, each result's largest difference from the
plain version relative to the plain result's largest magnitude (`rel_err`;
in bf16 also `excess` over the bf16 bar, which passes at <= 0, and the
relative L2) and `bits`, a short SHA-256 of the kernel's result (for
bit-identity across checkouts), the bounds (fp32: three TF32 products over
the dense TF32 rate, the fp32 FMA rate beside it; bf16: the dense bf16 rate)
and the card's name and power limit.  With `--by-kernel`, each kernel call's
device time by CUDA kernel, from `torch.profiler` over 3 calls (a bf16
forward or dX call is a weight pack, a layout pass and the main kernel; a
bf16 dW call two layout passes, summed under `fold_bf16_kernel`, the main
kernel and the reduce-and-unpack pass), per shape (`by_kernel_ms`) and
summed (`by_kernel_ms` of each total).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_ms_by_kernel(fn, calls: int = 3) -> dict:
    """{CUDA kernel name: device ms per call} of `fn()`, from the CUDA
    activity of torch.profiler over `calls` calls after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = Counter()
    for event in prof.key_averages():
        name = re.search(r"(\w+_kernel)\b", event.key)
        us = (event.device_time_total if hasattr(event, "device_time_total")
              else event.cuda_time_total)
        if name is not None and us:
            out[name.group(1)] += us / calls / 1e3
    return dict(out)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(ROOT))
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--segment", type=int, choices=(8192, 16384), default=8192)
    parser.add_argument("--by-kernel", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # imports no roar_tpu_torch module at import time

    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("grouped_conv_times_torch: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    bf16 = dtype == torch.bfloat16

    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("fwd", "dx", "dw")
    total = {name: {"ms": 0.0, "library_ms": 0.0, "rel_err": 0.0, "bytes": 0.0,
                    "operations": 0.0,
                    **({"excess": -1.0, "l2": 0.0} if bf16 else {"library_tf32_ms": 0.0})}
             for name in names}
    shapes = []
    for case in cs.msd_grouped_shapes(32, args.segment):
        x, w, dy = (t.to(dtype) for t in cs.grouped_conv_inputs(case, gen, "cuda"))
        calls = cs.grouped_conv_calls(case, x, w, dy)
        row = {"shape_bwiokSgp": list(case)}
        for name in names:
            kernel, plain, library = calls[name]
            got, want = kernel(), plain()
            rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            errs = (cs.bf16_errors(got, want, got[0].numel() if name == "dw" else got.shape[-1])
                    if bf16 else {})
            bits = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest()[:16]
            del got, want
            row[name] = cs.time_grouped_conv(kernel, library, tf32=not bf16)
            for key, value in row[name].items():
                total[name][key] += value
            if args.by_kernel:
                row[name]["by_kernel_ms"] = device_ms_by_kernel(kernel)
                summed = total[name].setdefault("by_kernel_ms", {})
                for key, value in row[name]["by_kernel_ms"].items():
                    summed[key] = summed.get(key, 0.0) + value
            row[name].update(rel_err=rel, bits=bits)
            total[name]["rel_err"] = max(total[name]["rel_err"], rel)
            if bf16:
                row[name].update(excess=errs["excess"], l2=errs["l2"])
                total[name]["excess"] = max(total[name]["excess"], errs["excess"])
                total[name]["l2"] = max(total[name]["l2"], errs["l2"])
            bound = cs.grouped_conv_case_bound(name, case, x, w, dy)
            total[name]["bytes"] += bound["bytes"]
            total[name]["operations"] += bound["operations"]
        shapes.append(row)
        del x, w, dy, calls
        torch.cuda.empty_cache()
    for name in names:
        acc = total[name]
        acc.update(cs._bound(acc["bytes"], acc["operations"], cs.BF16_FLOPS) if bf16 else
                   {k: v for k, v in cs.grouped_conv_bound(name, acc["bytes"],
                                                          acc["operations"]).items()
                    if k.startswith("bound")})
        acc["bound_share"] = acc["bound_ms"] / acc["ms"]
    result = {"repo": str(Path(args.repo).resolve()), "card": card, "dtype": args.dtype,
              "batch": 32, "segment": args.segment, "shapes": len(shapes), **total,
              "by_shape": shapes}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
