#!/usr/bin/env python3
"""Time the port's grouped-conv kernels K3 (forward and dX) and K4 (dW) of
one checkout on the card.

    python3 scripts/grouped_conv_times_torch.py [--repo DIR]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then times, at the 15
grouped-conv shapes of one multi-scale discriminator pass of
configs/hifigan_22050.yaml on a joint real/fake batch (B 32, segment 8192:
scales 8192 / 4097 / 2049, k 41, pad 20), the forward
(`grouped_conv_fwd`), the input gradient (`grouped_conv_dx`) and the weight
gradient (`grouped_conv_dw`), and beside them the PyTorch calls that compute
the same functions (cuDNN: `F.conv1d(groups=g)`, `torch.nn.grad.conv1d_input`
and `torch.nn.grad.conv1d_weight`) with TF32 off and on.  The inputs, calls,
timing (median of 5 by CUDA events after 2 warm-up calls) and bounds are
those of `chip_smoke.phase_kernel_grouped_conv`, from this checkout's
`chip_smoke.py`; the JSON line carries the sums over the 15 shapes, each
shape's own times, each result's largest difference from the plain version
relative to the plain result's largest magnitude (`rel_err`) and `bits`, a
short SHA-256 of the kernel's result (for bit-identity across checkouts), the
bounds (three TF32 products over the dense TF32 rate, and the fp32 FMA rate
beside it; the three kernels do the same work on the same three tensors), and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(ROOT))
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("fwd", "dx", "dw")
    total = {name: {"ms": 0.0, "library_ms": 0.0, "library_tf32_ms": 0.0, "rel_err": 0.0}
             for name in names}
    bytes_total, flops_total, shapes = 0.0, 0.0, []
    for case in cs.msd_grouped_shapes():
        x, w, dy = cs.grouped_conv_inputs(case, gen, "cuda")
        calls = cs.grouped_conv_calls(case, x, w, dy)
        row = {"shape_bwiokSgp": list(case)}
        for name in names:
            kernel, plain, library = calls[name]
            got, want = kernel(), plain()
            rel = float((got - want).abs().max() / want.abs().max())
            bits = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest()[:16]
            del got, want
            row[name] = cs.time_grouped_conv(kernel, library)
            for key, value in row[name].items():
                total[name][key] += value
            row[name].update(rel_err=rel, bits=bits)
            total[name]["rel_err"] = max(total[name]["rel_err"], rel)
        bound = cs.grouped_conv_case_bound("fwd", case, x, w, dy)
        bytes_total += bound["bytes"]
        flops_total += bound["operations"]
        shapes.append(row)
        del x, w, dy, calls
        torch.cuda.empty_cache()
    result = {"repo": str(Path(args.repo).resolve()), "card": card, "shapes": len(shapes),
              **total, **cs.grouped_conv_bound("fwd", bytes_total, flops_total),
              "by_shape": shapes}
    for name in names:
        result[name]["bound_share"] = result["bound_ms"] / result[name]["ms"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
