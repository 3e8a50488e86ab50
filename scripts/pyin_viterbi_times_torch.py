#!/usr/bin/env python3
"""Time the port's pYIN Viterbi kernels K1 (forward) and K2 (backtrack) of
one checkout on the card.

    python3 scripts/pyin_viterbi_times_torch.py [--repo DIR] [--reps N]

Imports `roar_tpu_torch` from `--repo` (default: this checkout), so that two
checkouts can be timed in turns in one run on one card (parent, change,
change, parent).  Builds that checkout's kernels, then at (B, T, N, W) =
(16, 449, 601, 101), the sup-data CLI's bucket of 10 s utterances at the
widths of configs/ds_for_fastpitch_align.yaml, and at B 128, times K1
(`viterbi_forward`) and K2 (`viterbi_backtrack`) on the inputs of
`chip_smoke.phase_kernel_viterbi` (seeded, with its tie rows), by CUDA events,
median of `--reps` calls after two warm-up calls; where the checkout's
`viterbi_forward` takes `cluster=`, also K1 with every admissible cluster
size forced.  Each result is checked against the plain version
(`torch.equal`), and `bits` is a short SHA-256 of the pointers, final scores
and states, for bit-identity across checkouts.  Bounds are
`chip_smoke.viterbi_bounds`.  One JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(16, 449, 601, 101), (128, 449, 601, 101)]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(ROOT))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # imports no roar_tpu_torch module at import time

    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pyin_viterbi_times_torch: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    from roar_tpu_torch.kernels import pyin_viterbi as pv
    from roar_tpu_torch.ops.pyin import _band_tables

    takes_cluster = "cluster" in inspect.signature(pv.viterbi_forward).parameters
    rng = np.random.default_rng(cs.SEED)
    log_stay, log_switch = float(np.log1p(-0.01)), float(np.log(0.01))
    out = {"repo": str(Path(args.repo).resolve()), "card": card, "shapes": []}
    for b, t, n, w in SHAPES:
        log_obs = torch.from_numpy(cs.viterbi_log_obs(rng, b, t, n, ties=True)).cuda()
        log_tri, log_norm = (torch.from_numpy(a).cuda() for a in _band_tables(n, w))
        fwd_args = (log_obs, log_tri, log_norm, log_stay, log_switch)
        want_ptrs, want_final = pv.viterbi_forward_plain(*fwd_args)
        last = torch.argmax(want_final, dim=-1).to(torch.int32)
        want_states = pv.viterbi_backtrack_plain(want_ptrs, last)
        ptrs, v_final = pv.viterbi_forward(*fwd_args)
        states = pv.viterbi_backtrack(ptrs, last)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for x in (ptrs, v_final, states):
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        fwd_bound, back_bound = cs.viterbi_bounds(b, t, n, w)
        row = {"shape_btnw": [b, t, n, w],
               "equal_plain": bool(torch.equal(ptrs, want_ptrs) and torch.equal(v_final, want_final)
                                   and torch.equal(states, want_states)),
               "bits": digest.hexdigest()[:16],
               "fwd_ms": cs._time_ms(lambda: pv.viterbi_forward(*fwd_args), reps=args.reps),
               "backtrack_ms": cs._time_ms(lambda: pv.viterbi_backtrack(ptrs, last),
                                           reps=args.reps),
               "fwd_bound_ms": fwd_bound["bound_ms"], "backtrack_bound_ms": back_bound["bound_ms"]}
        if takes_cluster:
            sm_count = torch.cuda.get_device_properties(0).multi_processor_count
            row["cluster"] = pv.cluster_size(b, n, w, sm_count)
            row["forced"] = {}
            for c in (1, 2, 4, 8):
                if not pv.cluster_admissible(n, w, c):
                    continue
                got = pv.viterbi_forward(*fwd_args, cluster=c)
                row["forced"][c] = {
                    "equal_plain": bool(torch.equal(got[0], want_ptrs)
                                        and torch.equal(got[1], want_final)),
                    "ms": cs._time_ms(lambda: pv.viterbi_forward(*fwd_args, cluster=c),
                                      reps=args.reps),
                    "max_active_clusters": pv.max_active_clusters(b, n, w, c)}
                del got
        out["shapes"].append(row)
        del log_obs, ptrs, v_final, states, want_ptrs, want_final, want_states
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
