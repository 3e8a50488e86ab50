"""chip_smoke.py's phase `align_and_train_durations`, rehearsed on the CPU at a
narrow width: phase `train_fastpitch` keeps its corpus, sup-data and bundle;
the Aligner CLI trains on configs/aligner.yaml with FastPitch's STFT and
tokenizer until the bin loss switches on, aligns the corpus (durations that
sum to the mel lengths), and the FastPitch CLI trains on those durations with
`remat` on both stacks; the step with `remat` equals the step without it bit
for bit; one bf16 step; `parse` through the ENCharParser and `infer`; and
GST's `infer` with two reference mels (the kernels' plain versions on both
paths here)."""

import shutil
import tempfile

import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_align_and_train_durations_phase_rehearsal():
    import chip_smoke as cs

    keep = tempfile.mkdtemp()
    try:
        fp = cs.phase_train_fastpitch(torch.device("cpu"), n_utterances=8, steps=4, batch_size=2,
                                      max_seconds=1.5, narrow=True, keep_dir=keep)
        out = cs.phase_align_and_train_durations(torch.device("cpu"), fp["kept"], steps=4,
                                                 aligner_batch=4, narrow=True)
    finally:
        shutil.rmtree(keep)
    # a step with remat counts two forwards a layer; the kernels' counts stay 0 here
    assert out["step_launches"] == {"fwd": 8, "dkv": 4, "dq": 4}
    assert out["launches"] == {"fwd": 0, "dkv": 0, "dq": 0} and out["gst_launches"] == 0
    assert out["timing"] is None and out["wall_s"] > 0
