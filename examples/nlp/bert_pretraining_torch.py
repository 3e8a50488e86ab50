"""BERT pretraining (MLM + NSP) on a raw text corpus with the PyTorch port, on
one CUDA card.

Same config and overrides as examples/nlp/bert_pretraining.py:

    python examples/nlp/bert_pretraining_torch.py --config-name=bert_pretraining \
        train_dataset=corpus.txt trainer.max_steps=1000 [+device=cuda]

`train_dataset` is a text file, one sentence per line; `validation_dataset`
an optional second one.  The SimpleWordTokenizer is built from both, the
masked sentence pairs come from `BertPretrainingDataset` (the same seed gives
the JAX package's batches), and `roar_tpu_torch/models/bert.py`'s
`BertPretrainingModel` trains through `run.py::train_supervised`.
`+device=cpu` runs the same loop on the host.  `run(cfg)` takes the loaded
config as a Python dict.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.lm_dataset import BertPretrainingDataset, SimpleWordTokenizer
from roar_tpu_torch.models.bert import BertPretrainingModel
from roar_tpu_torch.training.run import train_supervised


def run(cfg: dict):
    """Build the tokenizer, the datasets and the task from `cfg` and train;
    returns the final training state.  The parameters are drawn on `device`
    from `trainer.seed`."""
    device = torch.device(cfg.get("device", "cuda"))
    mcfg = dict(cfg["model"])
    corpus_files = [cfg["train_dataset"]]
    if cfg.get("validation_dataset"):
        corpus_files.append(cfg["validation_dataset"])
    tokenizer = SimpleWordTokenizer(corpus_files, max_vocab=mcfg.get("vocab_size", 8000))
    mcfg["vocab_size"] = tokenizer.vocab_size

    def make_ds(path):
        return BertPretrainingDataset(
            tokenizer, path, max_seq_length=mcfg.get("max_seq_length", 128),
            mask_prob=mcfg.get("mask_prob", 0.15), short_seq_prob=mcfg.get("short_seq_prob", 0.1),
            seq_a_ratio=mcfg.get("seq_a_ratio", 0.6))

    dataset = make_ds(cfg["train_dataset"])
    val_ds = make_ds(cfg["validation_dataset"]) if cfg.get("validation_dataset") else None
    with device:  # the parameters are made on the device, not copied there
        model = BertPretrainingModel(mcfg)
    model.module.to(device)
    seed = int((cfg.get("trainer") or {}).get("seed", 0))
    model.init_parameters(torch.Generator(device=device).manual_seed(seed))
    cfg = dict(cfg)
    cfg["model"] = mcfg
    return train_supervised(cfg, model, dataset, val_ds, device=device)


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="bert_pretraining",
)(run)


if __name__ == "__main__":
    main()
