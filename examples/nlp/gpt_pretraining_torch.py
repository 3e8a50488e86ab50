"""GPT causal-LM pretraining on a raw text corpus with the PyTorch port, on one
CUDA card.

Same config and overrides as examples/nlp/gpt_pretraining.py:

    python examples/nlp/gpt_pretraining_torch.py --config-name=gpt_pretraining \
        train_dataset=corpus.txt trainer.max_steps=1000 [+device=cuda]

`train_dataset` is a text file, one document per line.  Name a registry
architecture with `model.config_name=tiny-llama-1.1b` (fnmatch patterns
allowed; roar_tpu_torch/models/gpt.py GPT_CONFIGS) or set GPTConfig fields
directly.  Every GPTConfig field that the model block holds overrides the
registry entry, so with `--config-name=gpt_pretraining` the YAML's own
`n_layer`, `n_embd` and so on win over the named architecture's: take a config
whose model block holds only `config_name` and the fields you mean to change.

With `model.use_flash=true` every attention layer runs the hand-written causal
flash-attention kernels, forward and backward; `trainer.precision=bf16` runs
forward and backward in bf16 from fp32 master parameters.  `+device=cpu` runs
the same loop on the host with the kernels' plain versions.  `run(cfg)` takes
the loaded config as a Python dict.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.lm_dataset import CausalLMDataset, SimpleWordTokenizer
from roar_tpu_torch.models.gpt_model import GPTLMModel
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
    seq_length = int(mcfg.get("seq_length", 512))
    mcfg.setdefault("block_size", seq_length)

    dataset = CausalLMDataset(tokenizer, cfg["train_dataset"], seq_length=seq_length)
    val_ds = (CausalLMDataset(tokenizer, cfg["validation_dataset"], seq_length=seq_length)
              if cfg.get("validation_dataset") else None)
    with device:  # the parameters are made on the device, not copied there
        model = GPTLMModel(mcfg)
    model.module.to(device)
    seed = int((cfg.get("trainer") or {}).get("seed", 0))
    model.init_parameters(torch.Generator(device=device).manual_seed(seed))
    cfg = dict(cfg)
    cfg["model"] = mcfg
    return train_supervised(cfg, model, dataset, val_ds, device=device)


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="gpt_pretraining",
)(run)


if __name__ == "__main__":
    main()
