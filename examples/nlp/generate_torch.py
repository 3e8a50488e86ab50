"""Sample text from a GPT causal-LM bundle with the PyTorch port, on one CUDA card.

Same flags as examples/nlp/generate.py, plus `--device`.  Train with
`gpt_pretraining_torch.py` and `+exp_manager.always_save_roar=true`, then

    python examples/nlp/generate_torch.py --model <exp>/checkpoints/GPTPretraining.roar \
        --corpus corpus.txt --prompt "the cat" \
        [--max-new-tokens 32] [--temperature 0.8] [--top-k 40] [--seed 0] [--device cuda]

`--corpus` rebuilds the SimpleWordTokenizer from the same file(s) the training
run saw (the vocabulary is a pure function of the corpus and the configured
cap).  The bundle holds the JAX package's parameter layout, so a bundle of
either package loads.  Decoding runs the port's KV-cached `generate`
(roar_tpu_torch/models/gpt.py): one prefill, then a token a step; samples
are drawn from a `torch.Generator` seeded with `--seed`.  `--device cpu` runs
on the host.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def generate_text(model_path: str, corpus, prompt: str, max_new_tokens: int = 32,
                  temperature: float = 0.8, top_k=None, seed: int = 0,
                  device: str = "cuda") -> list:
    """The new words sampled after `prompt` from the bundle at `model_path`."""
    import numpy as np
    import torch

    from roar_tpu_torch.data.lm_dataset import SimpleWordTokenizer
    from roar_tpu_torch.models.gpt import generate
    from roar_tpu_torch.models.gpt_model import GPTLMModel
    from roar_tpu_torch.training.convert import load_gpt_params
    from roar_tpu_torch.training.save_restore import restore_from

    device = torch.device(device)
    cfg, params = restore_from(model_path)
    mcfg = dict(cfg.get("model") or {})
    tokenizer = SimpleWordTokenizer(corpus, max_vocab=mcfg.get("vocab_size", 8000))
    if tokenizer.vocab_size != mcfg.get("vocab_size"):
        raise SystemExit(
            f"tokenizer rebuilt from {corpus} has vocab {tokenizer.vocab_size} but the "
            f"bundle was trained with {mcfg.get('vocab_size')}: pass the same corpus file(s)")
    # the cached decode takes the unrolled blocks; the converter reads either layout
    with device:
        module = GPTLMModel({**mcfg, "scan_layers": False, "remat": False}).module
    load_gpt_params(module, params)
    module.to(device).eval()

    prompt_ids = tokenizer.text_to_ids(prompt) or [tokenizer.eos_id]
    tokens = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=device)[None]
    out = generate(module, tokens, max_new_tokens, temperature=temperature, top_k=top_k,
                   generator=torch.Generator(device=device).manual_seed(seed))
    return tokenizer.ids_to_tokens([int(t) for t in out[0, len(prompt_ids):].tolist()])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help=".roar bundle from gpt_pretraining")
    p.add_argument("--corpus", required=True, nargs="+",
                   help="training corpus file(s), to rebuild the tokenizer")
    p.add_argument("--prompt", default="the")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    words = generate_text(args.model, args.corpus, args.prompt, args.max_new_tokens,
                          args.temperature, args.top_k, args.seed, args.device)
    print(args.prompt, " ".join(words))


if __name__ == "__main__":
    main()
