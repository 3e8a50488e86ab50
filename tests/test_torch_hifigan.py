"""HiFi-GAN generator port against the JAX package.

The JAX Generator's weight-normed tree (every leaf drawn from a seeded numpy
generator, scales away from 1, so a fold over the wrong feature axis shows)
goes through roar_tpu_torch.training.convert, which folds weight norm once.
Narrow channels, real upsample geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from roar_tpu.models.hifigan_model import generator_from_config as jax_generator
from roar_tpu_torch.models.hifigan_model import generator_from_config
from roar_tpu_torch.training.convert import load_generator_params

# fp32 on both sides through ~40 convs; only the order of summation differs
PARITY_TOL = dict(atol=1e-4, rtol=1e-3)

V1_NARROW = {  # configs/hifigan/generator/v1.yaml at 1/16 of the channels
    "resblock": 1, "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
V3_NARROW = {  # configs/hifigan/generator/v3.yaml at 1/8 of the channels
    "resblock": 2, "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
    "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 5, 7],
    "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]],
}


def _random_tree(jgen, mel, rng):
    """The JAX generator's tree, every leaf drawn from `rng`: kernels
    N(0, 1/fan_in), biases N(0, 0.05), weight-norm scales U(0.5, 1.5)."""
    shapes = flatten_dict(jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.asarray(mel)))
    flat = {}
    for path, leaf in shapes.items():
        if path[-1] == "scale":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif path[-1] == "bias":
            v = 0.05 * rng.standard_normal(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[path] = v.astype(np.float32)
    return unflatten_dict(flat)


@pytest.mark.parametrize("cfg", [V1_NARROW, V3_NARROW], ids=["resblock1", "resblock2"])
def test_generator_parity(cfg):
    rng = np.random.default_rng(0)
    n_mel, t = 12, 9
    mel = rng.standard_normal((2, t, n_mel)).astype(np.float32)
    jgen = jax_generator(cfg, n_mel)
    params = _random_tree(jgen, mel, rng)
    want = np.asarray(jax.jit(jgen.apply)(params, jnp.asarray(mel)))

    gen = load_generator_params(generator_from_config(cfg, n_mel), params)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, t * gen.upsample_factor) == want.shape
    np.testing.assert_allclose(got, want, **PARITY_TOL)


def test_converter_rejects_unconsumed_and_missing_leaves():
    mel = np.zeros((1, 4, 12), np.float32)
    params = _random_tree(jax_generator(V3_NARROW, 12), mel, np.random.default_rng(1))
    extra = {"params": {**params["params"], "stray": {"kernel": np.zeros(3)}}}
    with pytest.raises(ValueError, match="not consumed"):
        load_generator_params(generator_from_config(V3_NARROW, 12), extra)
    missing = {"params": {k: v for k, v in params["params"].items() if k != "conv_post"}}
    with pytest.raises(KeyError, match="unfilled"):
        load_generator_params(generator_from_config(V3_NARROW, 12), missing)
