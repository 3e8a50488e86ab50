"""`remat` of FastPitch's FFT stacks, on the CPU at the small size of
tests/test_torch_fastpitch_train.py (2 + 2 layers, d_model 64).

With `remat: true` each transformer layer of a training-mode forward runs
under `torch.utils.checkpoint`, and the backward recomputes it.  The port
draws its dropout masks from an explicit generator, which the checkpoint's own
`preserve_rng_state` does not cover; `submodules.replay_dropout_generators`
sets the generator back for the recomputation.  So one step with `remat` and
one without, from the same weights, batch and generator seed and with every
dropout active, give the same losses, gradients and generator state bit for
bit, on the einsum path (attention dropout active too) and on the flash path
(`dropatt` 0; on the CPU the autograd Function runs K5's plain version, whose
forward runs again in the backward with the same bits).  Then the JAX remat
step (flax `nn.remat`) at the bars of the port's other parity tests.
"""

import numpy as np
import pytest
import test_torch_fastpitch_train as fp_tests
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.kernels import flash_attention as fa
from roar_tpu_torch.models import submodules
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.training import convert

TOL = dict(rtol=3e-3, atol=1e-6)
PATHS = {"einsum": dict(use_flash=False, dropatt=0.1), "flash": dict(use_flash=True, dropatt=0.0)}


def _remat_cfg(remat: bool, **kwargs):
    cfg = fp_tests._cfg(**kwargs)
    for k in ("input_fft", "output_fft"):
        cfg[k] = {**cfg[k], "remat": remat}
    return cfg


def _step(model, batch, seed: int = 5):
    """One training-mode loss and its gradients with dropout drawn from a
    generator seeded with `seed`: (metrics, gradients, generator state)."""
    generator = torch.Generator().manual_seed(seed)
    model.set_dropout_generator(generator)
    model.module.train()
    loss, metrics = model.loss_fn(batch, fp_tests.EPOCH)
    params = list(model.module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return metrics, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)], \
        generator.get_state()


@pytest.fixture(scope="module")
def weights():
    return convert.fastpitch_to_jax_tree(
        FastPitchModel(fp_tests._cfg(), generator=torch.Generator().manual_seed(0)).module)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_remat_step_equals_the_step_without_it(weights, path, monkeypatch):
    batch = fp_tests._torch_batch()
    calls = {"fwd": [], "bwd": 0}
    forward, backward = fa.flash_self_attention, fa.flash_self_attention_bwd

    def counting_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        calls["fwd"].append(out)
        return out

    def counting_backward(*args, **kwargs):
        calls["bwd"] += 1
        return backward(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_self_attention", counting_forward)
    monkeypatch.setattr(fa, "flash_self_attention_bwd", counting_backward)
    results, counts = {}, {}
    for remat in (False, True):
        model = FastPitchModel(_remat_cfg(remat, **PATHS[path]))
        convert.load_fastpitch_params(model.module, weights)
        assert model.module.decoder_module.remat is remat
        assert model.module.encoder_module.stack.remat is remat
        calls["fwd"].clear()
        calls["bwd"] = 0
        results[remat] = _step(model, batch)
        counts[remat] = (len(calls["fwd"]), calls["bwd"])
        if path == "flash" and remat:
            # each layer's recomputed forward (in the backward, last layer
            # first) gives the first forward's o and lse
            first, again = calls["fwd"][:4], calls["fwd"][4:][::-1]
            assert len(again) == 4
            for (o1, lse1), (o2, lse2) in zip(first, again):
                assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    n_layers = 4
    if path == "flash":
        # the forward runs again in the backward: 2 x 4 forwards, 4 backwards
        assert counts == {False: (n_layers, n_layers), True: (2 * n_layers, n_layers)}
    else:
        assert counts == {False: (0, 0), True: (0, 0)}
    (m0, g0, s0), (m1, g1, s1) = results[False], results[True]
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)
    # dropout acts: another seed gives another loss
    model = FastPitchModel(_remat_cfg(True, **PATHS[path]))
    convert.load_fastpitch_params(model.module, weights)
    assert not torch.equal(_step(model, batch, seed=6)[0]["loss"], m1["loss"])


def test_without_the_replay_the_recomputed_masks_differ(weights, monkeypatch):
    """The trap the replay closes: a checkpoint that restores only torch's
    global generators recomputes the layers with fresh masks, and nothing
    raises; the gradients differ from the step without remat."""
    batch = fp_tests._torch_batch()
    model = FastPitchModel(_remat_cfg(False, **PATHS["einsum"]))
    convert.load_fastpitch_params(model.module, weights)
    _, want, _ = _step(model, batch)
    model = FastPitchModel(_remat_cfg(True, **PATHS["einsum"]))
    convert.load_fastpitch_params(model.module, weights)
    monkeypatch.setattr("roar_tpu_torch.models.transformer.replay_dropout_generators",
                        lambda layer: (torch.utils.checkpoint.noop_context_fn()))
    _, got, _ = _step(model, batch)
    assert not all(torch.equal(a, b) for a, b in zip(got, want))


def test_remat_is_off_outside_training_with_gradients(weights, monkeypatch):
    import roar_tpu_torch.models.transformer as transformer

    model = FastPitchModel(_remat_cfg(True))
    convert.load_fastpitch_params(model.module, weights)
    seen = []
    real = transformer.checkpoint

    def spying(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(transformer, "checkpoint", spying)
    with torch.no_grad():
        model.module.train()
        model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    model.module.eval()
    model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    assert not seen
    model.module.train()
    model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    assert len(seen) == 4
    # the generators of a module's dropouts are what the replay saves
    gen = torch.Generator().manual_seed(1)
    submodules.set_dropout_generator(model.module, gen)
    forward_ctx, recompute_ctx = submodules.replay_dropout_generators(model.module)
    with forward_ctx:
        state = gen.get_state()
        torch.rand(3, generator=gen)
    moved = gen.get_state()
    with recompute_ctx:
        assert torch.equal(gen.get_state(), state)
        torch.rand(3, generator=gen)
    assert torch.equal(gen.get_state(), moved)


def test_remat_loss_and_gradients_match_the_jax_remat_step():
    """flax `nn.remat` (static `deterministic`) against the port's checkpoint,
    every dropout rate 0 in training mode on the port (the JAX side runs
    `deterministic=True`): loss terms and every gradient at the bars of
    tests/test_torch_fastpitch_train.py."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel

    cfg = _remat_cfg(True, dropout=0.0, dropatt=0.0)
    jax_model = JaxFastPitchModel(cfg)
    assert jax_model.module.decoder.remat and jax_model.module.encoder.remat
    batch = {k: jnp.asarray(v) for k, v in fp_tests._batch_np().items()}
    params = jax_model.init_params(jax.random.PRNGKey(0), batch)
    (loss, want), grads = jax.device_get(jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, batch, None, fp_tests.EPOCH, deterministic=True),
        has_aux=True))(params))
    model = FastPitchModel(cfg)
    convert.load_fastpitch_params(model.module, jax.device_get(params))
    model.module.train()
    model.set_dropout_generator(torch.Generator().manual_seed(0))
    got_loss, got = model.loss_fn(fp_tests._torch_batch(), fp_tests.EPOCH)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **TOL)
    got_loss.backward()
    scale = max(float(np.abs(v).max()) for v in flatten_dict(grads).values())
    fp_tests._assert_tree_close(fp_tests._grad_tree(model), grads, "grad", rtol=3e-3,
                                atol=3e-6 * scale)
