"""`remat` of JETS's FFT stacks (they take FastPitch's `_fft_config`), on the
CPU at the conditioned small size of tests/test_torch_jets.py.

One generator pass and G loss with `remat` and one without, from the same
weights, batch and generator seed (dropout active, and the segment starts
drawn from the same generator), give the same losses, gradients and generator
state bit for bit.  Then the JAX G loss with flax `nn.remat` at the bars of
tests/test_torch_jets.py.
"""

import numpy as np
import test_torch_jets as jets_tests
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.training import convert

FLAVOUR = "conditioned"


def _cfg(remat: bool, dropout: float = 0.0):
    cfg = jets_tests._cfg(dropout=dropout, flavour=FLAVOUR)
    for k in ("input_fft", "output_fft"):
        cfg[k] = {**cfg[k], "remat": remat}
    return cfg


def _g_step(model, batch, seed: int = 3):
    """(G metrics, generator gradients, generator state) of one generator
    pass and G loss, every random draw from a generator seeded with `seed`."""
    generator = torch.Generator().manual_seed(seed)
    model.set_dropout_generator(generator)
    for p in model.d_parameters():
        p.requires_grad_(False)
    loss, metrics = model.g_loss_from_out(model.forward_split(batch, jets_tests.EPOCH), batch,
                                          jets_tests.EPOCH)
    params = model.g_parameters()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return metrics, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)], \
        generator.get_state()


def test_jets_remat_step_equals_the_step_without_it():
    batch = jets_tests._torch_batch(FLAVOUR)
    tree = JETSModel(_cfg(False, 0.1), generator=torch.Generator().manual_seed(0)).to_jax_tree()
    results = {}
    for remat in (False, True):
        model = JETSModel(_cfg(remat, 0.1))
        convert.load_jets_bundle(model.module, model.mpd, model.msd, tree)
        assert model.module.decoder_module.remat is remat
        results[remat] = _g_step(model, batch)
    (m0, g0, s0), (m1, g1, s1) = results[False], results[True]
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)


def test_jets_remat_g_loss_and_gradients_match_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from roar_tpu.models.jets_model import JETSModel as JaxJETSModel

    cfg = _cfg(True)
    jax_model = JaxJETSModel(cfg)
    assert jax_model.module.decoder.remat
    batch = {k: jnp.asarray(v) for k, v in jets_tests._batch_np(FLAVOUR).items()}
    g, d, stats = jax.device_get(jax_model.init_params(jax.random.PRNGKey(0), batch))

    def g_loss(gp):
        out, aux = jax_model.forward_split(gp, batch, jax.random.PRNGKey(5), jets_tests.EPOCH)
        loss, metrics = jax_model.g_loss_from_out(out, aux, d, stats, batch, jets_tests.EPOCH)
        return loss, (metrics, aux["z_start_idxs"])

    (loss, (want, starts)), grads = jax.device_get(
        jax.jit(jax.value_and_grad(g_loss, has_aux=True))(g))
    model = JETSModel(cfg)
    convert.load_jets_bundle(model.module, model.mpd, model.msd,
                             {"g_params": g, "d_params": d, "d_stats": stats})
    jets_tests._starts(monkeypatch, starts)
    for p in model.d_parameters():
        p.requires_grad_(False)
    got_loss, got = model.g_loss_from_out(model.forward_split(jets_tests._torch_batch(FLAVOUR),
                                                              jets_tests.EPOCH),
                                          jets_tests._torch_batch(FLAVOUR), jets_tests.EPOCH)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), err_msg=k, **jets_tests.TOL)
    got_loss.backward()
    scale = max(float(np.abs(v).max()) for v in flatten_dict(grads).values())
    jets_tests._assert_tree_close(jets_tests._grads_as_tree(model)["g_params"], grads, "g grad",
                                  rtol=3e-3, atol=1e-5 * scale)
