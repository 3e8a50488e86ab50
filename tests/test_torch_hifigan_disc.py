"""HiFi-GAN discriminators of the port against the JAX package.

Weight norm and spectral norm as flax 0.12 computes them (value, gradient,
the stored u and sigma), then `DiscriminatorP`, `DiscriminatorS` (grouped and
dense), MPD and MSD at `debug` widths with every leaf of the JAX tree drawn
from a seeded numpy generator and carried across by training/convert.py.
The JAX modules return feature maps channels-last; the port's are transposed
for the comparison.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from roar_tpu.models import hifigan as jax_hifigan
from roar_tpu_torch.models import hifigan as port
from roar_tpu_torch.training import convert

# fp32 on both sides through up to 8 convs; only the order of summation differs
PARITY_TOL = dict(atol=2e-4, rtol=1e-3)
NORM_TOL = dict(atol=1e-5, rtol=1e-4)
DEBUG_P = (8, 12, 32, 64)
DEBUG_S = (16, 32, 32, 64)


def _random_like(variables, rng):
    """Every leaf drawn from `rng`: kernels N(0, 1/fan_in), biases N(0, 0.05),
    weight-norm scales U(0.5, 1.5), u N(0, 1), sigma U(0.5, 1.5)."""
    flat = {}
    for path, leaf in flatten_dict(variables).items():
        kind = path[-1].rsplit("/", 1)[-1]
        if kind in ("scale", "sigma"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif kind == "bias":
            v = 0.05 * rng.standard_normal(leaf.shape)
        elif kind == "u":
            v = rng.standard_normal(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[path] = np.asarray(v, np.float32)
    return unflatten_dict(flat)


def _audio(rng, b, s):
    return (0.3 * rng.standard_normal((b, s))).astype(np.float32)


def _cl(t):
    """A port feature map [B, C, ...] as the JAX layout [B, ..., C]."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _assert_fmaps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_cl(g), np.asarray(w), **PARITY_TOL)


# ---------------------------------------------------------------------------
# weight norm, spectral norm
# ---------------------------------------------------------------------------

WN_CASES = {
    "conv1d": (lambda: nn.Conv(6, (5,), strides=(2,), padding=[(2, 2)]),
               lambda: port.WeightNormConv("conv1d", 4, 6, 5, stride=2, padding=2), (2, 17, 4)),
    "grouped": (lambda: nn.Conv(8, (5,), strides=(2,), padding=[(2, 2)], feature_group_count=2),
                lambda: port.WeightNormConv("conv1d", 4, 8, 5, stride=2, padding=2, groups=2),
                (2, 17, 4)),
    "conv2d": (lambda: nn.Conv(6, (5, 1), strides=(3, 1), padding=((2, 2), (0, 0))),
               lambda: port.WeightNormConv("conv2d", 3, 6, (5, 1), stride=(3, 1), padding=(2, 0)),
               (2, 11, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(WN_CASES))
def test_weight_norm_value_and_gradient(case):
    make_flax, make_port, x_shape = WN_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    layer = nn.WeightNorm(make_flax())
    variables = _random_like(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = layer.apply(variables, jnp.asarray(x))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    grads = jax.grad(lambda v: jnp.sum(layer.apply(v, jnp.asarray(x)) * cot))(variables)

    conv = make_port()
    inner = "layer_instance"
    kernel = np.asarray(variables["params"][inner]["kernel"])
    scale_path = [p for p in flatten_dict(variables["params"]) if p[-1].endswith("scale")][0]
    conv.load_state_dict({
        "v": torch.from_numpy(convert._kernel_to_torch(kernel, conv.kind)),
        "scale": torch.from_numpy(np.asarray(flatten_dict(variables["params"])[scale_path])),
        "bias": torch.from_numpy(np.asarray(variables["params"][inner]["bias"])),
    })
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    got = conv(xt)
    np.testing.assert_allclose(_cl(got), np.asarray(want), **NORM_TOL)
    (got * torch.from_numpy(np.moveaxis(cot, -1, 1).copy())).sum().backward()
    flat_g = flatten_dict(grads["params"])
    np.testing.assert_allclose(
        convert._kernel_to_flax(conv.v.grad.numpy(), conv.kind),
        np.asarray(grads["params"][inner]["kernel"]), **NORM_TOL)
    np.testing.assert_allclose(conv.scale.grad.numpy(), np.asarray(flat_g[scale_path]), **NORM_TOL)
    np.testing.assert_allclose(conv.bias.grad.numpy(),
                               np.asarray(grads["params"][inner]["bias"]), **NORM_TOL)


def test_weight_norm_transposed_conv_normalises_per_input_channel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    layer = nn.WeightNorm(nn.ConvTranspose(4, (8,), strides=(4,), padding="SAME"), feature_axes=1)
    variables = _random_like(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = layer.apply(variables, jnp.asarray(x))
    flat = flatten_dict(variables["params"])
    conv = port.WeightNormConv("conv_transpose1d", 6, 4, 8, stride=4, padding=2)
    conv.load_state_dict({
        "v": torch.from_numpy(convert._kernel_to_torch(
            np.asarray(flat[("layer_instance", "kernel")]), "conv_transpose1d")),
        "scale": torch.from_numpy(np.asarray([v for p, v in flat.items() if p[-1].endswith("scale")][0])),
        "bias": torch.from_numpy(np.asarray(flat[("layer_instance", "bias")])),
    })
    assert conv.scale.shape == (6,)
    got = conv(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(_cl(got), np.asarray(want), **NORM_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_spectral_norm_value_stats_and_gradient(groups):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 19, 4)).astype(np.float32)
    layer = nn.SpectralNorm(nn.Conv(6, (5,), strides=(2,), padding=[(2, 2)],
                                    feature_group_count=groups))
    variables = _random_like(
        layer.init(jax.random.PRNGKey(0), jnp.asarray(x), update_stats=False), rng)
    flat_p, flat_s = flatten_dict(variables["params"]), flatten_dict(variables["batch_stats"])
    u0 = np.asarray([v for p, v in flat_s.items() if p[-1].endswith("/u")][0])

    def fresh():
        conv = port.SpectralNormConv("conv1d", 4, 6, 5, stride=2, padding=2, groups=groups)
        conv.load_state_dict({
            "weight": torch.from_numpy(convert._kernel_to_torch(
                np.asarray(flat_p[("layer_instance", "kernel")]), "conv1d")),
            "bias": torch.from_numpy(np.asarray(flat_p[("layer_instance", "bias")])),
            "u": torch.from_numpy(u0),
            "sigma": torch.from_numpy(np.asarray(
                [v for p, v in flat_s.items() if p[-1].endswith("sigma")][0])),
        })
        return conv

    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    # update_stats=False: one power iteration runs all the same, nothing is stored
    conv = fresh()
    want = layer.apply(variables, jnp.asarray(x), update_stats=False)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    got = conv(xt, update_stats=False)
    np.testing.assert_allclose(_cl(got), np.asarray(want), **NORM_TOL)
    np.testing.assert_array_equal(conv.u.numpy(), u0)
    grads = jax.grad(lambda p: jnp.sum(layer.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
        update_stats=False) * cot))(variables["params"])
    (got * torch.from_numpy(cot.transpose(0, 2, 1).copy())).sum().backward()
    np.testing.assert_allclose(convert._kernel_to_flax(conv.weight.grad.numpy(), "conv1d"),
                               np.asarray(grads["layer_instance"]["kernel"]), **NORM_TOL)
    # update_stats=True: the same value, and u' and sigma are stored
    conv = fresh()
    want, new = layer.apply(variables, jnp.asarray(x), update_stats=True, mutable=["batch_stats"])
    got = conv(xt, update_stats=True)
    np.testing.assert_allclose(_cl(got), np.asarray(want), **NORM_TOL)
    new_s = flatten_dict(new["batch_stats"])
    np.testing.assert_allclose(
        conv.u.numpy(), np.asarray([v for p, v in new_s.items() if p[-1].endswith("/u")][0]), **NORM_TOL)
    np.testing.assert_allclose(
        conv.sigma.numpy(), np.asarray([v for p, v in new_s.items() if p[-1].endswith("sigma")][0]),
        **NORM_TOL)
    assert not np.allclose(conv.u.numpy(), u0)


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("period,samples", [(2, 96), (3, 100), (11, 200)])
def test_discriminator_p_parity(period, samples):
    rng = np.random.default_rng(period)
    x = _audio(rng, 2, samples)  # 100 % 3 and 200 % 11 != 0: the reflect pad
    jdisc = jax_hifigan.DiscriminatorP(period, conv_channels=DEBUG_P)
    variables = _random_like(jdisc.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want_s, want_f = jdisc.apply(variables, jnp.asarray(x))
    disc = convert.load_discriminator_params(
        port.DiscriminatorP(period, conv_channels=DEBUG_P), variables["params"])
    got_s, got_f = disc(torch.from_numpy(x))
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s), **PARITY_TOL)
    _assert_fmaps(got_f, want_f)


@pytest.mark.parametrize("spectral", [False, True], ids=["weight_norm", "spectral_norm"])
@pytest.mark.parametrize("dense", [False, True], ids=["grouped", "dense"])
def test_discriminator_s_parity(spectral, dense):
    rng = np.random.default_rng(5)
    x = _audio(rng, 2, 257)
    jdisc = jax_hifigan.DiscriminatorS(use_spectral_norm=spectral, conv_channels=DEBUG_S,
                                       dense=dense)
    variables = _random_like(jdisc.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want_s, want_f = jdisc.apply(variables, jnp.asarray(x))
    disc = convert.load_discriminator_params(
        port.DiscriminatorS(use_spectral_norm=spectral, conv_channels=DEBUG_S, dense=dense),
        variables["params"], variables.get("batch_stats"))
    got_s, got_f = disc(torch.from_numpy(x))
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s), **PARITY_TOL)
    _assert_fmaps(got_f, want_f)
    assert [c.groups for c in disc.convs] == ([1] * 7 if dense else [1, 4, 16, 16, 16, 16, 1])


def _assert_disc_outputs(got, want):
    for i in (0, 1):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **PARITY_TOL)
    for i in (2, 3):
        assert len(got[i]) == len(want[i])
        for g, w in zip(got[i], want[i]):
            _assert_fmaps(g, w)


def test_mpd_parity():
    rng = np.random.default_rng(6)
    y, y_hat = _audio(rng, 2, 230), _audio(rng, 2, 230)
    jmpd = jax_hifigan.MultiPeriodDiscriminator(debug=True)
    variables = _random_like(jmpd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)),
                             rng)
    want = jmpd.apply(variables, jnp.asarray(y), jnp.asarray(y_hat))
    mpd = convert.load_mpd_params(port.MultiPeriodDiscriminator(debug=True), variables["params"])
    _assert_disc_outputs(mpd(torch.from_numpy(y), torch.from_numpy(y_hat)), want)


@pytest.fixture(scope="module")
def msd_case():
    rng = np.random.default_rng(7)
    y, y_hat = _audio(rng, 2, 512), _audio(rng, 2, 512)
    jmsd = jax_hifigan.MultiScaleDiscriminator(debug=True)
    variables = _random_like(jmsd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)),
                             rng)
    return jmsd, variables, y, y_hat


@pytest.mark.parametrize("update_stats", [False, True])
def test_msd_parity(msd_case, update_stats):
    jmsd, variables, y, y_hat = msd_case
    if update_stats:
        want, new = jmsd.apply(variables, jnp.asarray(y), jnp.asarray(y_hat), update_stats=True,
                               mutable=["batch_stats"])
    else:
        want = jmsd.apply(variables, jnp.asarray(y), jnp.asarray(y_hat))
    msd = convert.load_msd_params(port.MultiScaleDiscriminator(debug=True), variables["params"],
                                  variables["batch_stats"])
    got = msd(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats=update_stats)
    _assert_disc_outputs(got, want)
    if update_stats:
        _, stats = convert._norm_convs_to_jax(msd, convert._msd_sites(msd))
        want_stats = flatten_dict(new["batch_stats"])
        got_stats = flatten_dict(stats)
        assert set(got_stats) == set(want_stats)
        for path, value in want_stats.items():
            np.testing.assert_allclose(got_stats[path], np.asarray(value), **NORM_TOL)


def test_msd_dense_variant_and_unknown_variant():
    rng = np.random.default_rng(8)
    y, y_hat = _audio(rng, 1, 300), _audio(rng, 1, 300)
    jmsd = jax_hifigan.MultiScaleDiscriminator(debug=True, variant="dense")
    variables = _random_like(jmsd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)),
                             rng)
    want = jmsd.apply(variables, jnp.asarray(y), jnp.asarray(y_hat))
    msd = convert.load_msd_params(port.MultiScaleDiscriminator(debug=True, variant="dense"),
                                  variables["params"], variables["batch_stats"])
    _assert_disc_outputs(msd(torch.from_numpy(y), torch.from_numpy(y_hat)), want)
    with pytest.raises(ValueError, match="msd_variant"):
        port.MultiScaleDiscriminator(variant="sparse")


def test_joint_batch_equals_two_calls_and_unequal_shapes_take_two(msd_case):
    _, variables, y, y_hat = msd_case
    msd = convert.load_msd_params(port.MultiScaleDiscriminator(debug=True), variables["params"],
                                  variables["batch_stats"])
    yt, ht = torch.from_numpy(y), torch.from_numpy(y_hat)
    joint = msd(yt, ht)
    for i, disc in enumerate(msd.discs):
        if i:
            yt, ht = port._avg_pool_1d(yt), port._avg_pool_1d(ht)
        s_r, f_r = disc(yt)
        s_g, f_g = disc(ht)
        torch.testing.assert_close(joint[0][i], s_r, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(joint[1][i], s_g, atol=1e-5, rtol=1e-5)
        for a, b in zip(joint[2][i] + joint[3][i], f_r + f_g):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # unequal lengths cannot be batched: two calls, scores of two widths
    out = msd(torch.from_numpy(y), torch.from_numpy(y_hat[:, :400]))
    assert out[0][0].shape[1] != out[1][0].shape[1]


def test_avg_pool_counts_the_padding():
    x = np.arange(14, dtype=np.float32).reshape(2, 7)
    np.testing.assert_allclose(port._avg_pool_1d(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_hifigan._avg_pool_1d(jnp.asarray(x))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the converter, both ways
# ---------------------------------------------------------------------------


def test_converter_round_trip_and_raises(msd_case):
    jmsd, variables, y, y_hat = msd_case
    rng = np.random.default_rng(9)
    jmpd = jax_hifigan.MultiPeriodDiscriminator(debug=True)
    mpd_vars = _random_like(jmpd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)),
                            rng)
    gen_cfg = dict(resblock=2, upsample_rates=(8, 4), upsample_kernel_sizes=(16, 8),
                   upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1, 3),), initial_input_size=8)
    jgen = jax_hifigan.Generator(**gen_cfg)
    mel = rng.standard_normal((1, 5, 8)).astype(np.float32)
    gen_vars = _random_like(jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel)), rng)

    gen = convert.load_generator_train_params(port.Generator(**gen_cfg, weight_norm=True), gen_vars)
    mpd = convert.load_mpd_params(port.MultiPeriodDiscriminator(debug=True), mpd_vars["params"])
    msd = convert.load_msd_params(port.MultiScaleDiscriminator(debug=True), variables["params"],
                                  variables["batch_stats"])
    # the trainable generator equals the JAX one
    np.testing.assert_allclose(gen(torch.from_numpy(mel)).detach().numpy(),
                               np.asarray(jgen.apply(gen_vars, jnp.asarray(mel))),
                               atol=1e-4, rtol=1e-3)
    tree = convert.to_jax_tree(gen, mpd, msd)
    want = {"g_params": gen_vars,
            "d_params": {"params": {"mpd": mpd_vars["params"], "msd": variables["params"]}},
            "d_stats": {"msd": variables["batch_stats"]}}
    got_flat, want_flat = flatten_dict(tree), flatten_dict(want)
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        assert got_flat[path].shape == np.asarray(value).shape, path
        np.testing.assert_array_equal(got_flat[path], np.asarray(value), err_msg=str(path))

    extra = {**variables["params"], "stray": {"kernel": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_msd_params(port.MultiScaleDiscriminator(debug=True), extra,
                                variables["batch_stats"])
    with pytest.raises(KeyError, match="unfilled"):  # scale 0's u and sigma missing
        convert.load_msd_params(port.MultiScaleDiscriminator(debug=True), variables["params"], {})
    missing = {k: v for k, v in mpd_vars["params"].items() if k != "disc_p7"}
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_mpd_params(port.MultiPeriodDiscriminator(debug=True), missing)
