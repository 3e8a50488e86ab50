"""HiFi-GAN generator and discriminators.

Port of roar_tpu/models/hifigan.py: `ResBlock1`, `ResBlock2`, `Generator`
(conv_pre -> [leaky ReLU, transposed-conv upsample, mean of the
multi-receptive-field resblocks] x N -> leaky ReLU(0.01) -> conv_post -> tanh),
`DiscriminatorP`, `MultiPeriodDiscriminator`, `DiscriminatorS`,
`MultiScaleDiscriminator`.

The JAX modules wrap every conv in flax `nn.WeightNorm` (the first
multi-scale discriminator in `nn.SpectralNorm`).  The port has both forms of
the generator: `Generator()` holds plain folded conv weights for serving
(training/convert.py folds scale * v / ||v|| once, at load), and
`Generator(weight_norm=True)` holds `(v, scale, bias)` per layer for
training; `fold_weight_norm()` turns the second into the first.  The
discriminators exist only in the trainable form.  `WeightNormConv` and
`SpectralNormConv` compute what flax 0.12 computes, term for term.

All modules run channels-first.  The generator's input is the JAX layout, a
mel [B, T, n_mel], and its output audio [B, T * hop]; the discriminators take
audio [B, S] and return feature maps as [B, C, W] (period: [B, C, H, W]),
where the JAX modules return [B, W, C] ([B, H, W, C]).

The multi-scale discriminator's grouped convs (groups 4 and 16) go through
`ops.grouped_conv.grouped_conv1d_cf`: kernels K3 and K4 on the card, their
plain versions on the CPU.  Every other conv is a library call, as the JAX
package leaves them to XLA.

Geometry: flax `ConvTranspose(padding="SAME")` with stride u and kernel k
gives T * u samples; torch's ConvTranspose1d matches it with padding
(k - u) // 2 and a spatially flipped kernel (roar_tpu/training/convert.py:192-199),
which requires k - u to be even.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.ops.grouped_conv import grouped_conv1d_cf

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01  # before conv_post the JAX generator uses leaky_relu's default
NORM_EPS = 1e-12   # flax nn.WeightNorm's and nn.SpectralNorm's epsilon
INIT_STD = 0.01    # roar_tpu `_normal_init`


def _l2_normalize(x: torch.Tensor, dims=None) -> torch.Tensor:
    """flax `_l2_normalize`: x * rsqrt(sum(x^2) + eps)."""
    sq = (x * x).sum() if dims is None else (x * x).sum(dim=dims, keepdim=True)
    return x * torch.rsqrt(sq + NORM_EPS)


class _NormConv(nn.Module):
    """A conv whose kernel passes through a reparametrization on every call.

    `kind` is "conv1d", "conv2d" or "conv_transpose1d"; the kernel is held in
    torch's layout for that op.  Grouped 1-D convs (groups > 1) run through
    `grouped_conv1d_cf`, the others through the library op."""

    def __init__(self, kind: str, channels_in: int, channels_out: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1):
        super().__init__()
        if kind not in ("conv1d", "conv2d", "conv_transpose1d"):
            raise ValueError(f"unknown conv kind {kind!r}")
        if groups > 1 and (kind != "conv1d" or dilation != 1):
            raise ValueError("grouped convs are 1-D and undilated")
        self.kind, self.stride, self.padding = kind, stride, padding
        self.dilation, self.groups = dilation, groups
        ks = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) else (kernel_size,)
        if kind == "conv_transpose1d":
            shape = (channels_in, channels_out, *ks)
        else:
            shape = (channels_out, channels_in // groups, *ks)
        self.kernel_shape = shape
        self.bias = nn.Parameter(torch.zeros(channels_out))

    def _init_kernel(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn(self.kernel_shape, generator=generator) * INIT_STD

    def effective_weight(self, update_stats: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.effective_weight(update_stats)
        if self.kind == "conv_transpose1d":
            return F.conv_transpose1d(x, w, self.bias, stride=self.stride, padding=self.padding)
        if self.kind == "conv2d":
            return F.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding)
        if self.groups > 1:
            y = grouped_conv1d_cf(x, w, self.stride, self.padding, self.groups)
            return y + self.bias[None, :, None]
        return F.conv1d(x, w, self.bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)


class WeightNormConv(_NormConv):
    """flax `nn.WeightNorm` around a conv: w = v * rsqrt(sum(v^2) + 1e-12) * scale,
    the sum over every axis but the feature axis: the output channels for a
    conv, the INPUT channels for the generator's transposed convs
    (`feature_axes=1` there).  In torch's layouts that is dim 0 in both cases.
    Parameters `v` (flax's `kernel`), `scale`, `bias`."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.v = nn.Parameter(self._init_kernel(generator))
        self.scale = nn.Parameter(torch.ones(self.kernel_shape[0]))

    def effective_weight(self, update_stats: bool = False) -> torch.Tensor:
        dims = tuple(range(1, self.v.dim()))
        return _l2_normalize(self.v, dims) * self.scale.reshape(-1, *([1] * len(dims)))


class SpectralNormConv(_NormConv):
    """flax `nn.SpectralNorm` around a 1-D conv.  The kernel is read as a
    matrix W [k * Cin/G, Cout]; from the stored u [1, Cout] one power iteration
    runs on EVERY call, v = l2norm(u W^T), u' = l2norm(v W), both detached;
    sigma = v W u'^T; the conv uses W / where(sigma != 0, sigma, 1).  Only
    `update_stats=True` stores u' and sigma.  Parameters `weight`, `bias`;
    buffers `u`, `sigma` (fp32)."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.kind != "conv1d":
            raise ValueError("SpectralNormConv wraps 1-D convs")
        self.weight = nn.Parameter(self._init_kernel(generator))
        self.register_buffer("u", torch.randn((1, self.kernel_shape[0]), generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def effective_weight(self, update_stats: bool = False) -> torch.Tensor:
        mat = self.weight.reshape(self.weight.shape[0], -1).t()  # [k * Cin/G, Cout], rows permuted
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.t())
            u = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u.t())[0, 0]
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


def _same_conv(channels_in: int, channels_out: int, kernel_size: int, dilation: int = 1,
               weight_norm: bool = False, generator: Optional[torch.Generator] = None):
    if weight_norm:
        return WeightNormConv("conv1d", channels_in, channels_out, kernel_size,
                              padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                              generator=generator)
    return nn.Conv1d(channels_in, channels_out, kernel_size, dilation=dilation, padding="same")


class ResBlock1(nn.Module):
    """Two-conv residual units with dilated first convs."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int],
                 weight_norm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        # flax names the convs in call order: convs1_0, convs2_0, convs1_1, ...
        pairs = [(_same_conv(channels, channels, kernel_size, d, weight_norm, generator),
                  _same_conv(channels, channels, kernel_size, 1, weight_norm, generator))
                 for d in dilation]
        self.convs1 = nn.ModuleList(p[0] for p in pairs)
        self.convs2 = nn.ModuleList(p[1] for p in pairs)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Single-conv residual units."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int],
                 weight_norm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            _same_conv(channels, channels, kernel_size, d, weight_norm, generator)
            for d in dilation)

    def forward(self, x):
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel [B, T, n_mel] -> audio [B, T * prod(upsample_rates)].

    `weight_norm=False` (serving): plain conv weights, weight norm folded in.
    `weight_norm=True` (training): `(v, scale, bias)` per layer, initialised
    from `generator` (normal 0.01, scale 1, bias 0)."""

    def __init__(self, resblock: int = 1, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 initial_input_size: int = 80, weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(
            resblock=resblock, upsample_rates=tuple(upsample_rates),
            upsample_kernel_sizes=tuple(upsample_kernel_sizes),
            upsample_initial_channel=upsample_initial_channel,
            resblock_kernel_sizes=tuple(resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(tuple(d) for d in resblock_dilation_sizes),
            initial_input_size=initial_input_size)
        self.weight_norm = weight_norm
        self.upsample_factor = int(np.prod(upsample_rates))
        block_cls = ResBlock1 if resblock == 1 else ResBlock2
        ch = upsample_initial_channel
        self.conv_pre = _same_conv(initial_input_size, ch, 7, 1, weight_norm, generator)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            if (k - u) % 2:
                raise ValueError(f"upsample kernel {k} and rate {u}: k - u must be even")
            if weight_norm:
                self.ups.append(WeightNormConv("conv_transpose1d", ch, ch // 2, k, stride=u,
                                               padding=(k - u) // 2, generator=generator))
            else:
                self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, stride=u,
                                                   padding=(k - u) // 2))
            ch //= 2
            self.resblocks.append(nn.ModuleList(
                block_cls(ch, rk, rd, weight_norm, generator)
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)))
        self.conv_post = _same_conv(ch, 1, 7, 1, weight_norm, generator)

    def fold_weight_norm(self) -> "Generator":
        """The serving form of a trained generator: a new `Generator()` whose
        plain weights are scale * v / ||v||, folded by the one conversion that
        also loads JAX checkpoints (training/convert.py)."""
        if not self.weight_norm:
            raise ValueError("this generator holds folded weights already")
        from roar_tpu_torch.training.convert import generator_to_jax_tree, load_generator_params

        folded = Generator(**self.config).eval()
        return load_generator_params(folded, generator_to_jax_tree(self))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for up, blocks in zip(self.ups, self.resblocks):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / len(blocks)
        x = self.conv_post(F.leaky_relu(x, POST_SLOPE))
        return torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# Discriminators (trainable form only)
# ---------------------------------------------------------------------------

FeatureMaps = List[torch.Tensor]


class DiscriminatorP(nn.Module):
    """Period discriminator: audio [B, S] reflect-padded to a multiple of the
    period, read as an image [B, 1, S/p, p], through (5, 1) convs with stride
    (3, 1).  Returns (scores [B, -1], feature maps [B, C, H, W])."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 conv_channels: Sequence[int] = (32, 128, 512, 1024),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chs = [1, *conv_channels]
        self.convs = nn.ModuleList(
            WeightNormConv("conv2d", cin, cout, (kernel_size, 1), stride=(stride, 1),
                           padding=(pad, 0), generator=generator)
            for cin, cout in zip(chs[:-1], chs[1:]))
        self.convs.append(WeightNormConv("conv2d", chs[-1], chs[-1], (kernel_size, 1),
                                         padding=(2, 0), generator=generator))
        self.conv_post = WeightNormConv("conv2d", chs[-1], 1, (3, 1), padding=(1, 0),
                                        generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, FeatureMaps]:
        b, t = x.shape
        if t % self.period:
            x = F.pad(x[:, None, :], (0, self.period - t % self.period), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


def _joint_or_twice(disc, y: torch.Tensor, y_hat: torch.Tensor, **kwargs):
    """One call on cat([y, y_hat]) when the shapes agree (convs are per
    sample, so the halves equal two calls; a spectral-normed stack then runs
    one power iteration per step), else two calls."""
    nb = y.shape[0]
    if y.shape == y_hat.shape:
        scores, fmaps = disc(torch.cat([y, y_hat], dim=0), **kwargs)
        return scores[:nb], scores[nb:], [f[:nb] for f in fmaps], [f[nb:] for f in fmaps]
    score_r, fmap_r = disc(y, **kwargs)
    score_g, fmap_g = disc(y_hat, **kwargs)
    return score_r, score_g, fmap_r, fmap_g


def _collect(results):
    return tuple([r[i] for r in results] for i in range(4))


class MultiPeriodDiscriminator(nn.Module):
    """(real scores, fake scores, real feature maps, fake feature maps), one
    entry per period.  `debug` shrinks the channels (8, 12, 32, 64)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), debug: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chs = (8, 12, 32, 64) if debug else (32, 128, 512, 1024)
        self.periods = tuple(periods)
        self.discs = nn.ModuleList(
            DiscriminatorP(p, conv_channels=chs, generator=generator) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _collect([_joint_or_twice(d, y, y_hat) for d in self.discs])


class DiscriminatorS(nn.Module):
    """Scale discriminator: seven 1-D convs (15/1, 41/2, 41/2, 41/4, 41/4,
    41/1, 5/1; groups 1, 4, 16, 16, 16, 16, 1) and conv_post (3/1), weight
    normed or, with `use_spectral_norm`, spectrally normed.  `dense=True` is
    the same stack with groups = 1 everywhere.  Returns (scores [B, -1],
    feature maps [B, C, W])."""

    def __init__(self, use_spectral_norm: bool = False,
                 conv_channels: Sequence[int] = (128, 256, 512, 1024), dense: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c0, c1, c2, c3 = conv_channels
        g4, g16 = (1, 1) if dense else (4, 16)
        specs = [(c0, 15, 1, 1), (c0, 41, 2, g4), (c1, 41, 2, g16), (c2, 41, 4, g16),
                 (c3, 41, 4, g16), (c3, 41, 1, g16), (c3, 5, 1, 1)]
        conv_cls = SpectralNormConv if use_spectral_norm else WeightNormConv
        self.use_spectral_norm = use_spectral_norm
        self.convs = nn.ModuleList()
        cin = 1
        for cout, k, s, g in specs:
            self.convs.append(conv_cls("conv1d", cin, cout, k, stride=s, padding=(k - 1) // 2,
                                       groups=g, generator=generator))
            cin = cout
        self.conv_post = conv_cls("conv1d", cin, 1, 3, padding=1, generator=generator)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = x[:, None, :]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, update_stats), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, update_stats)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _avg_pool_1d(x: torch.Tensor) -> torch.Tensor:
    """[B, S] -> AvgPool1d(4, 2, padding=2), the padding counted."""
    return F.avg_pool1d(x[:, None, :], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators on the audio and on its once and twice
    average-pooled forms; the first is spectrally normed.  `variant`:
    "grouped" (128, 256, 512, 1024 channels, groups 4 and 16) or "dense"
    (48, 96, 192, 384, groups 1); `debug`: (16, 32, 32, 64)."""

    def __init__(self, debug: bool = False, variant: str = "grouped",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in ("grouped", "dense"):
            raise ValueError(f"unknown msd_variant {variant!r}")
        dense = variant == "dense"
        chs = (16, 32, 32, 64) if debug else (48, 96, 192, 384) if dense else (128, 256, 512, 1024)
        self.discs = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), conv_channels=chs, dense=dense,
                           generator=generator) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool = False):
        results = []
        for i, d in enumerate(self.discs):
            if i:
                y, y_hat = _avg_pool_1d(y), _avg_pool_1d(y_hat)
            results.append(_joint_or_twice(d, y, y_hat, update_stats=update_stats))
        return _collect(results)
