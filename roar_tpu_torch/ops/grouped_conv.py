"""Grouped 1-D convolution, channels-first, with its gradients.

Port of roar_tpu/ops/grouped_conv.py `grouped_conv1d_cf` and its custom VJP.
Activations keep the JAX op's [B, C, W]; the weight is torch's
[Cout, Cin/G, k], the layout the port's modules hold and
training/convert.py produces (the JAX op takes flax's [k, Cin/G, Cout]: a
caller that compares the two transposes the weight with `permute(2, 1, 0)`).

On a CUDA tensor the forward runs kernel K3, the backward K3's dX entry and
kernel K4 (dW), each only where a gradient is asked for; on a CPU tensor the
plain versions in kernels/grouped_conv.py.  fp32 or bf16, with the JAX
op's casts (roar_tpu/ops/grouped_conv.py:489-519): the weight is cast to x's
type, dy to the saved x's type; dX comes back in dy's type and dW (summed in
fp32 by K4) in the weight's.
"""

from __future__ import annotations

import torch

from roar_tpu_torch.kernels import grouped_conv as kernels
from roar_tpu_torch.kernels.grouped_conv import out_len  # noqa: F401  (part of this op's surface)


class GroupedConv1dCF(torch.autograd.Function):
    """y = grouped_conv(x, w); backward: dX where x needs a gradient, dW where
    w does (in the generator pass of a GAN step the discriminator's weights
    need none, and K4 does not run)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding, groups)
        return kernels.grouped_conv_fwd(x, w.to(x.dtype), stride, padding, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.geometry
        dyc = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = kernels.grouped_conv_dx(dyc, w.to(x.dtype), x.shape[2], stride, padding,
                                         groups).to(dy.dtype)
        if ctx.needs_input_grad[1]:
            dw = kernels.grouped_conv_dw(x, dyc, w.shape[2], stride, padding, groups).to(w.dtype)
        return dx, dw, None, None, None


def grouped_conv1d_cf(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                      feature_group_count: int) -> torch.Tensor:
    """x [B, Cin, W], w [Cout, Cin/G, k] -> [B, Cout, (W + 2*padding - k)//stride + 1],
    symmetric zero padding, output channel oc reading input group oc // (Cout/G)."""
    return GroupedConv1dCF.apply(x.contiguous(), w.contiguous(), stride, padding,
                                 feature_group_count)
