"""K3 and K4: grouped 1-D convolution forward, input gradient and weight
gradient (CUDA kernels + plain versions).

Port of roar_tpu/ops/grouped_conv.py: `_core_kernel` (K3, which the JAX
package runs for the forward and, with a phase-packed transposed weight, for
dX) and `_dw_kernel` (K4, dW).  The kernels are in `csrc/grouped_conv.cu`;
its source note says what bounds them on the H100 and what the design does
about it.  In fp32, K3 and K4 multiply on the tensor cores in 3xTF32 (each
fp32 operand split into two TF32 parts, three products per multiply-add,
fp32 sums: about 1e-7 to 3e-6 of the result's scale).  In bf16 (the JAX
package's bf16 step) they read bf16, form each product exactly as one TF32
product of the widened values, sum in fp32 and write y and dX in bf16,
rounded once, and dW in fp32, the TPU kernel's output types
(roar_tpu/ops/grouped_conv.py:253,326).  The TPU kernel's fold,
pack and tile helpers are not ported: the CUDA kernels take stride, padding
and groups at run time and index the raw tensors.

Layouts: activations [B, C, W] as in the JAX op; the weight is torch's
[Cout, Cin/G, k] (the JAX op takes flax's [k, Cin/G, Cout]).  Output channel
oc reads input group oc // (Cout/G).  x, w and dy share one type, fp32 or
bf16.

    fwd  y[b, g*Og+o, n]  = sum_{c,j} w[g*Og+o, c, j] * x[b, g*Cg+c, n*s + j - pad]
    dX   dx[b, g*Cg+c, m] = sum_{o,j: (m+pad-j) % s == 0} w[g*Og+o, c, j] * dy[b, g*Og+o, (m+pad-j)/s]
    dW   dw[g*Og+o, c, j] = sum_{b,n} dy[b, g*Og+o, n] * x[b, g*Cg+c, n*s + j - pad]

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  `LAUNCHES_FWD`, `LAUNCHES_DX` and
`LAUNCHES_DW` count the fp32 kernels' launches, `LAUNCHES_FWD_BF16`,
`LAUNCHES_DX_BF16` and `LAUNCHES_DW_BF16` the bf16 ones (dW counts one per
call, its reduction pass included).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_DX = 0
LAUNCHES_DW = 0
LAUNCHES_FWD_BF16 = 0
LAUNCHES_DX_BF16 = 0
LAUNCHES_DW_BF16 = 0
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def out_len(width: int, kernel_size: int, stride: int, padding: int) -> int:
    """Output width of a conv with symmetric padding (roar_tpu `_out_len`)."""
    return (width + 2 * padding - kernel_size) // stride + 1


def _check_geometry(cin: int, cout: int, w: torch.Tensor, width: int, stride: int, padding: int,
                    groups: int) -> None:
    if groups < 1 or cin % groups or cout % groups:
        raise ValueError(f"channels {cin} -> {cout} do not split into {groups} groups")
    if w.dim() != 3 or w.shape[0] != cout or w.shape[1] != cin // groups:
        raise ValueError(f"weight must be [Cout={cout}, Cin/G={cin // groups}, k], got "
                         f"{tuple(w.shape)}")
    k = w.shape[2]
    if stride < 1 or not 0 <= padding < k or width + 2 * padding < k:
        raise ValueError(f"unsupported geometry: width {width}, k {k}, stride {stride}, "
                         f"padding {padding}")


def _wide(t: torch.Tensor) -> torch.Tensor:
    """bf16 widened to fp32 (exactly); fp32 and fp64 as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _columns(x: torch.Tensor, kernel_size: int, stride: int, padding: int, groups: int):
    """[B, C, W] -> a view [B, G, C/G, Wout, k] of the zero-padded input's taps."""
    b, c, _ = x.shape
    cols = F.pad(x, (padding, padding)).unfold(2, kernel_size, stride)
    return cols.reshape(b, groups, c // groups, cols.shape[2], kernel_size)


def grouped_conv_fwd_plain(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                           groups: int) -> torch.Tensor:
    """K3 forward's plain PyTorch version: pad, unfold, one einsum per group
    (batched over the groups).  x [B, Cin, W], w [Cout, Cin/G, k] -> [B, Cout, Wout]
    in x's type; bf16 operands are widened to fp32 (exactly), summed in fp32
    and the result rounded once."""
    b, cin, width = x.shape
    cout, cg, k = w.shape
    cols = _columns(_wide(x), k, stride, padding, groups)
    y = torch.einsum("bgcnj,gocj->bgon", cols, _wide(w).reshape(groups, cout // groups, cg, k))
    return y.reshape(b, cout, cols.shape[3]).to(x.dtype)


def grouped_conv_dx_plain(dy: torch.Tensor, w: torch.Tensor, in_width: int, stride: int,
                          padding: int, groups: int) -> torch.Tensor:
    """K3 dX's plain PyTorch version: dy with stride - 1 zeros between its
    samples, padded by k - 1 - pad on the left, correlated with the reversed
    weight.  dy [B, Cout, Wout], w [Cout, Cin/G, k] -> [B, Cin, in_width] in
    dy's type, summed in fp32 as the forward is."""
    b, cout, wout = dy.shape
    _, cg, k = w.shape
    stuffed = _wide(dy).new_zeros((b, cout, (wout - 1) * stride + 1))
    stuffed[:, :, ::stride] = dy
    left = k - 1 - padding
    right = in_width + k - 1 - left - stuffed.shape[2]
    cols = F.pad(stuffed, (left, right)).unfold(2, k, 1)  # [B, Cout, in_width, k]
    cols = cols.reshape(b, groups, cout // groups, in_width, k)
    dx = torch.einsum("bgonj,gocj->bgcn", cols,
                      _wide(w).flip(-1).reshape(groups, cout // groups, cg, k))
    return dx.reshape(b, groups * cg, in_width).to(dy.dtype)


def grouped_conv_dw_plain(x: torch.Tensor, dy: torch.Tensor, kernel_size: int, stride: int,
                          padding: int, groups: int) -> torch.Tensor:
    """K4's plain PyTorch version.  x [B, Cin, W], dy [B, Cout, Wout] ->
    [Cout, Cin/G, k], in fp32 for bf16 operands (summed in fp32, as the TPU
    kernel returns it)."""
    b, cin, _ = x.shape
    cout = dy.shape[1]
    cols = _columns(_wide(x), kernel_size, stride, padding, groups)
    dw = torch.einsum("bgon,bgcnj->gocj",
                      _wide(dy).reshape(b, groups, cout // groups, -1), cols)
    return dw.reshape(cout, cin // groups, kernel_size)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    if t.dtype not in KERNEL_DTYPES or t.dtype != dtype:
        raise TypeError(f"{name} must be float32 or bfloat16, of the same type as the other "
                        f"operands ({dtype}), got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_or_plain(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def grouped_conv_fwd(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                     groups: int) -> torch.Tensor:
    """Grouped conv forward: x [B, Cin, W], w [Cout, Cin/G, k] -> [B, Cout, Wout]."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, Cin, W], got {tuple(x.shape)}")
    b, cin, width = x.shape
    _check_geometry(cin, w.shape[0], w, width, stride, padding, groups)
    if not _cuda_or_plain("grouped_conv_fwd", x):
        return grouped_conv_fwd_plain(x, w, stride, padding, groups)
    cout, _, k = w.shape
    _check_cuda("x", x, x.device, x.dtype)
    _check_cuda("w", w, x.device, x.dtype)
    wout = out_len(width, k, stride, padding)
    y = torch.empty((b, cout, wout), dtype=x.dtype, device=x.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    bf16 = x.dtype == torch.bfloat16
    launch = lib.roar_grouped_conv_fwd_bf16 if bf16 else lib.roar_grouped_conv_fwd
    err = launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, cin, width, cout, k, stride,
                 padding, groups, wout, torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "grouped_conv_fwd launch")
    global LAUNCHES_FWD, LAUNCHES_FWD_BF16
    if bf16:
        LAUNCHES_FWD_BF16 += 1
    else:
        LAUNCHES_FWD += 1
    return y


def grouped_conv_dx(dy: torch.Tensor, w: torch.Tensor, in_width: int, stride: int,
                    padding: int, groups: int) -> torch.Tensor:
    """Input gradient: dy [B, Cout, Wout], w [Cout, Cin/G, k] -> [B, Cin, in_width]."""
    if dy.dim() != 3:
        raise ValueError(f"dy must be [B, Cout, Wout], got {tuple(dy.shape)}")
    b, cout, wout = dy.shape
    cin = w.shape[1] * groups
    _check_geometry(cin, cout, w, in_width, stride, padding, groups)
    k = w.shape[2]
    if wout != out_len(in_width, k, stride, padding):
        raise ValueError(f"dy width {wout} does not belong to an input of width {in_width}")
    if not _cuda_or_plain("grouped_conv_dx", dy):
        return grouped_conv_dx_plain(dy, w, in_width, stride, padding, groups)
    _check_cuda("dy", dy, dy.device, dy.dtype)
    _check_cuda("w", w, dy.device, dy.dtype)
    dx = torch.empty((b, cin, in_width), dtype=dy.dtype, device=dy.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    bf16 = dy.dtype == torch.bfloat16
    launch = lib.roar_grouped_conv_dx_bf16 if bf16 else lib.roar_grouped_conv_dx
    err = launch(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), b, cin, in_width, cout, k, stride,
                 padding, groups, wout, torch.cuda.current_stream(dy.device).cuda_stream)
    check(lib, err, "grouped_conv_dx launch")
    global LAUNCHES_DX, LAUNCHES_DX_BF16
    if bf16:
        LAUNCHES_DX_BF16 += 1
    else:
        LAUNCHES_DX += 1
    return dx


def grouped_conv_dw(x: torch.Tensor, dy: torch.Tensor, kernel_size: int, stride: int,
                    padding: int, groups: int) -> torch.Tensor:
    """Weight gradient: x [B, Cin, W], dy [B, Cout, Wout] -> [Cout, Cin/G, k],
    fp32 for either operand type.  Sums run in a fixed order: two calls on the
    same inputs give the same bits."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"x must be [B, Cin, W] and dy [B, Cout, Wout], got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    b, cin, width = x.shape
    cout, wout = dy.shape[1], dy.shape[2]
    if groups < 1 or cin % groups or cout % groups:
        raise ValueError(f"channels {cin} -> {cout} do not split into {groups} groups")
    k = kernel_size
    if stride < 1 or not 0 <= padding < k or wout != out_len(width, k, stride, padding):
        raise ValueError(f"unsupported geometry: width {width} -> {wout}, k {k}, stride "
                         f"{stride}, padding {padding}")
    if not _cuda_or_plain("grouped_conv_dw", x):
        return grouped_conv_dw_plain(x, dy, k, stride, padding, groups)
    _check_cuda("x", x, x.device, x.dtype)
    _check_cuda("dy", dy, x.device, x.dtype)
    dw = torch.empty((cout, cin // groups, k), dtype=torch.float32, device=x.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    shape = (b, cin, width, cout, k, stride, padding, groups, wout)
    parts = lib.roar_grouped_conv_dw_parts(*shape)
    if parts < 1:
        raise ValueError(f"grouped_conv_dw: the kernel does not take shape {shape}")
    workspace = (torch.empty((parts, *dw.shape), dtype=torch.float32, device=x.device)
                 if parts > 1 else None)
    bf16 = x.dtype == torch.bfloat16
    launch = lib.roar_grouped_conv_dw_bf16 if bf16 else lib.roar_grouped_conv_dw
    err = launch(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                 workspace.data_ptr() if workspace is not None else None, *shape, parts,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "grouped_conv_dw launch")
    global LAUNCHES_DW, LAUNCHES_DW_BF16
    if bf16:
        LAUNCHES_DW_BF16 += 1
    else:
        LAUNCHES_DW += 1
    return dw
