"""LayerNorm and GELU that read and write bf16 and compute in f32.

No counterpart among the JAX package's Pallas kernels: XLA fuses the casts
that the JAX package's rounding points put around its LayerNorms and f32
GELUs, and PyTorch runs each cast as a kernel of its own, with an f32 copy
of the tensor in device memory. The CUDA kernels are ``csrc/norm_act.cu``;
``layer_norm_ref`` and ``gelu_ref`` are the plain versions, the
expressions the models ran before: upcast to f32, the f32 operator, cast
back to x's dtype.

Each kernel is a custom op (``vct::layer_norm``, ``vct::gelu``): CPU kernel
the plain version, CUDA kernel the launch, a fake implementation from the
shape alone, and a registered backward (``layer_norm_bwd``, ``gelu_bwd``:
PyTorch's f32 backward of the plain version on the upcast inputs, so the
gradients are autograd's of the plain version, bit for bit). ``layer_norm``
and ``gelu`` take the op for every bf16 tensor on CUDA, under autograd too;
an f32 tensor or a CPU tensor runs the plain version itself, as before.
Both kernels count in ``launches``; ``plain_on_cuda`` counts the calls on
CUDA tensors that took the plain version (f32 tensors alone).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.ops import build

launches = 0
"""Number of times ``layer_norm`` or ``gelu`` launched a CUDA kernel."""
plain_on_cuda = 0
"""Number of ``layer_norm`` and ``gelu`` calls on CUDA tensors that ran the
plain version (f32 tensors)."""
APPROXIMATIONS = ("tanh", "none")


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm over the last axis computed in f32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu_ref(x: torch.Tensor, approximate: str) -> torch.Tensor:
    """GELU computed in f32, cast back to x's dtype."""
    return F.gelu(x.float(), approximate=approximate).to(x.dtype)


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   grad: torch.Tensor, needs: tuple = (True, True, True)) -> tuple:
    """(dx, dweight, dbias) of ``layer_norm_ref`` for ``grad``, each cast to
    its input's dtype (None where ``needs`` says no): PyTorch's f32
    LayerNorm backward on the upcast tensors, with the mean and 1/std of its
    f32 forward, which autograd of the plain version runs."""
    h = x.shape[-1]
    xf, wf, bf = x.float(), weight.float(), bias.float()
    _, mean, rstd = torch.ops.aten.native_layer_norm(xf, [h], wf, bf, eps)
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(grad.float(), xf, [h], mean, rstd,
                                                           wf, bf, list(needs))
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip((dx, dw, db), (x, weight, bias)))


def gelu_bwd(x: torch.Tensor, grad: torch.Tensor, approximate: str) -> torch.Tensor:
    """dx of ``gelu_ref`` for ``grad``: PyTorch's f32 GELU backward on the
    upcast tensors, cast to x's dtype."""
    return torch.ops.aten.gelu_backward(grad.float(), x.float(),
                                        approximate=approximate).to(x.dtype)


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether a call goes to the kernel: x bf16 on CUDA."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def _check(x: torch.Tensor) -> None:
    build.require_cuda(x, "x")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the norm_act kernels take bf16 x, not {x.dtype}")


@torch.library.custom_op("vct::layer_norm", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm_ref(x, weight, bias, eps)


@_op.register_kernel("cuda")
def _cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    _check(x)
    build.require_cuda(weight, "weight")
    build.require_cuda(bias, "bias")
    h = x.shape[-1]
    if weight.shape != (h,) or bias.shape != (h,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)} must be "
                         f"[{h}] for x {tuple(x.shape)}")
    if weight.dtype not in (x.dtype, torch.float32) or bias.dtype != weight.dtype:
        raise TypeError(f"weight and bias must both be bf16 or both float32, got "
                        f"{weight.dtype} and {bias.dtype}")
    y = torch.empty_like(x)
    if x.numel():
        build.launch("vct_layer_norm", x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                     y.data_ptr(), x.numel() // h, h, float(eps),
                     build.dtype_code(weight.dtype), build.stream_of(x))
        launches += 1
    return y


@_op.register_fake
def _fake(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output) -> None:
    x, weight, bias, ctx.eps = inputs
    ctx.save_for_backward(x, weight, bias)


def _backward(ctx, grad):
    x, weight, bias = ctx.saved_tensors
    return (*layer_norm_bwd(x, weight, bias, ctx.eps, grad, ctx.needs_input_grad[:3]), None)


_op.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("vct::gelu", mutates_args=(), device_types="cpu")
def _gelu_op(x: torch.Tensor, approximate: str) -> torch.Tensor:
    return gelu_ref(x, approximate)


@_gelu_op.register_kernel("cuda")
def _gelu_cuda(x: torch.Tensor, approximate: str) -> torch.Tensor:
    global launches
    _check(x)
    if approximate not in APPROXIMATIONS:
        raise ValueError(f"approximate must be one of {APPROXIMATIONS}, got {approximate!r}")
    y = torch.empty_like(x)
    if x.numel():
        build.launch("vct_gelu", x.data_ptr(), y.data_ptr(), x.numel(),
                     int(approximate == "tanh"), build.stream_of(x))
        launches += 1
    return y


@_gelu_op.register_fake
def _gelu_fake(x: torch.Tensor, approximate: str) -> torch.Tensor:
    return torch.empty_like(x)


def _gelu_setup_context(ctx, inputs, output) -> None:
    x, ctx.approximate = inputs
    ctx.save_for_backward(x)


def _gelu_backward(ctx, grad):
    (x,) = ctx.saved_tensors
    return gelu_bwd(x, grad, ctx.approximate), None


_gelu_op.register_autograd(_gelu_backward, setup_context=_gelu_setup_context)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32, in x's dtype, differentiable: the
    kernel for bf16 x on CUDA (weight and bias on the same device, both bf16
    or both f32), the plain version for f32 or CPU tensors."""
    global plain_on_cuda
    build.require_device(x, weight, bias)
    if takes_kernel(x):
        return _op(x.contiguous(), weight.contiguous(), bias.contiguous(), eps)
    if x.is_cuda:
        plain_on_cuda += 1
    return layer_norm_ref(x, weight, bias, eps)


def gelu(x: torch.Tensor, approximate: str) -> torch.Tensor:
    """GELU (``approximate`` "tanh" or "none") in f32, in x's dtype,
    differentiable: the kernel for bf16 x on CUDA, the plain version for
    f32 or CPU tensors."""
    global plain_on_cuda
    build.require_device(x)
    if takes_kernel(x):
        return _gelu_op(x.contiguous(), approximate)
    if x.is_cuda:
        plain_on_cuda += 1
    return gelu_ref(x, approximate)
