"""ops/norm_act.py on the CPU: the dispatch rule. A CPU tensor and an f32
tensor run the plain expression the models ran before the kernels (upcast to
f32, the f32 operator, cast back), bit for bit, without the custom ops and
without a launch, under autograd too; through the ops (the dispatch forced
to them) the gradients are autograd's of that expression, bit for bit; the
models' LayerNorms and f32 GELUs go through the wrappers. tests/test_torch_cuda_kernels.py holds
the kernels to the plain versions on the card; tests/test_torch_custom_ops.py
checks the ops (opcheck, fake implementations, an exported program)."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from video_caption_tpu_torch.models import vit
from video_caption_tpu_torch.ops import norm_act

DTYPES = [torch.float32, torch.bfloat16]


def _todays_layer_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def _todays_gelu(x, approximate):
    return F.gelu(x.float(), approximate=approximate).to(x.dtype)


def _inputs(dtype, grad, width=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(3, 5, width, generator=g) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(dtype)
    b = (0.1 * torch.randn(width, generator=g)).to(dtype)
    return [t.requires_grad_(grad) for t in (x, w, b)]


@pytest.fixture
def without_ops(monkeypatch):
    """The two custom ops replaced by ones that fail the test if called."""
    def refuse(*args):
        raise AssertionError("the call went to a custom op")

    monkeypatch.setattr(norm_act, "_op", refuse)
    monkeypatch.setattr(norm_act, "_gelu_op", refuse)


def _counts():
    return norm_act.launches, norm_act.plain_on_cuda


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_on_the_cpu_is_the_plain_expression(without_ops, dtype, grad):
    """vit.layer_norm (the models' LayerNorm) returns today's expression bit
    for bit, and under autograd the same gradients."""
    x, w, b = _inputs(dtype, grad)
    before = _counts()
    got = vit.layer_norm(x, w, b, 1e-6)
    want = _todays_layer_norm(x, w, b, 1e-6)
    assert got.dtype == dtype and torch.equal(got, want)
    assert _counts() == before
    if grad:
        up = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
        for a, c in zip(torch.autograd.grad(got, (x, w, b), up),
                        torch.autograd.grad(want, (x, w, b), up)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("approximate", norm_act.APPROXIMATIONS)
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_on_the_cpu_is_the_plain_expression(without_ops, dtype, grad, approximate):
    x = _inputs(dtype, grad)[0]
    before = _counts()
    got = norm_act.gelu(x, approximate)
    want = _todays_gelu(x, approximate)
    assert got.dtype == dtype and torch.equal(got, want)
    assert _counts() == before
    if grad:
        up = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
        assert torch.equal(torch.autograd.grad(got, x, up)[0], torch.autograd.grad(want, x, up)[0])


def test_only_half_precision_cuda_tensors_outside_autograd_take_the_kernel():
    """Only a bf16 CUDA tensor takes the kernel, under autograd as outside
    it: never a CPU or meta tensor, recorded or not."""
    for grad in (False, True):
        x = _inputs(torch.bfloat16, grad)[0]
        assert not norm_act.takes_kernel(x)                     # on the CPU
        assert not norm_act.takes_kernel(x.detach().to("meta"))


@pytest.mark.parametrize("w_dtype", DTYPES)
def test_the_ops_gradients_are_the_plain_expressions(monkeypatch, w_dtype):
    """With the dispatch forced to the ops (as on the card), bf16 x under
    autograd: the values and the gradients of x, the weight and the bias
    (registered backward) equal today's expression's, bit for bit."""
    monkeypatch.setattr(norm_act, "takes_kernel", lambda x: True)
    x, w, b = _inputs(torch.bfloat16, True)
    w, b = (t.detach().to(w_dtype).requires_grad_() for t in (w, b))
    up = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).bfloat16()
    for fn, ref, args in ((lambda *a: norm_act.layer_norm(*a, 1e-5),
                           lambda *a: _todays_layer_norm(*a, 1e-5), (x, w, b)),
                          (lambda a: norm_act.gelu(a, "tanh"),
                           lambda a: _todays_gelu(a, "tanh"), (x,))):
        got, want = fn(*args), ref(*args)
        assert got.grad_fn is not None and torch.equal(got, want)
        for a, c in zip(torch.autograd.grad(got, args, up), torch.autograd.grad(want, args, up)):
            assert a.dtype == c.dtype and torch.equal(a, c)
    # only the gradients asked for: x alone, the weight and bias frozen
    w, b = w.detach(), b.detach()
    got = torch.autograd.grad(norm_act.layer_norm(x, w, b, 1e-5), x, up)[0]
    assert torch.equal(got, torch.autograd.grad(_todays_layer_norm(x, w, b, 1e-5), x, up)[0])


def test_the_models_go_through_the_wrappers(monkeypatch):
    """Every LayerNorm and f32 GELU of a ViT trunk goes through
    norm_act: with the dispatch forced to the ops (whose CPU kernels are the
    plain versions) the trunk calls them 2 x depth + 1 and depth times, and
    returns what it returns without them, bit for bit; with gelu_f32 off the
    GELU stays PyTorch's in the compute dtype."""
    cfg = vit.ViTConfig(image_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                        out_dim=8, dtype=torch.bfloat16)
    params = vit.init_vit_params(torch.Generator().manual_seed(0), cfg, "cpu")
    images = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    want = vit.vit_trunk(params, images, cfg)
    calls = {"layer_norm": 0, "gelu": 0}
    op, gelu_op = norm_act._op, norm_act._gelu_op

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(norm_act, "takes_kernel", lambda x: True)
    monkeypatch.setattr(norm_act, "_op", counted("layer_norm", op))
    monkeypatch.setattr(norm_act, "_gelu_op", counted("gelu", gelu_op))
    assert torch.equal(vit.vit_trunk(params, images, cfg), want)
    assert calls == {"layer_norm": 2 * cfg.depth + 1, "gelu": cfg.depth}
    vit.vit_trunk(params, images, dataclasses.replace(cfg, gelu_f32=False))
    assert calls == {"layer_norm": 2 * (2 * cfg.depth + 1), "gelu": cfg.depth}
