"""The conformer conv module's GLU and depthwise convolution on the CPU:
the plain chain, bit for bit (the CUDA kernels of ``ops/depthwise_glu.py``
run only on the card, where ``test_torch_kernels_cuda.py`` holds them
against the plain versions of their arithmetic), and those plain versions
against the chain evaluated in float64."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.config import AudioEncoderConfig
from speech_transcript_embeddings_torch.models import audio_encoder as ae
from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
from torch_port_cfg import one_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32


def _chain(x, weight, dtype):
    """The expression ``ConvModule.forward`` ran between pointwise1 and
    the depthwise norm before the kernels."""
    a, g = x.chunk(2, dim=-1)
    u = (a * torch.sigmoid(g)).transpose(1, 2)
    k = weight.shape[-1]
    return F.conv1d(F.pad(u, (k - 1, 0)), weight.to(dtype),
                    groups=weight.shape[0]).transpose(1, 2)


def _inputs(b, t, c, k, dtype, train, seed):
    """x [B, T, 2C], the weight [C, 1, K] (fp32 that trains, or bf16 frozen
    as ``create_train_state`` keeps it) and dy [B, T, C]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, 2 * c, generator=g).to(dtype)
    w = 0.2 * torch.randn(c, 1, k, generator=g)
    if not train:
        w = w.to(BF16)
    dy = torch.randn(b, t, c, generator=g).to(dtype)
    return x, w.requires_grad_(train), dy


def _close(got, want, what):
    """``got`` (rounded once to its dtype from fp32 arithmetic) against the
    float64 ``want``: within half a step of the dtype (bf16 2⁻⁸ of the
    value; fp32 sums in another order), on a floor of 1e-6 of the
    largest."""
    rtol = 2 ** -8 if got.dtype == BF16 else 1e-5
    atol = 1e-6 * want.abs().max().item()
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=atol,
                               msg=what)


# (B, T, C, K): the main path's taps at full width and at tensor
# parallel's half width, T off every strip of the kernels (256 forward, 128
# backward), T under K, and a small K at a width off the 32-channel slice
SHAPES = {"c1024_t300_k31": (2, 300, 1024, 31),
          "c512_t300_k31": (2, 300, 512, 31),
          "c1024_t9_k31": (3, 9, 1024, 31),
          "c48_t37_k5": (3, 37, 48, 5)}


@pytest.mark.parametrize("train", [True, False],
                         ids=["fp32_weight", "frozen_bf16_weight"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_versions_match_the_chain_in_float64(case, dtype, train):
    """y, da, dg and dw of the kernels' plain arithmetic (fp32, rounded
    once) against autograd through the chain in float64 from the same
    inputs."""
    b, t, c, k = SHAPES[case]
    x, w, dy = _inputs(b, t, c, k, dtype, train, seed=t + c + k)
    x64 = x.double().requires_grad_()
    w64 = w.detach().double().requires_grad_()
    want = _chain(x64, w64, torch.float64)
    want.backward(dy.double())
    y = dg.depthwise_glu_reference(x, w.detach())
    dx, dw = dg.depthwise_glu_bwd_reference(dy, x, w.detach())
    assert y.dtype == dx.dtype == dtype and dw.dtype == w.dtype
    assert y.shape == (b, t, c) and dx.shape == x.shape
    assert dw.shape == w.shape
    _close(y, want.detach(), "y")
    _close(dx[..., :c], x64.grad[..., :c], "da")
    _close(dx[..., c:], x64.grad[..., c:], "dg")
    _close(dw, w64.grad, "dw")


@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_backward_formula_matches_autograd_in_float64(case):
    """The backward formula against autograd through the plain forward,
    both in float64: the same function to the last bits."""
    b, t, c, k = SHAPES[case]
    x, w, dy = _inputs(b, t, c, k, torch.float64, True, seed=k)
    w = w.detach().double().requires_grad_()
    x.requires_grad_()
    dg.depthwise_glu_reference(x, w).backward(dy)
    dx, dw = dg.depthwise_glu_bwd_reference(dy, x.detach(), w.detach())
    torch.testing.assert_close(dx, x.grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dw, w.grad, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("train", [True, False],
                         ids=["fp32_weight", "frozen_bf16_weight"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["c48_t37_k5", "c1024_t9_k31"])
def test_cpu_depthwise_glu_is_the_chain_bit_for_bit(case, dtype, train):
    """Output and every gradient autograd gives, equal to the chain's."""
    b, t, c, k = SHAPES[case]
    x, w, dy = _inputs(b, t, c, k, dtype, train, seed=3)
    x = x.requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    w2 = w.detach().clone().requires_grad_(train)
    y = dg.depthwise_glu(x, w)
    want = _chain(x2, w2, dtype)
    assert y.dtype == dtype and torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(x.grad, x2.grad)
    if train:
        assert w.grad.dtype == F32 and torch.equal(w.grad, w2.grad)
    else:
        assert w.grad is None


def test_cpu_depthwise_glu_never_reaches_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel path")
    monkeypatch.setattr(dg, "_fwd", refuse)
    monkeypatch.setattr(dg, "_bwd", refuse)
    x, w, dy = _inputs(2, 11, 16, 7, BF16, True, seed=4)
    x.requires_grad_()
    dg.depthwise_glu(x, w).backward(dy)
    with torch.no_grad():
        dg.depthwise_glu(x, w)
    assert x.grad is not None and not dg.LAUNCHES["depthwise_glu_fwd"]


def _parent_forward(mod, x, mask):
    """``ConvModule.forward`` as it was before the kernels."""
    c = mod.cfg
    x = mod.norm(x)
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    a, g = mod.pointwise1(x).chunk(2, dim=-1)
    x = (a * torch.sigmoid(g)).transpose(1, 2)
    x = F.conv1d(F.pad(x, (c.conv_kernel_size - 1, 0)),
                 mod.depthwise_kernel.to(mod.pointwise1.dtype),
                 groups=mod.depthwise_kernel.shape[0]).transpose(1, 2)
    return mod.pointwise2(ae.swish(mod.depthwise_norm(x)))


@pytest.mark.parametrize("k", [31, 7])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_conv_module_on_the_cpu_is_the_parent_formula_bit_for_bit(dtype, k):
    """The module's output and its parameters' and input's gradients, with
    a mask, equal to the formula the module ran before the kernels."""
    cfg = dataclasses.replace(AudioEncoderConfig(), hidden_size=48,
                              conv_kernel_size=k, conv_dropout=0.0)
    torch.manual_seed(5)
    mod = ae.ConvModule(cfg, dtype)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(0.3 * torch.randn(p.shape))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 40, 48, generator=g).to(dtype)
    mask = (torch.arange(40)[None, :] < torch.tensor([[40], [23]])).float()
    dy = torch.randn(2, 40, 48, generator=g).to(dtype)
    outs, grads = [], []
    for forward in (lambda v: mod(v, mask),
                    lambda v: _parent_forward(mod, v, mask)):
        mod.zero_grad()
        v = x.clone().requires_grad_()
        out = forward(v)
        out.backward(dy)
        outs.append(out)
        grads.append([v.grad] + [p.grad.clone() for p in mod.parameters()])
    assert torch.equal(outs[0], outs[1])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("what", ["fp16", "float64", "c12", "k32",
                                  "odd_width", "weight_shape",
                                  "not_cuda", "two_devices"])
def test_wrapper_refuses_what_the_kernels_do_not_take(what):
    """Off the CPU route (here on the meta device, where no kernel can
    launch) the checks raise before any launch."""
    c, k, dtype, width = 16, 31, BF16, None
    if what == "fp16":
        dtype = torch.float16
    elif what == "float64":
        dtype = torch.float64
    elif what == "c12":
        c = 12
    elif what == "k32":
        k = 32
    elif what == "odd_width":
        width = 2 * c + 1
    x = torch.zeros(2, 9, width or 2 * c, dtype=dtype, device="meta")
    w_shape = (c, 2, k) if what == "weight_shape" else (c, 1, k)
    w = torch.zeros(w_shape, device="cpu" if what == "two_devices"
                    else "meta")
    match = {"fp16": "need", "float64": "need", "c12": "multiple of 8",
             "k32": "multiple of 8", "odd_width": "2C",
             "weight_shape": "1, K", "not_cuda": "CUDA",
             "two_devices": "CUDA"}[what]
    with pytest.raises(ValueError, match=match):
        dg.depthwise_glu(x, w)
