"""The port's LayerNorm on the CPU: the plain chain, bit for bit (the CUDA
kernels of ``ops/layer_norm.py`` run only on the card, where
``test_torch_kernels_cuda.py`` holds them against it), and the plain
version of the kernels' backward formula against autograd in fp64."""

import pytest
import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.models import layers
from speech_transcript_embeddings_torch.ops import layer_norm as ln
from speech_transcript_embeddings_torch.parallel.collectives import ModelAxis
from torch_port_cfg import one_thread  # noqa: F401

EPS = 1e-5


def _chain(x, weight, bias, eps, dtype):
    """The expression ``LayerNorm.forward`` ran before the kernels."""
    return F.layer_norm(x.float(), weight.shape, weight.float(), bias.float(),
                        eps).to(dtype)


def _module(n, dtype, frozen, seed):
    g = torch.Generator().manual_seed(seed)
    mod = layers.LayerNorm(n, EPS, dtype)
    with torch.no_grad():
        mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
        mod.bias.copy_(0.1 * torch.randn(n, generator=g))
    if frozen:             # as create_train_state keeps the frozen split
        for p in mod.parameters():
            p.data = p.data.to(torch.bfloat16)
            p.requires_grad_(False)
    return mod


def _input(shape, dtype, transposed, seed):
    g = torch.Generator().manual_seed(seed)
    if transposed:        # the depthwise norm's [B, H, T] conv output
        b, t, h = shape
        return (torch.randn(b, h, t, generator=g) * 3 + 1).to(
            dtype).transpose(1, 2)
    return (torch.randn(*shape, generator=g) * 3 + 1).to(dtype)


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["contiguous", "transposed"])
@pytest.mark.parametrize("frozen", [False, True], ids=["fp32_affine",
                                                        "frozen_bf16_affine"])
@pytest.mark.parametrize("x_dtype,dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)],
    ids=["bf16", "fp32_in_bf16_out", "fp32", "bf16_in_fp32_out"])
def test_cpu_layer_norm_is_the_chain_bit_for_bit(x_dtype, dtype, frozen,
                                                 transposed):
    """Output and every gradient autograd gives, equal to the chain's."""
    n = 40
    mod = _module(n, dtype, frozen, seed=1)
    x = _input((3, 7, n), x_dtype, transposed, seed=2).requires_grad_()
    dy = torch.randn(3, 7, n, generator=torch.Generator().manual_seed(3)).to(
        dtype)
    y = mod(x)
    x2 = x.detach().clone().requires_grad_()
    w2, b2 = (p.detach().clone().requires_grad_(p.requires_grad)
              for p in (mod.weight, mod.bias))
    want = _chain(x2, w2, b2, EPS, dtype)
    assert y.dtype == dtype and torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(x.grad, x2.grad)
    for p, q in ((mod.weight, w2), (mod.bias, b2)):
        if frozen:
            assert p.grad is None and q.grad is None
        else:
            assert p.grad.dtype == torch.float32 and torch.equal(p.grad, q.grad)


def test_cpu_layer_norm_never_reaches_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel path")
    monkeypatch.setattr(ln, "_fwd", refuse)
    monkeypatch.setattr(ln, "_bwd", refuse)
    mod = _module(16, torch.bfloat16, False, seed=4)
    x = torch.randn(5, 16, requires_grad=True)
    mod(x).float().sum().backward()
    with torch.no_grad():
        mod(x)
    assert x.grad is not None and ln.LAUNCHES["layer_norm_fwd"] == 0


def test_sharded_layer_norm_keeps_its_own_forward(monkeypatch):
    """``ShardedLayerNorm`` runs its own two-pass statistics over the axis,
    not the plain LayerNorm's route (one rank, the collectives as
    identities)."""
    assert layers.ShardedLayerNorm.forward is not layers.LayerNorm.forward

    def refuse(*args, **kwargs):
        raise AssertionError("ShardedLayerNorm reached layer_norm_op")
    monkeypatch.setattr(layers, "layer_norm_op", refuse)
    monkeypatch.setattr(layers, "all_reduce_model", lambda t, a: t)
    monkeypatch.setattr(layers, "copy_to_model", lambda t, a: t)
    n = 24
    mod = layers.ShardedLayerNorm(n, EPS, ModelAxis(1, 0), torch.bfloat16)
    ref = _module(n, torch.bfloat16, False, seed=5)
    mod.load_state_dict(ref.state_dict())
    x = torch.randn(4, n, generator=torch.Generator().manual_seed(6)).to(
        torch.bfloat16)
    xf = x.float()
    xc = xf - xf.sum(-1, keepdim=True) / n
    var = (xc * xc).sum(-1, keepdim=True) / n
    want = (xc * torch.rsqrt(var + EPS) * ref.weight + ref.bias).to(
        torch.bfloat16)
    assert torch.equal(mod(x), want)


@pytest.mark.parametrize("shape", [(1, 8), (13, 24), (2, 5, 160)],
                         ids=["one_row", "prime_rows", "feature_norm_width"])
def test_plain_statistics_match_aten_in_fp64(shape):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(*shape, generator=g, dtype=torch.float64) * 2 + 0.5
    n = shape[-1]
    mean, rstd = ln.layer_norm_stats_reference(x, EPS)
    _, want_mean, want_rstd = torch.native_layer_norm(x, (n,), None, None, EPS)
    torch.testing.assert_close(mean, want_mean.reshape(-1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(rstd, want_rstd.reshape(-1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 8), (13, 24), (2, 5, 160)],
                         ids=["one_row", "prime_rows", "feature_norm_width"])
def test_plain_backward_formula_matches_autograd_in_fp64(shape):
    """dx, dγ and dβ of the kernels' formula against autograd through
    ``F.layer_norm``, all in fp64."""
    g = torch.Generator().manual_seed(sum(shape))
    f64 = dict(generator=g, dtype=torch.float64)
    n = shape[-1]
    x = (torch.randn(*shape, **f64) * 2 + 0.5).requires_grad_()
    w = (1 + 0.1 * torch.randn(n, **f64)).requires_grad_()
    b = (0.1 * torch.randn(n, **f64)).requires_grad_()
    dy = torch.randn(*shape, **f64)
    F.layer_norm(x, (n,), w, b, EPS).backward(dy)
    mean, rstd = ln.layer_norm_stats_reference(x.detach(), EPS)
    dx, dgamma, dbeta = ln.layer_norm_bwd_reference(dy, x.detach(),
                                                    w.detach(), mean, rstd)
    assert dx.dtype == torch.float64 and dx.shape == x.shape
    for got, want in ((dx, x.grad), (dgamma, w.grad), (dbeta, b.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_plain_backward_rounds_dx_to_the_input_dtype():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(6, 32, generator=g).to(torch.bfloat16)
    dy = torch.randn(6, 32, generator=g).to(torch.bfloat16)
    w = torch.ones(32, dtype=torch.bfloat16)
    mean, rstd = ln.layer_norm_stats_reference(x, EPS)
    dx, dgamma, dbeta = ln.layer_norm_bwd_reference(dy, x, w, mean, rstd)
    assert dx.dtype == torch.bfloat16
    assert dgamma.dtype == dbeta.dtype == torch.float32
    assert mean.dtype == rstd.dtype == torch.float32


@pytest.mark.parametrize("n,x_dtype,w_dtype,b_dtype,match", [
    (12, torch.bfloat16, torch.float32, torch.float32, "multiple of 8"),
    (ln.MAX_WIDTH + 8, torch.bfloat16, torch.float32, torch.float32,
     "multiple of 8"),
    (16, torch.float16, torch.float32, torch.float32, "need"),
    (16, torch.bfloat16, torch.float32, torch.bfloat16, "need"),
], ids=["width_12", "too_wide", "fp16_input", "mixed_affine"])
def test_kernel_route_refuses_what_it_does_not_take(n, x_dtype, w_dtype,
                                                    b_dtype, match):
    x = torch.zeros(2, n, dtype=x_dtype)
    with pytest.raises(ValueError, match=match):
        ln._check(x, torch.ones(n, dtype=w_dtype), torch.zeros(n, dtype=b_dtype),
                  torch.bfloat16)


def test_kernel_route_refuses_cpu_tensors():
    x = torch.zeros(2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ln._check(x, torch.ones(16), torch.zeros(16), torch.bfloat16)
