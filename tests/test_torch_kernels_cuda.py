"""CUDA kernels of the torch port against their plain twins, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips when there is no card or no ``nvcc``. Run them on a GPU machine (no
jax needed there, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from speech_transcript_embeddings_torch.config import FrontendConfig
from speech_transcript_embeddings_torch.ops import flash_attention as fa
from speech_transcript_embeddings_torch.ops import frontend as fe
from speech_transcript_embeddings_torch.ops import frontend_kernels as fk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from speech_transcript_embeddings_torch.ops import _build
    try:
        _build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (clips, bucket, lengths, per-bin normalisation): a full clip, one under a
# frame and a third; the main paths' B=16 batches at 82,160 and 164,080
# (lengths spread over the bucket); clips all shorter than one cluster
# rank's slice (32 frames at 41,200), so ranks 1-7 of every clip see no
# valid frame; the unnormalised path; and a 60 s bucket, whose 80-bin slice
# (752 frames) is too large to keep in shared memory. 13 bins take the
# normalisation's scalar (not float4) loads and stores
LOG_MEL_CASES = {
    "b3_16000": (3, 16000, "full_sub_third", True),
    "b3_41200": (3, 41200, "full_sub_third", True),
    "b3_491760": (3, 491760, "full_sub_third", True),
    "b16_82160": (16, 82160, "spread", True),
    "b16_164080": (16, 164080, "spread", True),
    "b4_41200_under_one_slice": (4, 41200, "under_one_slice", True),
    "b3_41200_no_per_bin": (3, 41200, "full_sub_third", False),
    "b3_960000": (3, 960000, "full_sub_third", True),
}


def _log_mel_lengths(batch, bucket, kind):
    if kind == "full_sub_third":
        return [bucket, 399, bucket // 3]
    if kind == "spread":
        return [bucket - i * (bucket - 399) // (batch - 1)
                for i in range(batch)]
    return [399, 400, 3000, 5359]          # 0, 1, 17 and 31 frames


@pytest.mark.parametrize("case", list(LOG_MEL_CASES))
@pytest.mark.parametrize("mels", [80, 8, 13])
def test_log_mel_kernel_matches_twin(cuda, case, mels):
    batch, bucket, kind, per_bin = LOG_MEL_CASES[case]
    cfg = FrontendConfig(num_mel_bins=mels, per_bin_normalize=per_bin)
    g = torch.Generator().manual_seed(bucket + batch)
    lens = torch.tensor(_log_mel_lengths(batch, bucket, kind),
                        dtype=torch.int32)
    wav = torch.randn(batch, bucket, generator=g) * 0.1
    wav *= torch.arange(bucket)[None, :] < lens[:, None]
    wav, lens = wav.to(cuda), lens.to(cuda)
    front = fk.KernelLogMelFrontend(cfg).to(cuda)
    raw = front.raw_log_mel(wav)
    ref_raw = fe.log_mel_reference(cfg, wav, front.transform, front.mel)
    torch.testing.assert_close(raw, ref_raw, rtol=2e-4, atol=2e-4)
    feats, mask = front.normalize_and_stack(raw, lens)
    ref_feats, ref_mask = fe.normalize_and_stack_reference(cfg, raw, lens)
    assert torch.equal(mask, ref_mask)
    torch.testing.assert_close(feats, ref_feats, rtol=2e-3, atol=2e-3)


# (t, hd, heads, L, R, length of the second clip): small bands, hd 12 (the
# CUDA-core kernels in bf16 too), and the conformer's band L = 64, R = 8 at
# every head dim the tensor-core kernels are built for, a zero-length clip
FLASH_CASES = [
    (150, 16, 2, 9, 3, 50), (128, 12, 4, 8, 2, 42), (1536, 64, 16, 64, 8, 512),
    (200, 128, 1, 0, 5, 66), (150, 16, 2, 9, 3, 0), (150, 64, 4, 64, 8, 61),
    (768, 64, 4, 64, 8, 500), (150, 128, 4, 64, 8, 61),
    (768, 128, 4, 64, 8, 300), (300, 64, 4, 64, 8, 0),
] + [(300, hd, 2, 64, 8, 170) for hd in (32, 48, 80, 96, 112)]
FLASH_IDS = ["ragged", "hd12", "t1536", "hd128", "zero_length_row",
             "band_t150", "band_t768", "band_t150_hd128", "band_t768_hd128",
             "band_zero_length_clip"] + [
                 f"band_hd{hd}" for hd in (32, 48, 80, 96, 112)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd,nh,left,right,short", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_kernel_matches_twin(cuda, dtype, tol, t, hd, nh, left, right,
                                   short):
    """K3 through the public wrapper (the tensor-core kernel for bf16 with
    hd a multiple of 16, else the CUDA-core one) against the twin: out
    within ``tol``, lse within 1e-3."""
    g = torch.Generator().manual_seed(t + hd)
    b = 2
    q, k, v = (torch.randn(b * nh, t, hd, generator=g).to(cuda, dtype)
               for _ in range(3))
    e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(cuda, dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [short]])).to(cuda)
    name = "flash_rel_fwd" + ("_wgmma" if fa.flash_kernel(dtype, hd) == "mma"
                              else "")
    before = fa.LAUNCHES[name]
    out, lse = fa.flash_attention_fwd(q, k, v, e, mask, num_heads=nh,
                                      left_max=left)
    assert fa.LAUNCHES[name] == before + 1
    ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, num_heads=nh,
                                              left_max=left)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)


def test_flash_kernel_zero_length_row_is_finite(cuda):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 150, 16, generator=g).to(cuda) for _ in range(3))
    e = torch.randn(13, 16, generator=g).to(cuda)
    mask = torch.zeros(2, 150, device=cuda)
    mask[0, :90] = 1
    out = fa.flash_attention(q, k, v, e, mask, num_heads=2, left_max=9)
    ref, _ = fa.rel_attention_reference(q, k, v, e, mask, num_heads=2,
                                        left_max=9)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[2:], (v[2:].sum(1, keepdim=True) / 256)
                               .expand_as(out[2:]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd,nh,left,right,short", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_backward_kernel_matches_twin(cuda, dtype, tol, t, hd, nh, left,
                                            right, short):
    """K4 against the twin's backward on the same (out, lse): dq, dk, dv and
    dE within ``tol`` of the largest reference gradient (the order of the
    fp32 sums differs, dE most: it sums over every row and query)."""
    g = torch.Generator().manual_seed(t + hd + short)
    b = 2
    q, k, v, dout = (torch.randn(b * nh, t, hd, generator=g).to(cuda, dtype)
                     for _ in range(4))
    e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(cuda, dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [short]])).to(cuda)
    kw = dict(num_heads=nh, left_max=left)
    out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
    name = "flash_rel_bwd" + ("_wgmma" if fa.flash_kernel(dtype, hd) == "mma"
                              else "")
    before = fa.LAUNCHES[name]
    got = fa.flash_attention_bwd(q, k, v, e, mask, out, lse, dout, **kw)
    assert fa.LAUNCHES[name] == before + 1
    ref = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse, dout,
                                         **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv", "dE"), got, ref):
        assert a.dtype == r.dtype == dtype and a.shape == r.shape, name
        assert torch.isfinite(a).all(), name
        scale = r.float().abs().max().clamp_min(1e-30)
        err = ((a.float() - r.float()).abs().max() / scale).item()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("t,hd,nh,left,right,short", [
    c for c in FLASH_CASES if c[1] % 16 == 0], ids=[
        i for c, i in zip(FLASH_CASES, FLASH_IDS) if c[1] % 16 == 0])
def test_flash_backward_wgmma_pair_is_deterministic(cuda, t, hd, nh, left,
                                                    right, short):
    """The bf16 backward pair (no atomics, fixed reduction orders) gives
    the same bits for the same inputs, launch after launch."""
    g = torch.Generator().manual_seed(t + hd + short + 1)
    b = 2
    q, k, v, dout = (torch.randn(b * nh, t, hd, generator=g).to(
        cuda, torch.bfloat16) for _ in range(4))
    e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(
        cuda, torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [short]])).to(cuda)
    kw = dict(num_heads=nh, left_max=left)
    out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
    first = fa.flash_attention_bwd(q, k, v, e, mask, out, lse, dout, **kw)
    second = fa.flash_attention_bwd(q, k, v, e, mask, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv", "dE"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("t,hd,nh,left,right,short", [
    c for c in FLASH_CASES if c[1] % 16 == 0], ids=[
        i for c, i in zip(FLASH_CASES, FLASH_IDS) if c[1] % 16 == 0])
def test_flash_forward_wgmma_is_deterministic(cuda, t, hd, nh, left, right,
                                              short):
    """The bf16 forward (no atomics, fixed reduction orders) gives the same
    bits of out and lse for the same inputs, launch after launch."""
    g = torch.Generator().manual_seed(t + hd + short + 2)
    b = 2
    q, k, v = (torch.randn(b * nh, t, hd, generator=g).to(
        cuda, torch.bfloat16) for _ in range(3))
    e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(
        cuda, torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [short]])).to(cuda)
    kw = dict(num_heads=nh, left_max=left)
    before = fa.LAUNCHES["flash_rel_fwd_wgmma"]
    first = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
    second = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_rel_fwd_wgmma"] == before + 2
    for name, a, b_ in zip(("out", "lse"), first, second):
        assert torch.equal(a, b_), name


def test_flash_autograd_uses_both_kernels(cuda):
    """``flash_attention`` under grad mode: one forward and one backward
    launch, and the gradients of its twin path on the CPU (fp32, 1e-4)."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, 150, 16, generator=g) for _ in range(3))
    e = torch.randn(13, 16, generator=g) * 0.3
    mask = (torch.arange(150)[None, :] < torch.tensor([[150], [70]])).float()
    grads = []
    for device in ("cpu", cuda):
        args = [x.to(device).detach().requires_grad_()
                for x in (q, k, v, e)]
        f0, b0 = fa.LAUNCHES["flash_rel_fwd"], fa.LAUNCHES["flash_rel_bwd"]
        out = fa.flash_attention(*args, mask.to(device), num_heads=2,
                                 left_max=9)
        out.square().sum().backward()
        if device != "cpu":
            assert fa.LAUNCHES["flash_rel_fwd"] == f0 + 1
            assert fa.LAUNCHES["flash_rel_bwd"] == b0 + 1
        grads.append([a.grad.cpu() for a in args])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def test_main_path_shapes_launch_the_mma_kernels(cuda):
    """bf16 at hd 64 (the conformer's heads) goes to the tensor-core
    kernels through the public wrappers, and never to the CUDA-core ones."""
    g = torch.Generator().manual_seed(5)
    q, k, v, dout = (torch.randn(32, 512, 64, generator=g).to(
        cuda, torch.bfloat16) for _ in range(4))
    e = (torch.randn(73, 64, generator=g) * 0.3).to(cuda, torch.bfloat16)
    mask = (torch.arange(512)[None, :] < torch.tensor([[512], [300]])).to(cuda)
    before = dict(fa.LAUNCHES)
    args = [x.detach().requires_grad_() for x in (q, k, v, e)]
    out = fa.flash_attention(*args, mask, num_heads=16, left_max=64)
    out.backward(dout)
    torch.cuda.synchronize()
    grown = {name: n - before.get(name, 0) for name, n in fa.LAUNCHES.items()
             if n != before.get(name, 0)}
    assert grown == {"flash_rel_fwd_wgmma": 1, "flash_rel_bwd_wgmma": 1}



# ---- LayerNorm (ops/layer_norm.py, csrc/layer_norm.cu) ---------------------

BF16, F32 = torch.bfloat16, torch.float32
# (input, output) dtypes: the encoders, the feature norm, the heads
LN_DTYPES = [(BF16, BF16), (F32, BF16), (F32, F32), (BF16, F32)]
LN_DTYPE_IDS = ["bf16", "fp32_in_bf16_out", "fp32", "bf16_in_fp32_out"]


def _ln_inputs(cuda, shape, x_dtype, frozen, seed, transposed=False):
    """x (requires grad), γ, β: fp32 with grad, or bf16 frozen as
    ``create_train_state`` keeps them; the transposed x is the depthwise
    norm's view of the conv's [B, H, T] output."""
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    if transposed:
        b, t, h = shape
        x = (torch.randn(b, h, t, generator=g) * 3 + 1).to(cuda, x_dtype)
        x = x.transpose(1, 2)
    else:
        x = (torch.randn(*shape, generator=g) * 3 + 1).to(cuda, x_dtype)
    w = (1 + 0.1 * torch.randn(n, generator=g)).to(cuda)
    b_ = (0.1 * torch.randn(n, generator=g)).to(cuda)
    if frozen:
        w, b_ = w.to(BF16), b_.to(BF16)
    return (x.requires_grad_(), w.requires_grad_(not frozen),
            b_.requires_grad_(not frozen))


def _ln_close(got, want, what):
    """Within one rounding of the output dtype (bf16: 2⁻⁷ of the value, or
    fp32 sums in another order), on a floor of 1e-5 of the largest."""
    rtol = 2 ** -7 if got.dtype == BF16 else 1e-5
    atol = 1e-5 * want.float().abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=what)


def _ln_check(cuda, shape, x_dtype, dtype, frozen, seed, transposed=False):
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    x, w, b = _ln_inputs(cuda, shape, x_dtype, frozen, seed, transposed)
    dy = torch.randn(*shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(cuda, dtype)
    before = dict(ln.LAUNCHES)
    y = ln.layer_norm(x, w, b, 1e-5, dtype)
    y.backward(dy)
    grads = [x.grad] + ([] if frozen else [w.grad, b.grad])
    grown = {k: v - before.get(k, 0) for k, v in ln.LAUNCHES.items()
             if v != before.get(k, 0)}
    want_launches = {"layer_norm_fwd": 1, "layer_norm_bwd_dx": 1}
    if not frozen:
        want_launches["layer_norm_bwd_dgamma"] = 1
    assert grown == want_launches
    refs = [t.detach().clone().requires_grad_(t.requires_grad)
            for t in (x, w, b)]
    want = ln.layer_norm_reference(*refs, 1e-5, dtype)
    want.backward(dy)
    torch.cuda.synchronize()
    _ln_close(y, want, "y")
    for name, got, ref in zip(("dx", "dgamma", "dbeta"), grads,
                              [r.grad for r in refs]):
        assert torch.isfinite(got).all(), name
        if name == "dx":
            _ln_close(got, ref, name)
        else:       # sums over every row: within 1e-4 of the largest
            assert got.dtype == ref.dtype == F32, name
            scale = ref.abs().max().clamp_min(1e-30)
            assert ((got - ref).abs().max() / scale).item() <= 1e-4, name


@pytest.mark.parametrize("rows", [1, 97, 4099], ids=lambda r: f"rows{r}")
@pytest.mark.parametrize("frozen", [False, True],
                         ids=["fp32_affine", "frozen_bf16_affine"])
@pytest.mark.parametrize("x_dtype,dtype", LN_DTYPES, ids=LN_DTYPE_IDS)
@pytest.mark.parametrize("width", [160, 768, 1024])
def test_layer_norm_kernels_match_plain(cuda, width, x_dtype, dtype, frozen,
                                        rows):
    """Forward and backward through ``layer_norm`` against autograd of the
    plain chain, and one launch of each kernel that the call needs."""
    _ln_check(cuda, (rows, width), x_dtype, dtype, frozen, width + rows)


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["fp32_affine", "frozen_bf16_affine"])
@pytest.mark.parametrize("t", [128, 256, 499, 512, 768])
def test_layer_norm_kernels_at_the_cells_shapes(cuda, t, frozen):
    """The conformer's [64, T, 1024] bf16 activations of the cells."""
    _ln_check(cuda, (64, t, 1024), BF16, BF16, frozen, t)


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["fp32_affine", "frozen_bf16_affine"])
def test_layer_norm_kernels_on_the_depthwise_transposed_input(cuda, frozen):
    _ln_check(cuda, (8, 499, 1024), BF16, BF16, frozen, 11, transposed=True)


def test_layer_norm_backward_is_deterministic(cuda):
    """dx, dγ and dβ (persistent partials summed in a fixed order, no
    atomics) give the same bits launch after launch, and match the plain
    versions of the statistics and of the backward formula."""
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    x, w, b = _ln_inputs(cuda, (64, 499, 1024), BF16, False, 12)
    y, xc, mean, rstd = ln._fwd(x.detach(), w.detach(), b.detach(), 1e-5,
                                BF16)
    dy = torch.randn(64, 499, 1024, generator=torch.Generator().manual_seed(
        13)).to(cuda, BF16)
    first = ln._bwd(dy, xc, w.detach(), mean, rstd, True, True)
    second = ln._bwd(dy, xc, w.detach(), mean, rstd, True, True)
    again = ln._fwd(x.detach(), w.detach(), b.detach(), 1e-5, BF16)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dx", "dgamma", "dbeta"), first, second):
        assert torch.equal(a, b_), name
    assert torch.equal(y, again[0]) and torch.equal(rstd, again[3])
    # and the plain versions of the statistics and of the backward formula
    want_mean, want_rstd = ln.layer_norm_stats_reference(xc, 1e-5)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=1e-5)
    want = ln.layer_norm_bwd_reference(dy, xc, w.detach(), mean, rstd)
    _ln_close(first[0], want[0], "dx")
    for name, got, ref in zip(("dgamma", "dbeta"), first[1:], want[1:]):
        scale = ref.abs().max()
        assert ((got - ref).abs().max() / scale).item() <= 1e-4, name


def test_layer_norm_weight_grad_without_input_grad(cuda):
    """The feature norm: the input needs no gradient, γ and β do: one
    forward, the backward's partials and their sum, no dx."""
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    x, w, b = _ln_inputs(cuda, (4, 300, 160), F32, False, 14)
    x.requires_grad_(False)
    dy = torch.randn(4, 300, 160, generator=torch.Generator().manual_seed(
        15)).to(cuda, BF16)
    before = dict(ln.LAUNCHES)
    ln.layer_norm(x, w, b, 1e-5, BF16).backward(dy)
    refs = [t.detach().clone().requires_grad_() for t in (w, b)]
    ln.layer_norm_reference(x, *refs, 1e-5, BF16).backward(dy)
    torch.cuda.synchronize()
    assert {k: v - before.get(k, 0) for k, v in ln.LAUNCHES.items()} == {
        "layer_norm_fwd": 1, "layer_norm_bwd_dx": 1,
        "layer_norm_bwd_dgamma": 1}
    for got, ref in ((w.grad, refs[0].grad), (b.grad, refs[1].grad)):
        scale = ref.abs().max()
        assert ((got - ref).abs().max() / scale).item() <= 1e-4


@pytest.mark.parametrize("width", [12, 4104])
def test_layer_norm_kernel_refuses_unsupported_widths(cuda, width):
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    x = torch.zeros(3, width, device=cuda, dtype=BF16)
    w, b = torch.ones(width, device=cuda), torch.zeros(width, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln.layer_norm(x, w, b, 1e-5, BF16)


def test_layer_norm_launches_count_every_plain_layer_norm(cuda):
    """A small bf16 model's train forward and backward on the card: one
    forward launch for each plain LayerNorm call, one backward for each
    call whose output took a gradient, none of ATen's LayerNorm."""
    from speech_transcript_embeddings_torch.config import tiny_model_config
    from speech_transcript_embeddings_torch.models import layers
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        DualEncoderModel, init_model,
    )
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    import dataclasses
    mc = tiny_model_config()
    mc = dataclasses.replace(mc, dtype="bfloat16", audio=dataclasses.replace(
        mc.audio, use_flash_attention=False))
    model = init_model(mc, torch.Generator(cuda).manual_seed(0), cuda,
                       train=True)
    assert isinstance(model, DualEncoderModel)
    calls = []
    for mod in model.modules():
        if type(mod) is layers.LayerNorm:
            mod.register_forward_hook(
                lambda m, i, o: calls.append(o.requires_grad))
    g = torch.Generator().manual_seed(1)
    b, t, n = 2, 40, 12
    feats = torch.randn(b, t, mc.audio.feature_dim, generator=g).to(cuda)
    mask = torch.ones(b, t, dtype=torch.int32, device=cuda)
    ids = torch.randint(4, mc.text.vocab_size, (b, n), generator=g).to(cuda)
    tmask = torch.ones(b, n, dtype=torch.int32, device=cuda)
    ln.LAUNCHES.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        audio = model.encode_audio(feats, mask)[0]
        text = model.encode_text(ids, tmask)[0]
        (audio.float().sum() + text.float().sum()).backward()
        torch.cuda.synchronize()
    assert calls and ln.LAUNCHES["layer_norm_fwd"] == len(calls)
    assert ln.LAUNCHES["layer_norm_bwd_dx"] == sum(calls)
    names = [e.name for e in prof.events()]
    assert not [n_ for n_ in names if "vectorized_layer_norm" in n_
                or "GammaBeta" in n_ or "layer_norm_grad" in n_]


# ---- depthwise GLU (ops/depthwise_glu.py, csrc/depthwise_glu.cu) -----------

# (B, T, C): the b64 train cell's and the embed cell's 5 s bucket at full
# width, a rank's half width under tensor parallel, C off the 32-channel
# slice with T off every strip, and T under K
DW_SHAPES = {"b64_t499_c1024": (64, 499, 1024),
             "b64_t256_c1024": (64, 256, 1024),
             "tp_b64_t499_c512": (64, 499, 512), "b3_t37_c48": (3, 37, 48),
             "b2_t7_c64": (2, 7, 64)}


def _dw_inputs(cuda, shape, k, dtype, train, seed):
    """x [B, T, 2C] (requires grad), the weight [C, 1, K]: fp32 with its
    gradient, or bf16 frozen as ``create_train_state`` keeps it; dy."""
    b, t, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, 2 * c, generator=g).to(cuda, dtype)
    w = (0.2 * torch.randn(c, 1, k, generator=g)).to(cuda)
    if not train:
        w = w.to(BF16)
    dy = torch.randn(b, t, c, generator=g).to(cuda, dtype)
    return x.requires_grad_(), w.requires_grad_(train), dy


def _dw_close(got, want, what):
    """Within one rounding of the dtype (bf16: 2⁻⁷ of the value; fp32: sums
    in another order), on a floor of 1e-5 of the largest."""
    rtol = 2 ** -7 if got.dtype == BF16 else 1e-5
    atol = 1e-5 * want.float().abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=what)


def _dw_grad_close(got, want):
    """The weight gradient, a sum over every batch row and time: within
    1e-4 of its largest (in bf16 for a bf16 weight: one rounding more)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2 ** -7 if got.dtype == BF16 else 1e-4
    scale = want.float().abs().max()
    assert ((got.float() - want.float()).abs().max() / scale).item() <= tol


@pytest.mark.parametrize("k", [31, 5])
@pytest.mark.parametrize("train", [True, False],
                         ids=["fp32_weight", "frozen_bf16_weight"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(DW_SHAPES))
def test_depthwise_glu_kernels_match_plain(cuda, case, dtype, train, k):
    """Forward and backward through ``depthwise_glu`` against the plain
    versions of the kernels' arithmetic, and one launch of each kernel the
    call needs."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    x, w, dy = _dw_inputs(cuda, DW_SHAPES[case], k, dtype, train, k)
    before = dict(dg.LAUNCHES)
    y = dg.depthwise_glu(x, w)
    y.backward(dy)
    grown = {n: v - before.get(n, 0) for n, v in dg.LAUNCHES.items()
             if v != before.get(n, 0)}
    want_launches = {"depthwise_glu_fwd": 1, "depthwise_glu_bwd_dx": 1}
    if train:
        want_launches["depthwise_glu_bwd_dw"] = 1
    assert grown == want_launches
    want = dg.depthwise_glu_reference(x.detach(), w.detach())
    want_dx, want_dw = dg.depthwise_glu_bwd_reference(dy, x.detach(),
                                                      w.detach())
    torch.cuda.synchronize()
    assert y.is_contiguous() and y.data_ptr() % 16 == 0
    _dw_close(y, want, "y")
    _dw_close(x.grad, want_dx, "dx")
    if train:
        _dw_grad_close(w.grad, want_dw)
    else:
        assert w.grad is None


def test_depthwise_glu_backward_is_deterministic(cuda):
    """dx and dw (persistent partials summed in a fixed order, no atomics)
    give the same bits launch after launch; so does the forward."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    x, w, dy = _dw_inputs(cuda, (64, 499, 1024), 31, BF16, True, 16)
    x, w = x.detach(), w.detach()
    y, xc = dg._fwd(x, w)
    first = dg._bwd(dy, xc, w, True, True)
    second = dg._bwd(dy, xc, w, True, True)
    again = dg._fwd(x, w)[0]
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])
    assert torch.equal(y, again)


def test_depthwise_glu_weight_grad_without_input_grad(cuda):
    """A weight that trains over an input that needs no gradient: the
    backward kernel writes dw's partials and no dx, and their sum."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    x, w, dy = _dw_inputs(cuda, (4, 300, 256), 31, BF16, True, 17)
    x.requires_grad_(False)
    before = dict(dg.LAUNCHES)
    dg.depthwise_glu(x, w).backward(dy)
    torch.cuda.synchronize()
    assert {n: v - before.get(n, 0) for n, v in dg.LAUNCHES.items()} == {
        "depthwise_glu_fwd": 1, "depthwise_glu_bwd_dx": 1,
        "depthwise_glu_bwd_dw": 1}
    _dw_grad_close(w.grad,
                   dg.depthwise_glu_bwd_reference(dy, x, w.detach())[1])


GUARD = 4096


def _guarded(shape, dtype, device):
    """A view of ``shape`` inside a buffer of a sentinel pattern, GUARD
    bytes of it on each side: → (view, check), check() failing on a
    changed guard byte."""
    n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
    pattern = ((torch.arange(2 * GUARD + n, device=device) * 151 + 89)
               % 256).to(torch.uint8)
    raw = pattern.clone()

    def check(name):
        bad = raw != pattern
        bad[GUARD:GUARD + n] = False
        assert not bad.any(), f"{name}: {int(bad.sum())} guard bytes changed"
    return raw[GUARD:GUARD + n].view(dtype).view(shape), check


@pytest.mark.parametrize("case", ["b64_t499_c1024", "b3_t37_c48"])
def test_depthwise_glu_kernels_write_only_their_outputs(cuda, case):
    """The raw entry points with y, dx, the partials and dw each a view
    inside guard bands: every output byte written, no guard byte, no input
    changed."""
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    b, t, c = DW_SHAPES[case]
    x, w, dy = _dw_inputs(cuda, (b, t, c), 31, BF16, True, 18)
    x, w = x.detach(), w.detach()
    inputs = [(v, v.clone()) for v in (x, w, dy)]
    lib, (device, stream) = _build.library(), _build.launch_args(x)
    y, y_ok = _guarded((b, t, c), BF16, cuda)
    fwd_blocks, blocks = dg._blocks(b, t, c, device)
    dx, dx_ok = _guarded((b, t, 2 * c), BF16, cuda)
    part, part_ok = _guarded((blocks, dg.MAX_TAPS, c), F32, cuda)
    dw, dw_ok = _guarded((c, 1, 31), F32, cuda)
    _build.check(lib.ste_depthwise_glu_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c, 31, fwd_blocks, 1,
        0, device, stream), "fwd")
    _build.check(lib.ste_depthwise_glu_bwd(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dw.data_ptr(), b, t, c, 31, blocks, 1, 0, device,
        stream), "bwd")
    torch.cuda.synchronize()
    for check, name in ((y_ok, "y"), (dx_ok, "dx"), (part_ok, "part"),
                        (dw_ok, "dw")):
        check(name)
    for v, before in inputs:
        assert torch.equal(v, before)
    want_dx, want_dw = dg.depthwise_glu_bwd_reference(dy, x, w)
    _dw_close(y, dg.depthwise_glu_reference(x, w), "y")
    _dw_close(dx, want_dx, "dx")
    _dw_grad_close(dw, want_dw)


@pytest.mark.parametrize("what", ["fp16", "c12", "k32", "weight_on_cpu"])
def test_depthwise_glu_kernel_refuses_what_it_does_not_take(cuda, what):
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    c, k, dtype = (12 if what == "c12" else 16), (32 if what == "k32" else
                                                  31), F32
    if what == "fp16":
        dtype = torch.float16
    x = torch.zeros(2, 9, 2 * c, device=cuda, dtype=dtype)
    w = torch.zeros(c, 1, k, device="cpu" if what == "weight_on_cpu"
                    else cuda)
    with pytest.raises(ValueError, match="depthwise_glu kernel"):
        dg.depthwise_glu(x, w)


def test_depthwise_glu_launches_count_every_conv_module(cuda):
    """A small bf16 model's train forward and backward on the card: one
    forward launch for each conv module, one backward for each conv
    module whose output took a gradient, none of ATen's depthwise
    convolution."""
    from speech_transcript_embeddings_torch.config import tiny_model_config
    from speech_transcript_embeddings_torch.models import audio_encoder as ae
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    import dataclasses
    mc = tiny_model_config()
    mc = dataclasses.replace(mc, dtype="bfloat16", audio=dataclasses.replace(
        mc.audio, use_flash_attention=False))
    model = init_model(mc, torch.Generator(cuda).manual_seed(0), cuda,
                       train=True)
    calls = []
    for mod in model.modules():
        if type(mod) is ae.ConvModule:
            mod.register_forward_hook(
                lambda m, i, o: calls.append(o.requires_grad))
    g = torch.Generator().manual_seed(1)
    b, t = 2, 40
    feats = torch.randn(b, t, mc.audio.feature_dim, generator=g).to(cuda)
    mask = torch.ones(b, t, dtype=torch.int32, device=cuda)
    dg.LAUNCHES.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        model.encode_audio(feats, mask)[0].float().sum().backward()
        torch.cuda.synchronize()
    assert calls and dg.LAUNCHES["depthwise_glu_fwd"] == len(calls)
    assert dg.LAUNCHES["depthwise_glu_bwd_dx"] == sum(calls)
    trains = sum(m.depthwise_kernel.requires_grad for m in model.modules()
                 if type(m) is ae.ConvModule)
    assert dg.LAUNCHES["depthwise_glu_bwd_dw"] == trains
    names = [e.name for e in prof.events()]
    assert not [n_ for n_ in names if "conv_depthwise2d" in n_]
    assert any("depthwise_glu_fwd_kernel" in n_ for n_ in names)
