"""CUDA kernels of the torch port against their plain twins, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips when there is no card or no ``nvcc``. Run them on a GPU machine (no
jax needed there, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from speech_transcript_embeddings_tpu.config import FrontendConfig
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


@pytest.mark.parametrize("bucket", [16000, 41200, 491760])
@pytest.mark.parametrize("mels", [80, 8])
def test_log_mel_kernel_matches_twin(cuda, bucket, mels):
    cfg = FrontendConfig(num_mel_bins=mels)
    g = torch.Generator().manual_seed(bucket)
    lens = torch.tensor([bucket, 399, bucket // 3], dtype=torch.int32)
    wav = torch.randn(3, bucket, generator=g) * 0.1
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd,nh,left,right", [
    (150, 16, 2, 9, 3), (128, 12, 4, 8, 2), (1536, 64, 16, 64, 8),
    (200, 128, 1, 0, 5)])
def test_flash_kernel_matches_twin(cuda, dtype, tol, t, hd, nh, left, right):
    g = torch.Generator().manual_seed(t + hd)
    b = 2
    q, k, v = (torch.randn(b * nh, t, hd, generator=g).to(cuda, dtype)
               for _ in range(3))
    e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(cuda, dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [t // 3]])).to(cuda)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, e, mask, num_heads=nh,
                                      left_max=left)
    assert fa.flash_attention_fwd.launches == before + 1
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

