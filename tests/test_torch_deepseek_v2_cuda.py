"""The DeepSeek-V2 tower on the card: its grouped expert products against a
loop over the experts, forward and backward, and the bf16 serving tower
at a mid size against the fp32 plain reference.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips when there is no card. Run on a GPU machine (no jax needed there,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deepseek_v2_cuda.py

Tolerances: bf16 operands (8 significant bits, a relative rounding of
2^-9) with fp32 accumulation. One product's outputs are within a few
roundings of its fp32 value: 2e-2 of the largest output. Through the mid
tower (4 layers, each adding to a residual stream rounded to bf16, and
routing flips where a token's 6th and 7th scores lie within a rounding)
the unit embeddings stay within 0.05 of the fp32 reference's in L2: the
card read 0.026 here, and at the full depth the benchmark's cell reads
0.022-0.031 against the float8 reference's 0.25."""

import dataclasses

import pytest
import torch

from speech_transcript_embeddings_torch import config as C
from speech_transcript_embeddings_torch.models import deepseek_v2 as ds
from speech_transcript_embeddings_torch.models.dual_encoder import (
    init_model, l2_normalize,
)
from speech_transcript_embeddings_torch.reference import deepseek_v2 as ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, rtol):
    a, b = a.detach().float(), b.detach().float()
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rtol * scale, (
        float((a - b).abs().max()), scale)


def _loop(rows, counts, gate_up, down):
    """Each expert's SwiGLU over its rows in fp32, one expert at a time."""
    width, out, start = down.shape[-1], [], 0
    for e, n in enumerate(counts.tolist()):
        r = rows[start:start + n].float()
        gu = r @ gate_up[e].float().t()
        out.append((torch.nn.functional.silu(gu[:, :width]) * gu[:, width:])
                   @ down[e].float().t())
        start += n
    return torch.cat(out)


def test_grouped_products_against_the_loop(cuda):
    """2,048 rows over 16 experts of width 1,408 at hidden 2,048, expert 3
    given none, forward and backward."""
    g = torch.Generator(cuda).manual_seed(0)
    counts = torch.randint(64, 192, (16,), generator=g, device=cuda)
    counts[3] = 0
    rows = torch.randn(int(counts.sum()), 2048, device=cuda, generator=g,
                       dtype=torch.bfloat16).requires_grad_(True)
    gate_up = (torch.randn(16, 2816, 2048, device=cuda, generator=g,
                           dtype=torch.bfloat16) * 2048 ** -0.5
               ).requires_grad_(True)
    down = (torch.randn(16, 2048, 1408, device=cuda, generator=g,
                        dtype=torch.bfloat16) * 1408 ** -0.5
            ).requires_grad_(True)
    assert hasattr(torch, "_grouped_mm")
    got = ds.grouped_products(rows, counts, gate_up, down)
    want = _loop(rows, counts, gate_up, down)
    _close(got, want, 2e-2)
    upstream = torch.randn_like(got)
    grads = torch.autograd.grad(got, (rows, gate_up, down), upstream)
    want_grads = torch.autograd.grad(want, (rows, gate_up, down),
                                     upstream.float())
    for a, b in zip(grads, want_grads):
        _close(a, b, 2e-2)
    assert float(grads[1][3].abs().max()) == 0.0


def mid_text() -> C.DeepseekV2TextConfig:
    """The published widths of a layer but fewer layers, experts and
    vocabulary: 1 dense + 3 MoE layers of 16 experts, top-6."""
    return C.DeepseekV2TextConfig(num_hidden_layers=4, n_routed_experts=16,
                                  vocab_size=4096)


def test_bf16_tower_against_the_fp32_reference(cuda):
    mc = dataclasses.replace(C.deepseek_v2_lite_model_config(),
                             text=mid_text())
    model = init_model(mc, torch.Generator(cuda).manual_seed(1), cuda)
    g = torch.Generator(cuda).manual_seed(2)
    ids = torch.randint(4, 4096, (32, 64), generator=g, device=cuda)
    lens = torch.randint(4, 65, (32,), generator=g, device=cuda)
    mask = (torch.arange(64, device=cuda)[None] < lens[:, None]).long()
    with torch.no_grad():
        emb = l2_normalize(model.encode_text(ids, mask)[0])
        sd = model.state_dict()
        tower = ref.Tower(dataclasses.asdict(mc), lambda n: sd[n].float())
        want = tower.embed(ids, mask)
    gap = float((emb - want).norm(dim=-1).max())
    print(f"bf16 tower against fp32 reference: widest L2 gap {gap:.5f}")
    assert gap < 0.05
