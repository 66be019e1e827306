"""The port's training building blocks against the JAX package: the seeded
init's distributions, the Dense/Embed storage split, dropout, SpecAugment,
per-block remat, the losses, and the freeze labels at full width.

Tolerances are stated at each test."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from speech_transcript_embeddings_tpu.config import (
    AudioEncoderConfig, FreezeConfig, LossConfig, retrieval_model_config,
    tiny_model_config,
)
from speech_transcript_embeddings_tpu.models import audio_encoder as jae
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, abstract_params, init_params,
)
from speech_transcript_embeddings_tpu.training import losses as jlosses
from speech_transcript_embeddings_tpu.training import optimizer as jopt
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models import audio_encoder as tae
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model,
)
from speech_transcript_embeddings_torch.models.layers import (
    Dense, dropout, dropout_keep,
)
from speech_transcript_embeddings_torch.ops import flash_attention as fa
from speech_transcript_embeddings_torch.training import losses
from speech_transcript_embeddings_torch.training import optimizer as topt
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401


def _heads_off(mc):
    return dataclasses.replace(mc, heads=dataclasses.replace(
        mc.heads, use_cross_modal=False, use_word_alignment=False))


# ---- init ------------------------------------------------------------------

def test_init_matches_flax_distributions():
    """Per tensor, the std of the port's seeded init against JAX's
    ``init_params`` on the same geometry (tiny widths ×2, SpecAugment on):
    within 10% for tensors of ≥ 1000 elements, and within four standard
    errors of a std estimate (4/√(2n)) for the smaller ones; constants
    (biases, LayerNorm) equal; every truncated-normal Dense and depthwise
    weight inside ±2σ·1.0001 of the untruncated σ; the SpecAugment vector
    in [0, 1)."""
    mc = _heads_off(tiny_model_config(text_hidden=64, audio_hidden=96,
                                      projection_dim=48))
    mc = dataclasses.replace(mc, audio=dataclasses.replace(
        mc.audio, apply_spec_augment=True))
    ref = bridge.flax_to_state_dict(jax.tree.map(
        np.asarray, init_params(JaxModel(mc), jax.random.PRNGKey(0))))
    model = init_model(port_cfg(mc), torch.Generator().manual_seed(0),
                       train=True)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(got) == set(ref)
    for name, w in got.items():
        assert w.dtype == torch.float32, name
        a, b = w.double().numpy(), ref[name].double().numpy()
        if b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        tol = 0.1 if a.size >= 1000 else 4 / np.sqrt(2 * a.size)
        assert abs(a.std() / b.std() - 1) <= tol, (name, a.std(), b.std())
    truncated = [m.weight for m in model.modules() if isinstance(m, Dense)]
    truncated += [m.conv.depthwise_kernel for m in
                  model.audio_encoder.modules()
                  if isinstance(m, tae.ConformerBlock)]
    for w in truncated:
        sigma = w.shape[1 if w.ndim == 2 else -1] ** -0.5 / 0.87962566103423978
        assert w.abs().max() <= 2 * sigma * 1.0001
    spec = got["audio_encoder.masked_spec_embed"]
    assert spec.min() >= 0 and spec.max() < 1


# ---- Dense storage split ---------------------------------------------------

def test_bf16_dense_with_fp32_weight_matches_flax():
    """A bf16-compute Dense storing its weight in fp32 rounds weight, bias
    and input to bf16 at the call, as Flax ``nn.Dense(dtype=bf16)`` does
    with fp32 params: equal to bf16 resolution (one ulp of the output,
    2⁻⁷ relative: the two sum the products in another order); the
    gradient reaches the fp32 weight in fp32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    kernel = (rng.normal(size=(24, 16)) / 5).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    ref = np.asarray(fnn.Dense(16, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
        .astype(jnp.float32))
    dense = Dense(24, 16, dtype=torch.bfloat16, param_dtype=torch.float32)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(kernel.T))
        dense.bias.copy_(torch.from_numpy(bias))
    out = dense(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and dense.weight.dtype == torch.float32
    np.testing.assert_allclose(out.float().detach().numpy(), ref,
                               rtol=2 ** -7, atol=2 ** -7)
    out.float().sum().backward()
    assert dense.weight.grad.dtype == torch.float32
    assert dense.bias.grad.dtype == torch.float32
    assert dense.weight.grad.abs().max() > 0
    # serving storage: the weight already in bf16, the cast is a no-op
    serve = Dense(24, 16, dtype=torch.bfloat16)
    serve.load_state_dict({k: v.to(torch.bfloat16)
                           for k, v in dense.state_dict().items()})
    assert serve.weight.dtype == torch.bfloat16
    assert torch.equal(serve(torch.from_numpy(x)), out.detach())


# ---- dropout and SpecAugment -----------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_rate(rate):
    """Over 1e5 draws the kept share is within 3σ of 1 − rate; kept
    elements are scaled by 1/(1 − rate); no generator means identity."""
    n = 100_000
    g = torch.Generator().manual_seed(1)
    x = torch.ones(n)
    y = dropout(x, rate, g)
    kept = (y != 0).float().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept - (1 - rate)) <= 3 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - rate)))
    assert dropout(x, rate, None) is x and dropout_keep((3,), 0.0, g) is None


def test_spec_augment_apply_with_jax_draws_matches_jax():
    """The port's SpecAugment apply fed JAX's own uniform draws ``u`` equals
    ``_spec_augment_time`` exactly (ragged lengths, one clip shorter than
    a span)."""
    cfg = AudioEncoderConfig(hidden_size=8, mask_time_prob=0.3,
                             mask_time_length=4, mask_time_min_masks=2)
    b, t = 3, 40
    x = np.random.default_rng(2).normal(size=(b, t, 8)).astype(np.float32)
    embed = np.linspace(-1, 1, 8).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[40], [23], [3]])).astype(
        np.int32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jae._spec_augment_time(jnp.asarray(x), jnp.asarray(embed),
                                            jnp.asarray(mask), cfg, key))
    s_max = max(int(round(cfg.mask_time_prob * t / cfg.mask_time_length)),
                cfg.mask_time_min_masks)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b, s_max))))
    draw = tae.spec_augment_draw(b, t, port_cfg(cfg),
                                 torch.Generator().manual_seed(0))
    assert draw.shape == u.shape
    got = tae.spec_augment_apply(torch.from_numpy(x), torch.from_numpy(embed),
                                 torch.from_numpy(mask), port_cfg(cfg),
                                 u).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != x).any()


# ---- remat -----------------------------------------------------------------

def _encoder(policy, remat, conv_dropout=0.0):
    cfg = AudioEncoderConfig(
        feature_dim=8, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, conv_kernel_size=7, left_max_rel_pos=9,
        right_max_rel_pos=3, apply_spec_augment=False,
        use_flash_attention=True, remat_policy=policy,
        conv_dropout=conv_dropout)
    enc = tae.AudioEncoder(port_cfg(cfg), torch.float32, remat=remat)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return enc


@pytest.mark.parametrize("policy", ["full", "save_flash", "save_hot",
                                    "save_hot2", "save_hot3"])
def test_remat_matches_no_remat_and_saves_the_flash_forward(policy,
                                                            monkeypatch):
    """Per-block remat gives the loss and gradients of the unrematerialised
    encoder (1e-6), with conv dropout on: the replay draws the same masks.
    'full' runs the flash forward again in the backward (4 calls for 2
    blocks); every ``save_*`` policy keeps its (out, lse) and runs it twice."""
    calls = []
    fwd = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.normal(size=(2, 60, 8)).astype(np.float32))
    mask = torch.from_numpy((np.arange(60)[None, :] < np.array([[60], [41]]))
                            .astype(np.int32))
    results = []
    for remat in (False, True):
        enc = _encoder(policy, remat, conv_dropout=0.2)
        calls.clear()
        out = enc(feats, mask, torch.Generator().manual_seed(9))
        loss = out.square().sum()
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in enc.named_parameters()},
                        len(calls)))
    (l0, g0, n0), (l1, g1, n1) = results
    assert n0 == 2 and n1 == (4 if policy == "full" else 2)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, rtol=1e-6, atol=1e-6,
                                   msg=name)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="Unknown remat_policy"):
        _encoder("save_everything", True)


# ---- losses ------------------------------------------------------------------

def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_pairwise_loss_golden():
    """The hand-computed values of tests/test_model_and_loss.py, on the port
    (no alignment scores: word alignment is not ported)."""
    cfg = LossConfig(temperature=0.1, corrupt_gamma=0.35)
    s_pos = np.array([0.8, 0.2], np.float32)
    s_neg = np.array([0.1, -0.3], np.float32)
    audio = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    tp = np.array([[0.8, np.sqrt(1 - 0.64)], [0.2, np.sqrt(1 - 0.04)]],
                  np.float32)
    tn = np.array([[0.1, np.sqrt(1 - 0.01)], [-0.3, np.sqrt(1 - 0.09)]],
                  np.float32)
    logits = np.stack([s_pos, s_neg], 1) / 0.1
    ce = -np.log(np.exp(logits[:, 0]) / np.exp(logits).sum(1))
    expected = ce.mean() + 0.35 * np.maximum(s_neg, 0).mean()
    loss, aux = losses.pairwise_info_nce(port_cfg(cfg), *(torch.from_numpy(a)
                                                for a in (tp, tn, audio)))
    np.testing.assert_allclose(float(loss), expected, rtol=1e-5)
    np.testing.assert_allclose(aux.s_pos.numpy(), s_pos, rtol=1e-5)
    np.testing.assert_allclose(aux.s_neg.numpy(), s_neg, rtol=1e-5)


def test_global_loss_is_the_full_matrix_softmax_ce():
    cfg = LossConfig(temperature=0.1, corrupt_gamma=0.0)
    rng = np.random.default_rng(3)
    tp, tn, au = (_unit(rng.normal(size=(5, 8))).astype(np.float32)
                  for _ in range(3))
    logits = au @ np.concatenate([tp, tn], 0).T / 0.1
    expected = -np.mean(logits[np.arange(5), np.arange(5)]
                        - np.log(np.exp(logits).sum(axis=1)))
    loss, _ = losses.global_info_nce(port_cfg(cfg), *(torch.from_numpy(a)
                                            for a in (tp, tn, au)))
    np.testing.assert_allclose(float(loss), expected, rtol=1e-5)
    # the data axis needs a process group (tests/test_torch_parallel.py)
    with pytest.raises(RuntimeError,
                       match="no torch.distributed process group"):
        losses.global_info_nce(port_cfg(cfg), *(torch.from_numpy(a)
                                      for a in (tp, tn, au)), axis_name="data")


@pytest.mark.parametrize("kind,gamma", [("pairwise", 0.0), ("pairwise", 0.35),
                                        ("global", 0.0), ("global", 0.35)])
def test_losses_match_jax(kind, gamma):
    """compute_loss, global_per_sample_masked (a duplicated, masked tail
    row) and to_human_readable against the JAX functions: rtol 1e-5."""
    cfg = LossConfig(kind=kind, temperature=0.1, corrupt_gamma=gamma)
    rng = np.random.default_rng(4)
    tp, tn, au = (_unit(rng.normal(size=(6, 8))).astype(np.float32)
                  for _ in range(3))
    out = type("Out", (), {})()
    jout = type("Out", (), {})()
    for o, conv in ((out, torch.from_numpy), (jout, jnp.asarray)):
        o.text_pos, o.text_neg, o.audio = conv(tp), conv(tn), conv(au)
        o.alignment_scores = None
    loss, aux = losses.compute_loss(port_cfg(cfg), out)
    jloss, jaux = jlosses.compute_loss(cfg, jout)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux.s_pos.numpy(), np.asarray(jaux.s_pos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.s_neg.numpy(), np.asarray(jaux.s_neg),
                               rtol=1e-5, atol=1e-6)
    m = np.array([1, 1, 1, 1, 1, 0], np.float32)
    per = losses.global_per_sample_masked(port_cfg(cfg), *(torch.from_numpy(a) for a in (
        tp, tn, au, m)))
    jper = jlosses.global_per_sample_masked(cfg, *(jnp.asarray(a) for a in (
        tp, tn, au, m)))
    np.testing.assert_allclose(per.numpy()[:5], np.asarray(jper)[:5],
                               rtol=1e-5)
    for scale in ("prob", "0to1"):
        np.testing.assert_allclose(
            losses.to_human_readable(aux.s_pos, 0.1, scale).numpy(),
            np.asarray(jlosses.to_human_readable(jaux.s_pos, 0.1, scale)),
            rtol=1e-5)


# ---- labels ------------------------------------------------------------------

def test_labels_at_full_width_match_jax_without_allocating():
    """The port's freeze labels on the full ``retrieval_model_config()``
    model built on the meta device (no storage) give JAX's trainable and
    frozen counts from ``param_labels`` on ``abstract_params``:
    354,846,082 trainable of 863,886,658."""
    mc = retrieval_model_config()
    freeze = FreezeConfig(mode="partial", text_layers_to_unfreeze=5,
                          audio_layers_to_unfreeze=5)
    shapes = abstract_params(JaxModel(mc))
    jl = jopt.param_labels(shapes, freeze, mc)
    want = {"frozen": 0, "encoder": 0, "head": 0}
    for leaf, label in zip(jax.tree.leaves(shapes), jax.tree.leaves(jl)):
        want[label] += int(np.prod(leaf.shape))
    with torch.device("meta"):
        model = DualEncoderModel(port_cfg(mc), param_dtype=torch.float32)
    labels = topt.param_labels(model, port_cfg(freeze), port_cfg(mc))
    got = {"frozen": 0, "encoder": 0, "head": 0}
    for name, p in model.named_parameters():
        assert p.is_meta
        got[labels[name]] += p.numel()
    assert got == want
    assert got["encoder"] + got["head"] == 354_846_082
    assert got["frozen"] == 509_040_576
