"""The reference-parity heads and the fused model against the JAX package:
``CrossModalAttention`` and ``WordLevelAlignment`` on numpy-seeded inputs
with a clip that has no valid frame and partly masked text (forward within
1e-5; gradients of the inputs and of every weight within 1e-4 of each
leaf's largest element; the key biases, whose exact gradient is zero since
a softmax ignores a shift shared by all its inputs, within 1e-4 of the
largest gradient of the head), the fused tiny model's ``forward_pair`` and
``forward_pos_neg`` (1e-5), and the presets with fusion on, each covered by
its JAX abstract tree, which gives ``chip_smoke.py`` its flagship parameter
counts."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from speech_transcript_embeddings_tpu import train as jax_train
from speech_transcript_embeddings_tpu.config import tiny_model_config
from speech_transcript_embeddings_tpu.models import heads as jheads
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, abstract_params, init_params,
)
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models import heads as theads
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.training import optimizer as topt
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
ZERO_GRAD_LEAVES = ("key.bias", "attn_k.bias")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _masks(b, tt, ta):
    """Text: full, three tokens short, one token. Audio: full, 60%, and a
    clip with no valid frame."""
    tmask = np.arange(tt)[None] < np.array([[tt], [tt - 3], [1]])[:b]
    amask = np.arange(ta)[None] < np.array([[ta], [int(ta * 0.6)], [0]])[:b]
    return tmask.astype(np.int32), amask.astype(np.int32)


def _check_grads(jfn, jparams, inputs, port, call, cot):
    """JAX gradients of ⟨fn(params, *inputs), cot⟩ against the port's
    autograd on the same cotangent: every input and every weight, each
    within 1e-4 of its leaf's largest element."""
    jgrads = jax.grad(lambda p, *xs: jnp.sum(jfn(p, *xs) * cot),
                      argnums=tuple(range(1 + len(inputs))))(
        jparams, *map(jnp.asarray, inputs))
    tins = [torch.from_numpy(a).requires_grad_() for a in inputs]
    torch.autograd.backward(call(port, *tins), torch.from_numpy(cot))
    want = bridge.flax_to_state_dict(_np(jgrads[0]))
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(want) == set(got)
    pairs = [(k, got[k].numpy(), want[k].numpy()) for k in want]
    pairs += [(f"input {i}", t.grad.numpy(), np.asarray(g))
              for i, (t, g) in enumerate(zip(tins, jgrads[1:]))]
    top = max(np.abs(w).max() for _, _, w in pairs)
    for name, g, w in pairs:
        zero = name.endswith(ZERO_GRAD_LEAVES)
        tol = 1e-4 * (top if zero else max(np.abs(w).max(), 1e-12))
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


def test_cross_modal_attention_matches_jax():
    rng = np.random.default_rng(0)
    b, tk, d = 3, 11, 24
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    ctx = rng.normal(size=(b, tk, d)).astype(np.float32)
    _, mask = _masks(b, 5, tk)
    head = jheads.CrossModalAttention(num_heads=4, dropout=0.0)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(ctx), jnp.asarray(mask))["params"]
    apply = lambda p, x_, c_: head.apply(  # noqa: E731
        {"params": p}, x_, c_, jnp.asarray(mask))
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    assert np.isfinite(ref).all()         # the clip with no valid frame too
    port = bridge.load_flax_params(theads.CrossModalAttention(d, 4),
                                   _np(params))
    call = lambda m, x_, c_: m(x_, c_, torch.from_numpy(mask))  # noqa: E731
    with torch.no_grad():
        got = call(port, torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), ref, **FWD)
    _check_grads(apply, params, (x, ctx), port, call,
                 rng.normal(size=ref.shape).astype(np.float32))


@pytest.mark.parametrize("text_dim", [24, 32], ids=["raw_residual",
                                                     "projected_residual"])
def test_word_level_alignment_matches_jax(text_dim):
    rng = np.random.default_rng(1)
    b, tt, ta, d, da = 3, 7, 13, 24, 20
    text = rng.normal(size=(b, tt, text_dim)).astype(np.float32)
    audio = rng.normal(size=(b, ta, da)).astype(np.float32)
    tmask, amask = _masks(b, tt, ta)
    head = jheads.WordLevelAlignment(alignment_dim=d, num_heads=2,
                                     dropout=0.0)
    params = head.init(jax.random.PRNGKey(1), jnp.asarray(text),
                       jnp.asarray(audio), jnp.asarray(tmask),
                       jnp.asarray(amask))["params"]
    apply = lambda p, t, a: head.apply(  # noqa: E731
        {"params": p}, t, a, jnp.asarray(tmask), jnp.asarray(amask))
    ref = [np.asarray(r) for r in apply(params, jnp.asarray(text),
                                        jnp.asarray(audio))]
    port = bridge.load_flax_params(
        theads.WordLevelAlignment(text_dim, da, d, num_heads=2), _np(params))
    call = lambda m, t, a: m(t, a, torch.from_numpy(tmask),  # noqa: E731
                             torch.from_numpy(amask))
    with torch.no_grad():
        got = call(port, torch.from_numpy(text), torch.from_numpy(audio))
    for name, g, r in zip(("aligned", "scores", "matrix"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, **FWD, err_msg=name)
    # the clip with no valid frame attends uniformly, not NaN
    np.testing.assert_allclose(got[2][2].numpy(), 1.0 / ta, rtol=1e-6)
    assert (got[1][1, tt - 3:] == 0).all()      # padded tokens score 0
    # gradients through the three outputs at once
    flat = lambda outs: jnp.concatenate(  # noqa: E731
        [o.reshape(b, -1) for o in outs], axis=1)
    cot = rng.normal(size=flat(ref).shape).astype(np.float32)
    _check_grads(lambda p, t, a: flat(apply(p, t, a)), params,
                 (text, audio), port,
                 lambda m, t, a: torch.cat([o.reshape(b, -1)
                                            for o in call(m, t, a)], dim=1),
                 cot)


@pytest.fixture(scope="module")
def fused():
    mc = tiny_model_config()
    params = _np(init_params(JaxModel(mc), jax.random.PRNGKey(0)))
    port = bridge.load_flax_params(DualEncoderModel(port_cfg(mc)), params)
    return mc, params, port.eval().requires_grad_(False)


def _batch(mc, seed):
    rng = np.random.default_rng(seed)
    b, tt, ta = 3, 10, 40
    tmask, amask = _masks(b, tt, ta)
    ids = rng.integers(4, mc.text.vocab_size, size=(2, b, tt)).astype(np.int32)
    neg_mask = np.roll(tmask, 1, axis=0)
    return {"input_ids_pos": ids[0] * tmask, "attention_mask_pos": tmask,
            "input_ids_neg": ids[1] * neg_mask, "attention_mask_neg": neg_mask,
            "input_features": rng.normal(
                size=(b, ta, mc.audio.feature_dim)).astype(np.float32),
            "attention_mask_audio": amask}


def test_fused_forward_pos_neg_matches_jax(fused):
    mc, params, port = fused
    batch = _batch(mc, 2)
    ref = JaxModel(mc).apply({"params": params},
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = port.forward_pos_neg({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **FWD,
                                   err_msg=name)


def test_fused_forward_pair_matches_jax(fused):
    mc, params, port = fused
    b = _batch(mc, 3)
    batch = {"input_ids": b["input_ids_pos"],
             "attention_mask": b["attention_mask_pos"],
             "input_features": b["input_features"],
             "attention_mask_audio": b["attention_mask_audio"]}
    ref = JaxModel(mc).apply({"params": params},
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = port.forward_pair({k: torch.from_numpy(v) for k, v in batch.items()})
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)
    # the fusion is on: the pair embeddings differ from the independent ones
    with torch.no_grad():
        te, _ = port.encode_text(torch.from_numpy(batch["input_ids"]),
                                 torch.from_numpy(batch["attention_mask"]))
    assert not np.allclose(got[0].numpy(),
                           (te / te.norm(dim=-1, keepdim=True)).numpy())


@pytest.mark.parametrize("preset", ["flagship", "flagship-roberta", "tiny"])
def test_preset_models_build_and_cover_the_jax_tree(preset):
    """Each preset's model (fusion on) is built on the meta device and its
    JAX abstract tree sets every parameter with the transposed shape. The
    flagship's parameter and trainable counts are chip_smoke.py's
    constants."""
    cfg = jax_train.build_config([f"preset={preset}"])
    assert cfg.model.heads.use_cross_modal
    shapes = bridge.flax_shapes(abstract_params(JaxModel(cfg.model)))
    pcfg = port_cfg(cfg)
    with torch.device("meta"):
        model = DualEncoderModel(pcfg.model)
    bridge.check_covers(model, shapes)
    labels = topt.param_labels(model, pcfg.freeze, pcfg.model)
    n = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for k, p in model.named_parameters()
                  if labels[k] != topt.FROZEN)
    assert n == sum(int(np.prod(s)) for s in shapes.values())
    if preset == "flagship":
        assert 870e6 < n < 885e6 and cfg.model.heads.use_word_alignment
        assert (n, n_train) == (chip_smoke.FLAGSHIP_PARAMS,
                                chip_smoke.FLAGSHIP_TRAINABLE)
        assert shapes["word_level_alignment.attn_q.weight"] == (768, 768)
        assert shapes["text_fusion.weight"] == (768, 1536)
