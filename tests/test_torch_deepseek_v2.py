"""The DeepSeek-V2 transcript tower of the port (``models/deepseek_v2.py``)
against its plain reference (``reference/deepseek_v2.py``) on seeded random
weights at a tiny size, in fp32 on the CPU: the forward, the pooled and
projected embeddings, a train step's loss and gradients under the partial
freeze; the YaRN frequencies and scale against their closed forms; the
routing; the freeze labels, the config's JSON, the training CLI's preset, a
checkpoint, and the Embedder's id call. The port's JAX package has no such
tower, so nothing here imports it.

Tolerances: program and reference are both fp32 and differ only in the
order of their sums (SDPA against an explicit softmax, a sorted gather and
grouped sums against a masked loop), so they agree to a few fp32 ulps of
the values' scale: 1e-5 relative on hidden states and embeddings, 1e-4 on
gradients (summed over more terms)."""

import dataclasses
import filecmp
import json
import math
import os

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_torch import checkpoints
from speech_transcript_embeddings_torch import config as C
from speech_transcript_embeddings_torch import train as torch_train
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models import deepseek_v2 as ds
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model, l2_normalize,
)
from speech_transcript_embeddings_torch.reference import deepseek_v2 as ref
from speech_transcript_embeddings_torch.training import losses
from speech_transcript_embeddings_torch.training import optimizer as opt_lib
from speech_transcript_embeddings_torch.training import train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_text(**kw) -> C.DeepseekV2TextConfig:
    """Every width cut to a few units; one dense layer, three MoE layers of
    8 experts, top-3; the rope band moved inside the tiny context."""
    base = dict(vocab_size=97, hidden_size=32, intermediate_size=48,
                moe_intermediate_size=16, num_hidden_layers=4,
                num_attention_heads=2, num_key_value_heads=2,
                n_routed_experts=8, num_experts_per_tok=3, kv_lora_rank=16,
                qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=12,
                rope_scaling=C.YarnRopeScaling(
                    original_max_position_embeddings=16))
    base.update(kw)
    return C.DeepseekV2TextConfig(**base)


def tiny_model(**kw) -> C.ModelConfig:
    m = dataclasses.replace(C.tiny_model_config(use_word_alignment=False),
                            text=tiny_text(**kw))
    return dataclasses.replace(m, heads=dataclasses.replace(
        m.heads, use_cross_modal=False))


def _ids(rows=5, length=12, lens=(12, 3, 7, 1, 10), seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(4, 97, (rows, length), generator=g)
    mask = (torch.arange(length)[None] < torch.tensor(lens)[:, None]).long()
    return ids, mask


def _close(a, b, rtol):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rtol * max(scale, 1.0), (
        float((a - b).abs().max()), scale)


def test_tower_matches_the_reference():
    """Hidden states at valid tokens, pooled and projected embeddings."""
    mc = tiny_model()
    model = init_model(mc, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    ids, mask = _ids()
    with torch.no_grad():
        proj, hidden = model.encode_text(ids, mask)
    tower = ref.Tower(dataclasses.asdict(mc), lambda n: sd[n].float())
    with torch.no_grad():
        ref_hidden = tower.hidden(ids, mask)
        ref_emb = tower.embed(ids, mask)
    valid = mask.bool()
    _close(hidden[valid], ref_hidden[valid], RTOL)
    _close(l2_normalize(proj), ref_emb, RTOL)
    # the layer's counter: every (token, choice) row counted once
    rows = model.text_encoder.layer_1.mlp.expert_rows
    assert int(rows.sum()) == ids.numel() * mc.text.num_experts_per_tok


def test_valid_tokens_never_see_pads():
    """Right padding under the causal mask: changing the pad ids changes
    no valid token's hidden state."""
    mc = tiny_model()
    model = init_model(mc, torch.Generator().manual_seed(2))
    ids, mask = _ids()
    other = torch.where(mask.bool(), ids, torch.full_like(ids, 50))
    with torch.no_grad():
        a = model.text_encoder(ids, mask)
        b = model.text_encoder(other, mask)
    valid = mask.bool()
    assert torch.equal(a[valid], b[valid])


def test_train_step_loss_and_gradients_match_the_reference():
    """The partial freeze's trainable leaves of the tower (its top blocks,
    the token table, the final norm) get the reference's gradients of the
    global InfoNCE; a train step moves them and leaves the frozen block."""
    mc = tiny_model()
    cfg = C.ExperimentConfig(
        model=mc, freeze=C.FreezeConfig(text_layers_to_unfreeze=2,
                                        audio_layers_to_unfreeze=1),
        loss=C.LossConfig(kind="global"),
        optimizer=C.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        train=C.TrainConfig(accumulation_steps=1))
    model = init_model(mc, torch.Generator().manual_seed(3), train=True)
    state = ts.create_train_state(model, cfg, total_steps=10)
    names = [n for n in state.trainable if n.startswith("text_encoder.")]
    assert "text_encoder.embed_tokens.weight" in names
    assert "text_encoder.layer_3.mlp.experts.gate_up_proj" in names
    assert not any(n.startswith("text_encoder.layer_0.")
                   or n.startswith("text_encoder.layer_1.") for n in names)
    ids, mask = _ids(rows=4, lens=(12, 3, 7, 10))
    neg, _ = _ids(rows=4, lens=(12, 3, 7, 10), seed=9)
    g = torch.Generator().manual_seed(4)
    batch = {"input_ids_pos": ids, "attention_mask_pos": mask,
             "input_ids_neg": neg, "attention_mask_neg": mask,
             "input_features": torch.randn(4, 20, 16, generator=g),
             "attention_mask_audio": torch.ones(4, 20, dtype=torch.long)}
    out = model.forward_pos_neg(batch)
    loss, _ = losses.compute_loss(cfg.loss, out)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [state.trainable[n] for n in names])))

    weights = {n: p.detach().float().clone().requires_grad_(n in names)
               for n, p in model.named_parameters()}
    tower = ref.Tower(dataclasses.asdict(mc), lambda n: weights[n])
    text = tower.embed(torch.cat([ids, neg]), torch.cat([mask, mask]))
    ref_loss, _ = losses.global_info_nce(cfg.loss, text[:4], text[4:],
                                         out.audio.detach())
    _close(loss.detach(), ref_loss.detach(), RTOL)
    ref_grads = dict(zip(names, torch.autograd.grad(
        ref_loss, [weights[n] for n in names])))
    for n in names:
        _close(grads[n], ref_grads[n], GRAD_RTOL)

    top = state.trainable["text_encoder.layer_3.mlp.experts.down_proj"]
    frozen = state.frozen["text_encoder.layer_0.mlp.gate_proj.weight"]
    before = top.detach().clone(), frozen.detach().clone()
    # the step's frontend handed the features as they are
    host = dict(batch, waveform=batch["input_features"],
                num_samples=batch["attention_mask_audio"])
    metrics = ts.train_step(cfg, state, lambda wav, n: (wav, n), host,
                            torch.Generator().manual_seed(5))
    assert torch.isfinite(metrics["loss"])
    assert not torch.equal(top.detach(), before[0])
    assert torch.equal(frozen.detach(), before[1])


def test_yarn_frequencies_and_scale_against_closed_forms():
    """DeepSeek-V2-Lite's rope: the base frequencies below dimension pair
    ⌊d(β_fast)⌋ = 10, those ÷ 40 from ⌈d(β_slow)⌉ = 23 on, a linear ramp
    between, where d(r) = 64·ln(4096 / (2πr)) / (2·ln 10⁴); the scale
    192^-½·(0.1·0.707·ln 40 + 1)² and a cos/sin mscale ratio of 1."""
    c = C.DeepseekV2TextConfig()
    d = lambda r: 64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))
    low, high = math.floor(d(32)), math.ceil(d(1))
    assert (low, high) == (10, 23)
    want = []
    for j in range(32):
        base = 1e4 ** (-2 * j / 64)
        ramp = min(max((j - low) / (high - low), 0.0), 1.0)
        want.append(base * (1 - ramp) + base / 40 * ramp)
    want = torch.tensor(want, dtype=torch.float64)
    for got in (ds.yarn_inv_freq(c), ref.yarn_inv_freq(dataclasses.asdict(c))):
        np.testing.assert_allclose(got.double(), want, rtol=1e-6)
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert scale == pytest.approx(0.11472, abs=1e-5)
    assert ds.softmax_scale(c) == pytest.approx(scale, rel=1e-12)
    assert ref.softmax_scale(dataclasses.asdict(c)) == pytest.approx(
        scale, rel=1e-12)
    cos, sin = ds.rope_table(c, 5, "cpu")
    angle = torch.outer(torch.arange(5.0), ds.yarn_inv_freq(c))
    torch.testing.assert_close(cos, torch.cat([angle.cos()] * 2, -1))
    torch.testing.assert_close(sin, torch.cat([angle.sin()] * 2, -1))


def test_rope_deinterleaves_before_rotating():
    x = torch.arange(8.0)
    assert ds.deinterleave(x).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    # at position 0 rope is the de-interleave alone; at position 1 the
    # regrouped pairs (x_2i, x_2i+1) turn by their own angle
    c = tiny_text()
    cos, sin = ds.rope_table(c, 2, "cpu")
    q = torch.randn(1, 2, 1, c.qk_rope_head_dim)
    out = ds.apply_rope(q, cos, sin)
    torch.testing.assert_close(out[0, 0, 0], ds.deinterleave(q[0, 0, 0]))
    half = c.qk_rope_head_dim // 2
    theta = ds.yarn_inv_freq(c)
    even, odd = q[0, 1, 0, 0::2], q[0, 1, 0, 1::2]
    torch.testing.assert_close(out[0, 1, 0, :half],
                               even * theta.cos() - odd * theta.sin())
    torch.testing.assert_close(out[0, 1, 0, half:],
                               odd * theta.cos() + even * theta.sin())
    torch.testing.assert_close(
        ref.rope(q.transpose(1, 2), cos, sin).transpose(1, 2), out)


def test_routing_keeps_softmax_weights_without_renormalising():
    c = tiny_text()
    logits = torch.randn(6, c.n_routed_experts)
    weights, experts = ds.route(logits, c)
    probs = logits.softmax(-1)
    torch.testing.assert_close(weights, probs.gather(-1, experts))
    assert (weights.sum(-1) < 1).all()
    assert torch.equal(experts.sort(-1).values,
                       probs.topk(c.num_experts_per_tok).indices.sort(-1)
                       .values)
    scaled, _ = ds.route(logits, dataclasses.replace(
        c, routed_scaling_factor=2.5))
    torch.testing.assert_close(scaled, 2.5 * weights)
    normed, _ = ds.route(logits, dataclasses.replace(c, norm_topk_prob=True))
    torch.testing.assert_close(normed.sum(-1), torch.ones(6))


def test_routing_ties_pick_k_distinct_experts():
    c = tiny_text()
    weights, experts = ds.route(torch.zeros(4, c.n_routed_experts), c)
    for row in experts.tolist():
        assert len(set(row)) == c.num_experts_per_tok
    torch.testing.assert_close(
        weights, torch.full((4, c.num_experts_per_tok),
                            1.0 / c.n_routed_experts))


def _moe(seed=6, **kw):
    c = tiny_text(**kw)
    layer = ds.MoE(c, torch.float32, None)
    ds_model = torch.nn.ModuleDict({"mlp": layer})
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_module,
    )
    init_module(ds_model, torch.Generator().manual_seed(seed))
    return c, layer


def _reference_moe(c, layer, x):
    sd = {f"p.{k}": v for k, v in layer.state_dict().items()}
    tower = ref.Tower({"text": dataclasses.asdict(c)}, lambda n: sd[n])
    return tower.moe(1, "p", x)


def test_an_expert_given_no_rows():
    """Every token steered away from expert 0 (its router row far below
    the others): it gets zero rows, and the layer still agrees with the
    reference."""
    c, layer = _moe()
    with torch.no_grad():
        layer.gate.weight[0] = -10.0 * layer.gate.weight[1:].abs().sum(0)
    x = torch.randn(2, 5, c.hidden_size).abs()
    with torch.no_grad():
        y = layer(x)
        want = _reference_moe(c, layer, x)
    assert int(layer.expert_rows[0]) == 0
    assert int(layer.expert_rows.sum()) == 10 * c.num_experts_per_tok
    _close(y, want, RTOL)


def test_shared_experts_counted_once():
    """Routed experts zeroed: the layer is the shared experts' SwiGLU,
    once; and the routed part plus that is the whole layer."""
    c, layer = _moe()
    x = torch.randn(2, 5, c.hidden_size)
    with torch.no_grad():
        whole = layer(x)
        shared = layer.shared_experts(x)
        for p in layer.experts.parameters():
            p.zero_()
        torch.testing.assert_close(layer(x), shared)
    assert layer.shared_experts.gate_proj.weight.shape[0] == \
        c.moe_intermediate_size * c.n_shared_experts
    assert not torch.allclose(whole, shared)


def test_freeze_labels_of_the_new_names():
    mc = C.deepseek_v2_lite_model_config()
    f = C.FreezeConfig(text_layers_to_unfreeze=5)
    label = lambda n: opt_lib.label_for(n, f, mc)
    assert label("text_encoder.layer_21.self_attn.q_proj.weight") == "frozen"
    assert label("text_encoder.layer_22.mlp.experts.gate_up_proj") == \
        "encoder"
    assert label("text_encoder.layer_26.mlp.gate.weight") == "encoder"
    assert label("text_encoder.embed_tokens.weight") == "encoder"
    assert label("text_encoder.norm.weight") == "encoder"
    assert label("text_projection.dense_in.weight") == "head"
    no_emb = dataclasses.replace(f, train_text_embeddings=False)
    assert opt_lib.label_for("text_encoder.embed_tokens.weight", no_emb,
                             mc) == "frozen"


def test_config_json_round_trip_and_old_presets_unchanged():
    for name in ("tiny_model_config", "retrieval_model_config",
                 "flagship_model_config", "roberta_model_config"):
        m = getattr(C, name)()
        assert isinstance(m.text, C.TextEncoderConfig)
        cfg = C.ExperimentConfig(model=m)
        assert C.ExperimentConfig.from_json(cfg.to_json()) == cfg
    cfg = torch_train.build_config(["preset=deepseek-v2-lite"])
    assert cfg.model.text == C.DeepseekV2TextConfig()
    assert cfg.model.heads == C.retrieval_model_config().heads
    assert (cfg.loss.kind, cfg.freeze.mode) == ("global", "partial")
    back = C.ExperimentConfig.from_json(cfg.to_json())
    assert back == cfg and isinstance(back.model.text, C.DeepseekV2TextConfig)
    text = json.loads(cfg.to_json())["model"]["text"]
    assert text["model_type"] == "deepseek_v2"
    assert text["rope_scaling"]["factor"] == 40
    over = torch_train.build_config(["preset=deepseek-v2-lite",
                                     "model.text.num_hidden_layers=3",
                                     "model.text.rope_scaling.factor=8"])
    assert (over.model.text.num_layers, over.model.text.rope_scaling.factor
            ) == (3, 8)


def test_unsupported_uses_raise():
    with pytest.raises(ValueError, match="q_lora_rank"):
        DualEncoderModel(tiny_model(q_lora_rank=8))
    with pytest.raises(ValueError, match="tensor parallel"):
        ds.DeepseekV2TextTower(tiny_text(), torch.float32, axis=object())
    cfg = C.ExperimentConfig(model=tiny_model(), data=C.DataConfig(
        max_text_length=12, audio_buckets=(16000,), max_audio_samples=16000))
    emb = Embedder(cfg, init_model(cfg.model, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="int8"):
        emb.quantize_int8()


def test_embedder_id_call_equals_embed_texts():
    cfg = C.ExperimentConfig(model=tiny_model(), data=C.DataConfig(
        max_text_length=12, audio_buckets=(16000,), max_audio_samples=16000))
    emb = Embedder(cfg, init_model(cfg.model, torch.Generator().manual_seed(7)))
    texts = ["casa tempo dia", "mar sol", "um dois tres quatro cinco"]
    ids, masks = zip(*(emb.tokenizer.encode(t, 12) for t in texts))
    by_ids = emb.embed_ids(np.stack(ids), np.stack(masks))
    np.testing.assert_array_equal(by_ids, emb.embed_texts(texts))
    assert by_ids.shape == (3, cfg.model.heads.projection_dim)


def test_checkpoint_saves_and_loads(tmp_path):
    cfg = C.ExperimentConfig(model=tiny_model())
    model = init_model(cfg.model, torch.Generator().manual_seed(8),
                       train=True)
    checkpoints.save_params_checkpoint(str(tmp_path / "ck"), model, cfg)
    cfg2, served = checkpoints.load_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == cfg
    assert isinstance(served.text_encoder, ds.DeepseekV2TextTower)
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k].float(), v.float()), k


def test_training_cli_runs_the_preset_at_a_tiny_size(tmp_path):
    """``preset=deepseek-v2-lite`` through the CLI's loop on the CPU, every
    width cut by overrides; its final model serves."""
    t = {f"model.text.{k}": v for k, v in dataclasses.asdict(
        tiny_text()).items() if not isinstance(v, dict)}
    a = {"model.audio.feature_dim": 16, "model.audio.hidden_size": 32,
         "model.audio.num_layers": 2, "model.audio.num_heads": 4,
         "model.audio.intermediate_size": 64,
         "model.audio.conv_kernel_size": 7, "model.audio.left_max_rel_pos": 8,
         "model.audio.right_max_rel_pos": 2, "model.audio.scan_bottom": 0,
         "model.audio.apply_spec_augment": False,
         "model.frontend.num_mel_bins": 8, "model.heads.projection_dim": 24,
         "model.heads.dropout": 0.0, "model.dtype": "float32",
         "model.remat": True,
         "freeze.text_layers_to_unfreeze": 2,
         "freeze.audio_layers_to_unfreeze": 1,
         "model.text.rope_scaling.original_max_position_embeddings": 16,
         "data.batch_size": 8, "data.max_text_length": 16,
         "data.audio_buckets": [16000, 48000],
         "data.max_audio_samples": 48000, "data.num_synthetic_samples": 32,
         "train.accumulation_steps": 1, "train.num_epochs": 1,
         "optimizer.warmup_steps": 2}
    argv = ["preset=deepseek-v2-lite", "device=cpu",
            f"train.output_dir={tmp_path / 'run'}"]
    argv += [f"{k}={json.dumps(v)}" for k, v in {**t, **a}.items()]
    res = torch_train.main(argv)
    assert np.isfinite([s["loss"] for s in res["step_log"]]).all()
    emb = Embedder.from_checkpoint(str(tmp_path / "run" / "final_model"),
                                   device="cpu")
    assert isinstance(emb.model.text_encoder, ds.DeepseekV2TextTower)
    out = emb.embed_texts(["casa tempo dia", "mar sol"])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1, atol=1e-5)


def test_benchmark_reference_is_a_copy_of_the_repository_reference():
    assert filecmp.cmp(
        os.path.join(ROOT, "speech_transcript_embeddings_torch", "reference",
                     "deepseek_v2.py"),
        os.path.join(ROOT, "benchmark", "reference", "deepseek_v2.py"),
        shallow=False)
