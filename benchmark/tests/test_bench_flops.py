"""Model FLOPs and the attention rooflines against counts worked by hand
at small shapes."""

import pytest

from benchmark import flops, roofline


def tiny_model(cross=False, align=False):
    return {
        "text": {"hidden_size": 4, "intermediate_size": 8, "num_heads": 2,
                 "num_layers": 1},
        "audio": {"hidden_size": 4, "intermediate_size": 8, "num_heads": 2,
                  "num_layers": 1, "feature_dim": 2, "conv_kernel_size": 3,
                  "left_max_rel_pos": 1, "right_max_rel_pos": 1},
        "frontend": {"frame_length": 400, "hop_length": 160, "stride": 2},
        "heads": {"projection_dim": 2, "projection_hidden_dim": None,
                  "use_attentive_pooling": False, "use_cross_modal": cross,
                  "use_word_alignment": align},
    }


def test_valid_frames():
    fe = tiny_model()["frontend"]
    assert flops.valid_frames(fe, 399) == 0
    assert flops.valid_frames(fe, 400) == 0          # one frame, no pair
    assert flops.valid_frames(fe, 560) == 1          # two frames
    assert flops.valid_frames(fe, 160000) == 499


def test_embed_audio_counts_each_product_once():
    m = tiny_model()
    t = 3
    # feature projection 2·t·2·4; a block: two FFNs 2·(2·t·4·8·2),
    # q k v out 4·2·t·4·4, q·kᵀ and p·v 2·2·(2t)·t·2, q·Eᵀ 2·(2t)·3·2,
    # GLU in 2·t·8·4, depthwise 2·t·4·3, GLU out 2·t·4·4; projection
    # 2·4·4 + 2·4·2 (per clip)
    block = (2 * (2 * t * 4 * 8 * 2) + 4 * 2 * t * 4 * 4
             + 2 * 2 * (2 * t) * t * 2 + 2 * (2 * t) * 3 * 2
             + 2 * t * 8 * 4 + 2 * t * 4 * 3 + 2 * t * 4 * 4)
    want = 2 * t * 2 * 4 + block + 2 * 4 * 4 + 2 * 4 * 2
    samples = 400 + 160 * (2 * t - 1)                # 2t frames
    assert flops.valid_frames(m["frontend"], samples) == t
    assert flops.embed_audio({"model": m}, [samples]) == want


def test_count_backward_rules():
    c = flops.Count()
    c.product(2, 3, 4, act_grad=True, weight_grad=False)
    assert (c.forward, c.backward) == (48, 48)
    c.product(2, 3, 4, act_grad=True, weight_grad=True)
    assert (c.forward, c.backward) == (96, 144)
    c.product(2, 3, 4, act_grad=False, weight_grad=False)
    assert (c.forward, c.backward) == (144, 144)
    assert c.train == 288


def test_train_step_is_forward_plus_backward_without_recompute():
    m = tiny_model()
    cfg = {"model": m, "freeze": {"text_layers_to_unfreeze": 1,
                                  "audio_layers_to_unfreeze": 1,
                                  "train_text_embeddings": True,
                                  "train_audio_feature_projection": True}}
    samples = [400 + 160 * 5]
    total = flops.train_step(cfg, samples, 4)
    fwd = flops.embed_audio(cfg, samples)
    # everything trains: each product costs 3× its forward, but the
    # depthwise conv (forward and two gradients: 3×) and the loss
    assert total > 3 * fwd
    frozen = dict(cfg, freeze=dict(cfg["freeze"], audio_layers_to_unfreeze=0,
                                   text_layers_to_unfreeze=0,
                                   train_text_embeddings=False,
                                   train_audio_feature_projection=False))
    assert flops.train_step(frozen, samples, 4) < total


@pytest.mark.parametrize("backward", [False, True])
def test_attention_bound(backward):
    peak_f, peak_b = 1e12, 1e9
    t, heads, hd, p = 4, 2, 8, 3
    per_t2, per_tp, tensors = (10, 6, 8) if backward else (4, 2, 4)
    want_f = heads * (per_t2 * t * t * hd + per_tp * t * p * hd)
    want_b = (heads * t * (tensors * hd * 2 + 4)
              + (2 if backward else 1) * p * hd * 2)
    got = roofline.attention_bound_s([t], heads, hd, p, peak_f, peak_b,
                                     backward)
    assert got == pytest.approx(max(want_f / peak_f, want_b / peak_b))
    # bytes bound this shape at these peaks; twice the clips, twice the time
    assert roofline.attention_bound_s([t, t], heads, hd, p, peak_f, peak_b,
                                      backward) == pytest.approx(
        2 * got - (2 if backward else 1) * p * hd * 2 / peak_b)
