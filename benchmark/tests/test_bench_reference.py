"""The plain reference against the program on the CPU at tiny sizes: the
train step's first three steps, and the serving embedding. The tiny
configurations run in fp32, where the two agree to rounding."""

import numpy as np
import pytest
import torch

from benchmark.entries import embedding, train
from benchmark.reference import model as ref_model
from benchmark.tests import tiny
from benchmark.weights import make_weights


@pytest.mark.parametrize("config", ["retrieval", "flagship"])
def test_train_first_steps_agree(config):
    cell = tiny.tiny_cell("train", config)
    prog = train.Program(torch, cell, 2**31 + 9, torch.device("cpu"))
    first = prog.first_steps()
    ref = train.reference_first_steps(torch, cell.config, 2**31 + 9,
                                      prog.ran_first, "cpu")
    numbers, report = train.readings(first, ref)
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 1e-4
    assert report["grad_gap_worst"] < 1e-3
    assert numbers["change_gap"] < 0.05
    # an encoder's LayerNorm scales (≈ 1) move by less than half their
    # spacing at the encoders' rate in the first steps; the rest move
    moved = [k for k, v in ref["change"].items() if v > 0]
    assert len(moved) > 0.8 * len(ref["change"])
    assert all(first["change"][k] > 0 for k in moved)


def test_embedding_agrees():
    cell = tiny.tiny_cell("embed", "flagship")
    embedder = embedding.make_embedder(torch, cell, 3, "cpu")
    rng = np.random.default_rng(0)
    clips = [rng.normal(scale=0.05, size=n).astype(np.float32)
             for n in (3000, 7000, 8000, 12000, 16000)]
    prog = embedder.embed_audios(clips)
    ref = embedding.reference_embeddings(torch, cell.config, 3, clips,
                                         cell.mix["buckets"], "cpu")
    assert embedding.embedding_gap(prog, ref) < 1e-3


def test_weights_cover_the_programs_parameters():
    from benchmark import common
    cell = tiny.tiny_cell("train", "flagship")
    cfg = common.port_config(cell.config, cell.mix)
    weights = make_weights(cell.config, 1, "cpu")
    model = common.build_model(torch, cfg, weights, True, "cpu")
    assert set(dict(model.named_parameters())) == set(weights)
    again = make_weights(cell.config, 1, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in weights)


def test_frontend_matches_the_documented_frames():
    fe = tiny.tiny_config()["model"]["frontend"]
    wave = torch.randn(2, 16000, dtype=torch.float64) * 0.05
    n = torch.tensor([16000, 9000])
    feats, mask = ref_model.log_mel_features(fe, wave, n)
    frames = 1 + (16000 - 400) // 160
    assert feats.shape == (2, frames // 2, 2 * fe["num_mel_bins"])
    assert mask.sum(1).tolist() == [frames // 2, (1 + (9000 - 400) // 160)
                                    // 2]
    assert torch.all(feats[1, mask[1].sum():] == 0)
