"""The check that decides ``correct`` fails where it must: each run below
skips the look for a card and drives the rest of a run of a tiny cell on
the CPU, with the timed path broken underneath (or the control in the
program's place), against the real cell's limits. The tiny cells run in
fp32, where a sound program reads far under every limit. The cells run on
one card, so no exchange between cards can be left out."""

import json
import os

import numpy as np
import pytest

from benchmark import calibrate, common
from benchmark.entries import embed, train
from benchmark.tests import tiny


def _limits(cell):
    with open(os.path.join(common.HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def _train_cell(config, cell):
    return tiny.tiny_cell("train", config, _limits(cell))


TRAIN = [("retrieval", "retrieval-train-cvmix"),
         ("flagship", "flagship-train-b64")]


def _correct(cell, out):
    return common.judge(out["readings"], cell.limits)[0]


@pytest.mark.parametrize("config,cell", TRAIN)
def test_sound_train_run_is_correct(config, cell):
    c = _train_cell(config, cell)
    assert _correct(c, train.run(tiny.CpuContext(seed=21, seconds=0.2), c))


@pytest.mark.parametrize("config,cell", TRAIN)
def test_state_left_unchanged_fails(config, cell, monkeypatch):
    from speech_transcript_embeddings_torch.training import optimizer
    monkeypatch.setattr(optimizer.AdamW, "step", lambda self, grads: False)
    c = _train_cell(config, cell)
    out = train.run(tiny.CpuContext(seed=22, seconds=0.2), c)
    assert out["readings"]["change_gap"] == pytest.approx(1.0)
    assert not _correct(c, out)


@pytest.mark.parametrize("config,cell", TRAIN)
def test_half_batch_fails(config, cell, monkeypatch):
    from speech_transcript_embeddings_torch.training import losses
    patched, _ = calibrate.half_batch_loss(losses)
    monkeypatch.setattr(losses, "compute_loss", patched)
    c = _train_cell(config, cell)
    assert not _correct(c, train.run(tiny.CpuContext(seed=23, seconds=0.2), c))


@pytest.mark.parametrize("config,cell", TRAIN)
def test_lower_precision_control_fails(config, cell, monkeypatch):
    """The reference in float8 put in the program's place."""
    c = _train_cell(config, cell)

    def control(torch_, state, step, batches):
        return train.reference_first_steps(torch_, c.config, 24, batches,
                                           "cpu", "fp8")
    monkeypatch.setattr(train, "program_first_steps", control)
    assert not _correct(c, train.run(tiny.CpuContext(seed=24, seconds=0.2), c))


def _altered(monkeypatch):
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    original = Embedder.embed_audios

    def altered(self, audios):
        return np.roll(original(self, audios), 1, axis=1)
    monkeypatch.setattr(Embedder, "embed_audios", altered)


@pytest.mark.parametrize("entry,config,cell", [
    (embed, "flagship", "flagship-embed-cvmix")])
def test_embedding_runs(entry, config, cell, monkeypatch):
    name = entry.__name__.rsplit(".", 1)[1]
    c = tiny.tiny_cell(name, config, _limits(cell))
    sound = entry.run(tiny.CpuContext(seed=25, seconds=0.2), c)
    assert _correct(c, sound)
    # the program's int8 path (the control) reads far above the sound
    # program at this size too; the cell's limit is set at its own size
    control = entry.run(tiny.CpuContext(seed=25, seconds=0.2), c, "int8")
    assert control["readings"]["embedding_gap"] > \
        10 * sound["readings"]["embedding_gap"]
    _altered(monkeypatch)
    assert not _correct(c, entry.run(tiny.CpuContext(seed=27, seconds=0.2),
                                     c))
