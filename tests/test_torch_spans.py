"""The port's own phase spans (``utils/profile.span``), on the CPU at a tiny
size: under ``torch.profiler`` one ``train_step`` opens each phase of the
step once, in order, and every top-level op of the calling thread in that
step lies inside one of them; ``Embedder.embed_audios``, ``embed_texts``
and ``embed_pair`` open theirs the same way; with no profiler recording,
no ``record_function`` is entered at all."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from speech_transcript_embeddings_torch.config import (
    DataConfig, ExperimentConfig, FreezeConfig, LossConfig, TrainConfig,
    tiny_model_config,
)
from speech_transcript_embeddings_torch.data import (
    DataPipeline, SimpleWordTokenizer, SyntheticSource,
)
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.training import train_step as tts
from speech_transcript_embeddings_torch.utils import profile as up
from torch_port_cfg import one_thread  # noqa: F401

STEP_PHASES = ["frontend", "forward", "loss", "backward", "grad_norm",
               "optimizer", "metrics"]
CALL = "test: call"


def _cfg():
    return ExperimentConfig(
        model=tiny_model_config(use_word_alignment=False),
        freeze=FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                            audio_layers_to_unfreeze=1),
        loss=LossConfig(kind="global"),
        data=DataConfig(dataset="synthetic", batch_size=4, max_text_length=12,
                        audio_buckets=(16000, 32000),
                        max_audio_samples=32000, num_synthetic_samples=8),
        train=TrainConfig(num_epochs=1, accumulation_steps=1, seed=0))


@pytest.fixture(scope="module")
def cfg():
    return _cfg()


@pytest.fixture(scope="module")
def batch(cfg):
    pipe = DataPipeline(cfg.data, SimpleWordTokenizer(vocab_size=128), seed=0)
    return next(iter(pipe.epoch_batches(SyntheticSource(cfg.data, seed=3),
                                        "train", epoch=0)))


def _state(cfg):
    model = init_model(cfg.model, torch.Generator().manual_seed(0),
                       train=True)
    return tts.create_train_state(model, cfg, total_steps=10)


def _step(cfg):
    state, frontend = _state(cfg), make_frontend(cfg.model.frontend)
    gen = torch.Generator().manual_seed(1)
    return lambda b: tts.train_step(cfg, state, frontend, b, gen)


@pytest.fixture(scope="module")
def embedder(cfg):
    model = init_model(cfg.model, torch.Generator().manual_seed(0))
    return Embedder(cfg, model, SimpleWordTokenizer(vocab_size=128))


def _clips(lengths):
    rng = np.random.default_rng(5)
    return [rng.normal(scale=0.2, size=n).astype(np.float32) for n in lengths]


def _traced(fn, tmp_path):
    """``fn()`` once in a ``test: call`` range under a CPU profiler → the
    trace's complete events and that range's event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function(CALL):
            fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    call = next(e for e in events if e["name"] == CALL)
    return events, call


def _inside(e, outer):
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def _phases(events, call):
    """The ``phase:`` spans of the calling thread in the call, in order."""
    spans = sorted((e for e in events if e["name"].startswith(up.PHASE_MARK)
                    and e["tid"] == call["tid"] and _inside(e, call)),
                   key=lambda e: e["ts"])
    return spans, [e["name"][len(up.PHASE_MARK):] for e in spans]


def _assert_ops_in_spans(events, call, spans):
    """Every top-level ``cpu_op`` of the calling thread in the call (one no
    other op of the thread holds) lies inside exactly one span."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and e["tid"] == call["tid"] and _inside(e, call)),
                 key=lambda e: (e["ts"], -e["dur"]))
    top = []
    for e in ops:
        if not (top and _inside(e, top[-1])):
            top.append(e)
    assert top
    for e in top:
        holders = [s["name"] for s in spans if _inside(e, s)]
        assert len(holders) == 1, (e["name"], holders)


def _traced_step(cfg, batch, grouped, tmp_path):
    """A warm step traced (``_traced``), in one process or on a data axis
    (a one-rank gloo group) → events, the call's range, its spans and
    their names."""
    if grouped:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        step = _step(cfg)
        step(batch)
        events, call = _traced(lambda: step(batch), tmp_path)
    finally:
        if grouped:
            dist.destroy_process_group()
    return (events, call, *_phases(events, call))


GROUPED = pytest.mark.parametrize("grouped", [False, True],
                                  ids=["one_process", "data_axis"])


@GROUPED
def test_train_step_opens_each_phase_once_in_order(cfg, batch, grouped,
                                                   tmp_path):
    """On a data axis the gradient mean opens ``grad_sync`` between the
    backward and the norm."""
    *_, names = _traced_step(cfg, batch, grouped, tmp_path)
    want = list(STEP_PHASES)
    if grouped:
        want.insert(want.index("grad_norm"), "grad_sync")
    assert names == want


@GROUPED
def test_every_top_level_op_of_a_step_lies_in_one_span(cfg, batch, grouped,
                                                       tmp_path):
    events, call, spans, names = _traced_step(cfg, batch, grouped, tmp_path)
    _assert_ops_in_spans(events, call, spans)
    # on the CPU the autograd engine runs the backward's nodes on the
    # calling thread: they lie in its span
    backward = spans[names.index("backward")]
    assert any(e["name"].startswith("autograd::engine")
               and _inside(e, backward) for e in events)


EMBED_CALLS = {
    "embed_audios": (lambda emb: emb.embed_audios(_clips([9000, 20000,
                                                          31000])),
                     ["pad", "h2d", "frontend", "encode", "d2h"]),
    "embed_texts": (lambda emb: emb.embed_texts(["casa tempo", "mar sol dia",
                                                 "uma"]),
                    ["pad", "h2d", "encode", "d2h"]),
    "embed_pair": (lambda emb: emb.embed_pair("casa tempo dia",
                                              _clips([12000])[0]),
                   ["pad", "h2d", "frontend", "encode", "d2h"]),
}


@pytest.mark.parametrize("name", list(EMBED_CALLS))
def test_embedder_opens_its_phases(embedder, name, tmp_path):
    """The text path has no log-mel frontend: its spans skip it."""
    fn, want = EMBED_CALLS[name]
    events, call = _traced(lambda: fn(embedder), tmp_path)
    spans, names = _phases(events, call)
    assert names == want
    _assert_ops_in_spans(events, call, spans)


def test_no_record_function_without_a_profiler(cfg, batch, embedder,
                                               monkeypatch):
    """Off, a span is the one shared no-op context and enters no
    ``record_function``; the same calls under a profiler enter one a
    span."""
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    step = _step(cfg)

    def calls():
        step(batch)
        for fn, _ in EMBED_CALLS.values():
            fn(embedder)

    assert up.span("forward") is up.span("d2h")
    calls()
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        calls()
    spans = [n for n in entered if n.startswith(up.PHASE_MARK)]
    assert len(spans) == len(STEP_PHASES) + sum(
        len(want) for _, want in EMBED_CALLS.values())
