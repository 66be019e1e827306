"""The port's epoch loop end to end on the CPU (tests/test_end_to_end.py's
tests that need no mesh, against ``speech_transcript_embeddings_torch``'s
``run_experiment``): the fused tiny model trains on synthetic clips and the
gap grows, the artifacts keep the reference's schema, checkpoints describe
themselves, resume continues, preemption saves a mid-epoch ``latest`` and
the rerun skips the trained batches; plus an exact resume from inside an
accumulation window, the gradient-accumulation self-check and the profiler
trace."""

import json
import os
import signal
import threading

import pytest
import torch

from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch.config import (
    DataConfig, ExperimentConfig, FreezeConfig, LossConfig, OptimizerConfig,
    TrainConfig, tiny_model_config,
)
from speech_transcript_embeddings_torch.data import (
    DataPipeline, make_source, resolve_tokenizer,
)
from speech_transcript_embeddings_torch.training import loop as loop_mod
from speech_transcript_embeddings_torch.training.loop import run_experiment
from torch_port_cfg import one_thread  # noqa: F401

METRIC_KEYS = {"loss", "avg_similarity", "median_similarity",
               "std_similarity", "clean_similarity", "corrupt_similarity",
               "similarity_gap"}


def smoke_cfg(tmp, samples=96, **train_kw) -> ExperimentConfig:
    train = dict(num_epochs=2, accumulation_steps=1, seed=42,
                 output_dir=str(tmp), plot_every=1, log_every_batches=1000)
    train.update(train_kw)
    return ExperimentConfig(
        model=tiny_model_config(),
        freeze=FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                            audio_layers_to_unfreeze=1),
        loss=LossConfig(),
        optimizer=OptimizerConfig(learning_rate=2e-3, warmup_steps=3),
        data=DataConfig(dataset="synthetic", batch_size=8, max_text_length=12,
                        audio_buckets=(16000, 48000), max_audio_samples=48000,
                        num_synthetic_samples=samples),
        train=TrainConfig(**train))


def _run(cfg):
    return run_experiment(cfg, device="cpu")


def _batches_per_epoch(cfg):
    pipe = DataPipeline(cfg.data, resolve_tokenizer(cfg, context="test"),
                        seed=cfg.train.seed)
    return pipe.count_epoch_batches(make_source(cfg.data, seed=cfg.train.seed),
                                    "train")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_smoke_run")
    cfg = smoke_cfg(tmp)
    return cfg, _run(cfg), tmp


def test_training_improves_gap(run):
    cfg, results, tmp = run
    hist = results["val_history"]
    gaps = [c - k for c, k in zip(hist["clean"], hist["corrupt"])]
    assert gaps[-1] > 0.0
    assert gaps[-1] >= gaps[0] - 1e-6


def test_artifact_schema(run):
    cfg, results, tmp = run
    out = str(tmp)
    assert os.path.exists(os.path.join(out, "training.log"))
    with open(os.path.join(out, "test_metrics.json")) as f:
        tm = json.load(f)
    assert set(tm) <= {"best_loss_model", "best_gap_model"} and tm
    for block in tm.values():
        assert set(block) == METRIC_KEYS
    for name in ("similarity_dist_epoch_2.png", "clean_corrupt_progress.png",
                 "config.json", "test_similarity_dist_best_loss.png"):
        assert os.path.exists(os.path.join(out, name)), name
    # latest and the periodic checkpoints carry the optimizer, the best and
    # final ones are params-only
    for name, full in (("latest", True), ("checkpoint_epoch_2", True),
                       ("final_model", False), ("best_model_loss", False)):
        path = os.path.join(out, name)
        assert ckpt_lib.checkpoint_exists(path), name
        assert ckpt_lib.load_metadata(path)["params_only"] is not full
        assert os.path.exists(os.path.join(path, "optimizer.pt")) is full


def test_checkpoint_metadata_self_describing(run):
    cfg, results, tmp = run
    best = "best_model_gap" if "best_gap_model" in results["test_metrics"] \
        else "best_model_loss"
    meta = ckpt_lib.load_metadata(os.path.join(str(tmp), best))
    assert meta["config"]["freeze"]["mode"] == "partial"
    assert meta["config"]["model"]["heads"]["projection_dim"] == \
        cfg.model.heads.projection_dim
    assert meta["kind"] == ckpt_lib.KIND and "epoch" in meta
    assert set(meta["metrics"]["val_metrics"]) == METRIC_KEYS


def test_resume_continues_not_restarts(run):
    cfg, results, tmp = run
    cfg3 = smoke_cfg(tmp).with_overrides({"train": {"num_epochs": 3}})
    results3 = _run(cfg3)
    assert [e["epoch"] for e in results3["epochs"]] == [3]
    assert len(results3["val_history"]["clean"]) == 3
    assert results3["val_history"]["clean"][:2] == pytest.approx(
        results["val_history"]["clean"], abs=1e-6)
    assert results3["val_history"]["corrupt"][:2] == pytest.approx(
        results["val_history"]["corrupt"], abs=1e-6)
    meta = ckpt_lib.load_metadata(os.path.join(str(tmp), "latest"))
    assert meta["epoch"] == 3
    assert len(meta["metrics"]["val_history"]["clean"]) == 3
    assert results3["state"].step == 3 * _batches_per_epoch(cfg)


def test_retrieval_metrics_written(run):
    cfg, results, tmp = run
    with open(os.path.join(str(tmp), "retrieval_metrics.json")) as f:
        data = json.load(f)
    block = next(iter(data.values()))
    assert {"recall@1", "recall@5", "recall@10", "mean_rank", "mrr"} <= \
        set(block)
    assert 0.0 <= block["recall@1"] <= 1.0


def test_global_loss_training_improves_gap(tmp_path):
    cfg = smoke_cfg(tmp_path).with_overrides({"loss": {"kind": "global"}})
    results = _run(cfg)
    hist = results["val_history"]
    gaps = [c - k for c, k in zip(hist["clean"], hist["corrupt"])]
    assert gaps[-1] > 0.0
    # test pool of 24 clips: chance mean rank 12.5
    assert 0.0 <= results["retrieval"]["recall@1"] <= 1.0
    assert 1.0 <= results["retrieval"]["mean_rank"] <= 20.0
    assert "pairwise_loss" in results["epochs"][-1]["val_metrics"]


def test_exact_schedule_step_accounting(run):
    cfg, results, tmp = run
    per_epoch = _batches_per_epoch(cfg)
    assert sum(e["train_batches"] for e in results["epochs"]) == \
        cfg.train.num_epochs * per_epoch
    assert results["state"].optimizer.count == \
        cfg.train.num_epochs * per_epoch


def test_preemption_checkpoint_and_midepoch_resume(tmp_path):
    cfg = smoke_cfg(tmp_path, fault_inject_preempt_at=2)
    results = _run(cfg)
    assert results["preempted"] == {"epoch": 1, "batches_done": 2}
    meta = ckpt_lib.load_metadata(os.path.join(str(tmp_path), "latest"))
    assert meta["epoch"] == 0
    assert meta["metrics"]["mid_epoch"] == {"epoch": 1, "batches_done": 2}

    results2 = _run(smoke_cfg(tmp_path))
    assert "preempted" not in results2
    assert len(results2["val_history"]["clean"]) == cfg.train.num_epochs
    assert results2["state"].step == \
        cfg.train.num_epochs * _batches_per_epoch(cfg)
    assert results2["epochs"][0]["skipped_batches"] == 2
    log = open(os.path.join(str(tmp_path), "training.log")).read()
    assert "Resumed mid-epoch" in log and "skipping the first 2" in log


def test_request_preemption_via_sigterm(tmp_path):
    """A real SIGTERM mid-run goes through request_preemption and ends the
    run cleanly; the handler that was installed before comes back."""
    cfg = smoke_cfg(tmp_path)
    old = signal.getsignal(signal.SIGTERM)
    # pre-install the handler so the timer never meets the default
    # (process-terminating) disposition
    signal.signal(signal.SIGTERM, loop_mod.request_preemption)
    fired = threading.Timer(0.5, lambda: os.kill(os.getpid(), signal.SIGTERM))
    try:
        fired.start()
        results = _run(cfg)
        assert signal.getsignal(signal.SIGTERM) is loop_mod.request_preemption
    finally:
        fired.cancel()
        signal.signal(signal.SIGTERM, old)
        loop_mod._PREEMPT.clear()
    if "preempted" in results:
        latest = os.path.join(str(tmp_path), "latest")
        assert ckpt_lib.checkpoint_exists(latest)
        mid = ckpt_lib.load_metadata(latest)["metrics"]["mid_epoch"]
        assert mid["batches_done"] >= 1


def test_preempt_agreed_single_process_fast_path():
    assert loop_mod.preempt_agreed(True) is True
    assert loop_mod.preempt_agreed(False) is False


def _latest_state(out):
    path = os.path.join(str(out), "latest")
    return (torch.load(os.path.join(path, "model.pt"), weights_only=True),
            torch.load(os.path.join(path, "optimizer.pt"), weights_only=True))


def test_exact_resume_equals_an_uninterrupted_run(tmp_path):
    """Dropout 0 and SpecAugment off (the tiny model): a run preempted
    inside an accumulation window (micro-step 1 of 2) and resumed ends with
    trainable weights and optimizer state bit-identical to an
    uninterrupted run's. Tolerance 0, under deterministic algorithms: the
    CPU embedding backward otherwise sums in a thread-dependent order, and
    two uninterrupted runs differ in the last bit."""
    kw = dict(samples=48, accumulation_steps=2)
    torch.use_deterministic_algorithms(True)
    try:
        whole = _run(smoke_cfg(tmp_path / "whole", **kw))
        cut = _run(smoke_cfg(tmp_path / "cut", fault_inject_preempt_at=3,
                             **kw))
        assert cut["preempted"] == {"epoch": 1, "batches_done": 3}
        saved = torch.load(tmp_path / "cut" / "latest" / "optimizer.pt",
                           weights_only=True)
        assert saved["optimizer"]["mini_step"] == 1 and \
            saved["optimizer"]["acc"] is not None
        resumed = _run(smoke_cfg(tmp_path / "cut", **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    (m_a, o_a), (m_b, o_b) = (_latest_state(tmp_path / "whole"),
                              _latest_state(tmp_path / "cut"))
    assert m_a.keys() == m_b.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    assert o_a["step"] == o_b["step"] == whole["state"].step
    oa, ob = o_a["optimizer"], o_b["optimizer"]
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"])
    for part in ("mu", "nu"):
        for k in oa[part]:
            assert torch.equal(oa[part][k], ob[part][k]), (part, k)
    assert (oa["acc"] is None) == (ob["acc"] is None)
    assert resumed["val_history"] == whole["val_history"]
    assert resumed["test_metrics"] == whole["test_metrics"]


def test_validate_gradients_reports_ok_and_profile_is_written(tmp_path):
    prof = tmp_path / "prof"
    cfg = smoke_cfg(tmp_path / "run", samples=48, num_epochs=1,
                    accumulation_steps=2, validate_gradients=True,
                    profile_dir=str(prof), profile_steps=1)
    report = _run(cfg)["gradient_check"]
    assert report["ok"] and report["max_rel_err"] < 2e-2
    assert set(report) == {"max_rel_err", "mean_grad_norm", "max_grad_norm",
                           "ok"}
    assert json.load(open(prof / "trace.json"))["traceEvents"]
