"""Experiment driver: epochs, evaluation, the final checkpoint.

Port of the main line of ``speech_transcript_embeddings_tpu/training/
loop.py``: set-up and logging, the exact LR-schedule accounting, the epoch
loop over ``DataPipeline.epoch_batches`` with host prefetch, validation
each epoch, and the ``final_model`` checkpoint, which the port's serving
path loads. The data pipeline, the synthetic/Common Voice sources, the
tokenizers and the artifact helpers are the port's copies of the JAX
package's (``speech_transcript_embeddings_torch.data``). Each micro-step's loss stays
on the device with a CUDA event after it; both are read once the epoch
has synced, so the step log adds no host sync to the batch loop.

Not ported yet (ROADMAP.md, Queue 1 item 3): resume from ``latest``,
SIGTERM preemption, the best-loss / best-gap / periodic checkpoints, plots,
the test and retrieval phase, and the profiler. Fields whose honouring
would change the result raise; the artifacts not written are logged once.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.data import (
    DataPipeline, artifacts, make_source, prefetch, resolve_tokenizer,
)
from speech_transcript_embeddings_torch.inference.embed import resolve_device
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.training.train_step import (
    create_train_state, eval_step, train_step,
)

NOT_WRITTEN = ("latest/ and resume, best_model_loss/, best_model_gap/, "
               "checkpoint_epoch_N/, similarity and progress plots, "
               "test_metrics.json, retrieval_metrics.json, the profiler "
               "trace, SIGTERM preemption")


def check_supported(cfg: ExperimentConfig, device: torch.device) -> None:
    """Raise for the fields this loop cannot honour without changing the
    result of the run."""
    out_dir = cfg.train.output_dir
    if cfg.train.resume and ckpt_lib.checkpoint_exists(
            os.path.join(out_dir, "latest")):
        raise NotImplementedError(
            f"{out_dir}/latest exists and train.resume is on: resume is not "
            "ported yet (ROADMAP.md); use a fresh train.output_dir or "
            "train.resume=false")
    if cfg.train.init_checkpoint:
        kind = ckpt_lib.load_metadata(cfg.train.init_checkpoint).get("kind")
        if kind != ckpt_lib.KIND:
            raise NotImplementedError(
                f"train.init_checkpoint {cfg.train.init_checkpoint}: kind "
                f"{kind!r}; this loop initialises from {ckpt_lib.KIND!r} "
                "checkpoints only (convert others with bridge.py)")
    for field, value in (
            ("train.fault_inject_preempt_at",
             cfg.train.fault_inject_preempt_at),
            ("train.validate_gradients", cfg.train.validate_gradients),
            ("mesh.multihost", cfg.mesh.multihost)):
        if value:
            raise NotImplementedError(f"{field}={value!r} is not ported yet "
                                      "(ROADMAP.md)")
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    data = n_dev if cfg.mesh.num_data == -1 else cfg.mesh.num_data
    if data * cfg.mesh.num_model > 1:
        raise NotImplementedError(
            f"a {data}×{cfg.mesh.num_model} device mesh: data and tensor "
            "parallel training are not ported yet (ROADMAP.md); run on one "
            "device (mesh.num_data=1)")


def evaluate(cfg, model, frontend, pipeline, source, split: str, epoch: int,
             logger) -> Tuple[Dict[str, float], np.ndarray, np.ndarray, int]:
    """→ (metrics, raw clean cosines, raw corrupt cosines, batches)."""
    sums = []
    for batch in prefetch(pipeline.epoch_batches(source, split, epoch), 2):
        sums.append(eval_step(cfg, model, frontend, batch))
    if not sums:
        logger.warning(f"No valid samples were processed during {split} "
                       "evaluation")
        zero = {k: 0.0 for k in ("loss", "avg_similarity", "median_similarity",
                                 "std_similarity", "clean_similarity",
                                 "corrupt_similarity", "similarity_gap")}
        return zero, np.array([]), np.array([]), 0
    loss_sum = float(sum(o["loss_sum"] for o in sums))
    pairwise_sum = float(sum(o["pairwise_loss_sum"] for o in sums))
    count = float(sum(o["count"] for o in sums))
    masks = [o["example_mask"].cpu().numpy().astype(bool) for o in sums]
    s_pos = np.concatenate([o["s_pos"].cpu().numpy()[m]
                            for o, m in zip(sums, masks)])
    s_neg = np.concatenate([o["s_neg"].cpu().numpy()[m]
                            for o, m in zip(sums, masks)])
    t = cfg.loss.temperature
    clean_hr = 1.0 / (1.0 + np.exp(-s_pos / t))
    corrupt_hr = 1.0 / (1.0 + np.exp(-s_neg / t))
    metrics = artifacts.eval_metrics_dict(loss_sum / max(count, 1.0),
                                          clean_hr, corrupt_hr)
    if cfg.loss.kind == "global":
        metrics["pairwise_loss"] = pairwise_sum / max(count, 1.0)
    logger.info(f"{split} metrics:")
    logger.info(f"  Loss: {metrics['loss']:.4f}")
    logger.info(f"  Clean sample similarity: {metrics['clean_similarity']:.4f}")
    logger.info(f"  Corrupted sample similarity: "
                f"{metrics['corrupt_similarity']:.4f}")
    logger.info(f"  Similarity gap (clean - corrupt): "
                f"{metrics['similarity_gap']:.4f}")
    return metrics, s_pos, s_neg, len(sums)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    """A point of the run: a CUDA event on the current stream (no host
    sync), or the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(start, end) -> float:
    """Seconds between two marks (CUDA events: after a device sync)."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) / 1e3


def run_experiment(cfg: ExperimentConfig, device="cuda", source=None,
                   tokenizer=None, logger=None) -> dict:
    device = resolve_device(device)
    check_supported(cfg, device)
    out_dir = cfg.train.output_dir
    os.makedirs(out_dir, exist_ok=True)
    logger = logger or artifacts.setup_run_logging(out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    if device.type == "cuda":
        # fp32 products in full fp32, as the JAX package runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    source = source or make_source(cfg.data, seed=cfg.train.seed)
    tokenizer = tokenizer or resolve_tokenizer(cfg, context="training run")
    pipeline = DataPipeline(cfg.data, tokenizer, seed=cfg.train.seed)
    logger.info(f"PyTorch port on {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    logger.info(f"Not written by the port yet: {NOT_WRITTEN}")
    logger.info("Training with parameters:")
    logger.info(f"  Freeze mode: {cfg.freeze.mode}")
    logger.info(f"  Text layers to unfreeze: {cfg.freeze.text_layers_to_unfreeze}")
    logger.info(f"  Audio layers to unfreeze: {cfg.freeze.audio_layers_to_unfreeze}")
    logger.info(f"  Loss kind: {cfg.loss.kind}")
    logger.info(f"  Batch size: {cfg.data.batch_size}")
    logger.info(f"  Gradient accumulation steps: {cfg.train.accumulation_steps}")
    logger.info(f"  Learning rate: {cfg.optimizer.learning_rate}")
    logger.info(f"  Training samples: {source.num_examples('train')}")
    logger.info(f"  Validation samples: {source.num_examples('validation')}")

    model = init_model(cfg.model, torch.Generator(device).manual_seed(
        cfg.train.seed), device, train=True)
    if cfg.train.init_checkpoint:
        logger.info(f"Initializing params from {cfg.train.init_checkpoint}")
        ckpt_lib.load_into(cfg.train.init_checkpoint, model)

    exact = pipeline.count_epoch_batches(source, "train") \
        if cfg.train.exact_schedule else None
    batches_per_epoch = max(exact if exact is not None else
                            source.num_examples("train")
                            // cfg.data.batch_size, 1)
    steps_per_epoch = math.ceil(batches_per_epoch
                                / cfg.train.accumulation_steps)
    schedule_epochs = cfg.train.schedule_epochs or cfg.train.num_epochs
    if schedule_epochs < cfg.train.num_epochs:
        raise ValueError(
            f"train.schedule_epochs={schedule_epochs} < num_epochs="
            f"{cfg.train.num_epochs}: the decay would end before training does")
    total_steps = steps_per_epoch * schedule_epochs
    state = create_train_state(model, cfg, total_steps)
    n_param = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in state.trainable.values())
    logger.info(f"Model initialized with {n_train:,} trainable parameters "
                f"out of {n_param:,} total")
    logger.info(f"Scheduler: {batches_per_epoch} batches/epoch, "
                f"{steps_per_epoch} optimizer steps/epoch, {total_steps} "
                f"total, {cfg.optimizer.warmup_steps} warmup")
    frontend = make_frontend(cfg.model.frontend).to(device)
    generator = torch.Generator(device).manual_seed(cfg.train.seed + 17)

    results: dict = {"n_params": n_param, "n_trainable": n_train,
                     "step_log": [], "epochs": []}
    for epoch in range(1, cfg.train.num_epochs + 1):
        try:
            t0 = time.perf_counter()
            start = _mark(device)
            acc = None
            n_batches = 0
            steps = []      # (samples, loss on the device, mark) per step
            for batch in prefetch(pipeline.epoch_batches(source, "train",
                                                         epoch),
                                  cfg.train.prefetch_batches):
                metrics = train_step(cfg, state, frontend, batch, generator)
                acc = metrics if acc is None else {
                    k: acc[k] + v for k, v in metrics.items()}
                n_batches += 1
                steps.append((int(batch["waveform"].shape[1]),
                              metrics["loss"], _mark(device)))
                if n_batches % cfg.train.log_every_batches == 0:
                    # the only host sync in the batch loop
                    a = {k: float(v) / n_batches for k, v in acc.items()}
                    logger.info(
                        f"Epoch {epoch} batch {n_batches}: "
                        f"loss={a['loss']:.4f} clean={a['clean_hr']:.3f} "
                        f"corrupt={a['corrupt_hr']:.3f} "
                        f"gap={a['clean_hr'] - a['corrupt_hr']:.3f} "
                        f"grad_norm={a['grad_norm']:.3g}")
            _sync(device)
            train_time = time.perf_counter() - t0
            results["step_log"] += [
                {"epoch": epoch, "batch": i + 1, "samples": samples,
                 "loss": float(loss), "t": _seconds(start, mark)}
                for i, (samples, loss, mark) in enumerate(steps)]
            # from the end of the first micro-step to the end of the last
            warm_clips_per_sec = (
                (n_batches - 1) * cfg.data.batch_size
                / max(_seconds(steps[0][2], steps[-1][2]), 1e-9)
                if n_batches > 1 else 0.0)
            n = max(n_batches, 1)
            a = ({k: float(v) / n for k, v in acc.items()} if acc is not None
                 else {"loss": 0.0, "clean_hr": 0.0, "corrupt_hr": 0.0,
                       "grad_norm": 0.0})
            train_metrics = {
                "loss": a["loss"], "clean_similarity": a["clean_hr"],
                "corrupt_similarity": a["corrupt_hr"],
                "similarity_gap": a["clean_hr"] - a["corrupt_hr"],
                "grad_norm": a["grad_norm"]}
            clips_per_sec = n_batches * cfg.data.batch_size / max(
                train_time, 1e-9)
            val_metrics, _, _, n_eval = evaluate(
                cfg, state.model, frontend, pipeline, source, "validation",
                epoch, logger)
            logger.info(
                f"Epoch {epoch}/{cfg.train.num_epochs} - "
                f"Train Loss: {train_metrics['loss']:.4f}, "
                f"Val Loss: {val_metrics['loss']:.4f}, "
                f"Gap: {val_metrics['similarity_gap']:.4f}, "
                f"Time: {time.perf_counter() - t0:.2f}s "
                f"({clips_per_sec:.2f} clips/s train, "
                f"{warm_clips_per_sec:.2f} after the first step)")
            results["epochs"].append({
                "epoch": epoch, "train_batches": n_batches,
                "eval_batches": n_eval, "train_seconds": train_time,
                "clips_per_sec": clips_per_sec,
                "warm_clips_per_sec": warm_clips_per_sec,
                "train_metrics": train_metrics, "val_metrics": val_metrics})
        except Exception as e:                 # reference-parity resilience
            if not cfg.train.continue_on_epoch_error:
                raise
            logger.error(f"Error in epoch {epoch}: {e}")

    logger.info("Training completed!")
    ckpt_lib.save_checkpoint(os.path.join(out_dir, "final_model"),
                             state.model, cfg,
                             info={"epoch": cfg.train.num_epochs,
                                   "updates": state.optimizer.count})
    results.update(cfg=cfg, state=state, frontend=frontend,
                   pipeline=pipeline, source=source)
    return results
