"""The experiment: epochs, evaluation, checkpoints, artifacts.

Port of ``speech_transcript_embeddings_tpu/training/loop.py``: set-up and
logging, the exact LR-schedule accounting, resume from ``latest`` (weights,
optimizer state, the validation history and the best-so-far trackers),
SIGTERM preemption with a mid-epoch ``latest`` and a resume that skips the
batches already trained, the epoch loop over ``DataPipeline.epoch_batches``
with host prefetch, validation each epoch, the ``latest``, best-loss,
best-gap, periodic and final checkpoints, the plots, the test phase over
both best checkpoints (``test_metrics.json`` in the reference's schema)
and the retrieval phase on independent embeddings
(``retrieval_metrics.json``). The data pipeline, the sources, the
tokenizers and the artifact helpers are the port's copies of the JAX
package's (``speech_transcript_embeddings_torch.data``). Each micro-step's
loss stays on the device with a CUDA event after it; both are read once
the epoch has synced, so the step log adds no host sync to the batch loop.
The dropout generator restarts from ``seed + 17`` in every process, as the
JAX loop's key does.

The mesh (``parallel/``): under a process group every rank runs this loop
on its data index's rows of each global batch (``shard_batch`` in the
prefetch thread) with its data index's dropout stream (``seed + 17 +
RANK_STREAM·data_index``: the ranks of a data row, which hold one model's
shards, draw the same masks), and takes the data-parallel path at every
world size, one included. With ``mesh.num_model`` > 1 (tensor parallel)
each rank holds its shards of the model and of the optimizer state. The
step log's losses and metrics are reduced to global means over the data
axis at the syncs the loop already has (the ``log_every_batches`` cadence,
the end of an epoch), the evaluation's sums over the data axis and its
cosines and embeddings gathered, so every metric covers the whole split.
The preemption is agreed after every batch over the mesh's ranks
(``preempt_agreed``, over host memory: no device sync), so every rank
enters the mid-epoch save at the same batch, one micro-step after a SIGTERM
at most. Rank 0 writes every file (checkpoints, in the one-process layout,
plots, ``config.json``, ``training.log``, the metrics JSON); every rank
restores ``latest`` onto its own device and skips the same batches. Ranks
that a shrunk mesh leaves out log it and return without training.
"""

from __future__ import annotations

import functools
import itertools
import json
import logging
import math
import os
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.data import (
    DataPipeline, artifacts, make_source, prefetch, resolve_tokenizer,
)
from speech_transcript_embeddings_torch.inference.embed import (
    resolve_device, retrieval_metrics,
)
from speech_transcript_embeddings_torch.models.dual_encoder import (
    init_model, l2_normalize,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.parallel import collectives
from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
from speech_transcript_embeddings_torch.training.train_step import (
    _to_device, create_train_state, eval_step, train_step,
)

# set by the SIGTERM handler or request_preemption(): the batch loop saves
# ``latest`` with mid-epoch resume metadata at the next batch boundary and
# returns
_PREEMPT = threading.Event()

# the distance between two ranks' dropout seeds: rank 0 keeps seed + 17
RANK_STREAM = 1_000_003


def request_preemption(signum=None, frame=None) -> None:
    """Ask the running experiment to checkpoint and return at the next
    batch boundary. ``run_experiment`` installs it as the SIGTERM handler;
    safe to call from any thread."""
    _PREEMPT.set()


def preempt_agreed(local: bool, host_group=None) -> bool:
    """The preemption decision of the mesh's ranks (``host_group``; None:
    every rank): True on every rank when any rank's flag is set
    (``any_rank``), since the mid-epoch save is a collective that every
    rank must enter at the same batch. Called after every batch on every
    rank. One process: the local flag."""
    return collectives.any_rank(local, host_group)


def dropout_generator(seed: int, device: torch.device,
                      data_index: int = 0) -> torch.Generator:
    """The dropout and SpecAugment generator of a run: ``seed + 17`` (the
    JAX loop's key) at data index 0, a stream of its own at every other
    one, so that data ranks do not draw the same masks for different rows
    and the model ranks of one data row draw the same."""
    return torch.Generator(device).manual_seed(seed + 17
                                               + RANK_STREAM * data_index)


def check_supported(cfg: ExperimentConfig, device: torch.device
                    ) -> mesh_lib.Mesh:
    """Raise for the fields this loop cannot honour without changing the
    result of the run; → the run's mesh (``make_mesh``: a mesh larger than
    the process group, or a ``mesh.num_model`` that does not divide it,
    raises)."""
    latest = os.path.join(cfg.train.output_dir, "latest")
    if cfg.train.resume and ckpt_lib.checkpoint_exists(latest):
        meta = ckpt_lib.load_metadata(latest)
        if meta.get("kind") != ckpt_lib.KIND or meta.get("params_only", True):
            raise ValueError(
                f"{latest} cannot be resumed: kind {meta.get('kind')!r}, "
                f"params_only {meta.get('params_only')!r} (resume needs the "
                f"port's full training checkpoint); use a fresh "
                "train.output_dir or train.resume=false")
    if cfg.train.init_checkpoint:
        kind = ckpt_lib.load_metadata(cfg.train.init_checkpoint).get("kind")
        if kind != ckpt_lib.KIND:
            raise NotImplementedError(
                f"train.init_checkpoint {cfg.train.init_checkpoint}: kind "
                f"{kind!r}; this loop initialises from {ckpt_lib.KIND!r} "
                "checkpoints only: convert HF encoders or a reference *.pt "
                "with speech_transcript_embeddings_torch.convert_checkpoint, "
                "and a JAX package (orbax) checkpoint with bridge.py")
    return mesh_lib.make_mesh(cfg)


def _gather_batches(parts, group=None) -> np.ndarray:
    """This rank's per-batch rows (device tensors of one length) → every
    data rank's (``group``), on the host, in the order of the global
    batches: one collective."""
    local = torch.cat(parts)
    n = collectives.world_size(group)
    rows = collectives.gather_host(local, group)
    # [rank, batch, row] → [batch, rank, row]: the global batches' order
    return rows.reshape((n, len(parts), -1) + rows.shape[1:]).swapaxes(
        0, 1).reshape((-1,) + rows.shape[1:])


def evaluate(cfg, model, frontend, pipeline, source, split: str, epoch: int,
             logger, mesh: mesh_lib.Mesh = mesh_lib.Mesh()
             ) -> Tuple[Dict[str, float], np.ndarray, np.ndarray, int]:
    """→ (metrics, raw clean cosines, raw corrupt cosines, batches), over
    the whole split: under data parallel the sums are summed over the
    data axis and the cosines gathered."""
    sums = []
    group = mesh.data_group
    for batch in prefetch(map(functools.partial(mesh_lib.shard_batch, mesh),
                              pipeline.epoch_batches(source, split, epoch)),
                          2):
        sums.append(eval_step(cfg, model, frontend, batch, mesh))
    if not sums:
        logger.warning(f"No valid samples were processed during {split} "
                       "evaluation")
        zero = {k: 0.0 for k in ("loss", "avg_similarity", "median_similarity",
                                 "std_similarity", "clean_similarity",
                                 "corrupt_similarity", "similarity_gap")}
        return zero, np.array([]), np.array([]), 0
    loss_sum, pairwise_sum, count = collectives.sum_over_ranks(torch.stack([
        sum(o[k] for o in sums) for k in ("loss_sum", "pairwise_loss_sum",
                                          "count")]), group).tolist()
    masks = _gather_batches([o["example_mask"] for o in sums],
                            group).astype(bool)
    s_pos = _gather_batches([o["s_pos"] for o in sums], group)[masks]
    s_neg = _gather_batches([o["s_neg"] for o in sums], group)[masks]
    t = cfg.loss.temperature
    clean_hr = 1.0 / (1.0 + np.exp(-s_pos / t))
    corrupt_hr = 1.0 / (1.0 + np.exp(-s_neg / t))
    metrics = artifacts.eval_metrics_dict(loss_sum / max(count, 1.0),
                                          clean_hr, corrupt_hr)
    if cfg.loss.kind == "global":
        metrics["pairwise_loss"] = pairwise_sum / max(count, 1.0)
    logger.info(f"{split} metrics:")
    logger.info(f"  Loss: {metrics['loss']:.4f}")
    logger.info(f"  Average similarity: {metrics['avg_similarity']:.4f}")
    logger.info(f"  Median similarity: {metrics['median_similarity']:.4f}")
    logger.info(f"  Clean sample similarity: {metrics['clean_similarity']:.4f}")
    logger.info(f"  Corrupted sample similarity: "
                f"{metrics['corrupt_similarity']:.4f}")
    logger.info(f"  Similarity gap (clean - corrupt): "
                f"{metrics['similarity_gap']:.4f}")
    return metrics, s_pos, s_neg, len(sums)


@torch.no_grad()
def compute_retrieval(model, frontend, pipeline, source, split: str = "test",
                      mesh: mesh_lib.Mesh = mesh_lib.Mesh()
                      ) -> Tuple[Dict[str, float], int]:
    """Speech→text Recall@K over a split on *independent* embeddings
    (encoder → pooling → projection, no cross-modal fusion: fused
    embeddings depend on the pair and cannot rank). Under data parallel
    each rank embeds its rows and the embeddings are gathered, so every
    rank ranks the whole split. → (metrics, batches)."""
    device = next(model.parameters()).device
    text_embs, audio_embs, keeps = [], [], []
    for batch in map(functools.partial(mesh_lib.shard_batch, mesh),
                     pipeline.epoch_batches(source, split, epoch=0)):
        features, amask = frontend(_to_device(batch["waveform"], device),
                                   _to_device(batch["num_samples"], device))
        te, _ = model.encode_text(_to_device(batch["input_ids_pos"], device),
                                  _to_device(batch["attention_mask_pos"],
                                             device))
        ae, _ = model.encode_audio(features, amask)
        keeps.append(_to_device(batch["example_mask"], device))
        text_embs.append(l2_normalize(te))
        audio_embs.append(l2_normalize(ae))
    if not text_embs:
        return {}, 0
    group = mesh.data_group
    keep = _gather_batches(keeps, group).astype(bool)
    return retrieval_metrics(_gather_batches(audio_embs, group)[keep],
                             _gather_batches(text_embs, group)[keep]), \
        len(text_embs)


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


def _gib(fn, device: torch.device):
    """``fn(device)`` in GiB on a card (memory_allocated or
    max_memory_allocated), None on the CPU."""
    return fn(device) / 2 ** 30 if device.type == "cuda" else None


def run_experiment(cfg: ExperimentConfig, device="cuda", source=None,
                   tokenizer=None, logger=None) -> dict:
    """Train, validate, checkpoint, test. Owns the SIGTERM handler for the
    run (``train.preempt_checkpoint``; main thread only) and always puts
    the previous one back, so a library caller's process stays killable."""
    import signal
    installed, prev = False, None
    if cfg.train.preempt_checkpoint and \
            threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM, request_preemption)
        installed = True
    _PREEMPT.clear()
    try:
        return _run_experiment(cfg, device, source, tokenizer, logger)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev)


def _rank_logger(rank: int) -> logging.Logger:
    """The logger of a rank other than 0, which writes no file: its
    warnings and errors go to the console."""
    logger = logging.getLogger(f"ste_torch.rank{rank}")
    logger.setLevel(logging.WARNING)
    logger.propagate = False
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(
            f"rank {rank} %(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(console)
    return logger


def _run_experiment(cfg: ExperimentConfig, device, source, tokenizer,
                    logger) -> dict:
    device = resolve_device(device)
    mesh = check_supported(cfg, device)
    if not mesh.active:
        logging.getLogger(__name__).warning(
            f"rank {mesh.rank} is outside the mesh (data={mesh.data} × "
            f"model={mesh.model} runs on ranks 0-"
            f"{mesh.data * mesh.model - 1}): it does not train")
        return {"active": False, "mesh": mesh}
    writer = mesh.rank == 0          # the one rank that writes files
    if collectives.initialized() and device.type == "cuda":
        # the launcher's card, before the first collective binds NCCL to it
        if device.index not in (None, mesh.local_rank):
            raise ValueError(
                f"device={device} but this rank's LOCAL_RANK is "
                f"{mesh.local_rank}: pass device=cuda, and each rank takes "
                "the card of its LOCAL_RANK")
        device = torch.device("cuda", mesh.local_rank)
        torch.cuda.set_device(device)
    out_dir = cfg.train.output_dir
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        logger = logger or artifacts.setup_run_logging(out_dir)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    else:
        logger = logger or _rank_logger(mesh.rank)
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
    logger.info("Training with parameters:")
    logger.info(f"  Freeze mode: {cfg.freeze.mode}")
    logger.info(f"  Text layers to unfreeze: {cfg.freeze.text_layers_to_unfreeze}")
    logger.info(f"  Audio layers to unfreeze: {cfg.freeze.audio_layers_to_unfreeze}")
    logger.info(f"  Loss kind: {cfg.loss.kind}")
    logger.info(f"  Batch size: {cfg.data.batch_size}")
    logger.info(f"  Gradient accumulation steps: {cfg.train.accumulation_steps}")
    logger.info(f"  Effective batch size: "
                f"{cfg.data.batch_size * cfg.train.accumulation_steps}")
    logger.info(f"  Learning rate: {cfg.optimizer.learning_rate}")
    logger.info(f"  Temperature: {cfg.loss.temperature}")
    logger.info(f"  Projection dimension: {cfg.model.heads.projection_dim}")
    logger.info(f"  Training samples: {source.num_examples('train')}")
    logger.info(f"  Validation samples: {source.num_examples('validation')}")
    logger.info(f"  Test samples: {source.num_examples('test')}")
    if mesh.note:
        logger.warning(mesh.note)
    if collectives.initialized():
        world = collectives.world_size()
        off, per = mesh_lib.host_batch_slice(cfg.data.batch_size, mesh)
        logger.info(
            f"Mesh: data={mesh.data} × model={mesh.model} on ranks 0-"
            f"{mesh.data * mesh.model - 1} of {world}"
            + (f" (ranks {mesh.data * mesh.model}-{world - 1} do not "
               "train)" if mesh.data * mesh.model < world else ""))
        logger.info(
            f"Data parallel: {mesh.data} rank(s) over "
            f"{torch.distributed.get_backend()}; rank {mesh.rank} feeds rows "
            f"[{off}:{off + per}] of each global batch; gradients averaged "
            f"every micro-step; preemption agreed every batch")
        if mesh.model > 1:
            logger.info(
                f"Tensor parallel: {mesh.model} rank(s) a data row over "
                f"{torch.distributed.get_backend()}; each holds its shard of "
                "the split parameters and of their optimizer state")

    model = init_model(cfg.model, torch.Generator(device).manual_seed(
        cfg.train.seed), device, train=True, axis=mesh.model_axis())
    if cfg.train.init_checkpoint:
        logger.info(f"Initializing params from {cfg.train.init_checkpoint}")
        ckpt_lib.load_into(cfg.train.init_checkpoint, model, mesh)

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
    state = create_train_state(model, cfg, total_steps, mesh)
    # the whole model's counts (a rank's shards hold fewer under TP)
    shapes = model.full_shapes()
    n_param = sum(math.prod(s) for s in shapes.values())
    n_train = sum(math.prod(shapes[k]) for k in state.trainable)
    logger.info(f"Model initialized with {n_train:,} trainable parameters "
                f"out of {n_param:,} total")
    logger.info(f"Scheduler: {batches_per_epoch} batches/epoch, "
                f"{steps_per_epoch} optimizer steps/epoch, {total_steps} "
                f"total, {cfg.optimizer.warmup_steps} warmup")
    frontend = make_frontend(cfg.model.frontend).to(device)
    results: dict = {"n_params": n_param, "n_trainable": n_train,
                     "step_log": [], "epochs": [], "saves": []}

    def save(name, epoch, metrics, params_only=False):
        t0 = time.perf_counter()
        size = ckpt_lib.save_checkpoint(os.path.join(out_dir, name), state,
                                        cfg, epoch, metrics, params_only)
        secs = time.perf_counter() - t0
        if writer:
            results["saves"].append({"name": name, "bytes": size,
                                     "seconds": secs})
            logger.info(f"Saved {name}: {size / 2 ** 20:.1f} MiB in "
                        f"{secs:.1f} s")

    start_epoch, skip = 1, 0
    best_val_loss, best_gap = float("inf"), 0.0
    clean_history, corrupt_history = [], []
    latest_path = os.path.join(out_dir, "latest")
    if cfg.train.resume and ckpt_lib.checkpoint_exists(latest_path):
        meta = ckpt_lib.load_metadata(latest_path)
        ckpt_lib.restore_checkpoint(latest_path, state)
        start_epoch = meta["epoch"] + 1
        hist = meta["metrics"].get("val_history")
        if hist:
            clean_history = [float(v) for v in hist["clean"]]
            corrupt_history = [float(v) for v in hist["corrupt"]]
        mid = meta["metrics"].get("mid_epoch")
        if mid:
            # the epoch stream is deterministic per (seed, epoch): skipping
            # the batches already trained is exact
            skip = int(mid["batches_done"])
            logger.info(f"Resumed mid-epoch from {latest_path}: epoch "
                        f"{start_epoch}, skipping the first {skip} "
                        f"already-trained batches")
        else:
            logger.info(f"Resumed from {latest_path} at epoch {meta['epoch']}")
        # the best-so-far trackers: else the first epoch after the resume
        # would overwrite the best checkpoints with a worse model
        for kind in ("best_model_loss", "best_model_gap"):
            p = os.path.join(out_dir, kind)
            if ckpt_lib.checkpoint_exists(p):
                vm = ckpt_lib.load_metadata(p).get("metrics", {}).get(
                    "val_metrics", {})
                if kind == "best_model_loss" and "loss" in vm:
                    best_val_loss = float(vm["loss"])
                elif kind == "best_model_gap" and "similarity_gap" in vm:
                    best_gap = float(vm["similarity_gap"])

    if cfg.train.validate_gradients and cfg.train.accumulation_steps > 1:
        from speech_transcript_embeddings_torch.training import diagnostics
        probe = []
        for b in pipeline.epoch_batches(source, "train", epoch=0):
            if probe and b["waveform"].shape != probe[0]["waveform"].shape:
                continue
            probe.append(b)
            if len(probe) >= min(cfg.train.accumulation_steps, 4):
                break
        results["gradient_check"] = diagnostics.validate_gradient_accumulation(
            cfg, state, frontend, probe)

    generator = dropout_generator(cfg.train.seed, device, mesh.data_index)
    # under a process group every rank must agree to preempt
    agreed = cfg.train.preempt_checkpoint and collectives.initialized()
    for epoch in range(start_epoch, cfg.train.num_epochs + 1):
        try:
            t0 = time.perf_counter()
            start = _mark(device)
            acc = None
            n_batches = 0
            steps = []      # (samples, loss on the device, mark) per step
            offset = skip if epoch == start_epoch else 0
            batches = prefetch(map(
                functools.partial(mesh_lib.shard_batch, mesh),
                itertools.islice(pipeline.epoch_batches(source, "train",
                                                        epoch), offset, None)),
                cfg.train.prefetch_batches)
            prof = None     # the profiler while it traces
            for batch in batches:
                if (cfg.train.profile_dir and epoch == start_epoch
                        and n_batches == 2 and writer):
                    prof = _start_profiler(device)
                metrics = train_step(cfg, state, frontend, batch, generator)
                acc = metrics if acc is None else {
                    k: acc[k] + v for k, v in metrics.items()}
                steps.append((int(batch["waveform"].shape[1]),
                              metrics["loss"], _mark(device)))
                inject_at = cfg.train.fault_inject_preempt_at
                if (inject_at is not None and epoch == start_epoch
                        and n_batches + 1 >= inject_at):
                    request_preemption()
                if agreed:
                    # every rank reaches this batch: a matched collective
                    stop = preempt_agreed(_PREEMPT.is_set(), mesh.host_group)
                else:
                    stop = cfg.train.preempt_checkpoint and _PREEMPT.is_set()
                if stop:
                    if prof is not None:
                        _stop_profiler(prof, cfg, logger)
                    batches.close()      # stop the prefetch thread
                    done = offset + n_batches + 1
                    _sync(device)
                    results["step_log"] += _step_log(epoch, offset, start,
                                                     steps, mesh.data_group)
                    logger.info(f"Preemption requested: checkpointing "
                                f"{latest_path} mid-epoch (epoch {epoch}, "
                                f"{done} batches done) and exiting")
                    save("latest", epoch - 1,
                         {"mid_epoch": {"epoch": epoch, "batches_done": done},
                          "val_history": {"clean": clean_history,
                                          "corrupt": corrupt_history}})
                    results["preempted"] = {"epoch": epoch,
                                            "batches_done": done}
                    return results
                n_batches += 1
                if prof is not None and \
                        n_batches >= 2 + cfg.train.profile_steps:
                    _stop_profiler(prof, cfg, logger)
                    prof = None
                if n_batches % cfg.train.log_every_batches == 0:
                    # the only host sync in the batch loop
                    a = _global_mean(acc, n_batches, mesh.data_group)
                    mem = _gib(torch.cuda.memory_allocated, device)
                    logger.info(
                        f"Epoch {epoch} batch {n_batches}: "
                        f"loss={a['loss']:.4f} clean={a['clean_hr']:.3f} "
                        f"corrupt={a['corrupt_hr']:.3f} "
                        f"gap={a['clean_hr'] - a['corrupt_hr']:.3f} "
                        f"grad_norm={a['grad_norm']:.3g}"
                        + (f" mem={mem:.2f}GiB" if mem is not None else ""))
                    # the JAX loop's thresholds: > 100 → lower the LR,
                    # < 1e-8 → gradients may be vanishing
                    if a["grad_norm"] > 100.0:
                        logger.warning(
                            f"Mean gradient norm {a['grad_norm']:.1f} > 100 "
                            "— consider lowering the learning rate")
                    elif 0.0 < a["grad_norm"] < 1e-8:
                        logger.warning(
                            f"Mean gradient norm {a['grad_norm']:.3g} < 1e-8 "
                            "— gradients may be vanishing")
            if prof is not None:
                _stop_profiler(prof, cfg, logger)
            _sync(device)
            train_time = time.perf_counter() - t0
            results["step_log"] += _step_log(epoch, offset, start, steps,
                                             mesh.data_group)
            # from the end of the first micro-step to the end of the last
            warm_clips_per_sec = (
                (n_batches - 1) * cfg.data.batch_size
                / max(_seconds(steps[0][2], steps[-1][2]), 1e-9)
                if n_batches > 1 else 0.0)
            n = max(n_batches, 1)
            a = (_global_mean(acc, n, mesh.data_group) if acc is not None
                 else {"loss": 0.0, "clean_hr": 0.0, "corrupt_hr": 0.0,
                       "grad_norm": 0.0})
            train_metrics = {
                "loss": a["loss"], "clean_similarity": a["clean_hr"],
                "corrupt_similarity": a["corrupt_hr"],
                "similarity_gap": a["clean_hr"] - a["corrupt_hr"],
                "grad_norm": a["grad_norm"]}
            if offset + n_batches != batches_per_epoch:
                logger.info(f"Epoch {epoch}: {offset + n_batches} train "
                            f"batches (scheduler assumed {batches_per_epoch})")
            clips_per_sec = n_batches * cfg.data.batch_size / max(
                train_time, 1e-9)
            peak = _gib(torch.cuda.max_memory_allocated, device)
            val_metrics, val_s_pos, val_s_neg, n_eval = evaluate(
                cfg, state.model, frontend, pipeline, source, "validation",
                epoch, logger, mesh)
            clean_history.append(val_metrics["clean_similarity"])
            corrupt_history.append(val_metrics["corrupt_similarity"])
            logger.info(
                f"Epoch {epoch}/{cfg.train.num_epochs} - "
                f"Train Loss: {train_metrics['loss']:.4f}, "
                f"Val Loss: {val_metrics['loss']:.4f}, "
                f"Clean Sim: {val_metrics['clean_similarity']:.4f}, "
                f"Corrupt Sim: {val_metrics['corrupt_similarity']:.4f}, "
                f"Gap: {val_metrics['similarity_gap']:.4f}, "
                f"Time: {time.perf_counter() - t0:.2f}s "
                f"({clips_per_sec:.2f} clips/s train, "
                f"{warm_clips_per_sec:.2f} after the first step)"
                + (f", peak_mem={peak:.2f}GiB" if peak is not None else ""))
            results["epochs"].append({
                "epoch": epoch, "train_batches": n_batches,
                "skipped_batches": offset, "eval_batches": n_eval,
                "train_seconds": train_time, "clips_per_sec": clips_per_sec,
                "warm_clips_per_sec": warm_clips_per_sec,
                "peak_mem_gib": peak, "train_metrics": train_metrics,
                "val_metrics": val_metrics})

            meta = {"train_metrics": train_metrics, "val_metrics": val_metrics,
                    "clips_per_sec": clips_per_sec,
                    # best-loss selection uses the training objective
                    "best_loss_objective": cfg.loss.kind,
                    # restored on resume, so the progress plot covers the
                    # whole run
                    "val_history": {"clean": clean_history,
                                    "corrupt": corrupt_history}}
            save("latest", epoch, meta)
            # best and final checkpoints are params-only: they are only
            # evaluated or served (resume uses latest)
            if val_metrics["loss"] < best_val_loss:
                best_val_loss = val_metrics["loss"]
                logger.info(f"New best validation loss: {best_val_loss:.4f}")
                save("best_model_loss", epoch, meta, params_only=True)
            if val_metrics["similarity_gap"] > best_gap:
                best_gap = val_metrics["similarity_gap"]
                logger.info(f"New best similarity gap: {best_gap:.4f}")
                save("best_model_gap", epoch, meta, params_only=True)
            if cfg.train.save_every and epoch % cfg.train.save_every == 0:
                save(f"checkpoint_epoch_{epoch}", epoch, meta)
            if writer and (epoch % cfg.train.plot_every == 0
                           or epoch == cfg.train.num_epochs):
                artifacts.plot_similarity_distributions(
                    val_s_pos, val_s_neg,
                    os.path.join(out_dir, f"similarity_dist_epoch_{epoch}.png"))
                artifacts.plot_progress(
                    clean_history, corrupt_history,
                    os.path.join(out_dir, "clean_corrupt_progress.png"))
        except Exception as e:                 # reference-parity resilience
            if not cfg.train.continue_on_epoch_error:
                raise
            logger.error(f"Error in epoch {epoch}: {e}")

    logger.info("Training completed!")
    save("final_model", cfg.train.num_epochs, {}, params_only=True)
    # the test phase needs parameters only; each best checkpoint is loaded
    # into its own eval model (serving storage: the same values the training
    # form computes with; a rank's shards under tensor parallel), one at a
    # time
    state.optimizer.drop_moments()
    test_results: Dict[str, dict] = {}
    test_batches = 0
    for kind, name in (("best_model_loss", "Best Loss"),
                       ("best_model_gap", "Best Gap")):
        path = os.path.join(out_dir, kind)
        if not ckpt_lib.checkpoint_exists(path):
            logger.warning(f"{name} model not found")
            continue
        _, eval_model = ckpt_lib.load_checkpoint(path, device, mesh)
        logger.info(f"Loaded {name.lower()} model from epoch "
                    f"{ckpt_lib.load_metadata(path)['epoch']}")
        metrics, s_pos, s_neg, n = evaluate(
            cfg, eval_model, frontend, pipeline, source, "test",
            cfg.train.num_epochs + 1, logger, mesh)
        del eval_model
        test_batches += n
        test_results[f"{kind.replace('best_model', 'best')}_model"] = metrics
        if writer:
            artifacts.plot_similarity_distributions(s_pos, s_neg, os.path.join(
                out_dir,
                f"test_similarity_dist_{kind.replace('model_', '')}.png"))
    if writer:
        artifacts.write_test_metrics(out_dir, test_results)
    results["test_batches"] = test_batches

    # speech→text retrieval on the test split with the best-gap (else
    # best-loss) model, in a file of its own so test_metrics.json keeps the
    # reference's schema
    best_kind = ("best_model_gap" if ckpt_lib.checkpoint_exists(
        os.path.join(out_dir, "best_model_gap")) else "best_model_loss")
    if ckpt_lib.checkpoint_exists(os.path.join(out_dir, best_kind)):
        _, eval_model = ckpt_lib.load_checkpoint(
            os.path.join(out_dir, best_kind), device, mesh)
        retrieval, results["retrieval_batches"] = compute_retrieval(
            eval_model, frontend, pipeline, source, "test", mesh)
        del eval_model
        if writer:
            with open(os.path.join(out_dir, "retrieval_metrics.json"),
                      "w") as f:
                json.dump({best_kind: retrieval}, f, indent=2)
        logger.info(f"Retrieval ({best_kind}): " + ", ".join(
            f"{k}={v:.4f}" for k, v in retrieval.items()))
        results["retrieval"] = retrieval
    logger.info("Evaluation completed!")
    for model_name, metrics in test_results.items():
        logger.info(f"Test results for {model_name}:")
        logger.info(f"  Loss: {metrics['loss']:.4f}")
        logger.info(f"  Clean Sample Similarity: "
                    f"{metrics['clean_similarity']:.4f}")
        logger.info(f"  Corrupted Sample Similarity: "
                    f"{metrics['corrupt_similarity']:.4f}")
        logger.info(f"  Similarity Gap: {metrics['similarity_gap']:.4f}")
    results.update(test_metrics=test_results, cfg=cfg, state=state,
                   frontend=frontend, pipeline=pipeline, source=source,
                   val_history={"clean": clean_history,
                                "corrupt": corrupt_history})
    return results


def _global_mean(acc: dict, n: int, group=None) -> dict:
    """Each metric summed over ``n`` micro-steps → its mean, averaged over
    the data axis (``group``) under a process group (one collective)."""
    values = list(acc.values())
    if collectives.initialized():
        values = collectives.mean_over_ranks(torch.stack(values),
                                             group).tolist()
    return {k: float(v) / n for k, v in zip(acc, values)}


def _step_log(epoch, offset, start, steps, group=None):
    """The epoch's step-log entries (after a device sync); each loss the
    mean over the data axis (``group``) under a process group (one
    collective)."""
    losses = [loss for _, loss, _ in steps]
    if collectives.initialized() and steps:
        losses = collectives.mean_over_ranks(torch.stack(losses),
                                             group).tolist()
    return [{"epoch": epoch, "batch": offset + i + 1, "samples": samples,
             "loss": float(loss), "t": _seconds(start, mark)}
            for i, ((samples, _, mark), loss) in enumerate(zip(steps,
                                                               losses))]


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, cfg, logger) -> None:
    """Stop the trace and write it as a Chrome trace into
    ``train.profile_dir``."""
    prof.stop()
    os.makedirs(cfg.train.profile_dir, exist_ok=True)
    path = os.path.join(cfg.train.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"Profiler trace written to {path}")
