"""Rank functions of tests/test_torch_parallel.py: each runs in a process of
its own, spawned with ``torch.multiprocessing`` and joined to a gloo group
through a ``FileStore`` (no port, so parallel test workers never collide).
Nothing here imports JAX; each rank saves what the test compares with
``torch.save`` into the test's directory."""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
from speech_transcript_embeddings_torch.training import loop
from speech_transcript_embeddings_torch.training import losses
from speech_transcript_embeddings_torch.training import train_step as ts


def _entry(rank, world, store, fn_name, args):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        getattr(sys.modules[__name__], fn_name)(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, world, fn_name, *args, timeout=240.0):
    """Run ``fn_name(rank, world, *args)`` in ``world`` gloo ranks; raise
    what a rank raised, or TimeoutError after ``timeout`` seconds."""
    store = os.path.join(str(tmp_path), f"store_{fn_name}_{time.time_ns()}")
    ctx = mp.start_processes(_entry, args=(world, store, fn_name, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join(10)
            raise TimeoutError(f"{fn_name} ranks still running after "
                               f"{timeout} s")
    assert not any(p.is_alive() for p in ctx.processes)


def _save(out, rank, obj):
    torch.save(obj, os.path.join(str(out), f"rank{rank}.pt"))


def _model(cfg, weights):
    model = DualEncoderModel(cfg.model, param_dtype=torch.float32)
    model.load_state_dict(weights)
    return model


def loss_rank(rank, world, out, cfg, tp, tn, au, align):
    """``global_info_nce(axis_name="data")`` on this rank's rows; the
    backward of the global loss (the mean of the ranks' losses)."""
    b = len(au) // world
    rows = slice(rank * b, (rank + 1) * b)
    x = {k: torch.from_numpy(v[rows]).requires_grad_()
         for k, v in (("tp", tp), ("tn", tn), ("au", au))}
    loss, aux = losses.global_info_nce(cfg, x["tp"], x["tn"], x["au"],
                                       torch.from_numpy(align[rows]),
                                       axis_name="data")
    (loss / world).backward()
    _save(out, rank, {"loss": loss.detach(), "s_pos": aux.s_pos.detach(),
                      **{f"grad_{k}": v.grad for k, v in x.items()}})


def step_rank(rank, world, out, cfg, weights, batches, total_steps):
    """The train step on this rank's rows of each global batch: the loss
    averaged over the ranks, the grad norm, and the trainable weights after
    the micro-steps."""
    state = ts.create_train_state(_model(cfg, weights), cfg, total_steps)
    frontend = make_frontend(cfg.model.frontend)
    mesh = mesh_lib.make_mesh(cfg)
    metrics = []
    for batch in batches:
        m = ts.train_step(cfg, state, frontend,
                          mesh_lib.shard_batch(mesh, batch), None)
        metrics.append({"loss": loop._global_mean({"l": m["loss"]}, 1)["l"],
                        "grad_norm": float(m["grad_norm"])})
    _save(out, rank, {"metrics": metrics, "count": state.optimizer.count,
                      "trainable": {k: p.detach().clone()
                                    for k, p in state.trainable.items()}})


def eval_rank(rank, world, out, cfg, weights, batch):
    """``eval_step`` on this rank's rows."""
    model = _model(cfg, weights).eval().requires_grad_(False)
    got = ts.eval_step(cfg, model, make_frontend(cfg.model.frontend),
                       mesh_lib.shard_batch(mesh_lib.make_mesh(cfg), batch))
    _save(out, rank, got)


def preempt_rank(rank, world, out, flags):
    _save(out, rank, {"agreed": loop.preempt_agreed(flags[rank])})


def _watch_writes(root, record):
    """Record every file this process opens for writing, creates, renames
    or removes under ``root`` (an audit hook: it sees every open, from
    torch.save, logging and matplotlib alike)."""
    root = os.path.abspath(root)
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def under(path):
        if isinstance(path, (str, bytes, os.PathLike)):
            return os.path.abspath(os.fsdecode(path)).startswith(root)
        return False

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (isinstance(mode, str) and any(c in mode for c in
                                                     "wax+")) or \
                (isinstance(flags, int) and flags & write_flags)
            if writing and under(path):
                record.append((event, os.fsdecode(path)))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "os.rmdir", "shutil.rmtree") and under(args[0]):
            record.append((event, os.fsdecode(args[0])))

    sys.addaudithook(hook)


def loop_rank(rank, world, out, cfg):
    """``run_experiment`` on the CPU: its results, this rank's final
    weights and the files this rank wrote under the run's directory."""
    writes = []
    _watch_writes(cfg.train.output_dir, writes)
    res = loop.run_experiment(cfg, device="cpu")
    _save(out, rank, {
        "preempted": res.get("preempted"), "writes": writes,
        "step_log": res["step_log"],
        "skipped": [e["skipped_batches"] for e in res["epochs"]],
        "weights": {k: v.clone() for k, v in
                    res["state"].model.state_dict().items()}
        if "state" in res else None})


def load(out, world):
    return [torch.load(os.path.join(str(out), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def unit(rng, shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
