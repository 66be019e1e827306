"""Rank functions of tests/test_torch_parallel.py and
tests/test_torch_tensor_parallel.py: each runs in a process of its own,
spawned with ``torch.multiprocessing`` and joined to a gloo group through a
``FileStore`` (no port, so parallel test workers never collide). Nothing
here imports JAX; each rank saves what the test compares with
``torch.save`` into the test's directory."""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from speech_transcript_embeddings_torch.models import audio_encoder as tae
from speech_transcript_embeddings_torch.models import heads as theads
from speech_transcript_embeddings_torch.models import text_encoder as tte
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
    if res.get("active") is False:      # left outside a shrunk mesh
        _save(out, rank, {"active": False, "writes": writes})
        return
    _save(out, rank, {
        "preempted": res.get("preempted"), "writes": writes,
        "step_log": res["step_log"],
        "skipped": [e["skipped_batches"] for e in res["epochs"]],
        "weights": {k: v.clone() for k, v in
                    res["state"].model.state_dict().items()}
        if "state" in res else None})


# ---- tensor parallel --------------------------------------------------------

# each module's place in the dual encoder: its parameters' names there,
# which the sharding rule reads
TP_PREFIX = {"conformer_block": "audio_encoder.layer_0.",
             "text_encoder": "text_encoder.",
             "projection": "text_projection.",
             "cross_modal": "text_to_audio_attention.",
             "word_alignment": "word_level_alignment."}


def tp_module(name, spec, axis=None):
    """One of the modules tests/test_torch_tensor_parallel.py splits, fp32,
    on the model ``axis`` (None: whole)."""
    if name == "conformer_block":
        return tae.ConformerBlock(spec, torch.float32, axis=axis)
    if name == "text_encoder":
        return tte.TextEncoder(spec, torch.float32, axis=axis)
    if name == "projection":
        return theads.EnhancedProjection(*spec, axis=axis)
    if name == "cross_modal":
        return theads.CrossModalAttention(*spec, axis=axis)
    return theads.WordLevelAlignment(*spec, axis=axis)


def tp_call(name, module, inputs, masks):
    """The module's output on ``inputs`` (one tensor: the alignment head's
    three outputs flattened and joined)."""
    if name == "conformer_block":
        return module(inputs[0], masks[0])
    if name == "text_encoder":
        return module(masks[0], masks[1])
    if name == "projection":
        return module(inputs[0])
    if name == "cross_modal":
        return module(inputs[0], inputs[1], masks[0])
    outs = module(inputs[0], inputs[1], masks[0], masks[1])
    return torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)


def tp_module_rank(rank, world, out, cases):
    """Each case's module split over a model axis of every rank: forward
    on the same inputs, backward of ⟨output, cotangent⟩; the output, the
    inputs' gradients and this rank's shards' gradients."""
    axis = mesh_lib.ModelAxis(world, rank)
    got = {}
    for name, (spec, weights, inputs, masks, cot) in cases.items():
        module = tp_module(name, spec, axis)
        at = TP_PREFIX[name]
        module.load_state_dict({k: mesh_lib.shard_tensor(at + k, v, world,
                                                         rank)
                                for k, v in weights.items()})
        xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
        y = tp_call(name, module, xs,
                    [torch.from_numpy(m) for m in masks])
        torch.autograd.backward(y, torch.from_numpy(cot))
        got[name] = {"out": y.detach(), "inputs": [x.grad for x in xs],
                     "grads": {k: p.grad for k, p in
                               module.named_parameters()}}
    _save(out, rank, got)


def _tp_run(cfg, weights, batches, total_steps, dropout):
    """The train step on ``cfg``'s mesh from whole ``weights``: each
    micro-step's loss (the data axis's mean) and grad norm, and this rank's
    trainable shards after; None on a rank outside the mesh."""
    mesh = mesh_lib.make_mesh(cfg)
    if not mesh.active:
        return None
    model = DualEncoderModel(cfg.model, param_dtype=torch.float32,
                             axis=mesh.model_axis())
    model.load_state_dict(mesh_lib.shard_state(weights, mesh))
    state = ts.create_train_state(model, cfg, total_steps, mesh)
    frontend = make_frontend(cfg.model.frontend)
    gen = loop.dropout_generator(cfg.train.seed, torch.device("cpu"),
                                 mesh.data_index) if dropout else None
    metrics = []
    for batch in batches:
        m = ts.train_step(cfg, state, frontend,
                          mesh_lib.shard_batch(mesh, batch), gen)
        metrics.append({
            "loss": loop._global_mean({"l": m["loss"]}, 1,
                                      mesh.data_group)["l"],
            "grad_norm": float(m["grad_norm"])})
    return {"metrics": metrics, "count": state.optimizer.count,
            "data_index": mesh.data_index, "model_index": mesh.model_index,
            "trainable": {k: p.detach().clone()
                          for k, p in state.trainable.items()}}


def tp_step_rank(rank, world, out, cfgs, weights, batches, total_steps,
                 dropout):
    """``_tp_run`` for each config of ``cfgs`` in turn (every config's
    mesh over the same ranks)."""
    _save(out, rank, [_tp_run(cfg, weights, batches, total_steps, dropout)
                      for cfg in cfgs])


def eval_load_rank(rank, world, out, cfg, path, batch):
    """``checkpoints.load_checkpoint`` of ``path`` on ``cfg``'s mesh (the
    test phase's eval model): this rank's state and both embeddings of
    ``batch``."""
    from speech_transcript_embeddings_torch import checkpoints
    mesh = mesh_lib.make_mesh(cfg)
    _, model = checkpoints.load_checkpoint(path, "cpu", mesh)
    features, amask = make_frontend(cfg.model.frontend)(
        batch["waveform"], batch["num_samples"])
    with torch.no_grad():
        text, _ = model.encode_text(batch["input_ids_pos"],
                                    batch["attention_mask_pos"])
        audio, _ = model.encode_audio(features, amask)
    _save(out, rank, {"state": model.state_dict(), "text": text,
                      "audio": audio})


def load(out, world):
    return [torch.load(os.path.join(str(out), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def unit(rng, shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
