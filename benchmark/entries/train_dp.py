"""The data-parallel train cells: the program's
``training/train_step.py::train_step`` on ``ranks`` cards of one host, one
process a card, each on its rows of the mix's global batches, the global
InfoNCE's transcript embeddings gathered over the ranks and the gradients
averaged (the port's own collectives: NCCL on cards, gloo on the CPU).

The process ``run.py`` starts is rank 0, on card 0. It starts ranks 1 … n−1
(``python -m benchmark.entries.train_dp <spec> <rank>``, card r) and joins
them in a process group at ``tcp://localhost:<free port>``. A rank that
exits with an error, or a rendezvous or collective that waits longer than
``TIMEOUT_S``, fails the whole run; a rank whose parent is gone exits. No
rank waits forever.

Each rank builds the training state of ``entries/train.py``'s ``Program``
from the same seed, over the whole cycle of global batches (``batch``
clips, all of one bucket) and keeps rows ``[r·b, (r+1)·b)`` of each, ``b
= batch / ranks``. Set-up runs the first three steps and the warm-up of
``entries/train.py`` on every rank. The window: every rank steps through the
cycle; after each step rank 0's clock decides, over a host (gloo)
all-reduce, whether another step follows; the window ends once every rank's
card has finished. ``train_clips_per_s`` is the global clips of every step
÷ rank 0's window. With ``--trace 1`` every rank steps on for the mix's
``trace_steps``, rank 0 under the profiler.

``correct``: the first three steps' loss, the mean over the ranks of their
local losses (each the mean over its rows of the InfoNCE against every
rank's transcripts), against the plain reference's single-card step on the
same global batch (``entries/train.py``'s readings: ``loss_gap`` and rank
0's ``change_gap`` after three steps; the gradient readings from rank 0's
AdamW ν, which holds the averaged gradient).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List

from benchmark import common, flops
from benchmark.entries import train

# the longest a rendezvous or a collective may wait for a rank
TIMEOUT_S = 300
POLL_S = 0.5
VARIANTS = (None, "drop_rank", "local_negatives")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watch(check, message: str, stop: threading.Event) -> None:
    """A daemon thread that ends the process (``os._exit``) when ``check()``
    turns true before ``stop`` is set; the NCCL or gloo call this process
    waits in cannot be interrupted otherwise."""
    def loop():
        while not stop.wait(POLL_S):
            bad = check()
            if bad:
                print(f"benchmark: {message}: {bad}", file=sys.stderr,
                      flush=True)
                os._exit(6)
    threading.Thread(target=loop, daemon=True).start()


def _apply_variant(variant, rank: int, world: int) -> List[tuple]:
    """A fault put into the program, for ``correct``'s check: ``drop_rank``
    leaves the last rank's gradients out of the mean (zeroed before the
    all-reduce); ``local_negatives`` scores each rank's clips against its
    own transcripts only. → what to put back (module, name, original)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    from speech_transcript_embeddings_torch.parallel import collectives
    from speech_transcript_embeddings_torch.training import losses
    if variant == "drop_rank" and rank == world - 1:
        mean = collectives.all_reduce_mean_

        def dropped(tensors, group=None):
            for t in tensors:
                t.zero_()
            mean(tensors, group)
        collectives.all_reduce_mean_ = dropped
        return [(collectives, "all_reduce_mean_", mean)]
    if variant == "local_negatives":
        compute = losses.compute_loss
        losses.compute_loss = lambda cfg, out, axis_name=None, group=None: \
            compute(cfg, out, None, None)
        return [(losses, "compute_loss", compute)]
    return []


class _RankContext:
    """What a rank other than 0 needs of a run's context."""

    def __init__(self, torch, device, seed: int, seconds: float,
                 trace: bool):
        self.torch, self.device, self.seed = torch, device, seed
        self.seconds, self.trace = seconds, trace


def _rank_rows(batch: dict, rank: int, rows: int) -> dict:
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def _steps(ctx, cell, rank: int, world: int, port: int, variant) -> dict:
    """One rank's part of the run (every rank runs it); → on rank 0 what
    ``train.run`` returns but the reference's readings, plus the first
    steps and their global batches."""
    torch, device = ctx.torch, ctx.device
    import torch.distributed as dist
    from speech_transcript_embeddings_torch.parallel import collectives
    phases = common.Phases()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    undo = _apply_variant(variant, rank, world)
    try:
        collectives.any_rank(False)            # the host group, made once
        phases.mark("rendezvous")
        prog = train.Program(torch, cell, ctx.seed, device)
        rows = cell.mix["batch"] // world
        whole = prog.pool
        firsts = prog.first_batches()
        at = [next(i for i, b in enumerate(whole) if b is f) for f in firsts]
        prog.pool = [_rank_rows(b, rank, rows) for b in whole]
        prog.ran_first = [prog.pool[i] for i in at]
        phases.mark("weights, model, batches")
        first = train.program_first_steps(torch, prog.state, prog.step,
                                          prog.ran_first)
        first["losses"] = collectives.mean_over_ranks(torch.tensor(
            first["losses"], device=device)).tolist()
        phases.mark("first steps")
        prog.warm()
        phases.mark("warm-up")
        if rank == 0:
            ctx.mark_setup()
            ctx.reset_peak()
        collectives.any_rank(False)
        ran = []
        t0 = time.perf_counter()
        while True:
            prog.next()
            ran.append((prog.at - 1) % len(prog.pool))
            if collectives.any_rank(
                    rank == 0 and time.perf_counter() - t0 >= ctx.seconds):
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        collectives.any_rank(False)            # every rank's card is done
        window_s = time.perf_counter() - t0
        out = {"ran": ran, "window_s": window_s}
        if rank == 0:
            out.update(host=ctx.host_load(window_s), peak=ctx.peak_memory())
        stretch = None
        if ctx.trace:
            if rank == 0:
                traced = []
                with ctx.stretch() as s:
                    for _ in range(cell.mix["trace_steps"]):
                        prog.next()
                        traced.append((prog.at - 1) % len(prog.pool))
                # the K3/K4 calls of rank 0's own rows
                stretch = {"window_s": s.window_s, "events": s.events,
                           "steps": len(traced),
                           "attention": [train._attention_calls(
                               cell.config, train._lens(prog.pool[i]))
                               for i in traced]}
            else:
                for _ in range(cell.mix["trace_steps"]):
                    prog.next()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            collectives.any_rank(False)
        out.update(stretch=stretch, first=first,
                   first_batches=[whole[i] for i in at], whole=whole,
                   phases=phases)
        del prog
        return out
    finally:
        for module, name, original in undo:
            setattr(module, name, original)
        dist.destroy_process_group()


def _spec_file(ctx, cell, port: int, variant) -> str:
    spec = {"cell": {k: getattr(cell, k) for k in (
        "name", "chips", "config", "mix", "limits", "end_to_end",
        "per_layer", "here")},
        "seed": ctx.seed, "seconds": ctx.seconds, "trace": ctx.trace,
        "device": ctx.device.type, "port": port, "variant": variant}
    fd, path = tempfile.mkstemp(prefix="benchmark_dp_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(spec, f)
    return path


def run(ctx, cell, variant=None) -> dict:
    torch = ctx.torch
    world = cell.mix["ranks"]
    port = _free_port()
    path = _spec_file(ctx, cell, port, variant)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [common.ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    children: List[subprocess.Popen] = [
        subprocess.Popen([sys.executable, "-m", "benchmark.entries.train_dp",
                          path, str(r)], cwd=common.ROOT, env=env)
        for r in range(1, world)]
    done = threading.Event()
    _watch(lambda: [(r + 1, c.returncode) for r, c in enumerate(children)
                    if c.poll() not in (None, 0)],
           "a rank failed (rank, exit code)", done)
    try:
        out = _steps(ctx, cell, 0, world, port, variant)
        for c in children:
            c.wait(timeout=TIMEOUT_S)
    finally:
        done.set()
        for c in children:
            if c.poll() is None:
                c.kill()
        os.unlink(path)
    phases = out["phases"]
    ran, window_s = out["ran"], out["window_s"]
    whole = out.pop("whole")
    clips = sum(whole[i]["waveform"].shape[0] for i in ran)
    per_batch = {i: flops.train_step(cell.config, train._lens(whole[i]),
                                     cell.mix["text_len"]) for i in set(ran)}
    del whole
    ctx.free()
    phases.skip()
    ref = train.reference_first_steps(torch, cell.config, ctx.seed,
                                      out["first_batches"], ctx.device)
    phases.mark("reference")
    numbers, worst = train.readings(out["first"], ref)
    return {
        "attempted": len(ran), "failed": 0,
        "end_to_end": {"train_clips_per_s": clips / window_s},
        "readings": numbers,
        "memory_peak_bytes": out["peak"],
        "window": {"seconds": window_s, "steps": len(ran), "clips": clips,
                   "model_flops": sum(per_batch[i] for i in ran)},
        "stretch": out["stretch"],
        "report": dict(worst, host=out["host"], ranks=world,
                       losses=out["first"]["losses"],
                       ref_losses=ref["losses"]),
        "notes": [phases.note()],
    }


def _child(path: str, rank: int) -> int:
    """Rank ``rank`` (≥ 1) of the run ``path`` describes."""
    with open(path) as f:
        spec = json.load(f)
    parent = os.getppid()
    _watch(lambda: os.getppid() != parent, "rank 0 is gone",
           threading.Event())
    import torch
    torch.set_num_threads(1)
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    cell = common.Cell(**spec["cell"])
    ctx = _RankContext(torch, device, spec["seed"], spec["seconds"],
                       spec["trace"])
    _steps(ctx, cell, rank, cell.mix["ranks"], spec["port"], spec["variant"])
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
