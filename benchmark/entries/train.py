"""The train cells: the program's ``training/train_step.py::train_step`` on
device-resident batches of the mix, one distinct batch a step through the
mix's cycle.

Set-up builds one training state (the model holding the benchmark's
weights, the optimizer), drives it through its first three steps
(``Program.first_batches``: the cycle's first batch of each bucket, the
rarest bucket first, then the cycle's next batches) and reads what
``correct`` compares: each step's loss, each trainable leaf's first
gradient as the optimizer took it (from AdamW's ν after one step:
``‖g‖ = √(Σν / (1 − β₂))``) and each leaf's change after the three steps.
It then steps on until every bucket has run twice, and hands the same
state to the window.

The window steps through the cycle from its start until ``--seconds`` have passed on the
host clock, then waits for the device: ``train_clips_per_s`` is the clips
of every step issued ÷ the window's seconds. With ``--trace 1`` the cycle
goes on for the mix's ``trace_steps`` under the profiler.

After the window (and the peak memory read), the program's state is freed
and the reference (``reference/model.py``, fp32) follows the same three
steps from the same weights.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List

from benchmark import common, flops, traffic
from benchmark.reference import model as ref_model
from benchmark.weights import make_weights

FIRST_STEPS = 3
# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves under Adam by round-off alone: it is left out
ROUNDOFF_LEAF = 1e-3


def leaf_norms(tensors: Dict) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def program_first_steps(torch, state, step: Callable, batches: List
                        ) -> Dict[str, object]:
    """The first steps of a fresh training state on ``batches``: → losses,
    first gradients and changes by leaf. A leaf's first gradient is worked
    out from AdamW's ν after one step (``‖g‖ = √(Σν / (1 − β₂))``, the
    gradient as clipped) and the step's global norm before the clip."""
    start = {k: p.detach().float().clone() for k, p in state.trainable.items()}
    c = state.optimizer.cfg
    losses, grads = [], None
    for i, batch in enumerate(batches):
        out = step(batch)
        losses.append(float(out["loss"]))
        if i == 0:
            unclip = max(1.0, float(out["grad_norm"]) / c.max_grad_norm)
            grads = {k: float(torch.sqrt(nu.sum() / (1 - c.b2))) * unclip
                     for k, nu in state.optimizer.nu.items()}
    change = {k: float((p.detach().float() - start[k]).norm())
              for k, p in state.trainable.items()}
    return {"losses": losses, "grads": grads, "change": change}


def reference_first_steps(torch, config: dict, seed: int, batches: List,
                          device, precision: str = "fp32"
                          ) -> Dict[str, object]:
    """The reference's first steps from the same weights: → losses, first
    gradients (before the clip) and changes by leaf."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = make_weights(config, seed, device)
    names = ref_model.trainable_names(config["model"], config["freeze"])
    params = {k: weights[k].clone().requires_grad_(True) for k in names}
    start = {k: p.detach().clone() for k, p in params.items()}
    weights.update(params)
    ref = ref_model.Reference(config["model"], weights, precision)
    opt = ref_model.AdamW(config["optimizer"], config["freeze"],
                          config["schedule_total_steps"], params)
    losses, grads, kink = [], None, None
    for i, batch in enumerate(batches):
        outputs = ref.pos_neg(batch)
        if i == 0:
            # the corrupt penalty's kink: the cosine nearest 0
            s_neg = (outputs[2] * outputs[1]).detach().sum(-1)
            kink = float(s_neg.abs().min())
        loss = ref_model.loss(config["loss"], *outputs)
        del outputs
        g = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
        if i == 0:
            grads = leaf_norms(g)
        opt.step(g)
        losses.append(float(loss.detach()))
        del g, loss
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "grads": grads, "change": change,
            "sizes": {k: p.numel() for k, p in params.items()},
            "s_neg_nearest_0": kink}


def _normed(norms: Dict[str, float]) -> Dict[str, float]:
    """Leaf norms over their global norm (the clip's view of them)."""
    total = sum(v * v for v in norms.values()) ** 0.5
    return {k: v / total if total else 0.0 for k, v in norms.items()}


def readings(prog: dict, ref: dict):
    """The numbers ``correct`` may compare (a cell's limits name the ones it
    does): ``loss_gap``, the widest relative gap of a step's loss;
    ``loss_gap_first``, that of the first step, which no update before it
    has moved (the loss is continuous where its gradient is not);
    ``grad_gap``, the median leaf's gap of the first gradient's norm before
    the clip; ``grad_gap_normed``, the same with each side's leaf norms
    over its global norm; ``grad_gap_table``, the gap of the first
    gradient's norm on the largest leaf (the word embedding table, whose
    gradient sums over the batch's tokens); ``change_gap``, the worst
    leaf's gap of the change's norm. Leaves under ``ROUNDOFF_LEAF`` of the
    median leaf's first gradient in the reference are left out. → (those,
    a report: the worst leaves, the leaves left out, the reference's
    corrupt-penalty cosine nearest its kink at 0)."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    g = sorted(ref["grads"].values())
    floor = ROUNDOFF_LEAF * g[len(g) // 2]
    keep = [k for k, v in ref["grads"].items() if v >= floor]
    median = lambda d: sorted(d.values())[len(d) // 2]
    grads = common.leaf_gaps(prog["grads"], ref["grads"], keep)
    normed = common.leaf_gaps(_normed(prog["grads"]), _normed(ref["grads"]),
                              keep)
    change = common.leaf_gaps(prog["change"], ref["change"], keep)
    grad_worst, grad_leaf = common.worst(grads)
    change_gap, change_leaf = common.worst(change)
    table = max(ref["sizes"], key=ref["sizes"].get)
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "grad_gap": median(grads),
            "grad_gap_normed": median(normed), "grad_gap_table": grads[table],
            "change_gap": change_gap}, {
        "grad_gap_worst": grad_worst,
        "grad_leaf": grad_leaf, "change_leaf": change_leaf,
        "left_out": len(ref["grads"]) - len(keep),
        "s_neg_nearest_0": ref.get("s_neg_nearest_0")}


class Program:
    """The program's training state for a cell and a seed, with the
    batches of its mix."""

    def __init__(self, torch, cell, seed: int, device):
        from speech_transcript_embeddings_torch.ops import make_frontend
        from speech_transcript_embeddings_torch.training import (
            train_step as ts,
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.torch, self.cell, self.device = torch, cell, device
        self.cfg = common.port_config(cell.config, cell.mix)
        weights = make_weights(cell.config, seed, device)
        model = common.build_model(torch, self.cfg, weights, True, device)
        del weights
        self.state = ts.create_train_state(
            model, self.cfg, total_steps=cell.config["schedule_total_steps"])
        self.frontend = make_frontend(self.cfg.model.frontend).to(device)
        self.pool = traffic.train_pool(
            torch, cell.mix, seed, cell.config["model"]["text"]["vocab_size"],
            device)
        self.gen = torch.Generator(device).manual_seed(
            traffic.sub_seed(seed, "step"))
        self._ts = ts
        self.at = 0                              # the next batch of the cycle
        self.ran_first: List = []                # the first steps' batches

    def step(self, batch):
        return self._ts.train_step(self.cfg, self.state, self.frontend, batch,
                                   self.gen)

    def next(self):
        batch = self.pool[self.at % len(self.pool)]
        self.at += 1
        return self.step(batch), batch

    def first_batches(self) -> List:
        """The batches of the first steps: the cycle's first batch of each
        bucket, the rarest bucket first, then the cycle's next batches, up
        to ``FIRST_STEPS``; so the compared steps run the mix's rare shapes,
        where the window spends least of its time."""
        count = collections.Counter(_width(b) for b in self.pool)
        first: Dict[int, int] = {}
        for i, b in enumerate(self.pool):
            first.setdefault(_width(b), i)
        picked = sorted(first.values(),
                        key=lambda i: count[_width(self.pool[i])])
        picked += [i for i in range(len(self.pool)) if i not in picked]
        return [self.pool[i] for i in picked[:FIRST_STEPS]]

    def first_steps(self) -> dict:
        self.ran_first = self.first_batches()
        return program_first_steps(self.torch, self.state, self.step,
                                   self.ran_first)

    def warm(self) -> None:
        """Run each bucket of the cycle twice, counting the first steps,
        on the first batches of each."""
        runs = collections.Counter(_width(b) for b in self.ran_first)
        for batch in self.pool:
            width = _width(batch)
            if runs[width] < 2:
                self.step(batch)
                runs[width] += 1


def _width(batch) -> int:
    return batch["waveform"].shape[1]


def _lens(batch) -> List[int]:
    return [int(n) for n in batch["num_samples"].tolist()]


def _attention_calls(config: dict, lens: List[int]):
    """(valid frames, forward calls, backward calls) of a step: every block
    runs the forward; the backward runs wherever a gradient flows into the
    block (everywhere when the bottom trains)."""
    m, freeze = config["model"], config["freeze"]
    frames = [flops.valid_frames(m["frontend"], n) for n in lens]
    layers = m["audio"]["num_layers"]
    back = layers if freeze["train_audio_feature_projection"] else \
        freeze["audio_layers_to_unfreeze"]
    return frames, layers, back


def run(ctx, cell) -> dict:
    torch, device = ctx.torch, ctx.device
    phases = common.Phases()
    prog = Program(torch, cell, ctx.seed, device)
    phases.mark("weights, model, batches")
    first = prog.first_steps()
    first_batches = prog.ran_first
    phases.mark("first steps")
    prog.warm()
    phases.mark("warm-up")
    ctx.mark_setup()

    ctx.reset_peak()
    ran = []                                 # the cycle positions stepped
    t0 = time.perf_counter()
    while True:
        prog.next()
        ran.append((prog.at - 1) % len(prog.pool))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    host = ctx.host_load(window_s)
    peak = ctx.peak_memory()
    clips = sum(prog.pool[i]["waveform"].shape[0] for i in ran)
    per_batch = {i: flops.train_step(cell.config, _lens(prog.pool[i]),
                                     cell.mix["text_len"]) for i in set(ran)}
    model_flops = sum(per_batch[i] for i in ran)

    stretch = None
    if ctx.trace:
        traced = []
        with ctx.stretch() as s:
            for _ in range(cell.mix["trace_steps"]):
                prog.next()
                traced.append((prog.at - 1) % len(prog.pool))
        stretch = {"window_s": s.window_s, "events": s.events,
                   "steps": len(traced),
                   "attention": [_attention_calls(cell.config,
                                                  _lens(prog.pool[i]))
                                 for i in traced]}

    del prog
    ctx.free()
    phases.skip()
    ref = reference_first_steps(torch, cell.config, ctx.seed, first_batches,
                                device)
    phases.mark("reference")
    numbers, worst = readings(first, ref)
    return {
        "attempted": len(ran), "failed": 0,
        "end_to_end": {"train_clips_per_s": clips / window_s},
        "readings": numbers,
        "memory_peak_bytes": peak,
        "window": {"seconds": window_s, "steps": len(ran), "clips": clips,
                   "model_flops": model_flops},
        "stretch": stretch,
        "report": dict(worst, host=host, losses=first["losses"],
                       ref_losses=ref["losses"]),
        "notes": [phases.note()],
    }
