#!/usr/bin/env python
"""Training throughput of the PyTorch/CUDA port on one card: the port of
``bench.py``, with its four configurations, its batch defaults and its
method, and a FLOP ceiling on every reading.

    python bench_torch.py [--config retrieval|retrieval-lengths|
        retrieval-frozen|flagship-pairwise] [--batch N] [--device cuda|cpu]
        [key=value ...]

Each configuration times the port's train step (``training/train_step.py``
``train_step``: the log-mel frontend, the dual encoder's forward, the loss,
autograd over the trainable split and AdamW) at full width with random
weights from a seed, bf16, on device-resident batches, one distinct batch
per timed step, after two warm steps:

* ``retrieval`` (default): ``preset=retrieval``'s model (fusion heads off),
  global InfoNCE, 5+5 top blocks unfrozen, bf16 Adam μ, ``save_hot2``
  remat, B = 16. The headline is the Common Voice length mix (below); the
  fixed 10 s step rides along as ``fixed_10s_value``.
* ``retrieval-lengths``: the length mix alone.
* ``retrieval-frozen``: 10 s clips, the text embeddings and the audio
  feature projection frozen too, so that backprop can stop at the lowest
  unfrozen block.
* ``flagship-pairwise``: the reference-parity model (fusion and word
  alignment on), pairwise loss, ``save_hot`` remat, B = 64, 10 s clips.

The length mix is bench.py's: 2,048 clip lengths from ``default_rng(7)``
(lognormal, ≈4.7 s mean), each padded to the smallest of the shipped
buckets that holds it, each bucket batched with the remainder dropped,
each bucket's step timed on its own; clips/s = clips in full batches ÷
Σ(batches × step time). It is also written to
``chiprun_out/bench_torch_lengths.json``.

A timed window ends in ``torch.cuda.synchronize()``. Beside each reading:
the device busy ms of one more warm step (``torch.profiler``) and the idle
share of the step, the step's FLOPs (its matrix products, counted with the
kernels off on a model built for counting; the remat replay included, so
the ratio to the card's bf16 peak is HFU), the peak memory, the SM clock
and power ``nvidia-smi`` read during the timed windows (median and range),
the card's name and power limit, and the launches of the four kernels over
the timed steps, counted from zero. A reading above the card's bf16 peak,
or a kernel of K1-K4 that never launched, raises before anything is
printed. ``key=value`` overrides (``train.py``'s syntax) apply to the
configuration last; ``--device cpu`` runs the same code at a size the
overrides make small and measures nothing of a device (its device keys
are null). ``--device cuda`` without a card raises.

Prints ONE JSON line, the last: bench.py's ``metric``, ``value``, ``unit``,
``vs_baseline`` (and ``fixed_10s_value`` for ``retrieval``) and the keys
above.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_CLIPS_PER_SEC = 5.8     # the reference, fp32, one V100 (BASELINE.md)
AUDIO_SECONDS = 10
TEXT_LEN = 64
WARMUP_STEPS = 2
MEASURE_STEPS = 12
MIN_TIMED_CLIPS = 192            # MEASURE_STEPS is raised for small batches
# the length mix: clips drawn, and a bucket's timed steps,
# min(full batches, max(MIX_MIN_STEPS, MIX_TIMED_CLIPS // B))
MIX_CLIPS, MIX_SEED = 2048, 7
MIX_MIN_STEPS, MIX_TIMED_CLIPS = 4, 96
CONFIGS = ("retrieval", "retrieval-lengths", "retrieval-frozen",
           "flagship-pairwise")
LENGTHS_ARTIFACT = os.path.join(ROOT, "chiprun_out",
                                "bench_torch_lengths.json")


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="Training throughput of the port (bench.py's method).")
    ap.add_argument("--config", default="retrieval", choices=CONFIGS)
    ap.add_argument("--batch", type=int, default=None,
                    help="per-step batch (default 16; 64 for "
                         "flagship-pairwise)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 64 if args.config == "flagship-pairwise" else 16
    return args


def build_config(bench_config: str, batch: int, overrides=()):
    """bench.py's experiment config for ``bench_config`` at ``batch``
    (10 s buckets: the length mix takes the shipped ones), then the
    overrides."""
    from speech_transcript_embeddings_torch import config as c
    asamps = AUDIO_SECONDS * 16000
    if bench_config.startswith("retrieval"):
        model = c.retrieval_model_config()
        loss = c.LossConfig(kind="global")
    else:
        model = c.flagship_model_config()
        # the BENCH_r01/r02 workload: save_hot2 does not fit B = 64 on the TPU
        model = dataclasses.replace(model, audio=dataclasses.replace(
            model.audio, remat_policy="save_hot"))
        loss = c.LossConfig(kind="pairwise")
    train_bottom = bench_config != "retrieval-frozen"
    data = (c.DataConfig(batch_size=batch, max_text_length=TEXT_LEN)
            if bench_config == "retrieval-lengths" else
            c.DataConfig(batch_size=batch, max_text_length=TEXT_LEN,
                         audio_buckets=(asamps,), max_audio_samples=asamps))
    cfg = c.ExperimentConfig(
        model=model, loss=loss,
        freeze=c.FreezeConfig(mode="partial", text_layers_to_unfreeze=5,
                              audio_layers_to_unfreeze=5,
                              train_text_embeddings=train_bottom,
                              train_audio_feature_projection=train_bottom),
        optimizer=c.OptimizerConfig(learning_rate=5e-5, warmup_steps=100,
                                    mu_dtype="bfloat16"),
        data=data,
        train=c.TrainConfig(num_epochs=1, accumulation_steps=1))
    return cfg.with_overrides(c.parse_overrides(list(overrides)))


class Bench:
    """The train step of ``cfg`` on ``device`` and what it measured."""

    def __init__(self, cfg, device):
        import torch
        from speech_transcript_embeddings_torch.models.dual_encoder import (
            init_model,
        )
        from speech_transcript_embeddings_torch.ops import make_frontend
        from speech_transcript_embeddings_torch.training import (
            train_step as ts,
        )
        from speech_transcript_embeddings_torch.utils import bench as ub
        self.torch, self.ts, self.ub = torch, ts, ub
        self.cfg, self.device = cfg, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            # fp32 products in full fp32, as the training loop runs them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.card = torch.cuda.get_device_name(device)
            self.peak = ub.peak_bf16(self.card)
        model = init_model(cfg.model, torch.Generator(device).manual_seed(0),
                           device, train=True)
        self.state = ts.create_train_state(model, cfg, total_steps=1000)
        self.frontend = make_frontend(cfg.model.frontend).to(device)
        self.gen = torch.Generator(device).manual_seed(1)
        self.launches = collections.Counter()
        self.frames = collections.Counter()
        self.counting = []          # (window, a batch of its shape)

    def step(self, batch):
        return self.ts.train_step(self.cfg, self.state, self.frontend, batch,
                                  self.gen)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def to_device(self, batch):
        return {k: self.torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def window(self, warm, timed, sampler, **info):
        """``utils.bench.timed_window`` of the train step: → the window's
        record (its FLOPs are counted later), its launches added to the
        run's."""
        rec = self.ub.timed_window(self.step, warm, timed, self.cuda,
                                   sampler)
        self.launches.update(rec.pop("launches"))
        self.frames.update(rec.pop("log_mel_frames"))
        rec = dict(info, **rec)
        self.counting.append((rec, warm[0]))
        return rec

    def count(self):
        """Each window's step FLOPs, on a model of the counting config
        (one more step of each shape; never timed), and its HFU. The timed
        model is freed first: the counting model's plain attention holds
        its scores whole (B = 64 needs the card to itself)."""
        torch, ts, ub = self.torch, self.ts, self.ub
        del self.state, self.frontend
        if self.cuda:
            torch.cuda.empty_cache()
        from speech_transcript_embeddings_torch.models.dual_encoder import (
            init_model,
        )
        from speech_transcript_embeddings_torch.ops import make_frontend
        ccfg = ub.counting_config(self.cfg)
        model = init_model(ccfg.model, torch.Generator(self.device)
                           .manual_seed(0), self.device, train=True)
        state = ts.create_train_state(model, ccfg, total_steps=1000)
        frontend = make_frontend(ccfg.model.frontend).to(self.device)
        gen = torch.Generator(self.device).manual_seed(1)
        for rec, batch in self.counting:
            flops = ub.count_flops(ts.train_step, ccfg, state, frontend,
                                   batch, gen)
            rec["step_tflop"] = flops / 1e12
            rec["hfu"] = (ub.ceiling(flops, rec["step_ms"] / 1e3, self.peak)
                          if self.cuda else None)
        del model, state
        if self.cuda:
            torch.cuda.empty_cache()


def _text(rng, b, vocab):
    """bench.py's clean and corrupted transcripts: random ids, no
    padding, drawn clean first."""
    pos, neg = (rng.integers(4, vocab, size=(b, TEXT_LEN)).astype(np.int32)
                for _ in range(2))
    ones = np.ones((b, TEXT_LEN), np.int32)
    return {"input_ids_pos": pos, "attention_mask_pos": ones,
            "input_ids_neg": neg, "attention_mask_neg": ones}


def fixed_batches(cfg, n):
    """bench.py's ``n`` fixed 10 s batches (host arrays) from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    b, asamps = cfg.data.batch_size, AUDIO_SECONDS * 16000
    out = []
    for _ in range(n):
        wav = rng.normal(scale=0.05, size=(b, asamps)).astype(np.float32)
        lens = rng.integers(asamps * 3 // 4, asamps, size=b).astype(np.int32)
        out.append({"waveform": wav, "num_samples": lens,
                    **_text(rng, b, cfg.model.text.vocab_size)})
    return out


def mix_batches(cfg):
    """bench.py's length mix: → [(bucket, full batches, host batches to
    run)], each bucket's batches drawn in bench.py's order from one
    ``default_rng(7)``: ``min(measure + 1, full batches)`` of them, where
    ``measure = min(full batches, max(4, 96 // B))`` (the two constants:
    ``MIX_MIN_STEPS``, ``MIX_TIMED_CLIPS``)."""
    from speech_transcript_embeddings_torch import config as c
    from speech_transcript_embeddings_torch.utils import bench as ub
    shipped = c.DataConfig()
    b = cfg.data.batch_size
    rng = np.random.default_rng(MIX_SEED)
    lengths = ub.sample_cv_lengths(MIX_CLIPS, rng)
    out = []
    for bucket, ns, n_batches in ub.bucket_mix(
            lengths, shipped.audio_buckets, shipped.max_audio_samples, b):
        measure = min(n_batches, max(MIX_MIN_STEPS, MIX_TIMED_CLIPS // b))
        batches = []
        for i in range(min(measure + 1, n_batches)):
            rows = ns[i * b:(i + 1) * b]
            wav = np.zeros((b, bucket), np.float32)
            for j, m in enumerate(rows):
                wav[j, :m] = rng.normal(scale=0.05, size=m).astype(np.float32)
            batches.append({"waveform": wav,
                            "num_samples": np.asarray(rows, np.int32),
                            **_text(rng, b, cfg.model.text.vocab_size)})
        out.append((bucket, n_batches, batches))
    return out


def measure_fixed(bench, sampler):
    b = bench.cfg.data.batch_size
    steps = max(MEASURE_STEPS, MIN_TIMED_CLIPS // b)
    batches = [bench.to_device(x) for x in
               fixed_batches(bench.cfg, WARMUP_STEPS + steps)]
    bench.sync()
    return bench.window(batches[:WARMUP_STEPS], batches[WARMUP_STEPS:],
                        sampler, samples=AUDIO_SECONDS * 16000)


def measure_mix(bench, sampler):
    """bench.py's ``_measure_length_mix``: → the buckets' records."""
    records = []
    for bucket, n_batches, host in mix_batches(bench.cfg):
        batches = [bench.to_device(x) for x in host]
        bench.sync()
        # bench.py: two warm steps, then every batch after the first
        records.append(bench.window(
            batches[:2], batches[1:] if len(batches) > 1 else batches,
            sampler, samples=bucket, batches=n_batches))
        del batches
    return records


def mix_summary(records, batch, peak=None):
    """The mix's throughput and its per-step averages, each bucket weighted
    by its full batches, as bench.py weights its step times; HFU and the
    device keys where ``peak`` (a card's) is given."""
    from speech_transcript_embeddings_torch.utils import bench as ub
    n = sum(r["batches"] for r in records)
    total_s = sum(r["batches"] * r["step_ms"] for r in records) / 1e3
    flops = sum(r["batches"] * r["step_tflop"] for r in records) * 1e12
    out = {"clips_per_s": n * batch / total_s, "step_ms": total_s * 1e3 / n,
           "step_tflop": flops / n / 1e12, "device_busy_ms": None,
           "idle_share": None, "hfu": None}
    if peak is not None:
        busy = sum(r["batches"] * r["device_busy_ms"] for r in records) / n
        out.update(device_busy_ms=busy, idle_share=1 - busy / out["step_ms"],
                   hfu=ub.ceiling(flops, total_s, peak))
    return out


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cfg = build_config(args.config, args.batch, args.overrides)
    batch = cfg.data.batch_size
    bench = Bench(cfg, device)
    if bench.cuda:
        torch.cuda.reset_peak_memory_stats(device)
        sampler = ub.CardSampler(device.index or 0)
    else:
        sampler = None
    fixed = records = None
    with sampler or contextlib.nullcontext():
        if args.config != "retrieval-lengths":
            fixed = measure_fixed(bench, sampler)
        if args.config in ("retrieval", "retrieval-lengths"):
            records = measure_mix(bench, sampler)
    peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if bench.cuda else None)
    bench.count()
    if bench.cuda:
        ub.require_launches(bench.launches, ("K1", "K2", "K3", "K4"))
        clock_power = sampler.summary()
        card = ub.card_line(device.index or 0)
    else:
        clock_power = {"sm_clock_mhz": None, "power_w": None}
        card = "cpu"
    what = {"retrieval-frozen": "global InfoNCE retrieval preset, frozen "
                                "bottom I/O",
            "flagship-pairwise": "pairwise loss + fusion heads"}
    common = f"flagship geometry, bf16, 5+5 unfrozen, B={batch}, port on " \
             f"{card}"
    if records is not None:
        mix = ub.mix_string([(r["samples"], None, r["batches"])
                             for r in records])
        head = mix_summary(records, batch,
                           bench.peak if bench.cuda else None)
        value = head["clips_per_s"]
        unit = (f"clips/s/chip (CV-pt length-mix approx ~4.7s mean, "
                f"bucketed pipeline [{mix}], {common}, global InfoNCE "
                f"retrieval preset"
                + ("; fixed-10s number in fixed_10s_value)"
                   if fixed else ")"))
        os.makedirs(os.path.dirname(LENGTHS_ARTIFACT), exist_ok=True)
        with open(LENGTHS_ARTIFACT, "w") as f:
            json.dump({"metric": "train_clips_per_sec_per_chip_length_mix",
                       "value": round(value, 3), "unit": unit,
                       "vs_baseline": round(value / BASELINE_CLIPS_PER_SEC, 3),
                       "n_chips": 1, "buckets": records}, f, indent=2)
            f.write("\n")
    else:
        head = dict(fixed, clips_per_s=batch / (fixed["step_ms"] / 1e3))
        value = head["clips_per_s"]
        unit = f"clips/s/chip (10s clips, {common}, {what[args.config]})"
    out = {"metric": "train_clips_per_sec_per_chip", "value": round(value, 3),
           "unit": unit,
           "vs_baseline": round(value / BASELINE_CLIPS_PER_SEC, 3)}
    if records is not None and fixed is not None:
        fixed_value = batch / (fixed["step_ms"] / 1e3)
        out.update(fixed_10s_value=round(fixed_value, 3),
                   fixed_10s_vs_baseline=round(
                       fixed_value / BASELINE_CLIPS_PER_SEC, 3),
                   fixed_10s=fixed)
    out.update(
        config=args.config, batch=batch, device=str(device),
        step_ms=head["step_ms"], device_busy_ms=head["device_busy_ms"],
        idle_share=head["idle_share"], step_tflop=head["step_tflop"],
        hfu=head["hfu"], peak_tflops=bench.peak / 1e12 if bench.cuda
        else None, peak_memory_gib=peak_gib, **clock_power, card=card,
        kernel_launches=dict(bench.launches),
        log_mel_frames={str(k): v for k, v in sorted(bench.frames.items())},
        buckets=records)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
