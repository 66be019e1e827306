"""Tiny cells for the CPU tests: the shipped configurations with every
width cut to a few units, small mixes, and a context that runs an entry on
the CPU (no card: the device's synchronisation and memory readings are
no-ops)."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from benchmark import common

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def tiny_config(name: str = "retrieval", dtype: str = "float32") -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        c = json.load(f)
    m = c["model"]
    m["text"].update(vocab_size=128, hidden_size=32, num_layers=2,
                     num_heads=4, intermediate_size=64,
                     max_position_embeddings=96, scan_bottom=1)
    m["audio"].update(feature_dim=16, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, conv_kernel_size=7,
                      left_max_rel_pos=8, right_max_rel_pos=2, scan_bottom=1)
    m["frontend"].update(num_mel_bins=8)
    m["heads"].update(projection_dim=16, cross_modal_heads=4,
                      alignment_heads=2)
    m["dtype"] = dtype
    c["freeze"].update(text_layers_to_unfreeze=1, audio_layers_to_unfreeze=1)
    return c


def tiny_mix(entry: str) -> dict:
    base = {"lengths": {"dist": "uniform", "min_samples": 3000,
                        "max_samples": 16000, "length_seed": 3},
            "buckets": [8000, 16000], "max_samples": 16000}
    if entry == "train":
        return dict(base, entry="train", batch=4, clips=16, text_len=8,
                    trace_steps=2)
    return dict(base, entry="embed", batch=4, clips=16, sample=5,
                trace_batches=2)


def tiny_cell(entry: str, config: str = "retrieval", limits=None,
              dtype: str = "float32") -> common.Cell:
    names = {"train": "train_clips_per_s", "embed": "embed_clips_per_s"}
    e2e = [{"name": names[entry], "unit": "x"},
           {"name": "setup_s", "unit": "s"}]
    return common.Cell(f"tiny-{entry}", 1, tiny_config(config, dtype),
                       tiny_mix(entry), copy.deepcopy(limits or {}), e2e, [])


class CpuContext:
    """``run.Context`` for the CPU: same fields, no card."""

    def __init__(self, seed: int = 1, seconds: float = 0.5,
                 trace: bool = False):
        self.torch, self.device = torch, torch.device("cpu")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.start = time.time()
        self.setup_s = None

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak_memory(self):
        return 0

    def free(self):
        pass

    def mark_setup(self):
        self.setup_s = time.time() - self.start
        self._cpu = common.host_cpu()

    def host_load(self, seconds):
        return common.host_load(self._cpu, seconds)

    def stretch(self):
        return _NoTrace()


class _NoTrace:
    window_s = 0.0
    events: list = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
