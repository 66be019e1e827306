"""The traffic generator: every mix is a function of ``--seed``, every seed
gets the same set of lengths, and the cycles keep the mix's proportions."""

import collections

import numpy as np
import pytest
import torch

from benchmark import traffic

MIXES = ("train_cvmix", "train_b64", "embed_cvmix")


@pytest.mark.parametrize("name", MIXES)
def test_plan_is_fixed_and_seeds_reorder_the_same_lengths(name):
    mix = traffic.load(name)
    plan = traffic.batch_plan(mix)
    assert plan == traffic.batch_plan(mix)
    a = traffic.order_plan(plan, 2**31 + 7)
    b = traffic.order_plan(plan, 2**31 + 7)
    c = traffic.order_plan(plan, 5)
    assert a == b
    assert [x for x, _ in a] == [x for x, _ in c] == [x for x, _ in plan]
    assert sorted(n for _, ns in a for n in ns) == \
        sorted(n for _, ns in c for n in ns)
    assert a != c
    for bucket, ns in a:
        assert len(ns) == mix["batch"]
        assert all(n <= bucket for n in ns)


def test_cv_mix_proportions_and_interleave():
    plan = traffic.batch_plan(traffic.load("train_cvmix"))
    counts = collections.Counter(b for b, _ in plan)
    # bench.py's mix of 2,048 clips at B = 16: 2 s ×18, 5 s ×71, 10 s ×35,
    # 15 s ×3
    assert counts == {41200: 18, 82160: 71, 164080: 35, 246000: 3}
    # any stretch of 32 batches holds each bucket within one of its share
    order = [b for b, _ in plan]
    for start in range(0, len(order) - 32):
        window = collections.Counter(order[start:start + 32])
        for bucket, k in counts.items():
            assert abs(window[bucket] - 32 * k / len(order)) <= 1.5


def test_interleave_spreads_evenly():
    assert traffic.interleave([1, 2]) == [1, 0, 1]
    out = traffic.interleave([3, 1])
    assert sorted(out) == [0, 0, 0, 1]


def test_train_pool_is_deterministic_from_the_seed():
    mix = dict(traffic.load("train_b64"), clips=128, buckets=[8000],
               max_samples=8000, lengths={"dist": "uniform",
                                          "min_samples": 4000,
                                          "max_samples": 8000,
                                          "length_seed": 1})
    a = traffic.train_pool(torch, mix, 2**31 + 11, 100, "cpu")
    b = traffic.train_pool(torch, mix, 2**31 + 11, 100, "cpu")
    c = traffic.train_pool(torch, mix, 12, 100, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["waveform"], c[0]["waveform"])
    for batch in a:
        n = batch["num_samples"]
        wav = batch["waveform"]
        assert torch.all(wav[torch.arange(wav.shape[1])[None] >= n[:, None]]
                         == 0)
        assert batch["input_ids_pos"].min() >= traffic.FIRST_ID


def test_cv_lengths_match_the_documented_distribution():
    lens = traffic.sample_cv_lengths(20000, np.random.default_rng(0))
    secs = lens / traffic.SAMPLE_RATE
    assert abs(np.median(secs) - 4.2) < 0.1
    assert secs.min() >= 1.0 and secs.max() <= 30.0
