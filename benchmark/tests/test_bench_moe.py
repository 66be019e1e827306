"""The DeepSeek-V2 text embed cell and the data-parallel train cell: found by
name with their metrics; their entries driven on the CPU at a tiny size
(fp32), the sound program correct and each fault the cell's ``correct``
is there to catch read far above it; the data-parallel entry's ranks run
as gloo processes; the weights, FLOPs, roofline and counter readers
against hand counts."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import calibrate_moe, common, flops_moe, roofline_moe
from benchmark import weights_deepseek_v2 as wds
from benchmark.entries import embed_text, train_dp
from benchmark.tests import tiny

NEW_CELLS = {"deepseek-v2-lite-embed-text": "embed_text",
             "retrieval-train-dp4": "train_dp"}
TEXT_METRICS = ["embed_mfu", "text_attention_ms", "text_route_ms",
                "text_experts_ms", "text_experts_roofline",
                "text_expert_load_max"]
DP_METRICS = ["train_idle_share", "train_grad_sync_ms"]


def _limits(cell):
    with open(os.path.join(common.HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def test_new_cells_and_metrics_are_found():
    bench = common.benchmark()
    for name, entry in NEW_CELLS.items():
        cell = common.find_cell(name, bench)
        assert cell.mix["entry"] == entry
        assert cell.limits and cell.per_layer
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(common.HERE, "metrics",
                                               f"{m['name']}.py"))
    text = common.find_cell("deepseek-v2-lite-embed-text", bench)
    assert [m["name"] for m in text.end_to_end] == ["embed_clips_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in text.per_layer] == TEXT_METRICS
    dp = common.find_cell("retrieval-train-dp4", bench)
    assert dp.chips == 4
    assert [m["name"] for m in dp.end_to_end] == ["train_clips_per_s",
                                                  "setup_s"]
    assert [m["name"] for m in dp.per_layer] == DP_METRICS


def test_configuration_holds_the_published_model_whole():
    with open(os.path.join(common.HERE, "configs",
                           "deepseek-v2-lite.json")) as f:
        c = json.load(f)
    text = c["model"]["text"]
    for key in ("hidden_size", "intermediate_size", "moe_intermediate_size",
                "num_hidden_layers", "n_routed_experts", "n_shared_experts",
                "num_experts_per_tok", "vocab_size", "kv_lora_rank",
                "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim"):
        assert text[key] == c[key], key
    assert text["rope_scaling"] == {k: float(v) if isinstance(v, int) else v
                                    for k, v in c["rope_scaling"].items()} \
        or text["rope_scaling"] == c["rope_scaling"]
    specs = wds.specs(c["model"])
    tower = sum(np.prod(s) for n, (s, _) in specs.items()
                if n.startswith("text_encoder."))
    assert 15.4e9 < tower < 15.6e9          # 15.49 B without the LM head


def tiny_text_config(dtype="float32") -> dict:
    """The configuration file with every width cut to a few units (the
    audio side and the heads as ``tiny.tiny_config`` cuts them)."""
    with open(os.path.join(common.HERE, "configs",
                           "deepseek-v2-lite.json")) as f:
        c = json.load(f)
    small = tiny.tiny_config("retrieval", dtype)
    c["model"].update({k: small["model"][k] for k in (
        "audio", "frontend", "heads", "dtype")})
    c["model"]["text"].update(
        vocab_size=97, hidden_size=32, intermediate_size=48,
        moe_intermediate_size=16, num_hidden_layers=3,
        num_attention_heads=2, num_key_value_heads=2, n_routed_experts=8,
        num_experts_per_tok=3, kv_lora_rank=16, qk_rope_head_dim=8,
        qk_nope_head_dim=8, v_head_dim=12)
    c["model"]["text"]["rope_scaling"]["original_max_position_embeddings"] = 4
    return c


def tiny_text_cell(limits=None) -> common.Cell:
    mix = {"entry": "embed_text", "batch": 4, "transcripts": 16,
           "lengths": {"median_tokens": 5, "sigma_log": 0.5,
                       "min_tokens": 2, "max_tokens": 8, "length_seed": 7},
           "text_len": 8, "sample": 5, "trace_batches": 2}
    return common.Cell("tiny-embed-text", 1, tiny_text_config(), mix,
                       copy.deepcopy(limits or {}),
                       [{"name": "embed_clips_per_s", "unit": "x"},
                        {"name": "setup_s", "unit": "s"}], [])


def test_weights_cover_the_program_and_reach_the_reference():
    cell = tiny_text_cell()
    embedder = embed_text.make_embedder(torch, cell, 3, torch.device("cpu"))
    get = wds.getter(cell.config, 3, "cpu")
    for name, p in embedder.model.named_parameters():
        assert torch.equal(p.float(), get(name)), name
    shapes = {n: tuple(p.shape) for n, p in
              embedder.model.named_parameters()}
    assert shapes == {n: tuple(s) for n, (s, _) in
                      wds.specs(cell.config["model"]).items()}


def test_sound_text_run_is_correct_and_reports_its_counters():
    cell = tiny_text_cell(_limits("deepseek-v2-lite-embed-text"))
    out = embed_text.run(tiny.CpuContext(seed=2**33 + 5, seconds=0.2,
                                         trace=True), cell)
    assert common.judge(out["readings"], cell.limits)[0]
    assert out["readings"]["embedding_gap"] < 1e-5
    assert out["readings"]["route_flip_share"] == 0.0
    rows = out["stretch"]["expert_rows"]
    assert len(rows) == 2 and len(rows[0]) == 2       # batches, MoE layers
    assert all(sum(layer) == 4 * 8 * 3 for batch in rows for layer in batch)
    assert out["window"]["model_flops"] > 0


@pytest.mark.parametrize("fault", sorted(calibrate_moe.FAULTS))
def test_text_faults_read_far_above_the_sound_program(fault):
    """Each fault reads over a hundred times the sound program and fails
    the cell's limit at this size too."""
    cell = tiny_text_cell(_limits("deepseek-v2-lite-embed-text"))
    sound = embed_text.run(tiny.CpuContext(seed=31, seconds=0.1), cell)
    out = calibrate_moe.with_fault(fault, lambda: embed_text.run(
        tiny.CpuContext(seed=31, seconds=0.1), cell))
    gap = out["readings"]["embedding_gap"]
    assert gap > 100 * max(sound["readings"]["embedding_gap"], 1e-7)
    assert not common.judge(out["readings"], cell.limits)[0]


def test_text_control_reads_far_above_the_sound_program():
    cell = tiny_text_cell()
    ids, mask = embed_text.text_pool(torch, cell.mix, 4, 97, 1, "cpu")[0]
    fp32 = embed_text.reference(torch, cell.config, 4, ids, mask, "cpu")
    fp8 = embed_text.reference(torch, cell.config, 4, ids, mask, "cpu",
                               "fp8")
    assert np.linalg.norm(fp8[0] - fp32[0], axis=1).max() > 1e-2


def test_text_pool_is_the_mix():
    cell = tiny_text_cell()
    a = embed_text.text_pool(torch, cell.mix, 5, 97, 1, "cpu")
    b = embed_text.text_pool(torch, cell.mix, 5, 97, 1, "cpu")
    c = embed_text.text_pool(torch, cell.mix, 6, 97, 1, "cpu")
    assert len(a) == 4 and a[0][0].shape == (4, 8)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    lens = lambda p: sorted(int(n) for _, m in p for n in m.sum(1))
    assert lens(a) == lens(c)               # the same lengths, reordered
    for ids, mask in a:
        assert ((ids >= 4) | (mask == 0)).all() and (ids[mask == 0] == 1).all()
        # right-padded: a prefix of ones
        assert (np.diff(mask, axis=1) <= 0).all()


def test_flops_and_bound_against_hand_counts():
    c = tiny_text_config()
    t = c["model"]["text"]
    n = 5
    attn = 2 * n * (32 * 2 * 16 + 32 * (16 + 8) + 16 * 2 * (8 + 12)
                    + 2 * 12 * 32) + 2 * 15 * 2 * (16 + 12)
    dense = 3 * 2 * n * 32 * 48
    moe = 2 * n * 32 * 8 + 3 * 3 * 2 * n * 32 * 16 + 3 * 2 * n * 32 * 32
    pool = 2 * n * (32 * 16 + 16)
    proj = 2 * (32 * 32 + 32 * 16)
    assert flops_moe.embed_text(c, [n]) == 3 * attn + dense + 2 * moe + \
        pool + proj
    assert t["num_hidden_layers"] == 3
    s = roofline_moe.experts_bound_s([4, 0, 2], 8, 4, 1e3, 1e12)
    assert s == pytest.approx(6 * 3 * 2 * 8 * 4 / 1e3)
    s = roofline_moe.experts_bound_s([4, 0, 2], 8, 4, 1e30, 1.0)
    assert s == (2 * 3 * 8 * 4 + 6 * (8 + 8 + 8)) * 2


def _load(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(common.HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_counter_readers():
    class Run:
        config = tiny_text_config()
        device_us = {"moe_experts": 10.0, "grad_sync": 4.0}
        stretch = {"expert_rows": [[[4, 0, 2, 2], [2, 2, 2, 2]]],
                   "steps": 1, "phases": {"device_us": device_us,
                                          "idle_us": {}, "launches": {}}}
        peak_flops, peak_bytes = 1e15, 1e12
    assert _load("text_expert_load_max").read(Run) == pytest.approx(
        (4 / 2 + 1) / 2)
    share = _load("text_experts_roofline").read(Run)
    bound = sum(roofline_moe.experts_bound_s(r, 32, 16, 1e15, 1e12)
                for r in Run.stretch["expert_rows"][0])
    assert share == pytest.approx(100 * bound / 10e-6)
    assert _load("train_grad_sync_ms").read(Run) == pytest.approx(0.004)

    class Parent:                        # a program without the counter
        stretch = {"steps": 1, "events": []}
    assert _load("text_expert_load_max").read(Parent) is None
    assert _load("train_grad_sync_ms").read(Parent) is None
    assert _load("text_experts_roofline").read(Parent) is None
    assert _load("text_attention_ms").read(Parent) is None


def tiny_dp_cell(limits=None) -> common.Cell:
    mix = dict(tiny.tiny_mix("train"), entry="train_dp", batch=8, ranks=4,
               clips=32)
    return common.Cell("tiny-train-dp", 4, tiny.tiny_config("retrieval"),
                       mix, copy.deepcopy(limits or {}),
                       [{"name": "train_clips_per_s", "unit": "x"},
                        {"name": "setup_s", "unit": "s"}], [])


def test_dp_ranks_agree_with_the_single_device_reference_and_faults_fail():
    """Four gloo ranks on the CPU: the sound run is correct and its losses
    the reference's; local negatives fail ``loss_gap``; a rank's gradients
    left out fail ``grad_gap_normed``."""
    cell = tiny_dp_cell(_limits("retrieval-train-dp4"))
    sound = train_dp.run(tiny.CpuContext(seed=41, seconds=0.2, trace=True),
                         cell)
    assert common.judge(sound["readings"], cell.limits)[0]
    assert sound["readings"]["loss_gap"] < 1e-5
    assert sound["attempted"] >= 1 and sound["report"]["ranks"] == 4
    # rank 0's traced steps give the K3/K4 calls of its own rows
    attention = sound["stretch"]["attention"]
    assert len(attention) == sound["stretch"]["steps"] == \
        cell.mix["trace_steps"]
    assert all(len(frames) == cell.mix["batch"] // 4
               for frames, _, _ in attention)
    local = train_dp.run(tiny.CpuContext(seed=41, seconds=0.1), cell,
                         "local_negatives")
    assert not common.judge(local["readings"], cell.limits)[0]
    dropped = train_dp.run(tiny.CpuContext(seed=41, seconds=0.1), cell,
                           "drop_rank")
    assert not common.judge(dropped["readings"], cell.limits)[0]
    assert dropped["readings"]["grad_gap_normed"] > \
        100 * max(sound["readings"]["grad_gap_normed"], 1e-6)


def test_dp_rank_failure_fails_the_run_without_hanging():
    """Ranks 1-3 that die at their start (their interpreter ``false``) end
    rank 0, which waits for them at the rendezvous, within seconds: exit 6,
    long before the rendezvous's timeout."""
    import subprocess
    import sys
    script = ("import sys\n"
              "from benchmark.tests import tiny, test_bench_moe as t\n"
              "from benchmark.entries import train_dp\n"
              "sys.executable = 'false'\n"
              "train_dp.run(tiny.CpuContext(seed=1), t.tiny_dp_cell())\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=common.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 6, proc.stderr[-2000:]
    assert "a rank failed" in proc.stderr
