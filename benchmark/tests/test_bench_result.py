"""The result line a run prints, the whole-name check for JAX, and the
run's refusals without a card or outside a checkout."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import common, run
from benchmark.tests import tiny

ROOT = common.ROOT


def _out(trace):
    return {"attempted": 5, "failed": 0,
            "end_to_end": {"train_clips_per_s": 12.5},
            "readings": {"loss_gap": 0.001, "grad_gap": 0.002},
            "memory_peak_bytes": 123,
            "window": {"seconds": 2.0, "steps": 4, "clips": 16,
                       "model_flops": 1e12},
            "stretch": {"window_s": 1.0, "steps": 2, "attention": [
                ([10, 12], 2, 2)], "events": _events()} if trace else None}


def _events():
    k3 = "flash_rel_fwd_wgmma_kernel<64>"
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 0,
         "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "pid": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 100,
         "dur": 200, "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": k3, "ts": 500, "dur": 300,
         "args": {"correlation": 7}},
    ]


def _cell(name="retrieval-train-cvmix"):
    bench = common.benchmark()
    cell = common.find_cell(name, bench)
    cell.limits = {"loss_gap": 0.01, "grad_gap": 0.001}
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = _cell()
    ctx = tiny.CpuContext(trace=trace)
    ctx.setup_s = 3.5
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    result = run.assemble(cell, ctx, _out(trace), device, 989e12, 3.35e12)
    line = json.loads(json.dumps(result))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["checks"]["grad_gap"] == {"value": 0.002, "limit": 0.001}
    assert line["correct"] is False                  # 0.002 > 0.001
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert line["device"]["busy_s"] == pytest.approx(500e-6)
        assert line["device"]["window_s"] == 1.0
        assert line["metrics"]["train_launches_per_step"]["value"] == 1.0
        assert line["metrics"]["train_idle_share"]["value"] == \
            pytest.approx(100 * (1 - 500e-6))
        assert line["metrics"]["train_mfu"]["value"] == pytest.approx(
            100 * 1e12 / 2.0 / 989e12)
        assert "k4_roofline.train" not in line["metrics"]   # no K4 ran
        assert 0 < line["metrics"]["k3_roofline.train"]["value"] <= 100
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["breakdown"]["idle_gaps"][0][0] == "aten::linear"
    else:
        assert set(line["metrics"]) == {"train_clips_per_s", "setup_s"}
        assert line["metrics"]["setup_s"] == {"value": 3.5, "unit": "s"}
        assert "breakdown" not in line


@pytest.mark.parametrize("trace", [False, True])
def test_split_metric_reads_the_entrys_quantity(trace):
    """``train_clips_per_s.b64`` is the entry's ``train_clips_per_s``, and
    its per-layer metrics are the ``.b64`` ones."""
    cell = _cell("flagship-train-b64")
    ctx = tiny.CpuContext(trace=trace)
    ctx.setup_s = 3.5
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    line = run.assemble(cell, ctx, _out(trace), device, 989e12, 3.35e12)
    if trace:
        assert line["metrics"]["train_mfu.b64"]["value"] == pytest.approx(
            100 * 1e12 / 2.0 / 989e12)
        assert all(k.endswith(".b64") for k in line["metrics"])
    else:
        assert line["metrics"]["train_clips_per_s.b64"] == {
            "value": 12.5, "unit": "clips/s"}
        assert set(line["metrics"]) == {"train_clips_per_s.b64", "setup_s"}


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"speech_transcript_embeddings_torch": 1,
            "speech_transcript_embeddings_torch.ops": 1, "jaxtyping": 1,
            "flax_like": 1, "numpy": 1}
    assert common.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "speech_transcript_embeddings_tpu.config": 1,
                 "flax": 1, "jaxlib": 1})
    assert common.forbidden_modules(mods) == [
        "flax", "jax.numpy", "jaxlib",
        "speech_transcript_embeddings_tpu.config"]


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import torch; "
            "from benchmark import common, run, flops, roofline, trace, "
            "card, readers, traffic, weights, calibrate; "
            "from benchmark.entries import train, embed; "
            "from benchmark.reference import model; "
            "import speech_transcript_embeddings_torch.training.train_step; "
            "import speech_transcript_embeddings_torch.inference.embed; "
            "print(common.forbidden_modules())" % ROOT)
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.model; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('speech_transcript')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "retrieval-train-cvmix", "--seed", str(2**31 + 1),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"), "--workload",
         "retrieval-train-cvmix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
