"""A cell, a mix, a configuration and a per-layer metric are added by
adding files and ``BENCHMARK.json`` entries: the harness finds each by its
name, and no file already there changes."""

import copy
import hashlib
import json
import os
import shutil

from benchmark import common
from benchmark.tests import tiny


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_every_cell_of_the_benchmark_is_found():
    bench = common.benchmark()
    for w in bench["workloads"]:
        cell = common.find_cell(w["name"], bench)
        assert cell.mix["entry"] in ("train", "embed")
        assert cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(common.HERE, "metrics",
                                               f"{m['name']}.py"))


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(common.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)
    bench = copy.deepcopy(common.benchmark())
    # a configuration, a mix, a cell with its limits, a per-layer metric
    with open(here / "configs" / "small.json", "w") as f:
        json.dump(tiny.tiny_config(), f)
    with open(here / "traffic" / "short_embed.json", "w") as f:
        json.dump(tiny.tiny_mix("embed"), f)
    with open(here / "limits" / "small-embed-short.json", "w") as f:
        json.dump({"embedding_gap": 0.1}, f)
    with open(here / "metrics" / "embed_batches.py", "w") as f:
        f.write("def read(run):\n    return float(run.window['steps'])\n")
    bench["configs"].append({"name": "small", "source": "x",
                             "file": "benchmark/configs/small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small-embed-short", "config": "small",
                               "traffic": "short_embed", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "embed_clips_per_s.short",
                                "unit": "clips/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["small-embed-short"]})
    bench["per_layer"].append({"name": "embed_batches", "unit": "n",
                               "better": "lower", "source": "program_counter",
                               "layer": "inference/embed.py Embedder",
                               "moves": "embed_clips_per_s.short",
                               "workloads": ["small-embed-short"]})
    cell = common.find_cell("small-embed-short", bench, str(here))
    assert cell.config["model"]["text"]["hidden_size"] == 32
    assert cell.mix["entry"] == "embed"
    assert cell.limits == {"embedding_gap": 0.1}
    assert sorted(m["name"] for m in cell.end_to_end) == [
        "embed_clips_per_s.short", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["embed_batches"]

    class Run:
        window = {"steps": 3}
    assert common.read_metrics(cell, Run()) == {
        "embed_batches": {"value": 3.0, "unit": "n"}}
    after = _digests(here)
    assert {k: after[k] for k in before} == before
