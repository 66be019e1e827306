"""The port's quality tools (``scripts/torch_proxy_quality_run.py``,
``scripts/torch_int8_quality_eval.py``) against the JAX package's
(``scripts/proxy_quality_run.py``, ``scripts/int8_quality_eval.py``, loaded
by path): the configs of every geometry field for field, and the committed
JAX runs' ``config.json``; the int8 eval's seeded corrupted negatives string
for string; its fp and int8 metrics on one bridged small model, JAX's
``main`` against the port's; a tiny run of both port scripts end to end on
the CPU; and neither script importing JAX."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, LossConfig, TrainConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.inference import embed as jembed
from speech_transcript_embeddings_tpu.utils import compilation_cache
from speech_transcript_embeddings_torch import bridge, checkpoints
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = 64
# a tiny geometry over the midsize retrieval recipe, through --extra
TINY = ["model.text.hidden_size=32", "model.text.num_layers=2",
        "model.text.intermediate_size=128", "model.text.scan_bottom=0",
        "model.audio.hidden_size=48", "model.audio.num_layers=2",
        "model.audio.num_heads=4", "model.audio.intermediate_size=192",
        "model.audio.feature_dim=16", "model.audio.conv_kernel_size=7",
        "model.audio.scan_bottom=0", "model.frontend.num_mel_bins=8",
        "model.heads.projection_dim=24", "model.dtype=float32",
        "model.remat=false", "freeze.text_layers_to_unfreeze=1",
        "freeze.audio_layers_to_unfreeze=1"]


def _load(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jproxy, tproxy = _load("proxy_quality_run"), _load("torch_proxy_quality_run")
jint8, tint8 = _load("int8_quality_eval"), _load("torch_int8_quality_eval")


def _as_dict(cfg):
    return json.loads(cfg.to_json())


def _args(argv):
    """The JAX script's argument parser has no function of its own: the
    port's parser (the same flags and defaults, plus ``--device``) reads
    the command for both."""
    return tproxy.parse_args(argv)


GEOMETRIES = {
    "midsize": ["--loss", "global", "--no-cross-modal", "--samples", "4096"],
    "preset-retrieval": ["--preset-retrieval", "--samples", "8192", "--acc",
                         "1", "--epochs", "8", "--schedule-epochs", "16"],
    "flagship": ["--geometry", "flagship", "--samples", "2048", "--acc", "2",
                 "--epochs", "3"],
    "flagship-lengths": ["--geometry", "flagship-lengths", "--samples",
                         "1024", "--epochs", "2", "--schedule-epochs", "4"],
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_configs_equal_jax_builders(geometry):
    args = _args(["out"] + GEOMETRIES[geometry])
    want = _as_dict(jproxy.build_config("out", args))
    got = _as_dict(tproxy.build_config("out", args))
    assert got == want
    # --extra applies on top of the recipe in both
    extra = ["model.audio.use_flash_attention=true", "train.seed=43"]
    assert (_as_dict(tproxy.build_config("out", args).with_overrides(
        tproxy.config_lib.parse_overrides(extra)))
        == _as_dict(jproxy.build_config("out", args).with_overrides(
            jproxy.config_lib.parse_overrides(extra))))


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# data fields added to the config after the 96-epoch run was recorded: its
# config.json predates them (with a synthetic corpus the tokenizer is the
# hash tokenizer whatever the field says, and the rest are defaults)
LATER_FIELDS = {"data.tokenizer", "data.synthetic_length_profile",
                "data.synthetic_max_words", "data.cv_local_dataset_dir",
                "data.length_cache_dir"}


@pytest.mark.parametrize("run,argv,absent", [
    ("parity16_retained", ["--preset-retrieval", "--samples", "8192",
                           "--acc", "1", "--epochs", "8",
                           "--schedule-epochs", "16"], set()),
    ("proxy_retrieval_preset_96", ["--preset-retrieval", "--samples",
                                   "16384", "--acc", "1", "--epochs", "96"],
     LATER_FIELDS),
])
def test_configs_equal_the_committed_jax_runs(run, argv, absent):
    """The port's config of each committed JAX run's command equals that
    run's ``config.json`` in every field the file records,
    ``train.output_dir`` aside; the file lacks only ``absent``."""
    with open(os.path.join(ROOT, "runs", run, "config.json")) as f:
        want = _flat(json.load(f))
    got = _flat(_as_dict(tproxy.build_config(want["train.output_dir"],
                                             _args(["x"] + argv))))
    assert set(got) - set(want) == absent
    assert {k: got[k] for k in want} == want
    if run == "parity16_retained":
        assert got["data.tokenizer"] == \
            "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
    assert _as_dict(tproxy.build_config("x", _args(["x"] + argv)))[
        "data"]["dataset"] == "synthetic"


# ---- the int8 eval against JAX's, on one bridged small model ----------------

def _eval_cfg():
    """A tiny retrieval model (no fusion) in fp32 whose corpus's test split
    holds ``POOL`` clips, cut to one 16,000-sample bucket (the metrics do
    not depend on the bucket; JAX compiles a shorter one sooner)."""
    mc = tiny_model_config(use_word_alignment=False)
    mc = dataclasses.replace(mc, heads=dataclasses.replace(
        mc.heads, use_cross_modal=False))
    return ExperimentConfig(
        model=mc, loss=LossConfig(kind="global"),
        data=DataConfig(dataset="synthetic", num_synthetic_samples=4 * POOL,
                        max_text_length=16, audio_buckets=(16000,),
                        max_audio_samples=16000),
        train=TrainConfig(seed=42))


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """JAX's ``main`` and the port's on the same weights (the port's seeded
    init, saved as a params checkpoint and carried across to JAX with
    ``bridge``; a JAX init would spend seconds compiling), each over a
    ``POOL``-clip test pool, fp and int8; JAX's corrupted negatives
    recorded as its ``evaluate`` receives them."""
    tmp = tmp_path_factory.mktemp("int8_eval")
    cfg = _eval_cfg()
    model = init_model(port_cfg(cfg.model), torch.Generator().manual_seed(0))
    params = bridge.state_dict_to_flax(model, port_cfg(cfg.model))
    path = str(tmp / "best_model_gap")
    checkpoints.save_params_checkpoint(path, model, port_cfg(cfg))
    seen = []
    evaluate = jint8.evaluate

    def recording(emb, texts, corrupts, audios, temperature):
        seen.append((list(texts), list(corrupts)))
        return evaluate(emb, texts, corrupts, audios, temperature)

    patch = pytest.MonkeyPatch()
    try:
        patch.setattr(jint8, "evaluate", recording)
        patch.setattr(compilation_cache, "enable", lambda *a, **k: None)
        patch.setattr(jembed.Embedder, "from_checkpoint", classmethod(
            lambda cls, p, tokenizer=None: cls(cfg, params)))
        patch.setattr(sys, "argv", [
            "int8_quality_eval.py", "--checkpoint", path,
            "--out", str(tmp / "jax.json")])
        jint8.main()
    finally:
        patch.undo()
    with open(tmp / "jax.json") as f:
        want = json.load(f)
    got = tint8.main(["--checkpoint", path, "--device", "cpu",
                      "--out", str(tmp / "port.json")])
    return cfg, want, got, seen


def test_negatives_equal_jax(evals):
    """The port's seeded corrupted negatives are JAX's, string for string,
    in both of JAX's passes (fp and int8), and its pool is JAX's."""
    cfg, want, got, seen = evals
    texts, _, corrupts = tint8.eval_pool(port_cfg(cfg))
    assert len(seen) == 2 and len(texts) == POOL == want["pool"] == got["pool"]
    for jtexts, jcorrupts in seen:
        assert jtexts == texts
        assert jcorrupts == corrupts
    assert sum(c != t for c, t in zip(corrupts, texts)) > POOL // 2


# The tolerance on the similarities: fp32 embeddings agree to ≈1e-5
# (tests/test_torch_embed.py holds 1e-4), and int8 ones to ≈6e-3, because
# the two frontends' features differ by up to 5e-5 and W8A8 turns that into
# a whole int8 step where a rounding crosses a half (tests/test_torch_quant.py);
# sigmoid(cos/0.1) moves at most 2.5× the cosine. The ranks: a pair of texts
# whose scores lie closer than that may swap, so each recall may move by a
# clip or two of the 64 and the MRR by as much.
TOLS = {"fp": dict(cos=1e-4, rank=1), "int8": dict(cos=6e-3, rank=3)}


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_metrics_match_jax(evals, precision):
    _, want, got, _ = evals
    assert set(got) == set(want) == {"checkpoint", "pool", "fp", "int8",
                                     "delta_int8_minus_fp"}
    w, g = want[precision], got[precision]
    assert set(g) == set(w)
    tol = TOLS[precision]
    for k in ("clean_cos", "corrupt_cos"):
        assert abs(g[k] - w[k]) <= tol["cos"], (k, g[k], w[k])
    for k in ("clean_similarity", "corrupt_similarity", "similarity_gap"):
        assert abs(g[k] - w[k]) <= 2.5 * tol["cos"], (k, g[k], w[k])
    for k in ("recall@1", "recall@5", "recall@10", "mrr"):
        assert abs(g[k] - w[k]) <= tol["rank"] / POOL, (k, g[k], w[k])
    assert abs(g["mean_rank"] - w["mean_rank"]) <= tol["rank"]


# ---- both port scripts end to end, tiny, on the CPU ---------------------------

def test_tiny_run_writes_the_jax_artifacts_and_int8_reads_its_checkpoint(
        tmp_path):
    out = str(tmp_path / "run")
    res = tproxy.main([out, "--device", "cpu", "--preset-retrieval",
                       "--samples", "64", "--acc", "1", "--epochs", "2",
                       "--extra", *TINY])
    with open(os.path.join(out, "proxy_summary.json")) as f:
        summary = json.load(f)
    assert summary == json.loads(json.dumps(res["summary"]))
    assert set(summary) == {"val_gap_trajectory", "test_metrics", "retrieval"}
    assert len(summary["val_gap_trajectory"]) == 2
    assert set(summary["test_metrics"]) == {"best_loss_model",
                                            "best_gap_model"} or \
        set(summary["test_metrics"]) == {"best_loss_model"}
    assert set(summary["retrieval"]) == {"recall@1", "recall@5", "recall@10",
                                         "mean_rank", "mrr"}
    for name in ("config.json", "training.log", "test_metrics.json",
                 "retrieval_metrics.json"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model"]["text"]["num_layers"] == 2
    assert cfg["loss"]["kind"] == "global"
    assert not cfg["model"]["heads"]["use_cross_modal"]
    best = "best_model_gap" if os.path.isdir(
        os.path.join(out, "best_model_gap")) else "best_model_loss"
    result = tint8.main(["--checkpoint", os.path.join(out, best),
                         "--device", "cpu"])
    with open(os.path.join(out, "int8_quality_eval.json")) as f:
        assert json.load(f) == json.loads(json.dumps(result))
    assert result["pool"] == 16
    assert result["fp"]["recall@10"] == summary["retrieval"]["recall@10"]
    for k, d in result["delta_int8_minus_fp"].items():
        assert d == round(result["int8"][k] - result["fp"][k], 6)


SCRIPTS = ("torch_proxy_quality_run", "torch_int8_quality_eval")


@pytest.fixture(scope="module")
def no_jax_runs():
    """One fresh interpreter with JAX and the JAX package blocked: each
    script is loaded by path and its ``main`` called with ``cuda`` and no
    card; → the line each printed ("ok" when ``main`` raised the port's
    no-device error and no JAX module was imported)."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', "
            "'speech_transcript_embeddings_tpu'): sys.modules[m] = None\n"
            "import importlib.util, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"for script in {SCRIPTS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        script, f'scripts/{script}.py')\n"
            "    m = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(m)\n"
            "    argv = (['/nonexistent', '--preset-retrieval'] if 'proxy' in "
            "script else ['--checkpoint', '/nonexistent'])\n"
            "    try:\n"
            "        m.main(argv)\n"
            "    except RuntimeError as e:\n"
            "        said = 'ok' if 'no CUDA device' in str(e) else repr(e)\n"
            "    else:\n"
            "        said = 'cuda without a card ran'\n"
            "    if any(k.split('.')[0] in ('jax', 'flax', "
            "'speech_transcript_embeddings_tpu') and sys.modules[k] is not "
            "None for k in sys.modules):\n"
            "        said = 'JAX imported'\n"
            "    print(script, said, flush=True)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    return out, dict(ln.split(" ", 1) for ln in out.stdout.splitlines())


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_without_jax_and_cuda_without_a_card_raises(
        no_jax_runs, script):
    out, said = no_jax_runs
    assert out.returncode == 0 and said.get(script) == "ok", (said,
                                                              out.stderr)
