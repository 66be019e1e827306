"""The port's benchmark tools (``bench_torch.py``,
``scripts/torch_infer_bench.py``, ``scripts/torch_mfu.py``) and their shared
parts (``speech_transcript_embeddings_torch/utils/bench.py``) on the CPU:

(a) the clip-length sampler and the bucket mix equal bench.py's: its
    ``_sample_cv_lengths`` for several seeds, and the batches its
    ``_measure_length_mix`` feeds the train step (run with a stand-in for
    ``jax`` and the step), array for array, with its mix string at B = 16;
(b) ``count_flops`` of a tiny audio encoder's forward and of tiny train
    steps equals JAX's count of the same config (XLA attention, the plain
    frontend), read from the jaxpr as the FLOPs of ``dot_general`` and
    ``conv_general_dilated`` (2 a multiply-add), exactly. The one product
    the two counted differently, the depthwise convolution's weight
    gradient (torch's formula ignores its groups), is counted by
    ``utils.bench``'s own formula, held here to the forward's count;
(c) the ceiling refuses a reading above the peak, and an unknown card has
    no peak; the card sampler parses, windows and stops its process;
(d) each tool runs end to end with ``--device cpu`` at a tiny size (fewer
    steps: the step counts are module constants) and prints its keys;
(e) none of the three imports JAX, and ``--device cuda`` without a card
    raises.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.extend import core as jcore

import bench
from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, FreezeConfig, LossConfig, OptimizerConfig,
    TrainConfig, retrieval_model_config, tiny_model_config,
)
from speech_transcript_embeddings_tpu.data.pipeline import DataPipeline
from speech_transcript_embeddings_tpu.data.sources import SyntheticSource
from speech_transcript_embeddings_tpu.data.tokenizers import (
    SimpleWordTokenizer,
)
from speech_transcript_embeddings_tpu.models.audio_encoder import (
    AudioEncoder as JaxAudioEncoder,
)
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, init_params,
)
from speech_transcript_embeddings_tpu.ops.frontend import LogMelFrontend
from speech_transcript_embeddings_tpu.training import optimizer as jopt
from speech_transcript_embeddings_tpu.training import train_step as jts
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models import audio_encoder as tae
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.training import train_step as tts
from speech_transcript_embeddings_torch.utils import bench as ub
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny geometry through the tools' key=value overrides
TINY = ["model.text.vocab_size=128", "model.text.hidden_size=32",
        "model.text.num_layers=2", "model.text.num_heads=4",
        "model.text.intermediate_size=128", "model.text.scan_bottom=0",
        "model.audio.scan_bottom=0", "model.audio.hidden_size=48",
        "model.audio.num_layers=2", "model.audio.num_heads=4",
        "model.audio.intermediate_size=192", "model.audio.feature_dim=16",
        "model.audio.conv_kernel_size=7", "model.frontend.num_mel_bins=8",
        "model.heads.projection_dim=24", "model.dtype=float32",
        "freeze.text_layers_to_unfreeze=1",
        "freeze.audio_layers_to_unfreeze=1"]


def _load(path):
    name = "_tool_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench_torch = _load("bench_torch.py")


# ---- (a) bench.py's length mix ----------------------------------------------

@pytest.mark.parametrize("seed", [7, 0, 12345])
def test_cv_lengths_are_bench_py_s(seed):
    got = ub.sample_cv_lengths(2048, np.random.default_rng(seed))
    want = bench._sample_cv_lengths(2048, np.random.default_rng(seed))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _bench_py_mix(batch):
    """bench.py's ``_measure_length_mix`` with a stand-in for ``jax``
    (identity placement, no device) and a train step that records each
    batch it is given: → (the batches, in call order, its mix string)."""
    fake = types.SimpleNamespace(
        device_put=lambda x: x, block_until_ready=lambda x: x,
        random=types.SimpleNamespace(PRNGKey=lambda s: s,
                                     split=lambda k: (k, k)))
    calls = []

    def step(state, b, key):
        calls.append(b)
        return state, {"loss": 0.0}

    cfg = ExperimentConfig(model=retrieval_model_config(),
                           data=DataConfig(batch_size=batch,
                                           max_text_length=64))
    _, mix = bench._measure_length_mix(fake, cfg, step, None, 1)
    return calls, mix


@pytest.mark.parametrize("batch", [16, 64])
def test_bucket_mix_is_bench_py_s(batch):
    """The port's mix gives bench.py's train step the same batches, array
    for array, in the same order (two warm steps, then every batch after
    the first, bucket by bucket)."""
    want, want_mix = _bench_py_mix(batch)
    cfg = bench_torch.build_config("retrieval-lengths", batch)
    got, mix = [], []
    for bucket, n_batches, batches in bench_torch.mix_batches(cfg):
        got += batches[:2] + (batches[1:] if len(batches) > 1 else batches)
        mix.append((bucket, None, n_batches))
    assert ub.mix_string(mix) == want_mix
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    if batch == 16:
        assert want_mix == "2s×18 5s×71 10s×35 15s×3"


def test_bucket_mix_caps_and_drops_the_remainder():
    mix = ub.bucket_mix([10, 20, 21, 35, 99, 5], (20, 40), 30, 2)
    # 35 and 99 → capped at 30 → the 40 bucket, as 21; 10, 20 and 5 → 20;
    # each bucket one full batch, its third clip dropped
    assert mix == [(20, [10, 20, 5], 1), (40, [21, 30, 30], 1)]
    assert ub.bucket_mix([10], (20,), 30, 2) == []


# ---- (b) FLOP counts against JAX's jaxpr ------------------------------------

def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def jaxpr_flops(jaxpr) -> int:
    """2 a multiply-add of every ``dot_general`` and
    ``conv_general_dilated`` of ``jaxpr`` and its inner jaxprs (a scan's
    body times its length)."""
    total = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            (contract, _), _ = e.params["dimension_numbers"]
            k = math.prod(e.invars[0].aval.shape[d] for d in contract)
            total += 2 * math.prod(e.outvars[0].aval.shape) * k
        elif name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            out_features = rhs[e.params["dimension_numbers"].rhs_spec[0]]
            total += (2 * math.prod(e.outvars[0].aval.shape)
                      * math.prod(rhs) // out_features)
        else:
            times = e.params.get("length", 1) if name == "scan" else 1
            total += times * sum(jaxpr_flops(s) for s in _sub_jaxprs(e))
    return total


def test_encoder_forward_count_equals_jax():
    cfg = tiny_model_config().audio
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 40, cfg.feature_dim)).astype(np.float32)
    mask = np.ones((3, 40), np.float32)
    mask[1, 30:] = 0
    enc = JaxAudioEncoder(cfg, dtype=jnp.float32)
    params = enc.init(jax.random.PRNGKey(0), feats, mask)["params"]
    want = jaxpr_flops(jax.make_jaxpr(
        lambda p, x, m: enc.apply({"params": p}, x, m))(params, feats,
                                                        mask).jaxpr)
    port = tae.AudioEncoder(port_cfg(cfg), torch.float32)
    for p in port.parameters():
        torch.nn.init.normal_(p)
    got = ub.count_flops(port, torch.from_numpy(feats),
                         torch.from_numpy(mask))
    assert got == want > 0


STEP_CASES = {
    "global": dict(kind="global"),
    "pairwise_fused": dict(kind="pairwise", fused=True),
    "global_remat_full": dict(kind="global", remat=True),
    "global_remat_save_hot2": dict(kind="global", remat=True,
                                   policy="save_hot2"),
    "global_frozen_bottom": dict(kind="global", bottom=False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_count_equals_jax(case):
    """The whole step (frontend, both encoders, heads, loss, the backward
    of the trainable split, the remat replay where on), 1 of 2 blocks
    trainable: the port's count equals JAX's jaxpr count."""
    c = dict(kind="global", fused=False, remat=False, policy="full",
             bottom=True)
    c.update(STEP_CASES[case])
    mc = tiny_model_config(use_word_alignment=c["fused"])
    mc = dataclasses.replace(
        mc, remat=c["remat"],
        heads=dataclasses.replace(mc.heads, use_cross_modal=c["fused"]),
        audio=dataclasses.replace(mc.audio, remat_policy=c["policy"]))
    cfg = ExperimentConfig(
        model=mc,
        freeze=FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                            audio_layers_to_unfreeze=1,
                            train_text_embeddings=c["bottom"],
                            train_audio_feature_projection=c["bottom"]),
        loss=LossConfig(kind=c["kind"]),
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=0),
        data=DataConfig(dataset="synthetic", batch_size=4, max_text_length=12,
                        audio_buckets=(16000,), max_audio_samples=16000,
                        num_synthetic_samples=16),
        train=TrainConfig(num_epochs=1, accumulation_steps=1, seed=0))
    pipe = DataPipeline(cfg.data, SimpleWordTokenizer(vocab_size=128), seed=0)
    batch = next(iter(pipe.epoch_batches(SyntheticSource(cfg.data, seed=3),
                                         "train", epoch=0)))
    model = JaxModel(cfg.model)
    params = jax.tree.map(np.asarray, init_params(model,
                                                  jax.random.PRNGKey(0)))
    labels = jopt.param_labels(params, cfg.freeze, cfg.model)
    tx = jopt.make_optimizer(cfg.optimizer, cfg.freeze,
                             jopt.split_params(labels, labels)[0], 4)
    jstate = jts.create_train_state(jax.tree.map(jnp.asarray, params), labels,
                                    tx, jts.resolve_frozen_dtype(cfg))
    jstep = jts.make_train_step(cfg, model, LogMelFrontend(cfg.model.frontend),
                                tx)
    want = jaxpr_flops(jax.make_jaxpr(jstep)(jstate, batch,
                                             jax.random.PRNGKey(1)).jaxpr)
    pcfg = port_cfg(cfg)
    pmodel = DualEncoderModel(pcfg.model, param_dtype=torch.float32)
    bridge.load_flax_params(pmodel, params)
    state = tts.create_train_state(pmodel, pcfg, 4)
    got = ub.count_flops(tts.train_step, pcfg, state,
                         make_frontend(pcfg.model.frontend), batch,
                         torch.Generator().manual_seed(0))
    assert got == want > 0


def test_depthwise_weight_gradient_counts_as_its_forward():
    """A depthwise kernel's gradient is one product over the same
    positions as the forward: forward + input gradient + weight gradient
    = 3 × forward (torch's own formula counts the weight gradient H times
    over)."""
    h, k = 48, 7
    x = torch.randn(2, h, 30, requires_grad=True)
    w = torch.randn(h, 1, k, requires_grad=True)
    fwd = ub.count_flops(torch.nn.functional.conv1d, x.detach(), w.detach(),
                         groups=h)
    both = ub.count_flops(lambda: torch.nn.functional.conv1d(
        x, w, groups=h).sum().backward())
    assert fwd == 2 * 2 * h * 24 * k and both == 3 * fwd


@pytest.mark.parametrize("kernel", ["layer_norm_fwd", "depthwise_glu_fwd",
                                    "flash_rel_fwd"])
def test_count_flops_refuses_only_a_launch_that_hides_products(kernel):
    """The launch counters list the LayerNorm and depthwise GLU kernels,
    which the card runs whatever the config says; they compute no matrix
    products, so a count that launches them stands, while a flash launch
    raises."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    counter = {"layer_norm_fwd": ln.LAUNCHES, "depthwise_glu_fwd":
               dg.LAUNCHES, "flash_rel_fwd": fa.LAUNCHES}[kernel]
    ub.reset_launches()
    assert ub.launches()[kernel] == 0

    def step(a, b):
        counter[kernel] += 1
        return a @ b

    a, b = torch.ones(3, 4), torch.ones(4, 5)
    try:
        if counter is not fa.LAUNCHES:
            assert ub.count_flops(step, a, b) == 2 * 3 * 4 * 5
            assert ub.launches()[kernel] == 1
        else:
            with pytest.raises(RuntimeError, match="launched"):
                ub.count_flops(step, a, b)
    finally:
        ub.reset_launches()


# ---- (c) the ceiling and the card sampler -----------------------------------

def test_ceiling_refuses_a_reading_above_the_peak():
    peak = ub.peak_bf16("NVIDIA H100 80GB HBM3")
    assert peak == 989e12
    assert ub.ceiling(494.5e12, 1.0, peak) == pytest.approx(0.5)
    assert ub.ceiling(989e12, 1.0, peak) == 1.0
    for flops, secs in ((989.1e12, 1.0), (1e12, 1e-3), (float("nan"), 1.0)):
        with pytest.raises(ValueError, match="refused"):
            ub.ceiling(flops, secs, peak)


def test_an_unknown_card_has_no_peak():
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "cpu"):
        with pytest.raises(ValueError, match="no bf16 peak"):
            ub.peak_bf16(name)


def test_card_sampler_keeps_only_the_recorded_windows():
    """The sampler's process (a stand-in for ``nvidia-smi -lms``) prints a
    clock and a power each 10 ms, its power 500 W before the window and
    300 W after it starts; only the window's samples are kept, and the
    process is stopped at the end."""
    sampler = ub.CardSampler()
    flag = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"sampler_{os.getpid()}_{time.time_ns()}")
    sampler.cmd = [sys.executable, "-c", (
        "import os, sys, time\n"
        "while True:\n"
        f"    w = '300.5' if os.path.exists({flag!r}) else '500.0'\n"
        "    print('1755, ' + w, flush=True)\n"
        "    print('[N/A], [N/A]', flush=True)\n"
        "    time.sleep(0.01)\n")]
    try:
        with sampler:
            time.sleep(0.5)
            open(flag, "w").close()
            time.sleep(0.1)
            with sampler.recording():
                time.sleep(0.3)
            time.sleep(0.1)
        s = sampler.summary()
    finally:
        os.remove(flag)
    assert sampler._proc.returncode is not None
    assert s["sm_clock_mhz"]["median"] == 1755.0
    assert s["power_w"] == {"median": 300.5, "min": 300.5, "max": 300.5,
                            "samples": s["power_w"]["samples"]}
    assert s["power_w"]["samples"] >= 5


def test_card_sampler_without_a_sample_raises():
    with pytest.raises(RuntimeError, match="no sample"):
        ub.CardSampler().summary()


# ---- (d) the tools end to end on the CPU ------------------------------------

KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "device_busy_ms",
        "idle_share", "step_tflop", "hfu", "peak_memory_gib", "sm_clock_mhz",
        "power_w", "card", "kernel_launches"}


@pytest.mark.parametrize("config", bench_torch.CONFIGS)
def test_bench_runs_each_config_on_the_cpu(config, monkeypatch, capsys,
                                           tmp_path):
    for name, value in (("MEASURE_STEPS", 1), ("MIN_TIMED_CLIPS", 1),
                        ("MIX_CLIPS", 96), ("MIX_MIN_STEPS", 1),
                        ("MIX_TIMED_CLIPS", 1)):
        monkeypatch.setattr(bench_torch, name, value)
    artifact = tmp_path / "lengths.json"
    monkeypatch.setattr(bench_torch, "LENGTHS_ARTIFACT", str(artifact))
    out = bench_torch.main(["--config", config, "--batch", "4", "--device",
                            "cpu", *TINY, "model.audio.num_layers=1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert KEYS <= set(printed) and printed["config"] == config
    assert printed["metric"] == "train_clips_per_sec_per_chip"
    assert np.isfinite(printed["value"]) and printed["value"] > 0
    # both rounded to 3 decimals from the unrounded clips/s
    assert printed["vs_baseline"] == pytest.approx(printed["value"] / 5.8,
                                                   abs=1e-3)
    assert printed["step_tflop"] > 0 and printed["card"] == "cpu"
    # no device: nothing of one is measured
    for k in ("device_busy_ms", "idle_share", "hfu", "peak_memory_gib",
              "sm_clock_mhz", "power_w"):
        assert printed[k] is None, k
    mixed = config in ("retrieval", "retrieval-lengths")
    assert ("fixed_10s_value" in printed) == (config == "retrieval")
    assert artifact.exists() == mixed
    if mixed:
        assert "bucketed pipeline [" in printed["unit"]
        assert json.loads(artifact.read_text())["value"] == printed["value"]
        assert all(b["timed_steps"] >= 1 and b["step_tflop"] > 0
                   for b in printed["buckets"])


@pytest.mark.parametrize("int8", [False, True])
def test_infer_bench_runs_on_the_cpu(int8, monkeypatch, capsys):
    tool = _load("scripts/torch_infer_bench.py")
    monkeypatch.setattr(tool, "B", 2)
    monkeypatch.setattr(tool, "TIMED", 1)
    out = tool.main(["--device", "cpu", *TINY, "model.audio.num_layers=1"]
                    + (["--int8"] if int8 else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert lines[-2].startswith(f"embed step [{'int8' if int8 else 'bf16'}]")
    assert out["clips_per_s"] > 0 and out["step_tflop"] > 0
    assert out["mfu"] is None and out["device_busy_ms"] is None


def test_mfu_runs_on_the_cpu(capsys):
    tool = _load("scripts/torch_mfu.py")
    out = tool.main(["--device", "cpu", "--batch", "2", "--seconds", "1",
                     *TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == json.loads(json.dumps(out))
    fwd, step = out
    assert fwd["what"] == "conformer_forward" and fwd["model_tflops"] > 0
    assert step["what"] == "flagship_train_step"
    # the step's count holds a forward of the encoder and more
    assert step["executed_tflops"] > fwd["model_tflops"] / 2
    assert fwd["mfu"] is None and step["hfu"] is None


# ---- (e) no JAX, and no card ------------------------------------------------

TOOLS = ("bench_torch.py", "scripts/torch_infer_bench.py",
         "scripts/torch_mfu.py")


@pytest.fixture(scope="module")
def no_jax_runs():
    """One fresh interpreter with JAX and the JAX package blocked: each
    tool loaded by path and its ``main`` called with ``--device cuda`` and
    no card; → the line each printed ("ok" when ``main`` raised the port's
    no-device error and no JAX module was imported)."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', "
            "'speech_transcript_embeddings_tpu', 'bench'): "
            "sys.modules[m] = None\n"
            "import importlib.util, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"for tool in {TOOLS!r}:\n"
            "    spec = importlib.util.spec_from_file_location('t', tool)\n"
            "    m = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(m)\n"
            "    try:\n"
            "        m.main(['--device', 'cuda'])\n"
            "    except RuntimeError as e:\n"
            "        said = 'ok' if 'no CUDA device' in str(e) else repr(e)\n"
            "    else:\n"
            "        said = 'cuda without a card ran'\n"
            "    if any(k.split('.')[0] in ('jax', 'flax', 'bench', "
            "'speech_transcript_embeddings_tpu') and sys.modules[k] is not "
            "None for k in sys.modules):\n"
            "        said = 'JAX imported'\n"
            "    print(tool, said, flush=True)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    return out, dict(ln.split(" ", 1) for ln in out.stdout.splitlines())


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_import_without_jax_and_cuda_without_a_card_raises(
        no_jax_runs, tool):
    out, said = no_jax_runs
    assert out.returncode == 0 and said.get(tool) == "ok", (said, out.stderr)
