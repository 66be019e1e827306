"""The port's ablation tools and conversion validator
(``scripts/torch_conv_ablate.py``, ``torch_depthwise_sweep.py``,
``torch_flash_ablate.py``, ``torch_flash_tile_sweep.py``,
``torch_validate_flagship_conversion.py``) on the CPU, at tiny sizes:

(a) the conv-ablation variants and both depthwise formulations equal
    JAX's (``scripts/conv_ablate.py``, ``scripts/depthwise_sweep.py``,
    loaded by path with their ``B, T, H, K`` set small and their ``timeit``
    replaced by one that records the call) on the same
    ``default_rng(0)`` inputs, forward and forward+backward, in bf16 as the
    scripts run: max|Δ| over max|JAX| ≤ 2e-2;
(b) the kernel variants' source rewriting: the bias switches are defined
    once and committed as 1, each spec of the flash ablation and of the
    tile sweep replaces exactly its definitions, the head-dim rewrite
    replaces one switch, an unknown name raises;
(c) the validator's checks pass at a toy geometry (2 layers, hidden 32,
    vocab 100, set through its module constants), and its ingested state
    equals JAX's ``params_from_reference_checkpoint`` through the bridge;
(d) none of the five imports JAX, each one's ``--device cuda`` without a
    card raises, and the CPU paths (the two conv tools at a tiny size, the
    validator at the toy geometry) run with JAX blocked.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_transcript_embeddings_tpu.models import ingest_torch as jingest
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models import ingest_torch
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "speech_transcript_embeddings_torch", "csrc")
TINY_CONV = dict(B=2, T=9, H=8, K=3)
TOY = dict(D_TEXT=32, TEXT_LAYERS=2, TEXT_HEADS=4, D_AUDIO=32,
           AUDIO_LAYERS=2, AUDIO_HEADS=4, D_PROJ=32, VOCAB=100)


def _load(path, **constants):
    name = "_tool_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for k, v in constants.items():
        setattr(module, k, v)
    return module


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what):
    """max|got − want| ≤ 2e-2 · max|want| (bf16, as the scripts run)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = _np(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    assert err <= 2e-2 * float(np.max(np.abs(want))), (what, err)


def _recorded_jax(path):
    """JAX's script at ``TINY_CONV`` run through its ``main``; → the
    (jitted function, args) of each ``timeit`` call, in order."""
    module = _load(path, **TINY_CONV)
    calls = []

    def record(fn, *args, n=20):
        calls.append((fn, args))
        return 0.0

    module.timeit = record
    module.main()
    return calls


# ---- (a) the conv tools against JAX's ----------------------------------------

@pytest.fixture(scope="module")
def depthwise():
    calls = _recorded_jax("scripts/depthwise_sweep.py")
    port = _load("scripts/torch_depthwise_sweep.py", **TINY_CONV)
    x, w, cot = port.inputs("cpu")
    # the same draws: JAX's x and w are the arguments it timed
    np.testing.assert_array_equal(x.float().numpy(), _np(calls[0][1][0]))
    np.testing.assert_array_equal(w.numpy(), _np(calls[0][1][1]))
    return calls, port, (x, w, cot)


@pytest.mark.parametrize("pass_", ["fwd", "fwd_bwd"])
@pytest.mark.parametrize("name", ["grouped", "shift"])
def test_depthwise_formulations_match_jax(depthwise, name, pass_):
    calls, port, (x, w, cot) = depthwise
    fn = {"grouped": port.conv_grouped, "shift": port.conv_shift}[name]
    # timeit order: grouped fwd, grouped fwd+bwd, shift fwd, shift fwd+bwd
    jfn, jargs = calls[2 * ("grouped", "shift").index(name)
                       + ("fwd", "fwd_bwd").index(pass_)]
    if pass_ == "fwd":
        with torch.no_grad():
            _close(fn(x, w), jfn(*jargs), f"{name} forward")
        return
    value, (gx, gw) = jfn(*jargs)
    loss, px, pw = port.loss_and_grads(fn, x, w, cot)
    _close(loss.reshape(1), jnp.reshape(value, (1,)), f"{name} loss")
    _close(px, gx, f"{name} dx")
    _close(pw, gw, f"{name} dw")


@pytest.fixture(scope="module")
def conv_ablate():
    calls = _recorded_jax("scripts/conv_ablate.py")
    port = _load("scripts/torch_conv_ablate.py", **TINY_CONV)
    x, w1, w2, dw = port.inputs("cpu")
    np.testing.assert_array_equal(x.float().numpy(), _np(calls[0][1][0]))
    cot = np.random.default_rng(9).normal(size=tuple(x.shape)).astype(
        np.float32)
    return calls, port, (x, w1, w2, dw), cot


@pytest.mark.parametrize("pass_", ["fwd", "fwd_bwd"])
@pytest.mark.parametrize("name", ["full", "no_depthwise", "no_lns",
                                  "matmuls_only"])
def test_conv_ablation_variants_match_jax(conv_ablate, name, pass_):
    calls, port, (x, w1, w2, dw), cot = conv_ablate
    jfn, (jx,) = calls[port.VARIANTS.index(name)]
    fn = port.variant(name, w1, w2, dw)
    if pass_ == "fwd":
        with torch.no_grad():
            _close(fn(x), jfn(jx), f"{name} forward")
        return
    jcot = jnp.asarray(cot)
    want = jax.grad(lambda v: jnp.sum(jfn(v).astype(jnp.float32) * jcot))(jx)
    xg = x.detach().requires_grad_(True)
    (got,) = torch.autograd.grad(
        torch.sum(fn(xg).float() * torch.from_numpy(cot)), (xg,))
    _close(got, want, f"{name} dx")


# ---- (b) the kernel variants' sources -----------------------------------------

@pytest.fixture(scope="module")
def bwd_times():
    return _load("scripts/torch_flash_bwd_times.py")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("source, names", [
    ("flash_rel_fwd_sm90.cu", ("kRelBias",)),
    ("flash_rel_bwd_sm90.cu", ("kRelBias", "kRelBiasGrad"))])
def test_bias_switches_are_defined_once_and_committed_on(source, names):
    text = _source(source)
    for name in names:
        assert len(re.findall(rf"constexpr int {name} = ", text)) == 1
        assert len(re.findall(rf"constexpr int {name} = 1;", text)) == 1


def _specs():
    ablate = _load("scripts/torch_flash_ablate.py")
    sweep = _load("scripts/torch_flash_tile_sweep.py")
    cases = [(ablate.FWD_SOURCE, f) for f, _ in ablate.VARIANTS.values()]
    cases += [(ablate.BWD_SOURCE, b) for _, b in ablate.VARIANTS.values()]
    cases += [(sweep.SOURCE, s) for s in sweep.SPECS]
    return cases


@pytest.mark.parametrize("source, spec", _specs())
def test_each_spec_rewrites_exactly_its_definitions(bwd_times, source, spec):
    text = _source(source)
    out = bwd_times.variant_source(text, spec, source)
    pairs = [item.split("=") for item in filter(None, spec.split(","))]
    for name, value in pairs:
        assert len(re.findall(rf"constexpr int {name} = {value};", out)) == 1
    changed = [(a, b) for a, b in zip(text.splitlines(), out.splitlines())
               if a != b]
    assert len(changed) == len(pairs)
    assert len(text.splitlines()) == len(out.splitlines())


@pytest.mark.parametrize("source", ["flash_rel_fwd_sm90.cu",
                                    "flash_rel_bwd_sm90.cu"])
def test_head_dim_rewrite_and_an_unknown_name(bwd_times, source):
    text = _source(source)
    out = bwd_times.only_head_dim(text, 64, source)
    assert "case 16:" in text and "case 16:" not in out
    assert out.count("STE_LAUNCH(64);") == 1
    assert "if (hd != 64) return" in out
    with pytest.raises(ValueError, match="kNope: 0 definitions"):
        bwd_times.variant_source(text, "kNope=1", source)


# ---- (c) the conversion validator at a toy geometry ---------------------------

def test_validator_ingests_as_jax_does_at_a_toy_geometry(tmp_path, capsys):
    v = _load("scripts/torch_validate_flagship_conversion.py", **TOY)
    text_hf, text_cfg = v.build_text_hf()
    audio_hf, audio_cfg = v.build_audio_hf()
    text_state = v.validate_text(text_hf, text_cfg, "cpu")
    audio_state = v.validate_audio(audio_hf, audio_cfg, "cpu")
    state = v.validate_ingest(text_hf, audio_hf, text_state, audio_state,
                              str(tmp_path), "cpu")
    v.validate_build_converted(text_hf, audio_hf, "cpu")
    said = capsys.readouterr().out
    assert "FAIL" not in said and said.count("PASS") == 12, said
    ckpt, _ = v.build_reference_ckpt(text_hf, audio_hf)
    jcfg = jingest.sniff_reference_config(ckpt)
    want = bridge.flax_to_state_dict(
        jingest.params_from_reference_checkpoint(ckpt, jcfg))
    assert set(state) == set(want)
    for k, t in state.items():
        assert torch.equal(t, want[k]), k
    assert ingest_torch.sniff_reference_config(ckpt) == port_cfg(jcfg)


def test_validator_fails_a_check_beyond_its_tolerance():
    v = _load("scripts/torch_validate_flagship_conversion.py")
    with pytest.raises(SystemExit, match="exceeded tolerance"):
        v._report("a check", np.zeros(3), np.full(3, 2e-3), 1e-3)


# ---- (d) no JAX, and cuda without a card -------------------------------------

TOOLS = ("scripts/torch_conv_ablate.py", "scripts/torch_depthwise_sweep.py",
         "scripts/torch_flash_ablate.py", "scripts/torch_flash_tile_sweep.py",
         "scripts/torch_validate_flagship_conversion.py")


@pytest.fixture(scope="module")
def no_jax_runs():
    """One fresh interpreter with JAX and the JAX package blocked and no
    card: each tool loaded by path and its ``main`` called with ``--device
    cuda`` (→ "ok" when it raised the port's no-device error), then the CPU
    runs: the two conv tools at ``TINY_CONV``, the validator at ``TOY``
    (→ "cpu ok" when each returned); "JAX imported" if any module of JAX
    was."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', "
            "'speech_transcript_embeddings_tpu'): sys.modules[m] = None\n"
            "import importlib.util, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "def load(tool, **k):\n"
            "    spec = importlib.util.spec_from_file_location('t', tool)\n"
            "    m = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(m)\n"
            "    for a, b in k.items(): setattr(m, a, b)\n"
            "    return m\n"
            "def jax_seen():\n"
            "    return any(k.split('.')[0] in ('jax', 'flax', "
            "'speech_transcript_embeddings_tpu') and sys.modules[k] is not "
            "None for k in sys.modules)\n"
            f"for tool in {TOOLS!r}:\n"
            "    try:\n"
            "        load(tool).main(['--device', 'cuda'])\n"
            "    except RuntimeError as e:\n"
            "        said = 'ok' if 'no CUDA device' in str(e) else repr(e)\n"
            "    else:\n"
            "        said = 'cuda without a card ran'\n"
            "    print(tool, 'JAX imported' if jax_seen() else said, "
            "flush=True)\n"
            f"for tool, k, argv in ((({TOOLS[0]!r}, {TINY_CONV!r}, "
            "['--iters', '1'])), "
            f"({TOOLS[1]!r}, {TINY_CONV!r}, ['--iters', '1']), "
            f"({TOOLS[4]!r}, {TOY!r}, [])):\n"
            "    out = load(tool, **k).main(['--device', 'cpu'] + argv)\n"
            "    said = 'cpu ok' if out else 'no result'\n"
            "    print(tool + ':cpu', 'JAX imported' if jax_seen() else said, "
            "flush=True)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    said = dict(ln.split(" ", 1) for ln in out.stdout.splitlines()
                if ln.startswith("scripts/"))
    return out, said


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_import_without_jax_and_cuda_without_a_card_raises(
        no_jax_runs, tool):
    out, said = no_jax_runs
    assert said.get(tool) == "ok", (said, out.stderr[-3000:])


@pytest.mark.parametrize("tool", [TOOLS[0], TOOLS[1], TOOLS[4]])
def test_cpu_paths_run_without_jax(no_jax_runs, tool):
    out, said = no_jax_runs
    assert out.returncode == 0 and said.get(tool + ":cpu") == "cpu ok", (
        said, out.stderr[-3000:])
    # the conv tools and the validator end with their JSON line
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3 and all(json.loads(ln) for ln in lines)
