"""The port's step-diagnosis tools (``scripts/torch_profile_b16.py``,
``torch_step_decompose.py``, ``torch_block_breakdown.py``,
``torch_text_share.py``, ``torch_ab_remat.py``, ``torch_pipeline_bench.py``)
and their shared part (``speech_transcript_embeddings_torch/utils/
profile.py``) on the CPU, at tiny sizes:

(a) ``attribute`` on a hand-made trace (nested host ops on two threads,
    kernels on two streams that overlap, gaps whose ending kernel's
    correlation id names its launch, one that names none): self times,
    busy union, overlap, span, idle and each gap's attribution equal the
    values worked out by hand; ``kernel_family`` on the eight
    ``__global__`` kernels of ``csrc/`` and on library names as a card's
    trace prints them;
(b) the functions each tool times equal JAX's on weights carried across
    by ``bridge.load_flax_params``, fp32, rel 1e-4: step_decompose's loss
    and its gradients over the trainable split, block_breakdown's five
    modules forward and (parameters, input) gradients (JAX's Pallas flash
    in interpret mode), a chain of k = 2 against JAX's ``scan`` chain,
    text_share's two modules; ab_remat's variant configs equal, field by
    field, those JAX's ``build`` makes, and an unknown suffix raises its
    message; pipeline_bench's batches equal JAX's ``DataPipeline``'s;
(c) each tool's ``main`` runs on ``--device cpu`` at a tiny size, none
    imports JAX, and ``--device cuda`` without a card raises.
"""

import dataclasses
import gzip
import importlib.util
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from speech_transcript_embeddings_tpu import config as jconfig
from speech_transcript_embeddings_tpu.data.pipeline import (
    DataPipeline as JaxPipeline,
)
from speech_transcript_embeddings_tpu.data.sources import (
    make_source as jax_make_source,
)
from speech_transcript_embeddings_tpu.data.tokenizers import (
    SimpleWordTokenizer as JaxTokenizer,
)
from speech_transcript_embeddings_tpu.models import audio_encoder as jae
from speech_transcript_embeddings_tpu.models import text_encoder as jte
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel,
)
from speech_transcript_embeddings_tpu.ops import make_frontend as jax_frontend
from speech_transcript_embeddings_tpu.training import losses as jlosses
from speech_transcript_embeddings_tpu.training import optimizer as jopt
from speech_transcript_embeddings_tpu.training import train_step as jts
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.training import train_step as tts
from speech_transcript_embeddings_torch.utils import profile as up
from torch_port_cfg import port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def _close(got, want, what=""):
    """rel 1e-4 of the tensor's scale: fp32 sums taken in another order
    differ by a few ulps of the largest terms, which an element near 0
    cannot hold to 1e-4 of itself."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4,
        atol=1e-4 * float(np.abs(want).max(initial=0.0)), err_msg=what)
# a tiny geometry through the tools' key=value overrides (tests/
# test_torch_bench.py's)
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a) the attribution on a hand-made trace -------------------------------

def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


GEMM = "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT"
ELEM = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)")
K4 = ("void (anonymous namespace)::flash_rel_bwd_dq_wgmma_kernel<64>"
      "(CUtensorMap_st, int const*)")

# µs. Thread 1 runs a step: the forward phase with a module range (a
# linear whose addmm launches the GEMM, a mul launching the elementwise
# kernel) and the optimizer phase (an add_ launching a memset); thread 2
# is the autograd engine's (a node whose mm launches K4 by the driver
# API). The GEMM and the elementwise kernel overlap on two streams; the
# device idles 50 µs before K4 (ended by the node's launch), 1 µs before
# the memset and 27 µs before a kernel whose correlation id no launch has.
TRACE = [
    _x("user_annotation", "ProfilerStep#0", 0, 100),
    _x("user_annotation", "phase: forward", 5, 55),
    _x("user_annotation", "module: audio_encoder.layer_3.attention", 10, 40),
    _x("cpu_op", "aten::linear", 12, 18),
    _x("cpu_op", "aten::addmm", 14, 14),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
    _x("cpu_op", "aten::mul", 35, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 40, 2, correlation=2),
    _x("user_annotation", "phase: optimizer", 70, 25),
    _x("cpu_op", "aten::add_", 72, 8),
    _x("cuda_runtime", "cudaLaunchKernel", 74, 1, correlation=3),
    _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 60, 10,
       tid=2),
    _x("cpu_op", "aten::mm", 61, 8, tid=2),
    _x("cuda_driver", "cuLaunchKernelEx", 62, 1, tid=2, correlation=4),
    _x("kernel", GEMM, 20, 20, pid=0, tid=7, correlation=1, stream=7),
    _x("kernel", ELEM, 30, 20, pid=0, tid=8, correlation=2, stream=8),
    _x("kernel", K4, 100, 30, pid=0, tid=7, correlation=4, stream=7),
    _x("gpu_memset", "Memset (Device)", 131, 2, pid=0, tid=7, correlation=3,
       stream=7),
    _x("kernel", "some_unknown_kernel", 160, 10, pid=0, tid=7,
       correlation=99, stream=7),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 15, "id": 1},
    _x("gpu_user_annotation", "phase: forward", 20, 40, pid=0, tid=9),
]


def _by(rows, key="op"):
    return {r[key]: (r["ms_per_step"], r["count"]) for r in rows}


def test_attribute_matches_the_hand_worked_trace():
    a = up.attribute(TRACE, steps=1)
    ms = lambda us: pytest.approx(us / 1e3)
    # device: 20 + 20 + 30 + 2 + 10 summed; union 30 + 30 + 2 + 10
    assert a["device_ms_per_step"] == ms(82)
    assert a["device_busy_ms_per_step"] == ms(72)
    assert a["overlap_ms_per_step"] == ms(10)
    assert a["span_ms_per_step"] == ms(150)
    assert a["idle_ms_per_step"] == ms(78)
    assert a["device_busy_fraction_of_span"] == pytest.approx(72 / 150)
    assert a["kernels_per_step"] == 5
    # the 27 µs gap's kernel has no launch: 51 of 78 µs attributed
    assert a["idle_attributed_share"] == pytest.approx(51 / 78)
    assert a["idle_gaps_over_ms_per_step"] == ms(77)
    assert _by(a["by_family"], "family") == {
        "GEMM (cuBLAS, cuBLASLt)": (ms(20), 1), "elementwise": (ms(20), 1),
        "K4 flash backward": (ms(30), 1),
        "copy/transpose/cat/memcpy": (ms(2), 1), "misc": (ms(10), 1)}
    assert sum(r["ms_per_step"] for r in a["by_family"]) == \
        a["device_ms_per_step"]
    assert a["top_ops"][0]["op"] == K4 and len(a["all_ops"]) == 5
    assert a["planes"] == ["device 0 stream 7 (4 records)",
                           "device 0 stream 8 (1 records)"]
    gaps = a["idle_gaps"]
    # the 50 µs gap: K4, launched under the autograd node on thread 2 (no
    # phase range there: the backward); the 1 µs gap is under 20 µs
    assert _by(gaps["by_phase"]) == {"backward": (ms(50), 1),
                                     "(none)": (ms(27), 1)}
    assert _by(gaps["by_outermost_op"]) == {
        "autograd::engine::evaluate_function: MmBackward0": (ms(50), 1),
        "(none)": (ms(27), 1)}
    assert _by(gaps["by_innermost_op"]) == {"aten::mm": (ms(50), 1),
                                            "(none)": (ms(27), 1)}
    # host self times (JAX's stack rule), per thread, layer folded
    host = _by(a["host_top_ops"])
    assert host == {
        "ProfilerStep#*": (ms(20), 1), "phase: forward": (ms(15), 1),
        "module: audio_encoder.layer_*.attention": (ms(12), 1),
        "aten::linear": (ms(4), 1), "aten::addmm": (ms(12), 1),
        "cudaLaunchKernel": (ms(5), 3), "aten::mul": (ms(8), 1),
        "phase: optimizer": (ms(17), 1), "aten::add_": (ms(7), 1),
        "autograd::engine::evaluate_function: MmBackward0": (ms(2), 1),
        "aten::mm": (ms(7), 1), "cuLaunchKernelEx": (ms(1), 1)}
    assert a["host_self_ms_per_step"] == ms(110)


def test_attribute_names_each_launch_through_its_phase_and_module():
    """A gap ended by a forward kernel: its phase range, the module range
    below it as the outermost op, the aten op as the innermost; two steps
    halve every per-step number."""
    trace = [dict(e) for e in TRACE[:8]] + [
        _x("kernel", GEMM, 20, 20, pid=0, tid=7, correlation=1),
        _x("kernel", ELEM, 100, 20, pid=0, tid=7, correlation=2)]
    a = up.attribute(trace, steps=2)
    assert a["idle_ms_per_step"] == pytest.approx(60 / 2 / 1e3)
    assert _by(a["idle_gaps"]["by_phase"]) == {
        "forward": (pytest.approx(0.03), 1)}
    assert _by(a["idle_gaps"]["by_outermost_op"]) == {
        "module: audio_encoder.layer_*.attention": (pytest.approx(0.03), 1)}
    assert _by(a["idle_gaps"]["by_innermost_op"]) == {
        "aten::mul": (pytest.approx(0.03), 1)}


def test_attribute_without_device_records_has_no_device_numbers():
    a = up.attribute([e for e in TRACE if e.get("pid") == 1], steps=1)
    assert a["device_ms_per_step"] is None and a["idle_ms_per_step"] is None
    assert a["by_family"] == [] and a["kernels_per_step"] == 0
    assert a["host_self_ms_per_step"] == pytest.approx(0.11)


def test_load_trace_reads_gzip_and_plain(tmp_path):
    for name, opener in (("t.json.gz", gzip.open), ("t.json", open)):
        with opener(tmp_path / name, "wt") as f:
            json.dump({"traceEvents": TRACE}, f)
        assert up.load_trace(str(tmp_path / name)) == TRACE


def _global_kernels():
    names = set()
    for src in os.listdir(os.path.join(
            ROOT, "speech_transcript_embeddings_torch", "csrc")):
        if src.endswith(".cu"):
            with open(os.path.join(ROOT, "speech_transcript_embeddings_torch",
                                   "csrc", src)) as f:
                names |= set(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(", f.read()))
    return sorted(names)


def test_kernel_family_of_the_port_s_eight_kernels():
    names = _global_kernels()
    assert len(names) == 8, names
    want = {"log_mel_normalize_kernel": "K1 log-mel normalise",
            "log_mel_fft_kernel": "K2 log-mel",
            "flash_rel_fwd_kernel": "K3 flash forward",
            "flash_rel_fwd_wgmma_kernel": "K3 flash forward",
            "flash_rel_bwd_dq_kernel": "K4 flash backward",
            "flash_rel_bwd_dkv_kernel": "K4 flash backward",
            "flash_rel_bwd_dq_wgmma_kernel": "K4 flash backward",
            "flash_rel_bwd_dkv_wgmma_kernel": "K4 flash backward"}
    assert sorted(want) == names
    for name in names:
        # as a trace prints them: templated, in the anonymous namespace
        for shown in (name, f"void (anonymous namespace)::{name}<64>"
                            f"(CUtensorMap_st, int const*)",
                      f"(anonymous namespace)::{name}(float const*, int)"):
            assert up.kernel_family(shown) == want[name], shown


@pytest.mark.parametrize("name, family", [
    ("nvjet_tst_256x144_64x4_1x2_h_bz_coopA_NNT", "GEMM (cuBLAS, cuBLASLt)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize"
     "1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
     "GEMM (cuBLAS, cuBLASLt)"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>("
     "cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
     "GEMM (cuBLAS, cuBLASLt)"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, "
     "4, 4, false, false>", "GEMM (cuBLAS, cuBLASLt)"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>",
     "GEMM (cuBLAS, cuBLASLt)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_i161616gemm_s8_forward"
     "Compat_128x128_32x2_nn_align4>(cutlass_80_wmma_tensorop_i161616gemm_s8"
     "_forwardCompat_128x128_32x2_nn_align4::Params)", "int8 GEMM (_int_mm)"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_"
     "kernel_generic<c10::BFloat16, int>(int)", "depthwise convolution"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_"
     "kernel<c10::BFloat16, unsigned int>(int)", "depthwise convolution"),
    ("void at::native::(anonymous namespace)::embedding_backward_feature_"
     "kernel<c10::BFloat16, float, int>(int const*)",
     "embedding gather/scatter"),
    ("void at::native::vectorized_gather_kernel<16, int>(char*)",
     "embedding gather/scatter"),
    (ELEM, "elementwise"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_"
     "stride_kernel<float, 4>", "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>",
     "copy/transpose/cat/memcpy"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16"
     "_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}>",
     "copy/transpose/cat/memcpy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>",
     "copy/transpose/cat/memcpy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/transpose/cat/memcpy"),
    ("Memset (Device)", "copy/transpose/cat/memcpy"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<"
     "float, float, false>(int)", "reduction (softmax, LayerNorm, sums)"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >",
     "reduction (softmax, LayerNorm, sums)"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, "
     "6, false, false>(float*)", "reduction (softmax, LayerNorm, sums)"),
    ("void at::native::tensor_kernel_scan_innermost_dim<long, "
     "std::plus<long> >(long*)", "reduction (softmax, LayerNorm, sums)"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<"
     "4096ul>)", "NCCL"),
    ("some_unknown_kernel", "misc"),
])
def test_kernel_family_of_library_names(name, family):
    assert up.kernel_family(name) == family


def test_step_marks_every_encoder_part_and_head():
    cfg = port_cfg(jconfig.tiny_model_config())
    model = DualEncoderModel(cfg, param_dtype=torch.float32)
    marked = up.step_modules(model, frontend="F")
    assert marked["frontend"] == "F"
    assert {"audio_encoder.layer_1.attention", "audio_encoder.layer_0.conv",
            "audio_encoder.feature_projection", "text_encoder.embeddings",
            "text_encoder.layer_1.intermediate", "audio_projection",
            "word_level_alignment"} <= set(marked)
    names = list(marked)
    for a in names:
        for b in names:
            assert a == b or not b.startswith(a + "."), (a, b)


def test_module_and_phase_ranges_close_and_restore():
    """A range per call, closed when the forward raises too (as a
    non-reentrant checkpoint's replay stops one), and the wrapped
    attributes put back."""
    class Boom(Exception):
        pass

    class Raiser(torch.nn.Module):
        def forward(self, x):
            raise Boom

    lin, raiser = torch.nn.Linear(3, 3), Raiser()
    owner = types.SimpleNamespace(f=lambda x: x + 1)
    from torch.profiler import ProfilerActivity, profile
    with up.module_ranges({"lin": lin, "r": raiser}), up.call_ranges(
            {"phase: f": [(owner, "f")], "phase: g": [(lin, "forward")]}), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        lin(torch.ones(3))
        assert owner.f(1) == 2
        for _ in range(2):
            with pytest.raises(Boom):
                raiser(torch.ones(3))
        lin(torch.ones(3))
    events = prof.events()
    names = [e.name for e in events]
    assert names.count("module: lin") == 2 and names.count("phase: f") == 1
    assert names.count("phase: g") == 2
    first, second = [e.time_range for e in events if e.name == "module: r"]
    assert first.end <= second.start
    assert owner.f(1) == 2 and "forward" not in vars(lin)
    assert not lin._forward_hooks and not lin._forward_pre_hooks
    assert not raiser._forward_hooks


# ---- (b) each tool's functions against JAX's -------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# leaves whose gradient is exactly zero in exact arithmetic (a softmax
# ignores a shift shared by all its inputs): both frameworks give rounding
# noise there, held to 1e-4 of the largest gradient of the tree
ZERO_GRAD_LEAVES = ("key.bias", "pooling.score_out.bias", "attn_k.bias")


def _assert_grads(got: dict, want_tree):
    want = bridge.flax_to_state_dict(_np_tree(want_tree))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    scale = max(float(v.abs().max()) for v in want.values())
    for k in want:
        if k.endswith(ZERO_GRAD_LEAVES):
            np.testing.assert_allclose(got[k].detach().numpy(), 0,
                                       atol=1e-4 * scale, err_msg=k)
            np.testing.assert_allclose(want[k].numpy(), 0,
                                       atol=1e-4 * scale, err_msg=k)
        else:
            _close(got[k].detach().numpy(), want[k].numpy(), k)


def test_step_decompose_loss_and_gradients_match_jax():
    """The flagship path at a tiny size: fusion and word alignment,
    pairwise loss, ``save_hot2`` remat, 1 of 2 blocks trainable (the plain
    attention: the flash pair is held to JAX's in the block tests below);
    the loss of the forward alone and of ``value_and_grad``, and every
    trainable gradient. The weights are the port's seeded init, written
    as JAX's tree (its own init compiles for ≈12 s) and carried back."""
    tool = _load("scripts/torch_step_decompose.py")
    mc = jconfig.tiny_model_config(use_word_alignment=True)
    mc = dataclasses.replace(
        mc, remat=True,
        heads=dataclasses.replace(mc.heads, use_cross_modal=True),
        audio=dataclasses.replace(mc.audio, remat_policy="save_hot2"))
    cfg = jconfig.ExperimentConfig(
        model=mc, loss=jconfig.LossConfig(kind="pairwise"),
        freeze=jconfig.FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                                    audio_layers_to_unfreeze=1),
        data=jconfig.DataConfig(batch_size=3, max_text_length=12,
                                audio_buckets=(16000,),
                                max_audio_samples=16000))
    pcfg = port_cfg(cfg)
    params = bridge.state_dict_to_flax(
        init_model(pcfg.model, torch.Generator().manual_seed(0), train=True),
        pcfg.model)
    batch = tool.host_batch(cfg, np.random.default_rng(0))
    model = JaxModel(cfg.model)
    labels = jopt.param_labels(params, cfg.freeze, cfg.model)
    trainable, frozen = jopt.split_params(params, labels)
    frontend = jax_frontend(cfg.model.frontend)

    def loss_fn(trainable, frozen, batch, rng):
        p = jopt.merge_params(trainable, frozen)
        mb = jts.model_batch_from_host(frontend, batch)
        out = model.apply({"params": p}, mb, deterministic=False,
                          rngs={"dropout": rng})
        loss, _ = jlosses.compute_loss(cfg.loss, out)
        return loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        trainable, frozen, batch, jax.random.PRNGKey(1))
    pmodel = DualEncoderModel(pcfg.model, param_dtype=torch.float32)
    bridge.load_flax_params(pmodel, params)
    state = tts.create_train_state(pmodel, pcfg, 4)
    pfront = make_frontend(pcfg.model.frontend)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        fwd = tool.loss_fn(pcfg, state, pfront, batch, gen)
    loss, grads = tool.value_and_grad(pcfg, state, pfront, batch, gen)
    _close(float(fwd), float(want_loss))
    _close(float(loss), float(want_loss))
    assert len(grads) == len(want_grads) > 0
    _assert_grads(grads, traverse_util.unflatten_dict(want_grads, sep="/"))


AUDIO = jconfig.tiny_model_config().audio
T, B = 24, 2
JAX_MODULES = {"ffn1": jae.AudioFeedForward, "attention_flash":
               jae.RelPositionAttention, "conv": jae.ConvModule,
               "block": jae.ConformerBlock,
               "attention_xla": jae.RelPositionAttention}


def _audio_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, AUDIO.hidden_size)).astype(np.float32)
    w = rng.normal(size=(B, T, AUDIO.hidden_size)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 7]])).astype(np.int32)
    return x, w, mask


def _block_pair(tool, name):
    """JAX's module of ``name`` and its params, and the tool's module with
    them carried across."""
    flash = dataclasses.replace(AUDIO, use_flash_attention=True)
    plain = dataclasses.replace(AUDIO, use_flash_attention=False)
    jmod = JAX_MODULES[name](plain if name == "attention_xla" else flash,
                             jnp.float32)
    x, _, mask = _audio_inputs()
    args = (x,) if name == "ffn1" else (x, mask)
    # the flash and plain attention share one tree: init the cheap way
    init_mod = (JAX_MODULES[name](plain, jnp.float32)
                if name.startswith("attention") or name == "block" else jmod)
    params = _np_tree(init_mod.init(jax.random.PRNGKey(0), *args,
                                    deterministic=True)["params"])
    port = tool.build(name, port_cfg(flash), port_cfg(plain), torch.float32,
                      "cpu", torch.Generator().manual_seed(0))
    bridge.load_flax_params(port, params)
    return jmod, params, port


@pytest.mark.parametrize("name", ["ffn1", "attention_flash", "conv", "block",
                                  "attention_xla"])
def test_block_breakdown_modules_match_jax(name):
    tool = _load("scripts/torch_block_breakdown.py")
    assert tuple(JAX_MODULES) == tool.MODULES
    jmod, params, port = _block_pair(tool, name)
    x, w, mask = _audio_inputs()
    rest = () if name == "ffn1" else (mask,)

    def loss(p, xx):
        o = jmod.apply({"params": p}, xx, *rest, deterministic=True)
        return jnp.sum(o * w)

    want_out = jax.jit(lambda p, xx: jmod.apply(
        {"params": p}, xx, *rest, deterministic=True))(params, x)
    want_loss, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1)))(params, x)
    tx, tw, tmask = (torch.from_numpy(a) for a in (x, w, mask))
    with torch.no_grad():
        got_out = tool.apply(name, port, tx, tmask)
    _close(got_out.numpy(), np.asarray(want_out))
    got_loss, gp, gx = tool.loss_and_grads(name, port, tx, tmask, tw)
    _close(float(got_loss), float(want_loss))
    _close(gx.numpy(), want_gx)
    _assert_grads(dict(zip((k for k, _ in port.named_parameters()), gp)),
                  want_gp)


@pytest.mark.parametrize("name", ["ffn1", "conv"])
def test_chain_of_two_matches_jax_scan(name):
    """``utils/profile.chain`` and ``chain_loss_grads`` at k = 2 against
    block_breakdown.py's ``scan`` chain (RMS renormalised carry)."""
    tool = _load("scripts/torch_block_breakdown.py")
    jmod, params, port = _block_pair(tool, name)
    x, _, mask = _audio_inputs()
    rest = () if name == "ffn1" else (mask,)

    def fwd(p, c):
        def step(cc, _):
            y = jmod.apply({"params": p}, cc, *rest, deterministic=True)
            y = y * jax.lax.rsqrt(jnp.mean(jnp.square(y)) + 1e-6)
            return y.astype(cc.dtype), None

        out, _ = jax.lax.scan(step, c, None, length=2)
        return out

    want_loss, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        lambda p, c: jnp.sum(fwd(p, c).astype(jnp.float32)),
        argnums=(0, 1)))(params, x)
    tmask = torch.from_numpy(mask)
    fn = lambda c: tool.apply(name, port, c, tmask)
    with torch.no_grad():
        got = up.chain(fn, torch.from_numpy(x), 2)
    _close(got.numpy(), np.asarray(fwd(params, x)))
    loss, gp, gx = up.chain_loss_grads(fn, list(port.parameters()),
                                       torch.from_numpy(x), 2)
    _close(float(loss), float(want_loss))
    _close(gx.numpy(), want_gx)
    _assert_grads(dict(zip((k for k, _ in port.named_parameters()), gp)),
                  want_gp)


def test_chained_times_and_the_median_call():
    """``chained_times`` gives finite per-application times of a chain it
    runs with and without gradients; ``median_call_s`` reads a known
    sleep."""
    import time
    w = torch.ones(1, requires_grad=True)
    tf, tg = up.chained_times(lambda c: c * w, [w], torch.ones(4),
                              lambda: None, k1=1, k2=3, inputs=2)
    assert np.isfinite(tf) and np.isfinite(tg)
    assert up.median_call_s(lambda _: time.sleep(0.002), [0], lambda: None,
                            n=3, warmup=1) >= 0.002


@pytest.mark.parametrize("name", ["encoder", "attention"])
def test_text_share_modules_match_jax(name):
    tool = _load("scripts/torch_text_share.py")
    mc = jconfig.tiny_model_config()
    tc = mc.text
    rng = np.random.default_rng(4)
    b, t = 3, 10
    ids = rng.integers(4, tc.vocab_size, size=(b, t)).astype(np.int32)
    x = rng.normal(size=(b, t, tc.hidden_size)).astype(np.float32)
    w = rng.normal(size=(b, t, tc.hidden_size)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, 6:] = 0
    if name == "encoder":
        jmod, inp, argnums = jte.TextEncoder(tc, jnp.float32,
                                             remat=mc.remat), ids, 0
    else:
        jmod, inp, argnums = jte.TextSelfAttention(tc, jnp.float32), x, (0, 1)
    params = _np_tree(jmod.init(jax.random.PRNGKey(0), inp, mask,
                                deterministic=True)["params"])

    def loss(p, i):
        return jnp.sum(jmod.apply({"params": p}, i, mask,
                                  deterministic=True) * w)

    want_out = jax.jit(lambda p, i: jmod.apply(
        {"params": p}, i, mask, deterministic=True))(params, inp)
    want_loss, want_g = jax.jit(jax.value_and_grad(loss, argnums=argnums))(
        params, inp)
    port = tool.build(name, port_cfg(mc), torch.float32, "cpu",
                      torch.Generator().manual_seed(0))
    bridge.load_flax_params(port, params)
    tinp, tmask = torch.from_numpy(inp), torch.from_numpy(mask)
    with torch.no_grad():
        got_out = port(tinp, tmask)
    _close(got_out.numpy(), np.asarray(want_out))
    got_loss, gp, gx = tool.loss_and_grads(port, tinp, tmask,
                                           torch.from_numpy(w),
                                           name == "attention")
    _close(float(got_loss), float(want_loss))
    if name == "attention":
        want_g, want_gx = want_g
        _close(gx.numpy(), want_gx)
    else:
        assert gx is None
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(port.named_parameters(), gp)}
    _assert_grads(grads, want_g)


VARIANTS = ["full", "save_flash", "save_hot", "save_hot2",
            "save_hot2+f32frozen", "save_flash+bf16mu", "full+frozenemb",
            "save_hot+f32frozen+bf16mu+frozenemb"]


@pytest.fixture
def jax_ab_remat(monkeypatch):
    """JAX's ab_remat.py with the model, its state and its step stubbed:
    its ``build`` then returns the config it made."""
    from speech_transcript_embeddings_tpu.models import dual_encoder as jde
    from speech_transcript_embeddings_tpu import ops as jops
    for owner, attr, value in (
            (jde, "DualEncoderModel", lambda cfg: None),
            (jde, "template_params", lambda model: {}),
            (jops, "make_frontend", lambda cfg: None),
            (jopt, "param_labels", lambda *a: {}),
            (jopt, "split_params", lambda *a: ({}, {})),
            (jopt, "make_optimizer", lambda *a, **k: None),
            (jts, "create_train_state", lambda *a, **k: None),
            (jts, "make_train_step", lambda *a, **k: None)):
        monkeypatch.setattr(owner, attr, value)
    return _load("scripts/ab_remat.py")


@pytest.mark.parametrize("variant", VARIANTS)
def test_ab_remat_variant_configs_equal_jax(jax_ab_remat, variant):
    tool = _load("scripts/torch_ab_remat.py")
    want = jax_ab_remat.build(variant)[3]
    got = tool.build_config(variant, jax_ab_remat.BATCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(port_cfg(want))
    assert got == port_cfg(want)


def test_ab_remat_unknown_suffix_raises_jax_s_message(jax_ab_remat):
    tool = _load("scripts/torch_ab_remat.py")
    with pytest.raises(SystemExit) as want:
        jax_ab_remat.build("full+f32frozen+fast")
    with pytest.raises(SystemExit) as got:
        tool.build_config("full+f32frozen+fast", 64)
    assert str(got.value) == str(want.value)
    assert "['fast']" in str(got.value)


def test_pipeline_bench_batches_equal_jax():
    tool = _load("scripts/torch_pipeline_bench.py")
    data, source, pipe = tool.make_pipeline(samples=24, batch=4)
    jdata = jconfig.DataConfig(
        dataset="synthetic", num_synthetic_samples=24, batch_size=4,
        max_text_length=64, audio_buckets=(160000,),
        max_audio_samples=160000)
    assert dataclasses.asdict(data) == dataclasses.asdict(jdata)
    jsource = jax_make_source(jdata, seed=0)
    jpipe = JaxPipeline(jdata, JaxTokenizer(vocab_size=512), seed=0)
    for epoch in (0, 1):
        got = list(pipe.epoch_batches(source, "train", epoch))
        want = list(jpipe.epoch_batches(jsource, "train", epoch))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---- (c) the tools end to end on the CPU ------------------------------------

def test_profile_b16_runs_on_the_cpu_and_parses_again(tmp_path, capsys):
    tool = _load("scripts/torch_profile_b16.py")
    out = str(tmp_path / "prof")
    summary = tool.main(["--out", out, "--batch", "2", "--steps", "2",
                         "--device", "cpu", *TINY,
                         "model.audio.num_layers=1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["written"] == os.path.join(out, "profile_attribution.json")
    with open(line["written"]) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    # JAX's keys, and the port's
    assert {"batch", "traced_wall_ms_per_step", "clips_per_sec_device",
            "xplane", "planes", "device_ms_per_step",
            "device_busy_fraction_of_span",
            "async_dma_ms_per_step_overlapped", "by_family", "top_ops",
            "untraced_step_ms", "device_busy_ms", "overlap_ms_per_step",
            "host_top_ops", "idle_ms_per_step", "idle_gaps",
            "card"} <= set(written)
    # no device: nothing of one is measured
    assert written["card"] == "cpu" and written["device_busy_ms"] is None
    assert written["device_ms_per_step"] is None and not written["by_family"]
    ops = {r["op"] for r in written["host_top_ops"]}
    assert {"phase: forward", "phase: backward", "phase: optimizer"} <= ops
    ranges = {e["name"] for e in up.load_trace(written["xplane"][0])
              if e.get("cat") == "user_annotation"}
    assert {"module: audio_encoder.layer_0.attention", "module: frontend",
            "phase: frontend", "phase: loss", "phase: grad_norm",
            "ProfilerStep#1"} <= ranges
    assert written["untraced_step_ms"] > 0
    again = tool.main(["--out", out, "--parse-only"])
    assert json.loads(json.dumps(again)) == written
    assert os.path.exists(os.path.join(out, "top_ops_full.txt"))


def test_step_decompose_runs_on_the_cpu(monkeypatch, capsys):
    tool = _load("scripts/torch_step_decompose.py")
    monkeypatch.setattr(tool, "WARM", 1)
    monkeypatch.setattr(tool, "TIMED", 1)
    out = tool.main(["--batch", "2", "--seconds", "1", "--device", "cpu",
                     *TINY, "model.audio.num_layers=1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert [r["what"] for r in out["readings"]] == [
        "fwd-only (host batch)", "fwd-only (device batch)",
        "value_and_grad (device)", "full train_step"]
    assert all(r["host_ms"] > 0 and r["device_busy_ms"] is None
               for r in out["readings"])
    assert lines[0].startswith("fwd-only (host batch): ")


@pytest.mark.parametrize("chained", [False, True])
def test_block_breakdown_runs_on_the_cpu(chained, monkeypatch, capsys):
    tool = _load("scripts/torch_block_breakdown.py")
    monkeypatch.setattr(tool, "TIMED", 2)
    monkeypatch.setattr(tool, "CHAINS", {})
    monkeypatch.setattr(tool, "CHAIN", (1, 2))
    out = tool.main(["--batch", "2", "--frames", "20", "--device", "cpu",
                     "model.audio.hidden_size=32", "model.audio.num_heads=4",
                     "model.audio.intermediate_size=64",
                     "model.audio.conv_kernel_size=5"]
                    + (["--chained"] if chained else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert [r["what"] for r in out["results"]] == list(tool.MODULES)
    assert [json.loads(ln) for ln in lines[:-1]] == out["results"]
    assert all(np.isfinite(r["fwd_ms"]) and np.isfinite(r["fwd_bwd_ms"])
               and "error" not in r for r in out["results"])


def test_text_share_runs_on_the_cpu(capsys):
    tool = _load("scripts/torch_text_share.py")
    out = tool.main(["--batch", "2", "--tlen", "8", "--device", "cpu",
                     *TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    enc, attn = out["results"]
    assert enc["what"] == "encoder" and attn["what"] == "attention"
    assert attn["fwd_bwd_ms_x_layers"] == pytest.approx(
        attn["fwd_bwd_ms"] * 2)


def test_ab_remat_runs_on_the_cpu(monkeypatch, capsys):
    tool = _load("scripts/torch_ab_remat.py")
    monkeypatch.setattr(tool, "MEASURE_STEPS", 1)
    monkeypatch.setattr(tool, "WARMUP_STEPS", 1)
    out = tool.main(["--batch=2", "--device", "cpu", "full",
                     "save_hot2+frozenemb", "--set", *TINY,
                     "model.audio.num_layers=1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert list(out["step_ms"]) == ["full", "save_hot2+frozenemb"]
    assert lines[0].startswith("full: B=2 ")
    with pytest.raises(SystemExit, match="Unknown variant suffix"):
        tool.main(["--device", "cpu", "full+nope"])


def test_pipeline_bench_runs_on_the_cpu(monkeypatch, capsys):
    tool = _load("scripts/torch_pipeline_bench.py")
    for name, value in (("SAMPLES", 16), ("BATCH", 4), ("PAD_CALLS", 1)):
        monkeypatch.setattr(tool, name, value)
    out = tool.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert out["batches_per_epoch"] == 4 and out["clips"] == 32
    assert out["clips_per_s"] > 0 and out["h2d_clips_per_s"] is None
    assert out["cores"] >= out["cores_in_affinity"] >= 1


TOOLS = ("scripts/torch_profile_b16.py", "scripts/torch_step_decompose.py",
         "scripts/torch_block_breakdown.py", "scripts/torch_text_share.py",
         "scripts/torch_ab_remat.py", "scripts/torch_pipeline_bench.py")


@pytest.fixture(scope="module")
def no_jax_runs(tmp_path_factory):
    """One fresh interpreter with JAX and the JAX package blocked: each
    tool loaded by path and its ``main`` called with ``--device cuda`` and
    no card; → the line each printed ("ok" when ``main`` raised the port's
    no-device error and no JAX module was imported)."""
    out_dir = str(tmp_path_factory.mktemp("prof"))
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
            f"        m.main(['--device', 'cuda'] + (['--out', {out_dir!r}] "
            "if 'profile' in tool else []))\n"
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
