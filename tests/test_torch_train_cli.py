"""The port's training CLI: its preset table equals the JAX CLI's, a tiny
run on the CPU (fusion heads on) writes a ``final_model`` that the port's
serving path loads, and the fields the loop cannot honour raise."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu import train as jax_train
from speech_transcript_embeddings_torch import checkpoints
from speech_transcript_embeddings_torch import train as torch_train
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from speech_transcript_embeddings_torch.parallel import mesh as tmesh
from speech_transcript_embeddings_torch.training import loop
from torch_port_cfg import one_thread  # noqa: F401

HEADS_OFF = ["model.heads.use_cross_modal=false",
             "model.heads.use_word_alignment=false"]


@pytest.mark.parametrize("argv", [
    [], ["preset=tiny"], ["preset=flagship"], ["preset=flagship-roberta"],
    ["preset=retrieval"],
    ["preset=retrieval", "data.synthetic_length_profile=cv",
     "train.num_epochs=1", "optimizer.warmup_steps=2"],
    ["preset=tiny", "loss.kind=global", "freeze.frozen_dtype=bfloat16",
     "model.audio.remat_policy=save_hot2"] + HEADS_OFF,
], ids=["default", "tiny", "flagship", "flagship-roberta", "retrieval",
        "retrieval_overrides", "tiny_overrides"])
def test_build_config_equals_the_jax_cli(argv):
    # the port's own config classes: equal field by field
    assert dataclasses.asdict(torch_train.build_config(argv)) == \
        dataclasses.asdict(jax_train.build_config(argv))


def test_unknown_preset_exits():
    with pytest.raises(SystemExit, match="Unknown preset"):
        torch_train.build_config(["preset=huge"])


def test_tiny_run_on_cpu_writes_a_servable_final_model(tmp_path):
    out = tmp_path / "run"
    res = torch_train.main([
        "preset=tiny", "device=cpu", "train.num_epochs=1",
        f"train.output_dir={out}", "data.num_synthetic_samples=32"])
    assert res["n_trainable"] == res["n_params"] > 0   # 2 layers, 5 unfrozen
    # one step-log entry per micro-step at the default log interval
    losses = [s["loss"] for s in res["step_log"]]
    assert len(losses) == res["epochs"][0]["train_batches"] >= 2
    assert res["epochs"][0]["warm_clips_per_sec"] > 0
    assert np.isfinite(losses).all()
    val = res["epochs"][0]["val_metrics"]
    assert np.isfinite(val["loss"]) and res["epochs"][0]["eval_batches"] >= 1
    assert res["state"].optimizer.count == len(losses)
    path = out / "final_model"
    meta = checkpoints.load_metadata(str(path))
    assert meta["kind"] == "torch_params"
    assert json.loads((out / "config.json").read_text())["train"][
        "num_epochs"] == 1
    assert "Training completed!" in (out / "training.log").read_text()
    # trainable leaves are saved in fp32
    state = torch.load(path / "model.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in state.values())
    emb = Embedder.from_checkpoint(str(path), device="cpu")
    texts = emb.embed_texts(["casa tempo dia", "mar sol"])
    rng = np.random.default_rng(0)
    audio = emb.embed_audios([rng.normal(size=20000).astype(np.float32) * 0.1])
    for e in (texts, audio):
        assert np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1, atol=1e-5)
    # the trained weights, not a fresh init, are what is served, and what
    # train.init_checkpoint loads into a training-form model
    trained = res["state"].model.state_dict()
    for k, v in emb.model.state_dict().items():
        assert torch.equal(v.float(), trained[k].float()), k
    fresh = init_model(res["cfg"].model, torch.Generator().manual_seed(5),
                       train=True)
    checkpoints.load_into(str(path), fresh)
    for k, v in fresh.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, trained[k]), k


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train.main(["preset=tiny", f"train.output_dir={tmp_path}"])


@pytest.mark.parametrize("override,error,match", [
    # with no launcher environment a multihost run is one process
    pytest.param("mesh.multihost=true", None, None,
                 id="mesh.multihost=true-multihost"),
    # one process is a data axis of one rank
    pytest.param("mesh.num_data=2", ValueError,
                 r"mesh.num_data=2 but the process group has 1 rank",
                 id="mesh.num_data=2-data and tensor parallel"),
    # one process cannot hold a model axis of two: JAX's make_mesh error
    pytest.param("mesh.num_model=2", ValueError,
                 "1 devices not divisible by model=2",
                 id="mesh.num_model=2-data and tensor parallel"),
])
def test_fields_the_loop_cannot_honour_raise(tmp_path, override, error,
                                             match):
    """Data and tensor parallel are ported (parallel/mesh.py): the mesh
    must fit the process group, as JAX's ``make_mesh`` requires of its
    devices (tests/test_torch_tensor_parallel.py runs the meshes that
    fit)."""
    cfg = torch_train.build_config(
        ["preset=tiny", f"train.output_dir={tmp_path}", override])
    if error is None:
        assert loop.check_supported(cfg, torch.device("cpu")) == \
            tmesh.Mesh(data=1, model=1, rank=0, local_rank=0)
        return
    with pytest.raises(error, match=match):
        loop.check_supported(cfg, torch.device("cpu"))


@pytest.mark.parametrize("meta", [{}, {"kind": "torch_params",
                                       "params_only": True}],
                         ids=["foreign", "params_only"])
def test_resume_from_an_existing_latest_raises(tmp_path, meta):
    """Resume needs the port's full training checkpoint: a ``latest``
    without optimizer state, or of another kind, is refused before the
    model is built (tests/test_torch_loop.py resumes real ones)."""
    os.makedirs(tmp_path / "latest")
    (tmp_path / "latest" / "metadata.json").write_text(json.dumps(meta))
    cfg = torch_train.build_config(
        ["preset=tiny", f"train.output_dir={tmp_path}", "train.resume=true"])
    with pytest.raises(ValueError, match="resume"):
        loop.check_supported(cfg, torch.device("cpu"))
    loop.check_supported(cfg.with_overrides({"train": {"resume": False}}),
                         torch.device("cpu"))


def test_a_trained_bf16_model_loads_into_serving_storage(tmp_path):
    """Training stores the trainable split in fp32 and the frozen split in
    its frozen dtype; ``load_checkpoint`` casts every Dense and Embed weight
    to its compute dtype (bf16 in the encoders), as serving stores it, and
    keeps LayerNorm, distance embeddings and depthwise kernels in fp32."""
    from speech_transcript_embeddings_torch.models.layers import Dense, Embed
    from speech_transcript_embeddings_torch.training.train_step import (
        create_train_state,
    )
    cfg = torch_train.build_config(
        ["preset=tiny", "model.dtype=bfloat16", "freeze.mode=partial",
         "freeze.audio_layers_to_unfreeze=1",
         "freeze.text_layers_to_unfreeze=1"])
    model = init_model(cfg.model, torch.Generator().manual_seed(0),
                       train=True)
    state = create_train_state(model, cfg, total_steps=1)
    assert {p.dtype for p in state.trainable.values()} == {torch.float32}
    assert {p.dtype for p in state.frozen.values()} == {torch.bfloat16}
    checkpoints.save_params_checkpoint(str(tmp_path / "m"), model, cfg)
    _, served = checkpoints.load_checkpoint(str(tmp_path / "m"))
    trained = model.state_dict()
    dense = [(n, m) for n, m in served.named_modules()
             if isinstance(m, (Dense, Embed))]
    for name, mod in dense:        # the heads compute, and store, in fp32
        assert mod.weight.dtype == mod.dtype, name
    assert sum(m.weight.dtype == torch.bfloat16 for _, m in dense) > 20
    for name, p in served.named_parameters():
        if p.dtype == torch.float32:
            assert torch.equal(p, trained[name].float()), name
        else:
            assert torch.equal(p, trained[name].to(torch.bfloat16)), name


def test_main_loads_dotenv_before_the_run(tmp_path, monkeypatch):
    """``train.main`` reads ``.env`` from the working directory, as the JAX
    CLI does, before the experiment starts; a variable already set in the
    shell wins."""
    (tmp_path / ".env").write_text("STE_TEST_FROM_DOTENV=file\n"
                                   "STE_TEST_SHELL_WINS=file\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("STE_TEST_FROM_DOTENV", raising=False)
    monkeypatch.setenv("STE_TEST_SHELL_WINS", "shell")
    seen = {}

    def run(cfg, device):
        seen.update({k: os.environ.get(k) for k in (
            "STE_TEST_FROM_DOTENV", "STE_TEST_SHELL_WINS")}, device=device)
        return {}

    monkeypatch.setattr(loop, "run_experiment", run)
    torch_train.main(["preset=tiny", "device=cpu"])
    assert seen == {"STE_TEST_FROM_DOTENV": "file",
                    "STE_TEST_SHELL_WINS": "shell", "device": "cpu"}
