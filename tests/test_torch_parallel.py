"""Data-parallel training of the port (``speech_transcript_embeddings_torch.
parallel``) on the CPU: ranks are processes spawned by
``torch.multiprocessing`` into a gloo group (tests/torch_dp_workers.py), one
intra-op thread each, tiny configs with dropout and SpecAugment off, as
JAX's own data-parallel tests run deterministically.

Against the JAX package: ``global_info_nce(axis_name="data")`` at 2 and 4
ranks equals JAX's single-device loss and its ``shard_map`` form (rtol
1e-5, fp32); ``host_batch_slice`` gives JAX's offsets and error; a 2-rank
train step equals JAX's ``make_train_step`` on the 8-device CPU mesh (loss
rtol 1e-5). Against the port in one process on the global batch: the
gradients of each rank's rows (rtol 1e-5, atol 1e-7), the train step (loss
rtol 1e-5, weights by the step rule below), ``eval_step``'s sums (rtol
1e-5), and a whole ``run_experiment``, preempted and resumed (bit-identical
to an uninterrupted 2-rank run; the step rule against one process).

The step rule: tests/test_torch_train_step.py's rule for resolved
elements, held on every element: each trainable leaf within 0.25·lr and at
most 0.1% of it beyond 1e-5; the leaves whose exact gradient is zero (a
softmax ignores a shift shared by its inputs) within 2.5·lr, since Adam
scales their rounding noise up to ±lr.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

import torch_dp_workers as dpw
from speech_transcript_embeddings_torch import bridge, train as torch_train
from speech_transcript_embeddings_torch.checkpoints import (
    checkpoint_exists as ckpt_exists, load_metadata as load_meta,
)
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.parallel import mesh as tmesh
from speech_transcript_embeddings_torch.training import loop
from speech_transcript_embeddings_torch.training import losses as tlosses
from speech_transcript_embeddings_torch.training import train_step as tts
from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, FreezeConfig, LossConfig, MeshConfig,
    OptimizerConfig, TrainConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.data.pipeline import DataPipeline
from speech_transcript_embeddings_tpu.data.sources import SyntheticSource
from speech_transcript_embeddings_tpu.data.tokenizers import (
    SimpleWordTokenizer,
)
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, init_params,
)
from speech_transcript_embeddings_tpu.ops.frontend import LogMelFrontend
from speech_transcript_embeddings_tpu.parallel import mesh as jmesh
from speech_transcript_embeddings_tpu.training import losses as jlosses
from speech_transcript_embeddings_tpu.training import optimizer as jopt
from speech_transcript_embeddings_tpu.training import train_step as jts
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

LR = 1e-3
ZERO_GRAD_LEAVES = (".key.bias", "pooling.score_out.bias", ".attn_k.bias")


def hold_to_step_rule(got: dict, want: dict, lr: float = LR) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs()
        if name.endswith(ZERO_GRAD_LEAVES):
            assert diff.max() <= 2.5 * lr, name
        else:
            assert diff.max() <= 0.25 * lr and \
                (diff > 1e-5).float().mean() <= 1e-3, (name, diff.max())


# ---- (1) the global loss across ranks ---------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_global_info_nce_across_ranks_matches_jax(tmp_path, world):
    """The mean of the ranks' losses equals JAX's single-device
    global_info_nce and its shard_map form over ``world`` CPU devices; each
    rank's gradients equal one process's autograd of the global loss."""
    cfg = LossConfig(kind="global", temperature=0.1, corrupt_gamma=0.35,
                     alignment_weight=0.3)
    rng = np.random.default_rng(11)
    b, d = 16, 8
    tp, tn, au = (dpw.unit(rng, (b, d)) for _ in range(3))
    align = rng.normal(size=(b, 5)).astype(np.float32)
    ref, _ = jlosses.global_info_nce(cfg, *map(jnp.asarray, (tp, tn, au)),
                                     jnp.asarray(align))

    def local(tp_l, tn_l, au_l, al_l):
        loss, _ = jlosses.global_info_nce(cfg, tp_l, tn_l, au_l, al_l,
                                          axis_name="data")
        return jax.lax.pmean(loss, "data")

    mapped = shard_map(local, mesh=JaxMesh(np.array(jax.devices()[:world]),
                                           ("data",)),
                       in_specs=(P("data"),) * 4, out_specs=P())(
        *map(jnp.asarray, (tp, tn, au, align)))

    dpw.spawn(tmp_path, world, "loss_rank", tmp_path, port_cfg(cfg), tp, tn,
              au, align)
    ranks = dpw.load(tmp_path, world)
    got = float(np.mean([float(r["loss"]) for r in ranks]))
    np.testing.assert_allclose(got, float(ref), rtol=1e-5)
    np.testing.assert_allclose(got, float(mapped), rtol=1e-5)

    x = {k: torch.from_numpy(v).requires_grad_()
         for k, v in (("tp", tp), ("tn", tn), ("au", au))}
    loss, aux = tlosses.global_info_nce(port_cfg(cfg), x["tp"], x["tn"],
                                        x["au"], torch.from_numpy(align))
    loss.backward()
    np.testing.assert_allclose(got, loss.item(), rtol=1e-5)
    per = b // world
    for r, rank in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(rank["s_pos"], aux.s_pos.detach()[rows],
                                   rtol=1e-6)
        for k in x:
            np.testing.assert_allclose(rank[f"grad_{k}"], x[k].grad[rows],
                                       rtol=1e-5, atol=1e-7, err_msg=(r, k))


# ---- (2) the rows of each rank ----------------------------------------------

@pytest.mark.parametrize("batch,world", [(16, 1), (16, 2), (16, 4), (8, 8),
                                         (10, 4)])
def test_host_batch_slice_and_shard_batch_match_jax(monkeypatch, batch,
                                                    world):
    """The port's offsets are JAX's arithmetic (its host_batch_slice with
    the process count and index the port's mesh has), the rows
    ``shard_batch`` keeps are those, and an indivisible batch raises JAX's
    error."""
    host = {"waveform": np.arange(batch * 3).reshape(batch, 3),
            "example_mask": np.ones(batch, np.float32)}
    for rank in range(world):
        mesh = tmesh.Mesh(data=world, rank=rank)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        if batch % world:
            with pytest.raises(ValueError) as want:
                jmesh.host_batch_slice(batch)
            with pytest.raises(ValueError) as got:
                tmesh.host_batch_slice(batch, mesh)
            assert str(got.value) == str(want.value)
            with pytest.raises(ValueError):
                tmesh.shard_batch(mesh, host)
            continue
        off, per = jmesh.host_batch_slice(batch)
        assert tmesh.host_batch_slice(batch, mesh) == (off, per)
        rows = tmesh.shard_batch(mesh, host)
        for k, v in host.items():
            np.testing.assert_array_equal(rows[k], v[off:off + per])


# ---- (3) the train step -----------------------------------------------------

def _cfg(kind: str, acc: int = 2) -> ExperimentConfig:
    return ExperimentConfig(
        model=tiny_model_config(),
        freeze=FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                            audio_layers_to_unfreeze=1),
        loss=LossConfig(kind=kind, corrupt_gamma=0.35),
        optimizer=OptimizerConfig(learning_rate=LR, warmup_steps=0),
        data=DataConfig(dataset="synthetic", batch_size=8, max_text_length=12,
                        audio_buckets=(16000,), max_audio_samples=16000,
                        num_synthetic_samples=32),
        train=TrainConfig(num_epochs=1, accumulation_steps=acc, seed=0))


def _host_batches(cfg, n):
    pipe = DataPipeline(cfg.data, SimpleWordTokenizer(vocab_size=128),
                        seed=cfg.train.seed)
    batches = list(pipe.epoch_batches(SyntheticSource(cfg.data, seed=3),
                                      "train", epoch=0))
    assert len(batches) >= n
    return batches[:n]


@pytest.fixture(scope="module")
def params():
    model = JaxModel(_cfg("global").model)
    return jax.tree.map(np.asarray, init_params(model, jax.random.PRNGKey(0)))


def _weights(cfg, params):
    model = DualEncoderModel(port_cfg(cfg).model, param_dtype=torch.float32)
    bridge.load_flax_params(model, params)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _jax_mesh_losses(cfg, params, batches, total_steps):
    """JAX's make_train_step on the 8-device CPU data mesh
    (tests/test_training.py's global-loss set-up): each micro-step's
    loss."""
    labels = jopt.param_labels(params, cfg.freeze, cfg.model)
    tx = jopt.make_optimizer(cfg.optimizer, cfg.freeze,
                             jopt.split_params(labels, labels)[0],
                             total_steps,
                             accumulation_steps=cfg.train.accumulation_steps)
    state = jts.create_train_state(jax.tree.map(jnp.asarray, params), labels,
                                   tx)
    mesh = jmesh.make_mesh(MeshConfig(num_model=1), jax.devices()[:8])
    state = state.replace(
        trainable=jax.device_put(state.trainable, jmesh.flat_param_shardings(
            mesh, state.trainable)),
        frozen=jax.device_put(state.frozen, jmesh.flat_param_shardings(
            mesh, state.frozen)),
        opt_state=jmesh.place_opt_state(mesh, state.opt_state,
                                        state.trainable))
    step = jts.make_train_step(cfg, JaxModel(cfg.model),
                               LogMelFrontend(cfg.model.frontend), tx)
    out = []
    for batch in batches:
        state, m = step(state, jmesh.shard_batch(mesh, batch),
                        jax.random.PRNGKey(1))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("kind", ["global", "pairwise"])
def test_two_rank_train_step_matches_one_process_and_jax_mesh(
        tmp_path, params, kind):
    """One optimizer step at accumulation 2 (two micro-steps of the global
    batch of 8), 2 ranks of 4 rows: each micro-step's loss (the ranks'
    mean) and grad norm equal the port's step on the whole batch in one
    process (rtol 1e-5) and JAX's on the 8-device mesh (loss, rtol 1e-5);
    the weights equal one process's by the step rule, and the two ranks'
    bit for bit."""
    cfg = _cfg(kind)
    pcfg = port_cfg(cfg)
    batches = _host_batches(cfg, 2)
    weights = _weights(cfg, params)
    dpw.spawn(tmp_path, 2, "step_rank", tmp_path, pcfg, weights, batches, 4)
    ranks = dpw.load(tmp_path, 2)

    model = DualEncoderModel(pcfg.model, param_dtype=torch.float32)
    model.load_state_dict(weights)
    state = tts.create_train_state(model, pcfg, 4)
    frontend = make_frontend(pcfg.model.frontend)
    one = [tts.train_step(pcfg, state, frontend, b, None) for b in batches]
    jax_losses = _jax_mesh_losses(cfg, params, batches, 4)
    for i, (m, o, j) in enumerate(zip(ranks[0]["metrics"], one, jax_losses)):
        np.testing.assert_allclose(m["loss"], float(o["loss"]), rtol=1e-5,
                                   err_msg=f"micro-step {i}")
        np.testing.assert_allclose(m["grad_norm"], float(o["grad_norm"]),
                                   rtol=1e-5, err_msg=f"micro-step {i}")
        np.testing.assert_allclose(m["loss"], j, rtol=1e-5,
                                   err_msg=f"micro-step {i} vs JAX")
    assert ranks[0]["count"] == ranks[1]["count"] == state.optimizer.count \
        == 1
    for k, p in ranks[0]["trainable"].items():
        assert torch.equal(p, ranks[1]["trainable"][k]), k
    hold_to_step_rule(ranks[0]["trainable"],
                      {k: p.detach() for k, p in state.trainable.items()})
    moved = sum(not torch.equal(p, weights[k])
                for k, p in ranks[0]["trainable"].items())
    assert moved > 0.9 * len(state.trainable)


# ---- (4) the eval step ------------------------------------------------------

def test_two_rank_global_eval_step_matches_one_process(tmp_path, params):
    """kind='global' with the batch's last two rows masked (both on rank
    1): the ranks' sums add up to one process's, each row scored against
    the whole batch's unmasked candidates."""
    cfg = _cfg("global")
    pcfg = port_cfg(cfg)
    batch = dict(_host_batches(cfg, 1)[0])
    batch["example_mask"] = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    weights = _weights(cfg, params)
    dpw.spawn(tmp_path, 2, "eval_rank", tmp_path, pcfg, weights, batch)
    ranks = dpw.load(tmp_path, 2)
    model = DualEncoderModel(pcfg.model, param_dtype=torch.float32)
    model.load_state_dict(weights)
    one = tts.eval_step(pcfg, model.eval().requires_grad_(False),
                        make_frontend(pcfg.model.frontend), batch)
    for k in ("loss_sum", "pairwise_loss_sum", "count"):
        np.testing.assert_allclose(sum(float(r[k]) for r in ranks),
                                   float(one[k]), rtol=1e-5, err_msg=k)
    for k in ("s_pos", "s_neg", "example_mask"):
        np.testing.assert_allclose(torch.cat([r[k] for r in ranks]),
                                   one[k], rtol=1e-5, atol=1e-7, err_msg=k)


# ---- (5) the agreed preemption ----------------------------------------------

@pytest.mark.parametrize("flags,want", [((False, True), True),
                                        ((False, False), False)])
def test_preempt_agreed_across_ranks(tmp_path, flags, want):
    dpw.spawn(tmp_path, 2, "preempt_rank", tmp_path, flags)
    assert [r["agreed"] for r in dpw.load(tmp_path, 2)] == [want, want]


def test_each_rank_draws_its_own_dropout_stream():
    """Rank 0 keeps the JAX loop's seed + 17; other ranks draw other
    masks."""
    cpu = torch.device("cpu")
    draws = [torch.rand(64, generator=loop.dropout_generator(42, cpu, r))
             for r in range(3)]
    assert torch.equal(draws[0], torch.rand(
        64, generator=torch.Generator().manual_seed(42 + 17)))
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "2"}],
                         ids=["no_launcher", "incomplete_launcher"])
def test_initialize_without_a_launcher(monkeypatch, env):
    """No launcher environment: one process, no group. A launcher
    environment with variables missing raises rather than falling back to
    one process."""
    for k in tmesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not env:
        assert tmesh.maybe_initialize_distributed(True, "cpu") == 1
        assert not torch.distributed.is_initialized()
        return
    with pytest.raises(RuntimeError, match="RANK, MASTER_ADDR, MASTER_PORT"):
        tmesh.maybe_initialize_distributed(True, "cpu")


# ---- (6) the epoch loop -----------------------------------------------------

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _tiny(out, *extra):
    return torch_train.build_config(
        ["preset=tiny", "train.num_epochs=1", "data.num_synthetic_samples=32",
         "train.log_every_batches=2", f"train.output_dir={out}", *extra])


def test_two_rank_run_preempted_and_resumed(tmp_path):
    """preset=tiny on synthetic clips in 2 ranks: preempted after
    micro-step 2 (agreed after that batch), resumed, and finished through
    the test and retrieval phases. Only rank 0 wrote files, the same ones a
    one-process run writes; the final weights are bit-identical to an
    uninterrupted 2-rank run's, on both ranks, and equal a one-process run
    of the same global batches by the step rule."""
    torch.use_deterministic_algorithms(True)
    try:
        cut = tmp_path / "cut"
        dpw.spawn(tmp_path / "a", 2, "loop_rank", _ensure(tmp_path / "a"),
                  _tiny(cut, "train.fault_inject_preempt_at=2"))
        first = dpw.load(tmp_path / "a", 2)
        dpw.spawn(tmp_path / "b", 2, "loop_rank", _ensure(tmp_path / "b"),
                  _tiny(cut))
        resumed = dpw.load(tmp_path / "b", 2)
        whole = tmp_path / "whole"
        dpw.spawn(tmp_path / "c", 2, "loop_rank", _ensure(tmp_path / "c"),
                  _tiny(whole))
        uncut = dpw.load(tmp_path / "c", 2)
        one = loop.run_experiment(_tiny(tmp_path / "one"), device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    for r in first:
        assert r["preempted"] == {"epoch": 1, "batches_done": 2}
    for r in resumed:
        assert r["preempted"] is None and r["skipped"] == [2]
    assert "Resumed mid-epoch" in (cut / "training.log").read_text()
    for runs in (first, resumed, uncut):
        assert runs[0]["writes"] and not runs[1]["writes"], runs[1]["writes"]
    assert _files(whole) == _files(tmp_path / "one")
    assert [s["loss"] for s in uncut[0]["step_log"]] == \
        [s["loss"] for s in uncut[1]["step_log"]]
    for k, v in uncut[0]["weights"].items():
        assert torch.equal(v, uncut[1]["weights"][k]), k
        assert torch.equal(v, resumed[0]["weights"][k]), k
        assert torch.equal(v, resumed[1]["weights"][k]), k
    saved = torch.load(whole / "final_model" / "model.pt", weights_only=True)
    for k, v in saved.items():
        assert torch.equal(v, uncut[0]["weights"][k]), k
    trainable = set(one["state"].trainable)
    hold_to_step_rule({k: v for k, v in uncut[0]["weights"].items()
                       if k in trainable},
                      {k: p.detach() for k, p in
                       one["state"].trainable.items()}, lr=1e-3)
    for k, p in one["state"].frozen.items():
        assert torch.equal(p, uncut[0]["weights"][k]), k


def _ensure(path):
    path.mkdir(parents=True, exist_ok=True)
    return path


def _torchrun_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return root, dict(os.environ, OMP_NUM_THREADS="1",
                      PYTHONPATH=os.pathsep.join(
                          [root, os.environ.get("PYTHONPATH", "")]))


def test_sigterm_to_torchrun_saves_latest_within_the_grace_period(tmp_path):
    """A real SIGTERM to ``torchrun`` (2 gloo ranks, preset=tiny), sent
    once epoch 1 is saved: the launcher passes it to both ranks, which agree
    on it after the batch they are in, not on the (here never reached) log
    cadence, and save a mid-epoch ``latest`` well inside the launcher's 30 s
    before it kills them."""
    root, env = _torchrun_env()
    out = tmp_path / "dp"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "speech_transcript_embeddings_torch.train",
         "preset=tiny", "device=cpu", "train.num_epochs=50",
         "data.num_synthetic_samples=64", "train.log_every_batches=1000",
         f"train.output_dir={out}"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    log = out / "training.log"
    try:
        deadline = time.monotonic() + 240
        while not (log.exists() and "Saved latest" in log.read_text()):
            assert proc.poll() is None, proc.communicate()[0][-4000:]
            assert time.monotonic() < deadline, "epoch 1 was not saved"
            time.sleep(0.2)
        sent = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=120)[0]
        took = time.monotonic() - sent
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    latest = str(out / "latest")
    assert ckpt_exists(latest), text[-4000:]
    mid = load_meta(latest)["metrics"]["mid_epoch"]
    assert mid["epoch"] >= 2 and mid["batches_done"] >= 1, mid
    assert "Preemption requested" in log.read_text()
    assert took < 30, (took, text[-4000:])


def test_torchrun_cli_two_ranks_on_the_cpu(tmp_path):
    """``torchrun --nproc_per_node=2 -m speech_transcript_embeddings_torch.
    train preset=tiny device=cpu``: rank 0 writes what the one-process CLI
    writes, and the final weights equal the one-process run's by the step
    rule."""
    argv = ["preset=tiny", "device=cpu", "train.num_epochs=1",
            "data.num_synthetic_samples=32"]
    root, env = _torchrun_env()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "speech_transcript_embeddings_torch.train",
         *argv, f"train.output_dir={tmp_path / 'dp'}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    one = torch_train.main(argv + [f"train.output_dir={tmp_path / 'one'}"])
    assert _files(tmp_path / "dp") == _files(tmp_path / "one")
    log = (tmp_path / "dp" / "training.log").read_text()
    assert "Data parallel: 2 rank(s) over gloo" in log
    got = torch.load(tmp_path / "dp" / "final_model" / "model.pt",
                     weights_only=True)
    hold_to_step_rule({k: got[k] for k in one["state"].trainable},
                      {k: p.detach() for k, p in
                       one["state"].trainable.items()}, lr=1e-3)
