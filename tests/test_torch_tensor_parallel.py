"""Tensor parallel training of the port (the mesh's ``model`` axis,
``speech_transcript_embeddings_torch.parallel``) on the CPU: ranks are
processes spawned by ``torch.multiprocessing`` into a gloo group
(tests/torch_dp_workers.py), one intra-op thread each, tiny configs.

* The sharding rule (``shard_dim``) is JAX's ``_spec_for`` on every
  parameter of four presets (abstract trees on both sides, names mapped by
  the bridge), and the split model holds each shard's shape.
* ``shard_tensor`` / ``merge_shards`` round-trip exactly (the padded
  vocabulary, the GLU rows), and ``init_model(axis=...)`` draws each
  rank's shard bit for bit.
* Five split modules at M = 2 against one process and JAX single-device,
  fp32: forward within 1e-5, the gradients of the inputs and of every
  weight within 1e-4 of each leaf's largest element (the leaves whose
  exact gradient is zero within 1e-4 of the module's largest gradient).
* The train step at (data 1 × model 2) and (data 2 × model 2), accumulation
  2, the clip active, dropout and SpecAugment on: losses and grad norms
  rtol 1e-5 and the gathered weights by the step rule against the same
  dropout streams without the model axis (one process; a data axis of 2),
  the replicated leaves bit-identical across the model ranks; and, dropout
  off, against JAX's ``make_train_step`` on a (data 2, model 2) CPU mesh
  placed by ``flat_param_shardings`` / ``place_opt_state`` (losses and
  grad norms rtol 1e-4, tests/test_torch_train_step.py's port-vs-JAX rule;
  weights by the step rule).
* JAX's mesh shrink (a batch the data axis does not divide; a smaller
  ``mesh.num_data``), a preempted and resumed tensor-parallel run (its
  ``latest`` resumed at ``num_model=1``, its ``final_model`` served), the
  test phase's eval model loaded as shards, and ``torchrun`` through the
  CLI.

The step rule is tests/test_torch_parallel.py's.
"""

import dataclasses
import functools
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as dpw
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch import train as torch_train
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model,
)
from speech_transcript_embeddings_torch.ops import make_frontend
from speech_transcript_embeddings_torch.parallel import mesh as tmesh
from speech_transcript_embeddings_torch.training import loop
from speech_transcript_embeddings_torch.training import train_step as tts
from speech_transcript_embeddings_tpu import train as jax_train
from speech_transcript_embeddings_tpu.config import (
    MeshConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.models import audio_encoder as jae
from speech_transcript_embeddings_tpu.models import heads as jheads
from speech_transcript_embeddings_tpu.models import text_encoder as jte
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, abstract_params, init_params,
)
from speech_transcript_embeddings_tpu.parallel import mesh as jmesh
from speech_transcript_embeddings_tpu.training import optimizer as jopt
from speech_transcript_embeddings_tpu.training import train_step as jts
from speech_transcript_embeddings_tpu.ops.frontend import LogMelFrontend
from test_torch_parallel import (
    _cfg as dp_cfg, _ensure, _files, _host_batches, _tiny, _torchrun_env,
    _weights, hold_to_step_rule,
)
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
ZERO_GRAD_LEAVES = ("key.bias", "attn_k.bias", "pooling.score_out.bias")


# ---- (1) the sharding rule ----------------------------------------------------

@pytest.mark.parametrize("preset,m", [("tiny", 2), ("retrieval", 4),
                                      ("flagship", 4),
                                      ("flagship-roberta", 2)])
def test_sharding_rule_matches_jax_spec_for(preset, m):
    """For every parameter, the dimension ``shard_dim`` splits (in the
    port's layout) is the one JAX's ``_spec_for`` puts on the ``model``
    axis (in the Flax layout, through the bridge's permutation and layer
    unstacking); a model built on a model axis of ``m`` holds each split
    leaf at 1/m of it (a vocabulary padded to a multiple of m)."""
    cfg = jax_train.build_config([f"preset={preset}"])
    tree = abstract_params(JaxModel(cfg.model))
    leaves = dict(bridge._flatten(tree))
    with torch.device("meta"):
        whole = DualEncoderModel(port_cfg(cfg).model)
        split = DualEncoderModel(port_cfg(cfg).model,
                                 axis=tmesh.ModelAxis(m, m - 1))
    whole = {k: tuple(p.shape) for k, p in whole.named_parameters()}
    split = {k: tuple(p.shape) for k, p in split.named_parameters()}
    plan = bridge.plan(tree)
    assert set(plan) == set(whole) == set(split)
    n_split = 0
    for key, (path, layer, perm) in plan.items():
        spec = tuple(jmesh._spec_for("/".join(path), "model"))
        axes = spec + (None,) * (len(leaves[path].shape) - len(spec))
        if layer is not None:
            assert axes[0] is None, key       # the stacked layer axis
            axes = axes[1:]
        if perm:
            axes = tuple(axes[p] for p in perm)
        want = axes.index("model") if "model" in axes else None
        assert tmesh.shard_dim(key) == want, (key, spec)
        shape = list(whole[key])
        if want is not None:
            shape[want] = -(-shape[want] // m)
            n_split += 1
        assert split[key] == tuple(shape), key
    assert n_split > 10


# ---- (2) shards of a whole state, and back ----------------------------------

def _tiny_port(vocab):
    mc = tiny_model_config()
    return port_cfg(dataclasses.replace(
        mc, text=dataclasses.replace(mc.text, vocab_size=vocab),
        heads=dataclasses.replace(mc.heads, alignment_heads=4)))


@pytest.mark.parametrize("m,vocab", [(2, 50265), (4, 250002)])
def test_shard_state_round_trips_and_init_draws_the_shards(m, vocab):
    """A whole one-process state → M shards → the state again, exactly; a
    padded table's last rows are zeros; ``pointwise1``'s shard r is
    ``[a_r | g_r]``; and ``init_model`` on a model axis draws, bit for
    bit, each rank's shard of the one-process model of the same seed."""
    mc = _tiny_port(vocab)
    one = init_model(mc, torch.Generator().manual_seed(3), train=True)
    full = {k: v.detach() for k, v in one.state_dict().items()}
    shapes = one.full_shapes()
    shards = []
    for r in range(m):
        axis = tmesh.ModelAxis(m, r)
        mine = tmesh.shard_state(full, tmesh.Mesh(data=1, model=m, rank=r))
        drawn = init_model(mc, torch.Generator().manual_seed(3), train=True,
                           axis=axis).state_dict()
        assert set(drawn) == set(mine)
        for k, v in drawn.items():
            assert torch.equal(v, mine[k]), (r, k)
        shards.append(mine)
    for k, v in full.items():
        assert torch.equal(tmesh.merge_shards(
            k, [s[k] for s in shards], shapes[k]), v), k
    table = "text_encoder.embeddings.word_embeddings.weight"
    per = -(-vocab // m)
    assert all(s[table].shape[0] == per for s in shards)
    assert (shards[-1][table][vocab - (m - 1) * per:] == 0).all()
    assert vocab % m            # the case pads
    glu = "audio_encoder.layer_0.conv.pointwise1.weight"
    h = full[glu].shape[0] // 2
    for r, s in enumerate(shards):
        rows = torch.cat([torch.arange(r * h // m, (r + 1) * h // m),
                          h + torch.arange(r * h // m, (r + 1) * h // m)])
        assert torch.equal(s[glu], full[glu][rows])


# ---- (3) the split modules against one process and JAX ----------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _module_cases():
    """name → (port spec, whole weights, float inputs, other inputs,
    cotangent), with JAX's output and gradients (params, inputs) and the
    one-process port's."""
    rng = np.random.default_rng(7)
    mc = tiny_model_config()
    audio = dataclasses.replace(mc.audio, use_flash_attention=True)
    text = dataclasses.replace(mc.text, num_layers=1, vocab_size=131)
    b, t = 2, 24
    feats = rng.normal(size=(b, t, audio.hidden_size)).astype(np.float32)
    amask = (np.arange(t)[None] < np.array([[t], [15]])).astype(np.float32)
    ids = rng.integers(3, 131, size=(3, 9)).astype(np.int32)
    tmask = np.ones_like(ids)
    ids[1, 6:], tmask[1, 6:] = text.pad_token_id, 0
    ids[0, :3] = [130, 129, 66]            # both vocabulary shards, padded
    hmask = (np.arange(11)[None] < np.array([[11], [6], [0]])).astype(
        np.int32)
    wt = (np.arange(7)[None] < np.array([[7], [4], [1]])).astype(np.int32)
    wa = (np.arange(13)[None] < np.array([[13], [7], [0]])).astype(np.int32)
    x = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    specs = {
        # name: (JAX module, JAX init module, port spec, float inputs,
        #        other inputs, JAX call)
        "conformer_block": (
            jae.ConformerBlock(audio), jae.ConformerBlock(mc.audio),
            port_cfg(audio), [feats], [amask],
            lambda m, p, xs, o: m.apply({"params": p}, xs[0], o[0])),
        "text_encoder": (
            jte.TextEncoder(text), None, port_cfg(text), [], [ids, tmask],
            lambda m, p, xs, o: m.apply({"params": p}, o[0], o[1])),
        "projection": (
            jheads.EnhancedProjection(24, 48, dropout=0.0), None,
            (32, 24, 48), [x(3, 32)], [],
            lambda m, p, xs, o: m.apply({"params": p}, xs[0])),
        "cross_modal": (
            jheads.CrossModalAttention(num_heads=4, dropout=0.0), None,
            (24, 4), [x(3, 1, 24), x(3, 11, 24)], [hmask],
            lambda m, p, xs, o: m.apply({"params": p}, xs[0], xs[1], o[0])),
        "word_alignment": (
            jheads.WordLevelAlignment(alignment_dim=24, num_heads=2,
                                      dropout=0.0), None,
            (32, 20, 24, 2), [x(3, 7, 32), x(3, 13, 20)], [wt, wa],
            lambda m, p, xs, o: jnp.concatenate(
                [r.reshape(3, -1) for r in m.apply({"params": p}, xs[0],
                                                   xs[1], o[0], o[1])],
                axis=1)),
    }
    cases, jax_out, one_out = {}, {}, {}
    for i, (name, (jmod, jinit, spec, xs, other, jcall)) in enumerate(
            specs.items()):
        jargs = [jnp.asarray(a) for a in xs]
        oargs = [jnp.asarray(a) for a in other]
        params = jax.jit((jinit or jmod).init)(jax.random.PRNGKey(i),
                                               *(jargs + oargs))["params"]
        ref = np.asarray(jax.jit(lambda p, *a: jcall(jmod, p, list(a), oargs))(
            params, *jargs))
        cot = rng.normal(size=ref.shape).astype(np.float32)
        grads = jax.jit(jax.grad(lambda p, *a: jnp.sum(
            jcall(jmod, p, list(a), oargs) * cot),
            argnums=tuple(range(1 + len(jargs)))))(params, *jargs)
        weights = bridge.flax_to_state_dict(_np(params))
        jax_out[name] = {"out": ref, "grads": bridge.flax_to_state_dict(
            _np(grads[0])), "inputs": [np.asarray(g) for g in grads[1:]]}
        port = dpw.tp_module(name, spec)
        port.load_state_dict(weights)
        tin = [torch.from_numpy(a).requires_grad_() for a in xs]
        y = dpw.tp_call(name, port, tin, [torch.from_numpy(a) for a in other])
        torch.autograd.backward(y, torch.from_numpy(cot))
        one_out[name] = {"out": y.detach().numpy(),
                         "inputs": [a.grad.numpy() for a in tin],
                         "grads": {k: p.grad for k, p in
                                   port.named_parameters()},
                         "shapes": {k: tuple(p.shape) for k, p in
                                    port.named_parameters()}}
        cases[name] = (spec, weights, xs, other, cot)
    return cases, jax_out, one_out


@pytest.fixture(scope="module")
def split_modules(tmp_path_factory):
    cases, jax_out, one_out = _module_cases()
    out = tmp_path_factory.mktemp("tp_modules")
    dpw.spawn(out, 2, "tp_module_rank", out, cases)
    return dpw.load(out, 2), jax_out, one_out


def _hold_grads(got, want, what):
    """Each leaf within 1e-4 of its largest element; the zero-gradient
    leaves within 1e-4 of the largest gradient of all."""
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        zero = k.endswith(ZERO_GRAD_LEAVES)
        tol = 1e-4 * (top if zero else max(np.abs(w).max(), 1e-12))
        assert np.abs(got[k] - w).max() <= tol, (what, k)


@pytest.mark.parametrize("name", ["conformer_block", "text_encoder",
                                  "projection", "cross_modal",
                                  "word_alignment"])
def test_split_module_matches_one_process_and_jax(split_modules, name):
    """The module split over 2 ranks: both ranks' outputs and input
    gradients equal one process's and JAX's; the merged weight gradients
    equal both; each replicated leaf's gradient is bit-identical across
    the ranks (the conformer block runs the flash twin, whose distance
    table gradient sums each rank's heads)."""
    ranks, jax_out, one_out = split_modules
    one, ref = one_out[name], jax_out[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["out"].numpy(), one["out"], **FWD)
        np.testing.assert_allclose(got["out"].numpy(), ref["out"], **FWD)
        for g, o, j in zip(got["inputs"], one["inputs"], ref["inputs"]):
            _hold_grads({"x": g.numpy()}, {"x": o}, "input vs 1 process")
            _hold_grads({"x": g.numpy()}, {"x": j}, "input vs JAX")
    merged, at = {}, dpw.TP_PREFIX[name]
    for k, shape in one["shapes"].items():
        parts = [r[name]["grads"][k] for r in ranks]
        if tmesh.shard_dim(at + k) is None:
            assert torch.equal(parts[0], parts[1]), k
        merged[k] = tmesh.merge_shards(at + k, parts, shape).numpy()
    assert any(tmesh.shard_dim(at + k) is not None for k in merged)
    _hold_grads(merged, {k: g.numpy() for k, g in one["grads"].items()},
                "vs 1 process")
    _hold_grads(merged, {k: np.asarray(g) for k, g in ref["grads"].items()},
                "vs JAX")


# ---- (4) the train step -------------------------------------------------------

DROPOUT_ON = dict(text={"hidden_dropout": 0.1, "attention_dropout": 0.1},
                  audio={"activation_dropout": 0.1, "conv_dropout": 0.1,
                         "attention_dropout": 0.1,
                         "apply_spec_augment": True},
                  heads={"dropout": 0.1})
# below the tiny model's grad norms (9-25), so the clip fires; a clip that
# scales gradients near Adam's eps would turn fp32 rounding into ±lr steps
CLIP = 1.0


# each conformer block under save_hot2 remat, its attention in the flash
# twin (attention dropout off, which the flash path cannot draw)
REMAT_FLASH = dict(audio={"use_flash_attention": True,
                          "remat_policy": "save_hot2",
                          "attention_dropout": 0.0})


def _step_cfg(kind, data, model, dropout, remat=False):
    cfg = dp_cfg(kind)
    mc = cfg.model
    for on, parts in ((dropout, DROPOUT_ON), (remat, REMAT_FLASH)):
        if on:
            mc = dataclasses.replace(mc, **{
                part: dataclasses.replace(getattr(mc, part), **fields)
                for part, fields in parts.items()})
    mc = dataclasses.replace(mc, remat=remat)
    return dataclasses.replace(
        cfg, model=mc, mesh=MeshConfig(num_data=data, num_model=model),
        optimizer=dataclasses.replace(cfg.optimizer, max_grad_norm=CLIP))


@functools.lru_cache(maxsize=None)
def _jax_params(model_cfg):
    """JAX's seeded parameters of a model config (numpy)."""
    return jax.tree.map(np.asarray, init_params(JaxModel(model_cfg),
                                                jax.random.PRNGKey(0)))


def _merged(ranks, row, shapes):
    """The whole trainable weights of data row ``row`` (its model ranks'
    shards merged), checking that the replicated ones agree bit for
    bit."""
    mine = [r for r in ranks if r is not None and r["data_index"] == row]
    mine.sort(key=lambda r: r["model_index"])
    out = {}
    for k in mine[0]["trainable"]:
        parts = [r["trainable"][k] for r in mine]
        if tmesh.shard_dim(k) is None:
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), k
        out[k] = tmesh.merge_shards(k, parts, shapes[k])
    return out


@pytest.mark.parametrize("kind,data,world,remat", [
    ("global", 1, 2, False), ("pairwise", 1, 2, False),
    ("global", 2, 4, False), ("pairwise", 2, 4, False),
    ("global", 1, 2, True)], ids=[
    "data1_model2-global", "data1_model2-pairwise", "data2_model2-global",
    "data2_model2-pairwise", "data1_model2-global-remat_flash"])
def test_tensor_parallel_train_step_matches_the_same_streams_unsplit(
        tmp_path, kind, data, world, remat):
    """One optimizer step at accumulation 2 with the clip active and
    dropout and SpecAugment on, on a (data × model 2) mesh: each
    micro-step's loss and grad norm equal the run without the model axis
    that draws the same masks (rtol 1e-5) — one process at data 1; the
    data-parallel run on the first 2 of the same 4 ranks
    (``mesh.num_data=2``, ``num_model=1``) at data 2 — and the merged
    weights equal its weights by the step rule; the replicated leaves are
    bit-identical across the model ranks, and the data rows agree. One
    case runs the conformer blocks under save_hot2 remat with the flash
    twin: the model axis's collectives replay with their regions."""
    cfg = _step_cfg(kind, data, 2, dropout=True, remat=remat)
    pcfg = port_cfg(cfg)
    batches = _host_batches(cfg, 2)
    weights = _weights(cfg, _jax_params(cfg.model))
    cfgs = [pcfg]
    if data > 1:
        cfgs.append(port_cfg(dataclasses.replace(
            cfg, mesh=MeshConfig(num_data=data, num_model=1))))
    dpw.spawn(tmp_path, world, "tp_step_rank", tmp_path, cfgs, weights,
              batches, 4, True)
    ranks = dpw.load(tmp_path, world)
    tp = [r[0] for r in ranks]
    shapes = {k: tuple(v.shape) for k, v in weights.items()}
    if data == 1:
        model = DualEncoderModel(pcfg.model, param_dtype=torch.float32)
        model.load_state_dict(weights)
        state = tts.create_train_state(model, pcfg, 4)
        gen = loop.dropout_generator(0, torch.device("cpu"))
        frontend = make_frontend(pcfg.model.frontend)
        metrics = [tts.train_step(pcfg, state, frontend, b, gen)
                   for b in batches]
        want = {"metrics": [{k: float(m[k]) for k in ("loss", "grad_norm")}
                            for m in metrics],
                "trainable": {k: p.detach() for k, p in
                              state.trainable.items()},
                "count": state.optimizer.count}
    else:
        want = ranks[0][1]
        assert ranks[2][1] is None and ranks[3][1] is None  # not on that mesh
        for k, v in want["trainable"].items():
            assert torch.equal(v, ranks[1][1]["trainable"][k]), k
    for r in tp:
        assert r["count"] == want["count"] == 1
        for i, (m, w) in enumerate(zip(r["metrics"], want["metrics"])):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[key], w[key], rtol=1e-5,
                                           err_msg=f"{key} {i}")
            assert w["grad_norm"] > 2 * CLIP       # the clip fired
    rows = [_merged(tp, d, shapes) for d in range(data)]
    for k, v in rows[0].items():
        for other in rows[1:]:
            assert torch.equal(v, other[k]), k
    hold_to_step_rule(rows[0], want["trainable"])
    moved = sum(not torch.equal(v, weights[k]) for k, v in rows[0].items())
    assert moved > 0.9 * len(rows[0])


def _jax_tp_mesh_step(cfg, params, batches, total_steps):
    """JAX's make_train_step on a (data 2, model 2) CPU mesh, state placed
    by flat_param_shardings / place_opt_state: each micro-step's loss and
    grad norm, and the weights after (the port's names)."""
    labels = jopt.param_labels(params, cfg.freeze, cfg.model)
    tx = jopt.make_optimizer(cfg.optimizer, cfg.freeze,
                             jopt.split_params(labels, labels)[0],
                             total_steps,
                             accumulation_steps=cfg.train.accumulation_steps)
    state = jts.create_train_state(jax.tree.map(jnp.asarray, params), labels,
                                   tx)
    mesh = jmesh.make_mesh(cfg.mesh, jax.devices()[:4])
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": 2, "model": 2}
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
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
    return out, bridge.flax_to_state_dict(jax.tree.map(
        np.asarray, jopt.merge_params(dict(state.trainable),
                                      dict(state.frozen))))


def test_tensor_parallel_train_step_matches_jax_on_a_data_model_mesh(
        tmp_path):
    """Dropout off, global loss, the clip active: the port on 4 ranks as
    (data 2 × model 2) against JAX on a (data 2, model 2) CPU mesh by
    tests/test_torch_train_step.py's port-vs-JAX rule (each micro-step's
    loss and grad norm within rtol 1e-4) and the merged weights by the step
    rule."""
    cfg = _step_cfg("global", 2, 2, dropout=False)
    params = _jax_params(cfg.model)
    batches = _host_batches(cfg, 2)
    dpw.spawn(tmp_path, 4, "tp_step_rank", tmp_path, [port_cfg(cfg)],
              _weights(cfg, params), batches, 4, False)
    ranks = [r[0] for r in dpw.load(tmp_path, 4)]
    want, weights = _jax_tp_mesh_step(cfg, params, batches, 4)
    for i, (g, w) in enumerate(zip(ranks[0]["metrics"], want)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=f"{key} {i}")
    got = _merged(ranks, 0, {k: tuple(v.shape) for k, v in weights.items()})
    hold_to_step_rule(got, {k: weights[k] for k in got})


# ---- (5) JAX's mesh shrink ----------------------------------------------------

@pytest.fixture(scope="module")
def two_rank_batch6(tmp_path_factory):
    base = tmp_path_factory.mktemp("shrink_ref")
    dpw.spawn(base, 2, "loop_rank", _ensure(base / "w"),
              _tiny(base / "run", "data.batch_size=6"))
    return base / "run", dpw.load(base / "w", 2)


@pytest.mark.parametrize("override", ["data.batch_size=6",
                                      "mesh.num_data=2"])
def test_shrunk_mesh_trains_as_the_smaller_mesh(tmp_path, two_rank_batch6,
                                                override):
    """4 ranks with a global batch of 6 (gcd(6, 4) = 2, JAX's warning) or
    ``mesh.num_data=2``: ranks 0-1 train and write what a 2-rank run
    writes, bit for bit; ranks 2-3 write nothing, join no collective of
    the run and return."""
    ref_dir, ref = two_rank_batch6
    out = tmp_path / "run"
    dpw.spawn(tmp_path, 4, "loop_rank", _ensure(tmp_path / "w"),
              _tiny(out, "data.batch_size=6", override))
    ranks = dpw.load(tmp_path / "w", 4)
    assert ranks[2] == ranks[3] == {"active": False, "writes": []}
    for r in range(2):
        for k, v in ref[r]["weights"].items():
            assert torch.equal(ranks[r]["weights"][k], v), (r, k)
    assert _files(out) == _files(ref_dir)
    log = (out / "training.log").read_text()
    assert "Mesh: data=2 × model=1 on ranks 0-1 of 4" in log
    if override == "data.batch_size=6":
        assert "shrinking the mesh to data=2" in log


@pytest.mark.parametrize("batch,world,num_data,model,want", [
    (6, 4, -1, 1, 2), (8, 4, 2, 1, 2), (8, 4, -1, 2, 2), (6, 8, -1, 2, 2),
    (3, 4, -1, 2, 1), (8, 4, 1, 2, 1)])
def test_make_mesh_follows_jax_arithmetic(monkeypatch, batch, world,
                                          num_data, model, want):
    """The data axis ``make_mesh`` gives is JAX's: its ``make_mesh`` over
    ``world`` devices, shrunk as its loop shrinks a batch the axis does not
    divide."""
    cfg = dp_cfg("global")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        mesh=MeshConfig(num_data=num_data, num_model=model))
    jm = jmesh.make_mesh(cfg.mesh, jax.devices()[:world])
    n = jm.shape["data"]
    if batch % n:
        jm = jmesh.make_mesh(dataclasses.replace(
            cfg.mesh, num_data=np.gcd(batch, n)), jax.devices()[:world])
    monkeypatch.setattr(tmesh.collectives, "world_size", lambda: world)
    mesh = tmesh.make_mesh(port_cfg(cfg))
    assert (mesh.data, mesh.model) == (jm.shape["data"], jm.shape["model"]) \
        == (want, model)


# ---- (6) a preempted tensor-parallel run, resumed -----------------------------

def test_tensor_parallel_run_preempted_and_resumed(tmp_path):
    """preset=tiny on (data 1 × model 2) at accumulation 2: preempted
    after micro-step 3, inside an accumulation window (the accumulator's
    shards are saved), resumed, finished; bit-identical to an
    uninterrupted run on both ranks; its checkpoints hold the one-process
    layout: ``final_model`` equals the ranks' merged shards and serves
    through ``Embedder``, and the preempted ``latest`` resumes at
    ``num_model=1`` to the same weights by the step rule."""
    tp, acc = "mesh.num_model=2", "train.accumulation_steps=2"
    cut = tmp_path / "cut"
    dpw.spawn(tmp_path / "a", 2, "loop_rank", _ensure(tmp_path / "a"),
              _tiny(cut, tp, acc, "train.fault_inject_preempt_at=3"))
    first = dpw.load(tmp_path / "a", 2)
    shutil.copytree(cut, tmp_path / "one")
    saved_opt = torch.load(cut / "latest" / "optimizer.pt",
                           weights_only=True)["optimizer"]
    assert saved_opt["mini_step"] == 1 and saved_opt["acc"] is not None
    dpw.spawn(tmp_path / "b", 2, "loop_rank", _ensure(tmp_path / "b"),
              _tiny(cut, tp, acc))
    resumed = dpw.load(tmp_path / "b", 2)
    whole = tmp_path / "whole"
    dpw.spawn(tmp_path / "c", 2, "loop_rank", _ensure(tmp_path / "c"),
              _tiny(whole, tp, acc))
    uncut = dpw.load(tmp_path / "c", 2)
    for r in first:
        assert r["preempted"] == {"epoch": 1, "batches_done": 3}
    assert "Tensor parallel: 2 rank(s)" in (cut / "training.log").read_text()
    for r in range(2):
        assert resumed[r]["skipped"] == [3]
        for k, v in uncut[r]["weights"].items():
            assert torch.equal(v, resumed[r]["weights"][k]), (r, k)
    assert uncut[0]["writes"] and not uncut[1]["writes"]
    saved = torch.load(whole / "final_model" / "model.pt", weights_only=True)
    for k, v in saved.items():
        parts = [u["weights"][k] for u in uncut]
        assert torch.equal(tmesh.merge_shards(k, parts, v.shape), v), k
    one = loop.run_experiment(_tiny(tmp_path / "one", acc), device="cpu")
    assert one["epochs"][0]["skipped_batches"] == 3
    trainable = set(one["state"].trainable)
    hold_to_step_rule({k: v for k, v in saved.items() if k in trainable},
                      {k: p.detach() for k, p in
                       one["state"].trainable.items()})
    emb = Embedder.from_checkpoint(str(whole / "final_model"), device="cpu")
    e = emb.embed_texts(["casa tempo dia", "mar sol"])
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1, atol=1e-5)


def test_test_phase_loads_a_best_checkpoint_as_shards(tmp_path):
    """The eval model the test and retrieval phases load under tensor
    parallel (``load_checkpoint`` with a mesh) holds each rank's shards of
    the one-process model exactly, and embeds as the whole model does."""
    cfg = _tiny(tmp_path / "run", "mesh.num_model=2")
    path = str(tmp_path / "best")
    model = init_model(cfg.model, torch.Generator().manual_seed(5),
                       train=True)
    ckpt_lib.save_params_checkpoint(path, model, cfg)
    batch = {k: torch.as_tensor(v) for k, v in
             _host_batches(dp_cfg("global"), 1)[0].items()}
    dpw.spawn(tmp_path, 2, "eval_load_rank", str(tmp_path), cfg, path, batch)
    ranks = dpw.load(tmp_path, 2)
    _, whole = ckpt_lib.load_checkpoint(path, "cpu")
    shapes = whole.full_shapes()
    for k, v in whole.state_dict().items():
        parts = [r["state"][k] for r in ranks]
        if tmesh.shard_dim(k) is not None:
            assert parts[0].shape != v.shape, k
        assert torch.equal(tmesh.merge_shards(k, parts, shapes[k]), v), k
    features, amask = make_frontend(cfg.model.frontend)(
        batch["waveform"], batch["num_samples"])
    with torch.no_grad():
        want = {"text": whole.encode_text(batch["input_ids_pos"],
                                          batch["attention_mask_pos"])[0],
                "audio": whole.encode_audio(features, amask)[0]}
    for r in ranks:
        for key, v in want.items():
            torch.testing.assert_close(r[key], v, **FWD)


# ---- (7) torchrun through the CLI ---------------------------------------------

def test_torchrun_cli_tensor_parallel_on_the_cpu(tmp_path):
    """``torchrun --nproc_per_node=2 -m speech_transcript_embeddings_torch.
    train preset=tiny device=cpu mesh.num_model=2``: rank 0 writes what the
    one-process CLI writes, and the final weights equal the one-process
    run's by the step rule."""
    argv = ["preset=tiny", "device=cpu", "train.num_epochs=1",
            "data.num_synthetic_samples=32"]
    root, env = _torchrun_env()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "speech_transcript_embeddings_torch.train",
         *argv, "mesh.num_model=2", f"train.output_dir={tmp_path / 'tp'}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    one = torch_train.main(argv + [f"train.output_dir={tmp_path / 'one'}"])
    assert _files(tmp_path / "tp") == _files(tmp_path / "one")
    log = (tmp_path / "tp" / "training.log").read_text()
    assert "Tensor parallel: 2 rank(s) a data row over gloo" in log
    got = torch.load(tmp_path / "tp" / "final_model" / "model.pt",
                     weights_only=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(p.shape) for k, p in one["state"].model.named_parameters()}
    hold_to_step_rule({k: got[k] for k in one["state"].trainable},
                      {k: p.detach() for k, p in
                       one["state"].trainable.items()}, lr=1e-3)
