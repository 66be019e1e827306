"""Port of the relative_key flash attention: the plain twin (and the CPU
path of the wrapper) against the JAX ``flash_attention`` in interpret mode,
with the shapes of tests/test_flash_attention.py plus a clip with no valid
frame."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_transcript_embeddings_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from speech_transcript_embeddings_torch.ops import flash_attention as fa
from torch_port_cfg import one_thread  # noqa: F401

NH, T, HD = 2, 150, 16
L, R = 9, 3


def _inputs(lengths, seed=0, t=T):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(len(lengths) * NH, t, HD)).astype(np.float32)
               for _ in range(3))
    e = (rng.normal(size=(L + R + 1, HD)) * 0.3).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return q, k, v, e, mask


def _jax(q, k, v, e, mask, dtype=jnp.float32):
    out = jax_flash(*(jnp.asarray(x, dtype) for x in (q, k, v, e)),
                    jnp.asarray(mask), num_heads=NH, left_max=L,
                    interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, q, k, v, e, mask, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v, e)]
    return fn(*args, torch.from_numpy(mask), num_heads=NH, left_max=L)


@pytest.mark.parametrize("t,lengths", [(T, (T, 100)), (T, (T, 0)),
                                       (128, (128, 77)), (256, (256, 200))],
                         ids=["ragged", "zero_length_row", "one_tile",
                              "two_tiles"])
def test_twin_matches_jax_interpret(t, lengths):
    """fp32 at 1e-5, as the JAX kernel is held to its own reference; a clip
    with no valid frame gets the uniform average over the 256 padded keys
    (finite, not NaN), as JAX's finite NEG gives it."""
    q, k, v, e, mask = _inputs(lengths, t=t)
    ref = _jax(q, k, v, e, mask)
    out, lse = _torch(fa.rel_attention_reference, q, k, v, e, mask)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    assert lse.shape == (len(lengths) * NH, t, 1)
    # the wrapper takes the twin for CPU tensors
    via_wrapper = _torch(fa.flash_attention, q, k, v, e, mask)
    np.testing.assert_array_equal(via_wrapper.numpy(), out.numpy())
    if lengths[1] == 0:
        np.testing.assert_allclose(out.numpy()[NH:], np.broadcast_to(
            v[NH:].sum(1, keepdims=True) / 256, (NH, T, HD)),
            rtol=1e-5, atol=1e-6)


def test_lse_is_the_row_logsumexp():
    """lse = log Σ_j exp(s_ij) over the valid keys, from the math in float64."""
    q, k, v, e, mask = _inputs((T, 100))
    _, lse = _torch(fa.rel_attention_reference, q, k, v, e, mask)
    pos = np.arange(T)
    rel = e[np.clip(pos[None, :] - pos[:, None], -L, R) + L]      # [T, T, HD]
    qs = q.astype(np.float64) / np.sqrt(HD)
    s = np.einsum("bqd,bkd->bqk", qs, k) + np.einsum("bqd,qkd->bqk", qs, rel)
    lengths = np.repeat([T, 100], NH)
    s = np.where(pos[None, None, :] < lengths[:, None, None], s, -np.inf)
    ref = np.log(np.sum(np.exp(s - s.max(-1, keepdims=True)), -1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy()[..., 0], ref, rtol=1e-5, atol=1e-4)


def test_twin_matches_jax_bf16():
    """bf16 inputs: the same roundings (q_s, qE, probabilities) as the TPU
    kernel; 2e-2 is bf16's resolution at these magnitudes."""
    q, k, v, e, mask = _inputs((T, 100), seed=3)
    ref = _jax(q, k, v, e, mask, jnp.bfloat16)
    out, _ = _torch(fa.rel_attention_reference, q, k, v, e, mask,
                    torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2, atol=2e-2)


def test_wrapper_raises_without_backward():
    """The wrapper is differentiable now (the name predates the backward):
    under grad mode every input gets a finite gradient of its own shape and
    dtype, through the twins on the CPU, with no kernel launch counted."""
    q, k, v, e, mask = _inputs((T, 100))
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, e)]
    out = fa.flash_attention(*args, torch.from_numpy(mask), num_heads=NH,
                             left_max=L)
    assert out.requires_grad
    out.square().sum().backward()
    for x in args:
        assert x.grad is not None and x.grad.shape == x.shape
        assert x.grad.dtype == x.dtype and torch.isfinite(x.grad).all()
        assert x.grad.abs().max() > 0
    assert sum(fa.LAUNCHES.values()) == 0
    with torch.no_grad():
        assert not fa.flash_attention(*args, torch.from_numpy(mask),
                                      num_heads=NH, left_max=L).requires_grad


def test_wrapper_rejects_bad_inputs_and_other_devices():
    q, k, v, e, mask = _inputs((T, 100))
    t = [torch.from_numpy(x) for x in (q, k, v, e)]
    with pytest.raises(ValueError, match="num_pos"):
        fa.flash_attention(t[0], t[1], t[2], torch.zeros(129, HD),
                           torch.from_numpy(mask), num_heads=NH, left_max=L)
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention(*t, torch.from_numpy(mask), num_heads=3,
                           left_max=L)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*meta, torch.from_numpy(mask).to("meta"),
                           num_heads=NH, left_max=L)
    assert sum(fa.LAUNCHES.values()) == 0


@functools.lru_cache(maxsize=None)
def _jax_grads_cached(t, lengths, seed, dtype_name):
    """``jax.grad`` of Σ out·w for the inputs of ``_inputs(lengths, seed,
    t)`` (interpret mode is slow: tests that share inputs share this)."""
    import jax
    q, k, v, e, mask = _inputs(lengths, seed=seed, t=t)
    w = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    dtype = getattr(jnp, dtype_name)

    def loss(q, k, v, e):
        out = jax_flash(q, k, v, e, jnp.asarray(mask), num_heads=NH,
                        left_max=L, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x, dtype) for x in (q, k, v, e)))
    return w, [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(fn, q, k, v, e, mask, w, dtype=torch.float32, **kw):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v, e)]
    out = fn(*args, torch.from_numpy(mask), num_heads=NH, left_max=L, **kw)
    out = out[0] if isinstance(out, tuple) else out
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [a.grad.float().numpy() for a in args], args


@pytest.mark.parametrize("t,lengths", [(T, (T, 100)), (T, (T, 0)),
                                       (128, (128, 77)), (256, (256, 200))],
                         ids=["ragged", "zero_length_row", "one_tile",
                              "two_tiles"])
def test_backward_matches_jax_grad(t, lengths):
    """dq, dk, dv and dE of the wrapper (its CPU backward is the twin of K4)
    against ``jax.grad`` of the JAX function in interpret mode; fp32 at
    rtol 1e-4 / atol 1e-5, as tests/test_flash_attention.py holds the
    kernel's gradients. A clip with no valid frame has p = 1 on all 256
    keys in JAX's backward (see the test below), so its gradients are 256×
    larger and the absolute floor scales with them."""
    q, k, v, e, mask = _inputs(lengths, seed=4, t=t)
    w, ref = _jax_grads_cached(t, lengths, 4, "float32")
    got, _ = _torch_grads(fa.flash_attention, q, k, v, e, mask, w)
    atol = 1e-5 * (fa._t_pad(t) if 0 in lengths else 1)
    for name, a, b in zip(("dq", "dk", "dv", "dE"), got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=name)


def test_backward_matches_jax_grad_bf16():
    """bf16 inputs, gradients in bf16 (dE in E's dtype): 2e-2 of the
    largest gradient, bf16's resolution after the fp32 accumulations."""
    q, k, v, e, mask = _inputs((T, 100), seed=6)
    w, ref = _jax_grads_cached(T, (T, 100), 6, "bfloat16")
    got, args = _torch_grads(fa.flash_attention, q, k, v, e, mask, w,
                             torch.bfloat16)
    assert all(a.grad.dtype == torch.bfloat16 for a in args)
    for name, a, b in zip(("dq", "dk", "dv", "dE"), got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-2,
                                   atol=2e-2 * np.abs(b).max(), err_msg=name)


def test_autograd_of_the_additive_twin_on_a_clip_with_no_frame():
    """The twin masks additively, as the TPU kernels do, so autograd through
    it sends the padded keys' gradient into the bias (dE) on a clip with no
    valid frame; a ``torch.where`` mask sent none. JAX's backward reads p
    from lse = NEG there (log 256 vanishes beside 1e30), so p = 1 where
    the exact softmax has 1/256: on that clip its gradients are 256×
    autograd's, on the other clip they agree."""
    lengths = (T, 0)
    q, k, v, e, mask = _inputs(lengths, seed=4)
    w, ref = _jax_grads_cached(T, lengths, 4, "float32")
    per_clip = []
    for c in range(2):
        rows = slice(c * NH, (c + 1) * NH)
        got, _ = _torch_grads(fa.rel_attention_reference, q[rows], k[rows],
                              v[rows], e, mask[c:c + 1], w[rows])
        per_clip.append(got)
    assert np.abs(per_clip[1][3]).max() > 0
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(per_clip[0][i], ref[i][:NH], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(256 * per_clip[1][i], ref[i][NH:],
                                   rtol=1e-4, atol=256e-5, err_msg=name)
    np.testing.assert_allclose(per_clip[0][3] + 256 * per_clip[1][3], ref[3],
                               rtol=1e-4, atol=256e-5, err_msg="dE")


@pytest.mark.parametrize("t,lengths", [(T, (T, 100)), (T, (T, 0)),
                                       (128, (128, 77)), (256, (256, 200))],
                         ids=["ragged", "zero_length_row", "one_tile",
                              "two_tiles"])
def test_additive_mask_forward_is_bitwise_the_where_mask(t, lengths):
    """The additive key mask leaves the twin's forward bit for bit where a
    ``torch.where`` mask put it (|s| ≪ ulp(1e30), so s + NEG == NEG)."""
    q, k, v, e, mask = _inputs(lengths, t=t)
    qt, kt, vt, et = (torch.from_numpy(x) for x in (q, k, v, e))
    out, lse = fa.rel_attention_reference(qt, kt, vt, et, torch.from_numpy(
        mask), num_heads=NH, left_max=L)
    t_pad = fa._t_pad(t)
    pad = (0, 0, 0, t_pad - t)
    qp, kp, vp = (torch.nn.functional.pad(x, pad)
                  for x in (qt * fa._scale(qt.dtype, HD), kt, vt))
    qe = qp @ et.T
    bias = torch.gather(qe, 2, fa._dist_index(t_pad, t_pad, L, R, "cpu")[
        None].expand(qp.shape[0], t_pad, t_pad))
    lens = torch.repeat_interleave(torch.tensor(lengths), NH)
    s = torch.where(torch.arange(t_pad)[None, None, :] < lens[:, None, None],
                    qp @ kp.transpose(1, 2) + bias, fa.NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    assert torch.equal(out, ((p @ vp) / l)[:, :t])
    assert torch.equal(lse, (m + torch.log(l))[:, :t])


def test_save_residuals_matches_plain(monkeypatch):
    """The ``residuals`` list (the JAX ``save_residuals``): the first call
    stores the forward's (out, lse) in it; a call with the filled list, as
    a remat replay makes it, runs no forward and gives the same output and
    gradients, bit for bit, as a call without the list."""
    q, k, v, e, mask = _inputs((T, 100), seed=10)
    w = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)
    plain, _ = _torch_grads(fa.flash_attention, q, k, v, e, mask, w)
    residuals = []
    first, _ = _torch_grads(fa.flash_attention, q, k, v, e, mask, w,
                            residuals=residuals)
    assert len(residuals) == 2 and residuals[1].shape == (2 * NH, T, 1)
    monkeypatch.setattr(fa, "flash_attention_fwd", None)   # must not run
    replay, _ = _torch_grads(fa.flash_attention, q, k, v, e, mask, w,
                             residuals=residuals)
    for name, a, b, c in zip(("dq", "dk", "dv", "dE"), first, replay, plain):
        np.testing.assert_array_equal(a, c, err_msg=name)
        np.testing.assert_array_equal(b, c, err_msg=name)


def test_module_flash_matches_plain_path():
    """The port's RelPositionAttention with use_flash_attention flipped:
    the same forward and parameter gradients (fp32, the tolerances of
    tests/test_flash_attention.py's module test)."""
    import dataclasses

    from speech_transcript_embeddings_torch.config import AudioEncoderConfig
    from speech_transcript_embeddings_torch.models.audio_encoder import (
        RelPositionAttention,
    )
    cfg = AudioEncoderConfig(
        feature_dim=8, hidden_size=NH * HD, num_layers=1, num_heads=NH,
        intermediate_size=64, conv_kernel_size=7, left_max_rel_pos=L,
        right_max_rel_pos=R, attention_dropout=0.0, apply_spec_augment=False)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, T, NH * HD, generator=g)
    mask = (torch.arange(T)[None, :] < torch.tensor([[T], [100]])).int()
    grads, outs = [], []
    for flash in (False, True):
        mod = RelPositionAttention(
            dataclasses.replace(cfg, use_flash_attention=flash), torch.float32)
        gi = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in mod.parameters():
                p.copy_(torch.randn(p.shape, generator=gi) * 0.2)
        out = mod(x, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in mod.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    for name, gx in grads[0].items():
        torch.testing.assert_close(grads[1][name], gx, rtol=2e-3, atol=1e-4,
                                   msg=name)


# ---- the tensor-core kernels' tile schedule, rehearsed on the CPU ----------
#
# A test-only emulation of the bf16 kernels of csrc/flash_rel_fwd_sm90.cu
# (the wgmma forward) and csrc/flash_rel_bwd_sm90.cu (the wgmma backward
# pair): the same tiles (blocks of 64 query or key rows, each warp's 16 rows
# against steps of 32 columns), the same band classification (a warp's step
# whose every j − i ≤ −L or ≥ R takes a row-constant bias, whose gradient is
# the row sum of ds), the same skip of the keys past a clip's length, the
# same online softmax per 32-key tile, the same bf16 rounding points and
# scratch (q_s, qE in bf16, dd summed in kernel A's order), in fp32 torch
# ops.

EL, ER = 64, 8                     # the conformer's band
TILE, WARP_ROWS = 64, 16          # rows a block owns, rows a warp owns
COLS = 32                          # columns of a step (the kernels' kN)
NEG = -1e30


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, e, lengths, nh):
    """(out, lse) of one call of the forward kernel, q/k/v ``[B·h, t, hd]``
    bf16 (as fp32 values), e ``[P, hd]``, ``lengths`` per clip: each warp's
    16 queries over the key tiles of 32, the online softmax rescaled once a
    tile, a tile of one bias a row adding it to the row max and taking it
    off the max in p's exponent."""
    bh, t, hd = q.shape
    t_pad, lr = fa._t_pad(t), EL + ER
    qs = _bf(q * _bf(torch.tensor(1.0 / np.sqrt(hd))))
    qe = _bf(qs @ e.T)                                       # [bh, t, P]
    out = torch.zeros_like(q)
    lse = torch.zeros(bh, t, 1)
    for row in range(bh):
        limit = lengths[row // nh]
        n_keys = limit if limit > 0 else t
        for i0 in range(0, t, WARP_ROWS):
            rows = torch.arange(i0, min(i0 + WARP_ROWS, t))
            m = torch.full((len(rows), 1), -np.inf)
            l = torch.zeros(len(rows), 1)
            o = torch.zeros(len(rows), hd)
            for j0 in range(0, n_keys, COLS):
                cols = torch.arange(j0, min(j0 + COLS, t))
                s = qs[row, rows] @ k[row, cols].T
                all_lo = j0 + COLS - 1 - i0 <= -EL
                all_hi = j0 - (i0 + WARP_ROWS - 1) >= ER
                if j0 + COLS <= limit and (all_lo or all_hi):
                    # one bias a row: on the row max, and in p's exponent
                    shift = qe[row, rows][:, [0 if all_lo else lr]]
                    m_new = torch.maximum(m, s.amax(1, keepdim=True) + shift)
                else:
                    c = torch.clamp(cols[None] - rows[:, None], -EL, ER) + EL
                    s = s + torch.gather(qe[row, rows], 1, c)
                    s = torch.where(cols[None] >= limit, NEG, s)
                    shift = 0.0
                    m_new = torch.maximum(m, s.amax(1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - (m_new - shift))
                l = l * corr + p.sum(1, keepdim=True)
                o = o * corr + _bf(p) @ v[row, cols]
                m = m_new
            l = l + (t_pad - t) * torch.exp(NEG - m)
            out[row, rows] = _bf(o / l)
            lse[row, rows] = m + torch.log(l)
    return out, lse


def _dd_kernel_a(dout, out):
    """dd = rowsum(dO∘O) as kernel A sums it: two threads a row, each adding
    its half of the columns in order in fp32 (a bf16·bf16 product is exact
    there, so this is the kernel's fmaf chain), then half 0 + half 1."""
    hd = dout.shape[-1]
    halves = []
    for cols in (range(hd // 2), range(hd // 2, hd)):
        acc = torch.zeros(dout.shape[:-1])
        for c in cols:
            acc = acc + dout[..., c] * out[..., c]
        halves.append(acc)
    return halves[0] + halves[1]


def _emulate_bwd(q, k, v, e, lengths, nh, out, lse, dout):
    """(dq, dk, dv, dE) of one call of the backward pair: kernel A a block
    per (row, 64 queries), each warp's 16 queries over the key tiles of 32;
    kernel B a block per (row, 64 keys), each warp's 16 keys over the query
    tiles of 32, reading q_s, qE (bf16) and dd from kernel A's scratch."""
    bh, t, hd = q.shape
    t_pad, lr, num_pos = fa._t_pad(t), EL + ER, e.shape[0]
    cols_step = COLS
    qs = _bf(q * _bf(torch.tensor(1.0 / np.sqrt(hd))))       # scratch
    qe_scratch = (qs @ e.T).to(torch.bfloat16)               # scratch
    qe = qe_scratch.float()
    dd = _dd_kernel_a(dout, out)                             # scratch
    lse = lse[..., 0]
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    de = torch.zeros(num_pos, hd)
    for row in range(bh):
        limit = lengths[row // nh]
        n_keys = limit if limit > 0 else t
        dqe = torch.zeros(t, num_pos)
        for b0 in range(0, t, TILE):                         # kernel A
            for i0 in range(b0, min(b0 + TILE, t), WARP_ROWS):
                rows = torch.arange(i0, min(i0 + WARP_ROWS, t))
                acc = torch.zeros(len(rows), hd)
                lo = torch.zeros(len(rows))
                hi = torch.zeros(len(rows))
                for j0 in range(0, n_keys, cols_step):
                    cols = torch.arange(j0, min(j0 + cols_step, t))
                    s = qs[row, rows] @ k[row, cols].T
                    dp = dout[row, rows] @ v[row, cols].T
                    all_lo = j0 + cols_step - 1 - i0 <= -EL
                    all_hi = j0 - (i0 + WARP_ROWS - 1) >= ER
                    if j0 + cols_step <= limit and (all_lo or all_hi):
                        b = qe[row, rows][:, [0 if all_lo else lr]]
                        ds = torch.exp(s + b - lse[row, rows, None]) * (
                            dp - dd[row, rows, None])
                        if all_lo:
                            lo += ds.sum(1)
                        else:
                            hi += ds.sum(1)
                    else:
                        c = torch.clamp(cols[None] - rows[:, None], -EL,
                                        ER) + EL
                        s = torch.where(cols[None] >= limit, NEG,
                                        s + torch.gather(qe[row, rows], 1, c))
                        ds = torch.exp(s - lse[row, rows, None]) * (
                            dp - dd[row, rows, None])
                        lo += torch.where(c == 0, ds, 0.0).sum(1)
                        hi += torch.where(c == lr, ds, 0.0).sum(1)
                        inner = (c > 0) & (c < lr)
                        dqe[rows] += torch.zeros(
                            len(rows), num_pos).scatter_add_(
                                1, c, torch.where(inner, ds, 0.0))
                    acc += _bf(ds) @ k[row, cols]
                dqe[rows, 0] += lo
                dqe[rows, lr] += hi
                p_pad = torch.exp(NEG - lse[row, rows])
                for j in range(t, t_pad):                    # padded keys
                    c = torch.clamp(j - rows, -EL, ER) + EL
                    dqe[rows, c] += -p_pad * dd[row, rows]
                acc += _bf(dqe[rows]) @ e
                dq[row, rows] = _bf(_bf(acc) * (1.0 / np.sqrt(hd)))
        de += dqe.T @ qs[row]
        for b0 in range(0, t, TILE):                         # kernel B
            if limit > 0 and b0 >= limit:
                continue                                     # dk = dv = 0
            for j0 in range(b0, min(b0 + TILE, t), WARP_ROWS):
                keys = torch.arange(j0, min(j0 + WARP_ROWS, t))
                ak = torch.zeros(len(keys), hd)
                av = torch.zeros(len(keys), hd)
                for iq in range(0, t, cols_step):
                    qr = torch.arange(iq, min(iq + cols_step, t))
                    s = k[row, keys] @ qs[row, qr].T         # [keys, queries]
                    dp = v[row, keys] @ dout[row, qr].T
                    all_lo = j0 + WARP_ROWS - 1 - iq <= -EL
                    all_hi = j0 - (iq + cols_step - 1) >= ER
                    if j0 + WARP_ROWS <= limit and (all_lo or all_hi):
                        s = s + qe[row, qr][:, 0 if all_lo else lr][None]
                    else:
                        c = torch.clamp(keys[:, None] - qr[None], -EL,
                                        ER) + EL
                        s = torch.where(keys[:, None] >= limit, NEG,
                                        s + torch.gather(qe[row, qr].T, 0, c))
                    p = torch.exp(s - lse[row, qr][None])
                    ds = p * (dp - dd[row, qr][None])
                    av += _bf(p) @ dout[row, qr]
                    ak += _bf(ds) @ qs[row, qr]
                dk[row, keys], dv[row, keys] = _bf(ak), _bf(av)
    return dq, dk, dv, de


def _bf_inputs(lengths, t, seed, hd=16):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(
        len(lengths) * NH, t, hd)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    e = torch.from_numpy((rng.normal(size=(EL + ER + 1, hd)) * 0.3).astype(
        np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy((np.arange(t)[None, :] < np.asarray(
        lengths)[:, None]).astype(np.float32))
    return q, k, v, e, mask, dout


@pytest.mark.parametrize("t,lengths,hd", [
    (150, (150, 97), 16), (300, (300, 0), 16), (300, (211, 300), 16),
    (100, (37, 0), 16), (200, (200, 131), 80)],
    ids=["t150_ragged", "t300_zero_length_clip", "t300_ragged",
         "t100_short_and_zero_length_clips", "t200_ragged_hd80"])
def test_mma_tile_schedule_matches_twins(t, lengths, hd):
    """The emulated schedule against ``rel_attention_reference`` (out within
    2e-2, lse within 1e-3: phase 3's tolerances) and ``rel_attention_bwd_
    reference`` (each gradient within 2e-2 of its largest element: phase
    6's), in bf16 at L = 64, R = 8. No t here is a multiple of the 64- or
    32-row tiles; hd 80 is the kernels' two-chunk case."""
    q, k, v, e, mask, dout = _bf_inputs(lengths, t, seed=t + lengths[1],
                                        hd=hd)
    kw = dict(num_heads=NH, left_max=EL)
    ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
    out, lse = _emulate_fwd(*(x.float() for x in (q, k, v, e)), lengths, NH)
    torch.testing.assert_close(out, ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
    grads = fa.rel_attention_bwd_reference(q, k, v, e, mask, ref, ref_lse,
                                           dout, **kw)
    got = _emulate_bwd(*(x.float() for x in (q, k, v, e)), lengths, NH,
                       ref.float(), ref_lse, dout.float())
    for name, a, r in zip(("dq", "dk", "dv", "dE"), got, grads):
        r = r.float()
        err = ((a - r).abs().max() / r.abs().max()).item()
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [12, 16, 32, 48, 64, 80, 96, 112, 128])
def test_scale_is_the_dtype_rounding_of_the_inverse_root(dtype, hd):
    """The launch's scale, a Python float made once per (dtype, hd), is
    bit for bit the 0-dim tensor of ``dtype`` that the JAX wrapper's
    1/√hd rounds to, and scaling q by it gives that tensor's product."""
    ref = torch.tensor(1.0 / np.sqrt(hd), dtype=dtype)
    got = fa._scale(dtype, hd)
    assert isinstance(got, float)
    assert torch.equal(torch.tensor(got, dtype=dtype), ref)
    assert got == ref.item()
    q = torch.from_numpy(np.random.default_rng(hd).normal(
        size=(3, 5, hd)).astype(np.float32)).to(dtype)
    assert torch.equal(q * got, q * ref)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.float32])
def test_lengths_match_the_three_pass_form(dtype):
    """``_lengths`` (one device pass for a bool mask, two otherwise) gives
    the int32 counts that ``sum(mask > 0).to(int32)`` gave, for a full
    clip, a ragged one, a clip with no valid frame and, for int and float
    masks, entries that are not 0 or 1."""
    mask = np.zeros((4, 150), dtype=np.float32)
    mask[0] = 1
    mask[1, :97] = 1
    mask[3, :40] = 1
    if dtype != torch.bool:
        mask[3, 40:60] = -2           # not positive: not a valid frame
        mask[1, :10] = 3
    m = torch.from_numpy(mask).to(dtype)
    got = fa._lengths(m)
    ref = torch.sum(m > 0, dim=-1).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert got.tolist() == [150, 97, 0, 40]


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 72, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 12, "simt")])
def test_flash_dispatch_rule(dtype, hd, kernel):
    """bf16 with hd a multiple of 16 up to 128 goes to the tensor-core
    kernels, everything else (fp32, odd head dims) to the CUDA-core ones."""
    assert fa.flash_kernel(dtype, hd) == kernel
