"""Port of the relative_key flash attention: the plain twin (and the CPU
path of the wrapper) against the JAX ``flash_attention`` in interpret mode,
with the shapes of tests/test_flash_attention.py plus a clip with no valid
frame."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_transcript_embeddings_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from speech_transcript_embeddings_torch.ops import flash_attention as fa

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
    q, k, v, e, mask = _inputs((T, 100))
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, e)]
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.flash_attention(*args, torch.from_numpy(mask), num_heads=NH,
                           left_max=L)
    with torch.no_grad():
        fa.flash_attention(*args, torch.from_numpy(mask), num_heads=NH,
                           left_max=L)


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
    assert fa.flash_attention_fwd.launches == 0
