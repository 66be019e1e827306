"""Model FLOPs of the dual encoder, counted from a configuration's widths and
the valid lengths of a batch: what the model's mathematics needs, whatever
the program dispatches.

* Every matrix product and convolution of the forward, 2 FLOP a
  multiply-add, at each clip's valid frames and each transcript's tokens:
  the frontend's FFT, the norms, the softmaxes and the elementwise work are
  not counted. A product whose operands are the same for the clean and the
  corrupted transcript (the fusion's audio side) is counted once a clip.
* In a train step, the backward: the gradient of each product's
  activation operand wherever a gradient flows into it (below the lowest
  trainable weight none does), and the gradient of each trainable weight;
  never any recompute (remat's replay is the program's choice).

The relative_key bias is counted as the product of the queries with the
distance table (``2·t·num_pos·H``), as the flash kernels compute it.
"""

from __future__ import annotations

from typing import Sequence


def valid_frames(fe: dict, num_samples: int) -> int:
    """Stacked frames a clip of ``num_samples`` holds valid: log-mel frames
    wholly inside the clip, paired by the stride (a stacked frame is valid
    where its last frame is)."""
    if num_samples < fe["frame_length"]:
        return 0
    frames = 1 + (num_samples - fe["frame_length"]) // fe["hop_length"]
    return frames // fe["stride"]


class Count:
    """Forward and backward FLOPs of the products added to it."""

    def __init__(self):
        self.forward = 0.0
        self.backward = 0.0

    def product(self, m: float, n: float, k: float, *, act_grad: bool,
                weight_grad: bool, weight_is_activation: bool = False):
        """``[m, k] × [k, n]``. ``act_grad``: a gradient flows into the
        left (activation) operand; ``weight_grad``: the right operand needs
        its gradient (a trainable weight, or an activation where
        ``weight_is_activation`` and a gradient flows)."""
        f = 2.0 * m * n * k
        self.forward += f
        self.backward += f * (int(act_grad) + int(weight_grad))

    @property
    def train(self) -> float:
        return self.forward + self.backward


def _audio(c: Count, m: dict, t: int, grad: bool, trainable) -> None:
    """One clip of ``t`` valid frames through the conformer, its pooling
    and its projection. ``trainable(i)``: whether block ``i`` trains (-1:
    the feature projection); ``grad``: whether a gradient flows at all."""
    a, h = m["audio"], m["heads"]
    width, inter, nh = a["hidden_size"], a["intermediate_size"], a["num_heads"]
    num_pos = a["left_max_rel_pos"] + a["right_max_rel_pos"] + 1
    flows = lambda i: grad and any(trainable(j) for j in range(-1, i + 1))
    c.product(t, width, a["feature_dim"], act_grad=flows(-1),
              weight_grad=grad and trainable(-1))
    for i in range(a["num_layers"]):
        g, w = flows(i), grad and trainable(i)
        for _ in range(2):                           # ffn1, ffn2
            c.product(t, inter, width, act_grad=g, weight_grad=w)
            c.product(t, width, inter, act_grad=g, weight_grad=w)
        for _ in range(4):                           # q, k, v, out
            c.product(t, width, width, act_grad=g, weight_grad=w)
        hd = width // nh
        for _ in range(2):                           # q·kᵀ, p·v
            c.product(nh * t, t, hd, act_grad=g, weight_grad=g,
                      weight_is_activation=True)
        c.product(nh * t, num_pos, hd, act_grad=g, weight_grad=w)   # q·Eᵀ
        c.product(t, 2 * width, width, act_grad=g, weight_grad=w)   # GLU in
        c.product(t, width, a["conv_kernel_size"], act_grad=False,
                  weight_grad=False)                 # depthwise, per channel
        c.backward += 2.0 * t * width * a["conv_kernel_size"] * (
            int(g) + int(w))
        c.product(t, width, width, act_grad=g, weight_grad=w)       # GLU out
    _pool_project(c, h, width, t, grad)


def _pool_project(c: Count, h: dict, width: int, t: int, grad: bool) -> None:
    d = h["projection_dim"]
    hidden = h.get("projection_hidden_dim") or 2 * d
    if h["use_attentive_pooling"]:
        c.product(t, width // 2, width, act_grad=grad, weight_grad=grad)
        c.product(t, 1, width // 2, act_grad=grad, weight_grad=grad)
        c.product(1, width, t, act_grad=grad, weight_grad=grad,
                  weight_is_activation=True)
    c.product(1, hidden, width, act_grad=grad, weight_grad=grad)
    c.product(1, d, hidden, act_grad=grad, weight_grad=grad)


def _text(c: Count, m: dict, n: int, grad: bool, trainable) -> None:
    """One transcript of ``n`` tokens through the text encoder, its pooling
    and its projection (``trainable(-1)``: the embeddings)."""
    t = m["text"]
    width, inter, nh = t["hidden_size"], t["intermediate_size"], t["num_heads"]
    flows = lambda i: grad and any(trainable(j) for j in range(-1, i + 1))
    for i in range(t["num_layers"]):
        g, w = flows(i), grad and trainable(i)
        for _ in range(4):
            c.product(n, width, width, act_grad=g, weight_grad=w)
        for _ in range(2):
            c.product(nh * n, n, width // nh, act_grad=g, weight_grad=g,
                      weight_is_activation=True)
        c.product(n, inter, width, act_grad=g, weight_grad=w)
        c.product(n, width, inter, act_grad=g, weight_grad=w)
    _pool_project(c, m["heads"], width, n, grad)


def _fusion(c: Count, m: dict, t: int, n: int, grad: bool) -> None:
    """The cross-modal heads for one clip of ``t`` frames against its clean
    and corrupted transcript of ``n`` tokens each."""
    d, ha, ht = (m["heads"]["projection_dim"], m["audio"]["hidden_size"],
                 m["text"]["hidden_size"])
    p = lambda *s: c.product(*s, act_grad=grad, weight_grad=grad)
    p(t, d, ha)                      # audio_seq, once a clip
    p(2 * t, d, d)                   # its keys and values (text→audio)
    p(1, d, d)                       # the audio query (audio→text)
    for _ in range(2):               # the clean and the corrupted transcript
        p(n, d, ht)                  # text_seq
        p(2 * n, d, d)               # its keys and values (audio→text)
        p(1, d, d)                   # the text query (text→audio)
        p(1, t, d)                   # text→audio scores
        p(1, d, t)                   # and values
        p(1, n, d)                   # audio→text scores
        p(1, d, n)                   # and values
        p(2, d, d)                   # the two out projections
        p(2, d, 2 * d)               # the two fusion denses


def _alignment(c: Count, m: dict, t: int, n: int, grad: bool) -> None:
    """The word-alignment head for one clip and its clean transcript."""
    d, ha, ht = (m["heads"]["projection_dim"], m["audio"]["hidden_size"],
                 m["text"]["hidden_size"])
    p = lambda *s: c.product(*s, act_grad=grad, weight_grad=grad)
    p(n, d, ht)
    p(t, d, ha)
    p(n, d, d)                                   # q
    p(2 * t, d, d)                               # k, v
    p(n, t, d)                                   # scores
    p(n, d, t)                                   # values
    p(n, d, d)                                   # out
    p(n, d, d)                                   # output_proj
    p(n, d // 2, d)
    p(n, 1, d // 2)


def _trainable(m: dict, freeze: dict, side: str):
    enc = m[side]
    keep = freeze[f"{side}_layers_to_unfreeze"]
    bottom = freeze["train_text_embeddings" if side == "text"
                    else "train_audio_feature_projection"]
    return lambda i: bottom if i < 0 else i >= enc["num_layers"] - keep


def train_step(config: dict, clip_samples: Sequence[int],
               text_len: int) -> float:
    """Model FLOPs of one train step of a configuration file's model: each
    clip (valid samples) with its clean and corrupted transcript of
    ``text_len`` tokens, forward and backward, and the loss."""
    m, freeze = config["model"], config["freeze"]
    c = Count()
    ta = _trainable(m, freeze, "audio")
    tt = _trainable(m, freeze, "text")
    for n in clip_samples:
        t = valid_frames(m["frontend"], int(n))
        _audio(c, m, t, True, ta)
        for _ in range(2):
            _text(c, m, text_len, True, tt)
        if m["heads"]["use_cross_modal"]:
            _fusion(c, m, t, text_len, True)
        if m["heads"]["use_word_alignment"]:
            _alignment(c, m, t, text_len, True)
    b, d = len(clip_samples), m["heads"]["projection_dim"]
    c.product(b, 2 * b, d, act_grad=True, weight_grad=True,
              weight_is_activation=True)
    return c.train


def embed_audio(config: dict, clip_samples: Sequence[int]) -> float:
    """Model FLOPs of the serving embedding of each clip: the conformer,
    the pooling and the projection, forward only."""
    m = config["model"]
    c = Count()
    for n in clip_samples:
        _audio(c, m, valid_frames(m["frontend"], int(n)), False,
               lambda i: False)
    return c.forward
