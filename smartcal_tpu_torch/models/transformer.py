"""Transformer classifier for demixing-direction recommendation
(counterpart of smartcal_tpu/models/transformer.py; reference
``calibration/transformer_models.py:76-186``).

A 1-layer encoder whose multi-head attention has NO sequence axis: the
input (batch, K*(Npix^2+8)) is projected to model_dim, reshaped into
``num_heads = K`` head slots, and attention runs ACROSS THE HEADS (each
head is one sky direction; the logits are (batch, heads, heads)).  The
output is a sigmoid over K-1 labels ("demix this direction?").

The submodules carry flax's auto names (``Dense_0``, ``EncoderBlock_0``,
``HeadAttention_0``, ``LayerNorm_1``, ...), so
``interop.params_from_flax`` fills them from a flax tree and
``ops.autodiff.ravel_params`` flattens them in ``ravel_pytree``'s order.
As in flax: LayerNorm eps 1e-6, Dense kernels lecun-normal and the
attention projections xavier-uniform, zero biases.  Dropout draws its
masks from the ``generator`` the caller passes (flax's keep mask, scaled
by 1/(1-p)).

Also the generic (x, y) buffer of transformer_models.py:10-70 (host numpy
with ``resize``), whose pickles are the JAX package's bytes.
"""

import math
import pickle
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-6     # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def dense(n_in, n_out, init="lecun", generator=None) -> nn.Linear:
    """A flax ``nn.Dense``: lecun-normal (truncated) or xavier-uniform
    kernel, zero bias."""
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        if init == "xavier":
            a = math.sqrt(6.0 / (n_in + n_out))
            lin.weight.uniform_(-a, a, generator=generator)
        else:   # variance_scaling(1, fan_in, truncated_normal)
            std = math.sqrt(1.0 / n_in) / 0.87962566103423978
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        lin.bias.zero_()
    return lin


def dropout(x, p, train, generator):
    """flax ``nn.Dropout``: keep with probability 1-p, scale by 1/(1-p);
    the identity when not training or p == 0."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class HeadAttention(nn.Module):
    """The reference's seq-free multi-head attention
    (transformer_models.py:85-119): qkv projection, heads as the attention
    axis, output projection."""

    def __init__(self, embed_dim, num_heads, generator=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.Dense_0 = dense(embed_dim, 3 * embed_dim, "xavier", generator)
        self.Dense_1 = dense(embed_dim, embed_dim, "xavier", generator)

    def forward(self, x, return_attention=False):
        head_dim = self.embed_dim // self.num_heads
        # (batch, heads, 3 head_dim), then q, k, v along the last axis
        qkv = self.Dense_0(x).reshape(x.shape[0], self.num_heads,
                                      3 * head_dim)
        q, k, v = torch.split(qkv, head_dim, dim=-1)
        logits = torch.einsum("bhd,bgd->bhg", q, k) / math.sqrt(head_dim)
        attn = torch.softmax(logits, dim=-1)
        values = torch.einsum("bhg,bgd->bhd", attn, v)
        o = self.Dense_1(values.reshape(x.shape[0], self.embed_dim))
        return (o, attn) if return_attention else o


class EncoderBlock(nn.Module):
    """Post-norm residual block (transformer_models.py:121-151)."""

    def __init__(self, input_dim, num_heads, dropout=0.0, generator=None):
        super().__init__()
        self.p = dropout
        self.HeadAttention_0 = HeadAttention(input_dim, num_heads, generator)
        self.LayerNorm_0 = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.Dense_0 = dense(input_dim, input_dim, generator=generator)
        self.Dense_1 = dense(input_dim, input_dim, generator=generator)
        self.LayerNorm_1 = nn.LayerNorm(input_dim, eps=LN_EPS)

    def forward(self, x, train=False, generator=None):
        attn_out = self.HeadAttention_0(x)
        x = self.LayerNorm_0(x + dropout(attn_out, self.p, train, generator))
        h = self.Dense_0(x)
        h = torch.relu(dropout(h, self.p, train, generator))
        h = self.Dense_1(h)
        return self.LayerNorm_1(x + dropout(h, self.p, train, generator))


class TransformerEncoder(nn.Module):
    """transformer_models.py:153-186; sigmoid multi-label output.
    ``generator`` seeds the initial weights (CPU draws, then moved)."""

    def __init__(self, num_layers, input_dim, model_dim, num_classes,
                 num_heads, dropout=0.0, generator=None):
        super().__init__()
        self.num_layers, self.input_dim = num_layers, input_dim
        self.model_dim, self.num_classes = model_dim, num_classes
        self.num_heads, self.p = num_heads, dropout
        self.Dense_0 = dense(input_dim, model_dim, generator=generator)
        for i in range(num_layers):
            setattr(self, f"EncoderBlock_{i}",
                    EncoderBlock(model_dim, num_heads, dropout, generator))
        self.Dense_1 = dense(model_dim, model_dim, generator=generator)
        self.LayerNorm_0 = nn.LayerNorm(model_dim, eps=LN_EPS)
        self.Dense_2 = dense(model_dim, num_classes, generator=generator)

    def forward(self, x, train=False, generator=None):
        x = dropout(x, self.p, train, generator)
        x = self.Dense_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderBlock_{i}")(x, train, generator)
        x = torch.relu(self.LayerNorm_0(self.Dense_1(x)))
        x = dropout(x, self.p, train, generator)
        return torch.sigmoid(self.Dense_2(x))


class XYBuffer:
    """Generic (x, y) training buffer with grow-on-demand ``resize``
    (transformer_models.py:10-70) and whole-object pickling."""

    def __init__(self, max_size: int, x_shape: Tuple[int, ...],
                 y_shape: Tuple[int, ...]):
        self.mem_size = max_size
        self.mem_cntr = 0
        self.x = np.zeros((max_size,) + tuple(x_shape), np.float32)
        self.y = np.zeros((max_size,) + tuple(y_shape), np.float32)

    def store(self, x, y):
        i = self.mem_cntr % self.mem_size
        self.x[i] = x
        self.y[i] = y
        self.mem_cntr += 1

    def sample(self, rng, batch_size):
        hi = min(self.mem_cntr, self.mem_size)
        idx = rng.choice(hi, min(batch_size, hi), replace=False)
        return self.x[idx], self.y[idx]

    def resize(self, new_size):
        old_x, old_y, n = self.x, self.y, min(self.mem_cntr, self.mem_size)
        self.x = np.zeros((new_size,) + old_x.shape[1:], np.float32)
        self.y = np.zeros((new_size,) + old_y.shape[1:], np.float32)
        self.x[:n] = old_x[:n]
        self.y[:n] = old_y[:n]
        self.mem_size = new_size
        self.mem_cntr = n

    def save(self, path):
        with open(path, "wb") as fh:
            pickle.dump({"x": self.x, "y": self.y,
                         "mem_cntr": self.mem_cntr}, fh)

    def load(self, path):
        from smartcal_tpu_torch.runtime.atomic import strict_pickle_load

        d = strict_pickle_load(path)
        self.x, self.y, self.mem_cntr = d["x"], d["y"], d["mem_cntr"]
        self.mem_size = self.x.shape[0]


def bce(pred, y):
    """The trainers' clipped binary cross-entropy (train_model.py)."""
    pred = torch.clamp(pred, 1e-6, 1 - 1e-6)
    return -torch.mean(y * torch.log(pred) + (1 - y) * torch.log(1 - pred))


def build_transformer(K, npix, model_dim, dropout=0.0, input_dim=None,
                      generator: Optional[torch.Generator] = None,
                      device="cpu") -> TransformerEncoder:
    """The recommender of K directions on npix^2 influence images:
    TransformerEncoder(1 layer, input K*(npix^2+8), model_dim*K, K-1
    classes, K heads) on ``device``."""
    model = TransformerEncoder(
        num_layers=1, input_dim=input_dim or K * (npix * npix + 8),
        model_dim=model_dim * K, num_classes=K - 1, num_heads=K,
        dropout=dropout, generator=generator)
    return model.to(device)
