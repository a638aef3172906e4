"""Actor/critic networks (counterpart of smartcal_tpu/rl/networks.py).

The same architectures as the JAX package's flax modules, as
``torch.nn.Module`` s whose ``state_dict`` keys are the flax parameter
paths (``ImageMetaActor_0.InfluenceCNN_0.Conv_0.weight`` for flax's
``['ImageMetaActor_0']['InfluenceCNN_0']['Conv_0']['kernel']``), so
``interop.params_from_flax`` carries weights across by name.  What flax
does implicitly is spelled out here:

* ``nn.Conv(k=5, stride=2)`` pads SAME, and SAME at stride 2 is asymmetric
  (128 -> (1, 2), 15 -> (2, 2)): :func:`_pad_same` pads per input size and
  the convolution itself pads nothing;
* the CNN features are flattened in flax's NHWC order (H, W, C);
* LayerNorm and GroupNorm take eps 1e-6; GroupNorm has ``min(8, ch)``
  groups of contiguous channels, and an UNBATCHED map is normalised row by
  row, because flax's GroupNorm takes the leading axis for the batch;
* Dense kernels and biases start from U(+-1/sqrt(out)), final layers from
  U(+-0.003); convolutions from flax's default (lecun normal, truncated at
  two standard deviations, zero bias).

The inputs may be one observation (1-D) or a batch (2-D), as in flax.
"""

import math
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOG_SIG_MIN, LOG_SIG_MAX = -20.0, 2.0
FINAL_INIT_SCALE = 0.003
NORM_EPS = 1e-6                   # flax LayerNorm / GroupNorm default
# jax.nn.initializers.variance_scaling's truncated-normal correction: the
# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class _Names:
    """Registers submodules under flax's compact names: the i-th module of
    a kind becomes ``<Kind>_<i>``, in creation order."""

    def __init__(self, owner):
        self.owner, self.count = owner, defaultdict(int)

    def add(self, kind, module) -> str:
        name = f"{kind}_{self.count[kind]}"
        self.count[kind] += 1
        self.owner.add_module(name, module)
        return name


def _dense(d_in, d_out, final, generator, device):
    lin = nn.Linear(d_in, d_out, device=device)
    sc = FINAL_INIT_SCALE if final else 1.0 / math.sqrt(d_out)
    with torch.no_grad():
        for p in (lin.weight, lin.bias):
            p.uniform_(-sc, sc, generator=generator)
    return lin


def _tower(names, d_in, sizes, generator, device):
    """Dense + LayerNorm (+ elu in :func:`_run`) per width; returns the
    (dense, norm) name pairs and the output width."""
    layers = []
    for h in sizes:
        layers.append((names.add("Dense", _dense(d_in, h, False, generator,
                                                 device)),
                       names.add("LayerNorm", nn.LayerNorm(h, eps=NORM_EPS,
                                                           device=device))))
        d_in = h
    return layers, d_in


def _run(module, layers, x):
    for dense, norm in layers:
        x = F.elu(getattr(module, norm)(getattr(module, dense)(x)))
    return x


def _same_pads(n, k, s):
    """``jax.lax.padtype_to_pads`` for SAME: (lo, hi) along one axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s):
    h_lo, h_hi = _same_pads(x.shape[-2], k, s)
    w_lo, w_hi = _same_pads(x.shape[-1], k, s)
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi))


class GroupNorm(nn.GroupNorm):
    """flax's GroupNorm.  A batch (B, C, H, W) is normalised per sample
    over (group, H, W), as in torch.  An unbatched (C, H, W) map is
    normalised per row over (group, W): flax reads the leading axis of an
    unbatched (H, W, C) map as the batch."""

    def forward(self, x):
        if x.dim() == 3:
            return super().forward(x.transpose(0, 1)).transpose(0, 1)
        return super().forward(x)


class InfluenceCNN(nn.Module):
    """Conv(1->16->32->32, kernel 5, stride 2, SAME) + GroupNorm + elu over
    an (H, W) or (B, H, W) map; returns the flat (H, W, C)-ordered
    features."""

    KERNEL, STRIDE = 5, 2

    def __init__(self, img_shape, channels=(16, 32, 32), generator=None,
                 device=None):
        super().__init__()
        names = _Names(self)
        self.layers = []
        c_in, (h, w) = 1, img_shape
        for ch in channels:
            conv = nn.Conv2d(c_in, ch, self.KERNEL, stride=self.STRIDE,
                             device=device)
            fan_in = c_in * self.KERNEL * self.KERNEL
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                conv.bias.zero_()
            self.layers.append(
                (names.add("Conv", conv),
                 names.add("GroupNorm", GroupNorm(min(8, ch), ch,
                                                  eps=NORM_EPS,
                                                  device=device))))
            c_in, h, w = ch, -(-h // self.STRIDE), -(-w // self.STRIDE)
        self.out_dim = c_in * h * w

    def forward(self, img):
        x = img.unsqueeze(-3)
        for conv, norm in self.layers:
            x = _pad_same(x, self.KERNEL, self.STRIDE)
            x = F.elu(getattr(self, norm)(getattr(self, conv)(x)))
        return x.movedim(-3, -1).flatten(-3)


def _heads(names, d_in, n_actions, generator, device):
    return (names.add("Dense", _dense(d_in, n_actions, True, generator,
                                      device)),
            names.add("Dense", _dense(d_in, n_actions, True, generator,
                                      device)))


class MLPActor(nn.Module):
    """Gaussian policy head (reference ``ActorNetwork``): LayerNorm + elu
    stack 512->256->128 -> (mu, logsigma clamped to [-20, 2])."""

    def __init__(self, obs_dim, n_actions, hidden=(512, 256, 128),
                 generator=None, device=None):
        super().__init__()
        names = _Names(self)
        self.body, d = _tower(names, obs_dim, hidden, generator, device)
        self.mu, self.logsigma = _heads(names, d, n_actions, generator,
                                        device)

    def forward(self, x):
        x = _run(self, self.body, x)
        return (getattr(self, self.mu)(x),
                torch.clamp(getattr(self, self.logsigma)(x), LOG_SIG_MIN,
                            LOG_SIG_MAX))


class MLPDeterministicActor(nn.Module):
    """Deterministic tanh policy of TD3/DDPG (reference enet_td3.py /
    enet_ddpg.py actor): LayerNorm + elu stack 512->256->128 ->
    tanh(n_actions)."""

    def __init__(self, obs_dim, n_actions, hidden=(512, 256, 128),
                 generator=None, device=None):
        super().__init__()
        names = _Names(self)
        self.body, d = _tower(names, obs_dim, hidden, generator, device)
        self.mu = names.add("Dense", _dense(d, n_actions, True, generator,
                                            device))

    def forward(self, x):
        return torch.tanh(getattr(self, self.mu)(_run(self, self.body, x)))


class MLPCritic(nn.Module):
    """Two-tower Q network (reference ``CriticNetwork``): state 512->256,
    action 128->64, concatenated into the Q head."""

    def __init__(self, obs_dim, n_actions, state_hidden=(512, 256),
                 action_hidden=(128, 64), generator=None, device=None):
        super().__init__()
        names = _Names(self)
        self.state_tower, ds = _tower(names, obs_dim, state_hidden,
                                      generator, device)
        self.action_tower, da = _tower(names, n_actions, action_hidden,
                                       generator, device)
        self.q = names.add("Dense", _dense(ds + da, 1, True, generator,
                                           device))

    def forward(self, state, action):
        z = torch.cat([_run(self, self.state_tower, state),
                       _run(self, self.action_tower, action)], dim=-1)
        return getattr(self, self.q)(z)


class ImageMetaActor(nn.Module):
    """CNN(map) + MLP(metadata ->128->16) -> 256 -> 128 -> Gaussian policy
    (reference calibration/demixing actor); ``use_image=False`` drops the
    CNN branch."""

    def __init__(self, img_shape, meta_dim, n_actions, use_image=True,
                 meta_hidden=(128, 16), head_hidden=(256, 128),
                 generator=None, device=None):
        super().__init__()
        names = _Names(self)
        self.cnn = None
        d = 0
        if use_image:
            self.cnn = names.add("InfluenceCNN", InfluenceCNN(
                img_shape, generator=generator, device=device))
            d = getattr(self, self.cnn).out_dim
        self.meta, dm = _tower(names, meta_dim, meta_hidden, generator,
                               device)
        self.head, dh = _tower(names, d + dm, head_hidden, generator, device)
        self.mu, self.logsigma = _heads(names, dh, n_actions, generator,
                                        device)

    def forward(self, img, meta):
        feats = [getattr(self, self.cnn)(img)] if self.cnn else []
        x = _run(self, self.head,
                 torch.cat(feats + [_run(self, self.meta, meta)], dim=-1))
        return (getattr(self, self.mu)(x),
                torch.clamp(getattr(self, self.logsigma)(x), LOG_SIG_MIN,
                            LOG_SIG_MAX))


class ImageMetaCritic(nn.Module):
    """CNN(map) + MLP(metadata) + MLP(action ->128->64) -> 256 -> Q."""

    def __init__(self, img_shape, meta_dim, n_actions, use_image=True,
                 meta_hidden=(128, 16), action_hidden=(128, 64),
                 head_hidden=(256,), generator=None, device=None):
        super().__init__()
        names = _Names(self)
        self.cnn = None
        d = 0
        if use_image:
            self.cnn = names.add("InfluenceCNN", InfluenceCNN(
                img_shape, generator=generator, device=device))
            d = getattr(self, self.cnn).out_dim
        self.meta, dm = _tower(names, meta_dim, meta_hidden, generator,
                               device)
        self.action, da = _tower(names, n_actions, action_hidden, generator,
                                 device)
        self.head, dh = _tower(names, d + dm + da, head_hidden, generator,
                               device)
        self.q = names.add("Dense", _dense(dh, 1, True, generator, device))

    def forward(self, img, meta, action):
        feats = [getattr(self, self.cnn)(img)] if self.cnn else []
        feats += [_run(self, self.meta, meta), _run(self, self.action,
                                                    action)]
        return getattr(self, self.q)(_run(self, self.head,
                                          torch.cat(feats, dim=-1)))


def split_obs(obs, img_shape):
    """A flat observation [img.ravel(), meta] -> (img (..., H, W), meta)."""
    h, w = img_shape
    return (obs[..., :h * w].reshape(*obs.shape[:-1], h, w),
            obs[..., h * w:])


class SplitImageMetaActor(nn.Module):
    """:class:`ImageMetaActor` over a flat observation (the SAC actor of the
    radio envs)."""

    def __init__(self, img_shape, obs_dim, n_actions, use_image=True,
                 generator=None, device=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.ImageMetaActor_0 = ImageMetaActor(
            img_shape, obs_dim - img_shape[0] * img_shape[1], n_actions,
            use_image=use_image, generator=generator, device=device)

    def forward(self, obs):
        return self.ImageMetaActor_0(*split_obs(obs, self.img_shape))


class SplitImageMetaDeterministicActor(SplitImageMetaActor):
    """Deterministic tanh variant for TD3/DDPG (reference calib_td3.py):
    ``tanh(mu)`` of :class:`ImageMetaActor`.  The logsigma head is unused
    but kept, as flax creates its parameters; it gets no gradient."""

    def forward(self, obs):
        return torch.tanh(super().forward(obs)[0])


class SplitImageMetaCritic(nn.Module):
    """:class:`ImageMetaCritic` over a flat observation."""

    def __init__(self, img_shape, obs_dim, n_actions, use_image=True,
                 generator=None, device=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.ImageMetaCritic_0 = ImageMetaCritic(
            img_shape, obs_dim - img_shape[0] * img_shape[1], n_actions,
            use_image=use_image, generator=generator, device=device)

    def forward(self, obs, action):
        return self.ImageMetaCritic_0(*split_obs(obs, self.img_shape),
                                      action)


class SplitImageMetaCategoricalActor(nn.Module):
    """Image + metadata towers over a flat observation -> one dense vector
    over a discrete action set: the categorical policy (logits) of the
    distributed demixing learner, whose actions are the 2^(K-1) direction
    subsets (``demixing_rl/distributed_per_sac.py:34,180-184``).  The
    submodules carry flax's names at the top level: ``InfluenceCNN_0``,
    then ``Dense_i`` / ``LayerNorm_i`` of the metadata and head towers and
    the final ``Dense``."""

    def __init__(self, img_shape, obs_dim, n_actions, use_image=True,
                 meta_hidden=(128, 16), head_hidden=(256, 128),
                 generator=None, device=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        names = _Names(self)
        self.cnn = None
        d = 0
        if use_image:
            self.cnn = names.add("InfluenceCNN", InfluenceCNN(
                img_shape, generator=generator, device=device))
            d = getattr(self, self.cnn).out_dim
        meta_dim = obs_dim - img_shape[0] * img_shape[1]
        self.meta, dm = _tower(names, meta_dim, meta_hidden, generator,
                               device)
        self.head, dh = _tower(names, d + dm, head_hidden, generator, device)
        self.out = names.add("Dense", _dense(dh, n_actions, True, generator,
                                             device))

    def forward(self, obs):
        img, meta = split_obs(obs, self.img_shape)
        feats = [getattr(self, self.cnn)(img)] if self.cnn else []
        x = _run(self, self.head,
                 torch.cat(feats + [_run(self, self.meta, meta)], dim=-1))
        return getattr(self, self.out)(x)


class SplitImageMetaQVector(SplitImageMetaCategoricalActor):
    """The same towers read as a state-only critic: Q(s, .) over every
    discrete action, so the discrete SAC's soft value is an exact
    expectation."""


def _obs_keys(obs_dict, img_key, meta_key):
    if img_key is None:
        img_key = "img" if "img" in obs_dict else "infmap"
    if meta_key is None:
        meta_key = "sky" if "sky" in obs_dict else "metadata"
    return img_key, meta_key


def flatten_obs(obs_dict, img_key=None, meta_key=None):
    """Dict observation -> flat numpy vector [img.ravel(), meta.ravel()]
    (CalibEnv {'img', 'sky'}, DemixingEnv {'infmap', 'metadata'})."""
    img_key, meta_key = _obs_keys(obs_dict, img_key, meta_key)
    return np.concatenate([np.asarray(obs_dict[img_key]).ravel(),
                           np.asarray(obs_dict[meta_key]).ravel()])


def flatten_obs_batch(obs_dict, img_key=None, meta_key=None):
    """Batched :func:`flatten_obs`: dict of (E, ...) arrays -> (E, obs_dim)."""
    img_key, meta_key = _obs_keys(obs_dict, img_key, meta_key)
    img = np.asarray(obs_dict[img_key])
    meta = np.asarray(obs_dict[meta_key])
    E = img.shape[0]
    return np.concatenate([img.reshape(E, -1), meta.reshape(E, -1)], axis=1)


def gaussian_sample(mu, logsigma, noise):
    """Tanh-squashed reparameterised sample and its log-prob, given the unit
    normal ``noise`` (shape of ``mu``): ``a = tanh(z)``, ``log pi = log
    N(z; mu, sigma) - log(1 - a^2 + 1e-6)`` summed over the last axis
    (keepdim)."""
    sigma = torch.exp(logsigma)
    z = mu + sigma * noise
    a = torch.tanh(z)
    log_probs = (-0.5 * ((z - mu) / sigma) ** 2 - logsigma
                 - 0.5 * math.log(2.0 * math.pi))
    log_probs = log_probs - torch.log(1.0 - a ** 2 + 1e-6)
    return a, torch.sum(log_probs, dim=-1, keepdim=True)


def tanh_gaussian_log_prob(mu, logsigma, actions):
    """log pi(a|s) of an already-squashed action under the tanh-gaussian
    head (the evaluation counterpart of :func:`gaussian_sample`)."""
    a = torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6)
    z = torch.atanh(a)
    sigma = torch.exp(logsigma)
    log_probs = (-0.5 * ((z - mu) / sigma) ** 2 - logsigma
                 - 0.5 * math.log(2.0 * math.pi))
    log_probs = log_probs - torch.log(1.0 - a ** 2 + 1e-6)
    return torch.sum(log_probs, dim=-1)


def tanh_gaussian_log_prob_np(mu, logsigma, actions):
    """Host numpy (f64) form of :func:`tanh_gaussian_log_prob`, term for
    term."""
    mu = np.asarray(mu, np.float64)
    logsigma = np.asarray(logsigma, np.float64)
    a = np.clip(np.asarray(actions, np.float64), -1.0 + 1e-6, 1.0 - 1e-6)
    z = np.arctanh(a)
    sigma = np.exp(logsigma)
    log_probs = (-0.5 * ((z - mu) / sigma) ** 2 - logsigma
                 - 0.5 * np.log(2.0 * np.pi))
    log_probs = log_probs - np.log(1.0 - a ** 2 + 1e-6)
    return np.sum(log_probs, axis=-1)
