"""Plot / inspect utilities for training artifacts (counterpart of
smartcal_tpu/train/plots.py).

Parity targets (SURVEY §2.6 row "Plot/inspect utilities"):

* ``demixing_rl/plot_databuffer.py`` — per-direction metadata scatter from
  a TrainingBuffer (un-scaled by META_SCALE) + reward traces rescaled back
  to raw AIC units (``rewards*3559+859`` un-does the empirical
  normalization, :50-52 — note the reference adds +859 although the
  normalization subtracted -859; the faithful inverse is
  ``r*REWARD_STD + REWARD_MEAN`` with REWARD_MEAN = -859, used here);
* ``calibration/inspect_replaybuffer.py`` — grid PNG of influence-map
  states from a replay buffer (gray -> unit-range tiles);
* ``demixing_rl/plot_tsk.py`` — dump/plot of trained TSK parameters.

All functions write PNG via matplotlib (Agg, imported on first use; an
ImportError that names matplotlib when it is absent) and return the
arrays they plotted so tests don't need to parse images.
"""

from __future__ import annotations

import numpy as np
import torch

from smartcal_tpu_torch.envs.demixing import (META_SCALE, REWARD_MEAN,
                                              REWARD_STD)


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("train.plots needs matplotlib, which is not "
                          "installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_databuffer(buf, K, field="azimuth", out_png="databuffer.png"):
    """Per-direction metadata scatter (plot_databuffer.py:30-43).

    ``buf`` is a TrainingBuffer whose x rows are META_SCALE-scaled
    3K+2 metadata vectors; ``field`` selects the block."""
    offset = {"separation": 0, "azimuth": 1, "elevation": 2}[field]
    n = min(buf.mem_cntr, buf.mem_size)
    X = np.asarray(buf.x[:n]) / META_SCALE
    cols = X[:, offset * K:(offset + 1) * K]
    plt = _plt()
    fig, axs = plt.subplots(K, sharex=True)
    for d in range(K):
        axs[d].plot(cols[:, d], ".")
        axs[d].set_ylabel(f"dir {d}")
    axs[-1].set_xlabel("Simulation number")
    fig.suptitle(f"{field}/deg")
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return cols


def plot_rewards(rewards, out_png="rewards.png", labels=None,
                 rescale=True):
    """Reward traces, un-normalized back to raw AIC units
    (plot_databuffer.py:46-56)."""
    rewards = np.atleast_2d(np.asarray(rewards, np.float64))
    if rescale:
        rewards = rewards * REWARD_STD + REWARD_MEAN
    plt = _plt()
    fig = plt.figure()
    for row in rewards:
        plt.plot(row)
    if labels:
        plt.legend(labels)
    plt.xlabel("Trial")
    plt.ylabel("Reward")
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return rewards


def gray_to_unit(x):
    """Per-tile normalization into [0.1, 0.9].

    The reference (inspect_replaybuffer.py:5-16) scales by the range but
    never subtracts the minimum, so non-zero-mean tiles land outside
    [0, 1] and wreck the shared grid autoscale; the corrected affine map
    is used here."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[None]
    out = np.zeros_like(x)
    for i, z in enumerate(x):
        rng = float(z.max() - z.min())
        out[i] = 0.8 * (z - z.min()) / (rng if rng > 0 else 1.0) + 0.1
    return out


def inspect_replaybuffer(buf, img_shape, out_png="replay_states.png",
                         stride=10, max_tiles=54):
    """Tile the image block of replay states into one PNG grid
    (inspect_replaybuffer.py:19-27).  ``buf`` is an rl.replay.ReplayState
    whose 'state' rows start with a flattened (H, W) influence map."""
    h, w = img_shape
    n = int(min(buf.cntr, buf.size))
    states = buf.data["state"][:n:stride][:max_tiles].detach().cpu().numpy()
    tiles = gray_to_unit(states[:, :h * w].reshape(-1, h, w))
    cols = max(1, int(np.ceil(np.sqrt(tiles.shape[0]))))
    rows = int(np.ceil(tiles.shape[0] / cols))
    grid = np.zeros((rows * h, cols * w), np.float32)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = t
    plt = _plt()
    fig = plt.figure(figsize=(cols, rows))
    plt.imshow(grid, cmap="gray")
    plt.axis("off")
    fig.savefig(out_png, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return tiles


def plot_tsk(params, out_png="tsk_params.png"):
    """Trained TSK parameter dump: rule centers/sigmas heatmaps + consequent
    weights (plot_tsk.py role)."""
    params = type(params)(*(np.asarray(torch.as_tensor(p).detach().cpu())
                            for p in params))
    plt = _plt()
    fig, axs = plt.subplots(1, 3, figsize=(12, 3))
    for ax, arr, title in (
            (axs[0], np.asarray(params.center), "antecedent centers (M,R)"),
            (axs[1], np.asarray(params.sigma), "antecedent sigmas (M,R)"),
            (axs[2], np.asarray(params.A).reshape(
                np.asarray(params.A).shape[0], -1),
             "order-1 consequents (R, M*out)")):
        im = ax.imshow(arr, aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return {"center": np.asarray(params.center),
            "sigma": np.asarray(params.sigma)}
