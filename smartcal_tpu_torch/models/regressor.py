"""MLP regressor (MSP) and training buffer for metadata -> hint regression
(counterpart of smartcal_tpu/models/regressor.py; reference
``demixing_rl/regressor_net.py:6-28``: M -> 32 -> 32 -> K-1 with a tanh
output, and ``demixing_rl/training_buffer.py:5-51``).

The layers carry flax's auto names (``Dense_0..2``), so
``interop.params_from_flax`` fills them from a flax tree; the buffer's
pickle is the JAX package's bytes.
"""

import pickle

import numpy as np
import torch
from torch import nn

from smartcal_tpu_torch.models.transformer import dense


class RegressorNet(nn.Module):
    """3-layer MLP, tanh output in action space."""

    def __init__(self, n_inputs, n_outputs, hidden=32, generator=None):
        super().__init__()
        self.Dense_0 = dense(n_inputs, hidden, generator=generator)
        self.Dense_1 = dense(hidden, hidden, generator=generator)
        self.Dense_2 = dense(hidden, n_outputs, generator=generator)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return torch.tanh(self.Dense_2(x))


class TrainingBuffer:
    """Minimal (x, y) ring buffer with pickle persistence
    (training_buffer.py:5-51)."""

    def __init__(self, max_size, input_shape, output_shape):
        self.mem_size = max_size
        self.mem_cntr = 0
        self.x = np.zeros((max_size, input_shape), np.float32)
        self.y = np.zeros((max_size, output_shape), np.float32)

    def store(self, x, y):
        i = self.mem_cntr % self.mem_size
        self.x[i] = x
        self.y[i] = y
        self.mem_cntr += 1

    def filled(self):
        n = min(self.mem_cntr, self.mem_size)
        return self.x[:n], self.y[:n]

    def save_checkpoint(self, path="databuffer.pkl"):
        with open(path, "wb") as fh:
            pickle.dump(self.__dict__, fh)

    def load_checkpoint(self, path="databuffer.pkl"):
        from smartcal_tpu_torch.runtime.atomic import strict_pickle_load

        self.__dict__.update(strict_pickle_load(path))
