"""The regression model and dataset of the sanity scripts and parity tests.

Counterpart of ``accelerate_tpu/test_utils/training.py``: a ``y = a*x + b``
fit, a ``torch.nn.Module`` with the port's ``param_tree``/``apply``
protocol, whose training is held for exact agreement between one process
and several.
"""

from __future__ import annotations

import numpy as np
import torch


class RegressionDataset:
    def __init__(self, a: float = 2.0, b: float = 3.0, length: int = 64, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + rng.normal(scale=0.1, size=(length,))).astype(np.float32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        return {"x": self.x[i], "y": self.y[i]}


class RegressionModel(torch.nn.Module):
    """``y_hat = a*x + b``: two scalar fp32 parameters."""

    def __init__(self, a0: float = 0.0, b0: float = 0.0):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(a0, dtype=torch.float32))
        self.b = torch.nn.Parameter(torch.tensor(b0, dtype=torch.float32))

    def param_tree(self) -> dict:
        return {"a": self.a, "b": self.b}

    @staticmethod
    def apply(params: dict, x):
        return params["a"] * x + params["b"]

    @staticmethod
    def loss_fn(params: dict, batch: dict):
        pred = RegressionModel.apply(params, batch["x"])
        return torch.mean((pred - batch["y"]) ** 2)


class SGD:
    """optax's ``sgd`` formula as a transform of the port's protocol:
    ``update = -learning_rate * grad``, no state."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> tuple:  # noqa: ARG002 - the protocol's signature
        return ()

    def update(self, grads: dict, state: tuple, params: dict | None = None):  # noqa: ARG002 - the protocol's
        return {k: -self.learning_rate * g for k, g in grads.items()}, state
