r"""
Optimization (counterpart of ``probnmn_tpu/training/optim.py``; reference
``_trainer.py:102-118``): the same update as the JAX package's
``make_optimizer``, and a host-side ``ReduceLROnPlateau`` copied from it.

:class:`ClampedAdam` clamps every gradient elementwise to (-5, 5) after
backward (the reference's ``clamp_`` before ``optimizer.step``), then runs
``torch.optim.Adam`` with beta (0.9, 0.999), eps 1e-8 and bias correction,
which adds the weight decay to the gradient torch style. A parameter that
got no gradient steps on a zero gradient, as under ``jax.grad`` and optax.
The learning rate is set in place, without rebuilding anything.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

GRAD_CLAMP = 5.0


class ClampedAdam:
    def __init__(self, params: List[torch.Tensor], lr_initial: float, weight_decay: float = 0.0):
        self._params = list(params)
        self._adam = torch.optim.Adam(self._params, lr=lr_initial, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self._adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        r"""Clamp every ``.grad`` to (-5, 5), then one Adam update."""
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.clamp_(-GRAD_CLAMP, GRAD_CLAMP)
        self._adam.step()

    def set_learning_rate(self, lr: float) -> None:
        for group in self._adam.param_groups:
            group["lr"] = lr

    def get_learning_rate(self) -> float:
        return float(self._adam.param_groups[0]["lr"])

    def state_dict(self) -> Dict[str, Any]:
        return self._adam.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._adam.load_state_dict(state)


class ReduceLROnPlateau:
    r"""torch ``ReduceLROnPlateau(mode="max", threshold=1e-3)`` semantics
    (rel threshold, no cooldown): shrink lr by ``factor`` after ``patience``
    consecutive non-improving observations."""

    def __init__(self, lr_initial: float, factor: float, patience: int, threshold: float = 1e-3,
                 eps: float = 1e-8):
        self.lr = lr_initial
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.eps = eps  # torch: skip the update when old_lr - new_lr <= eps
        self.best = -float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        # torch's is_better for mode="max", threshold_mode="rel" is unconditionally
        # `a > best * (threshold + 1.)`, including for negative `best`, where the
        # rel margin flips direction (torch lr_scheduler.ReduceLROnPlateau.is_better).
        is_better = metric > self.best * (1.0 + self.threshold)
        if is_better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_lr = self.lr * self.factor
                if self.lr - new_lr > self.eps:
                    self.lr = new_lr
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad": self.num_bad,
            "factor": self.factor,
            "patience": self.patience,
            "threshold": self.threshold,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for key, value in state.items():
            setattr(self, key, float(value) if key not in ("num_bad", "patience") else int(value))
