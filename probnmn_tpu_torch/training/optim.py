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

``mu_dtype="bfloat16"`` (config ``OPTIM.ADAM_MU_DTYPE``) keeps the first
moment in bfloat16, as the JAX package's optax chain does
(``scale_by_adam(mu_dtype=bfloat16)``, optax 0.2.6), with its own step in
``torch._foreach_*`` ops: ``mu32 = (1 - b1) * g + b1 * mu``, where JAX's weak
typing takes the product ``b1 * mu`` in bfloat16 (b1 rounded to bfloat16,
the product rounded once) and only the sum in float32; the bias-corrected
update uses ``mu32``; then ``mu`` is stored as ``bfloat16(mu32)``. The
second moment and the update stay float32, in optax's order of operations
(weight decay added to the clamped gradient first). The float32 moment
keeps ``torch.optim.Adam``. Either way the state is ``torch.optim.Adam``'s
``state_dict`` layout (``step``, ``exp_avg``, ``exp_avg_sq`` a parameter),
with ``exp_avg`` in bfloat16 in the bfloat16 mode.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

GRAD_CLAMP = 5.0
BETAS = (0.9, 0.999)
EPS = 1e-8
MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ClampedAdam:
    def __init__(self, params: List[torch.Tensor], lr_initial: float, weight_decay: float = 0.0,
                 mu_dtype: str = "float32"):
        if mu_dtype not in MU_DTYPES:
            raise ValueError(f"OPTIM.ADAM_MU_DTYPE must be float32 or bfloat16, got {mu_dtype!r}")
        self.mu_dtype = mu_dtype
        self._params = list(params)
        self._adam = torch.optim.Adam(self._params, lr=lr_initial, betas=BETAS, eps=EPS,
                                      weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self._adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        r"""Clamp every ``.grad`` to (-5, 5), then one Adam update."""
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.clamp_(-GRAD_CLAMP, GRAD_CLAMP)
        if self.mu_dtype == "bfloat16":
            self._step_bfloat16_mu()
        else:
            self._adam.step()

    def _step_bfloat16_mu(self) -> None:
        r"""One Adam update with the first moment stored in bfloat16, optax's
        arithmetic op by op (module docstring)."""
        b1, b2 = BETAS
        group = self._adam.param_groups[0]
        params = self._params
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
        states = [self._adam.state[p] for p in params]
        for p, state in zip(params, states):
            if not state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                state["exp_avg_sq"] = torch.zeros_like(p)
            state["step"] += 1
        count = int(states[0]["step"]) if states else 0
        # b1 * mu in bfloat16: bf16(b1) times a bf16 value is exact in
        # float32, so rounding the float32 product is the bf16 product.
        b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
        decayed = torch._foreach_mul([s["exp_avg"] for s in states], b1_bf16)
        mu32 = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                  [d.float() for d in decayed])
        nu = [s["exp_avg_sq"] for s in states]
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(count))
        bc2 = float(one - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(torch._foreach_div(mu32, bc1), denom)
        torch._foreach_mul_(update, -float(np.float32(group["lr"])))
        torch._foreach_add_(params, update)
        for state, m in zip(states, mu32):
            state["exp_avg"] = m.to(torch.bfloat16)

    def set_learning_rate(self, lr: float) -> None:
        for group in self._adam.param_groups:
            group["lr"] = lr

    def get_learning_rate(self) -> float:
        return float(self._adam.param_groups[0]["lr"])

    def state_dict(self) -> Dict[str, Any]:
        return self._adam.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        r"""Restore a ``state_dict`` (``torch.optim.Adam``'s layout); the first
        moment takes this optimizer's ``mu_dtype`` whatever the file held."""
        self._adam.load_state_dict(state)
        for st in self._adam.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(MU_DTYPES[self.mu_dtype])


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
