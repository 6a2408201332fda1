r"""
ELBO / REINFORCE estimators as functions with explicit carried state (a copy
of ``probnmn_tpu/modules/elbo.py``; reference ``probnmn/modules/elbo.py``).

The moving-average baseline is the only mutable state in the reference's
``Reinforce`` module; here it is a 0-dim float32 tensor the trainer carries on
its device and passes in, so that updating it needs no host sync. The
reference's (unusual) update rule is kept exactly (``elbo.py:28-34``):

    centered = reward.detach() - baseline
    baseline' = baseline + decay * mean(centered)       # NOT the textbook EMA

Means take an optional mask with a 1e-12 epsilon, so that an empty subset
gives 0 and not NaN.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / (mask.sum() + 1e-12)


def reinforce(
    inputs: torch.Tensor,
    reward: torch.Tensor,
    baseline: torch.Tensor,
    decay: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""REINFORCE with a decaying moving-average baseline.

    Returns (inputs * centered_reward, new_baseline). ``mask`` restricts the
    baseline update (and downstream means) to a subset of the batch.
    """
    centered = reward.detach() - baseline
    new_baseline = baseline + decay * masked_mean(centered, mask)
    return inputs * centered, new_baseline


def elbo_with_reinforce(
    inference_likelihood: torch.Tensor,
    reconstruction_likelihood: torch.Tensor,
    reinforce_reward: torch.Tensor,
    baseline: torch.Tensor,
    beta: float,
    decay: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    r"""Fully-Monte-Carlo ELBO (reference ``elbo.py:61-89``).

    kl = REINFORCE(inference_ll, reward) - beta * inference_ll;
    elbo = reconstruction_ll - kl. Returns (diagnostics with (masked) batch
    means, new_baseline). The per-example elbo is also returned under
    "elbo_per_example" for loss composition.
    """
    reinforce_term, new_baseline = reinforce(
        inference_likelihood, reinforce_reward, baseline, decay, mask
    )
    kl_divergence = reinforce_term - beta * inference_likelihood
    elbo = reconstruction_likelihood - kl_divergence
    diagnostics = {
        "reconstruction_likelihood": masked_mean(reconstruction_likelihood, mask),
        "kl_divergence": masked_mean(kl_divergence, mask),
        "elbo": masked_mean(elbo, mask),
        "reinforce_reward": masked_mean(reinforce_reward, mask),
        "elbo_per_example": elbo,
    }
    return diagnostics, new_baseline


def question_coding_reward(
    logprobs_reconstruction: torch.Tensor,
    logprobs_generation: torch.Tensor,
    logprobs_prior: torch.Tensor,
    beta: float,
) -> torch.Tensor:
    r"""R = log p(x|z) + beta * (log p(z) - log q(z|x))  (reference ``elbo.py:152-159``)."""
    return logprobs_reconstruction + beta * (logprobs_prior - logprobs_generation)


def joint_training_reward(
    logprobs_reconstruction: torch.Tensor,
    logprobs_generation: torch.Tensor,
    logprobs_prior: torch.Tensor,
    logprobs_answering: torch.Tensor,
    beta: float,
    gamma: float,
) -> torch.Tensor:
    r"""R = log p(x|z) + beta*log p(z) - beta*log q(z|x) + gamma*log p(a|z,i)
    (reference ``elbo.py:259-270``)."""
    return (
        logprobs_reconstruction
        + beta * logprobs_prior
        - beta * logprobs_generation
        + gamma * logprobs_answering
    )
