r"""
ELBO / REINFORCE estimators as functions with explicit carried state (a copy
of ``probnmn_tpu/modules/elbo.py``; reference ``probnmn/modules/elbo.py``).

The moving-average baseline is the only mutable state in the reference's
``Reinforce`` module; here it is a 0-dim float32 tensor the trainer carries on
its device and passes in, so that updating it needs no host sync. The
reference's (unusual) update rule is kept exactly (``elbo.py:28-34``):

    centered = reward.detach() - baseline
    baseline' = baseline + decay * mean(centered)       # NOT the textbook EMA

A subset's mean is its sum over its count plus 1e-12 (:func:`mean_over`, the
JAX package's ``masked_mean``), so that an empty subset gives 0 and not NaN.
A data-parallel trainer (``parallel/mesh.py``) holds a subset's rows on
several ranks, in counts that differ from rank to rank, so every mean is
taken over the global batch: the rank's rows' sum over the global count.
:func:`elbo_rows` and :func:`reinforce_rows` give the rows with gradient and
the detached sums of every logged term, and :func:`baseline_update` moves
the baseline by the global batch's mean centered reward.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch


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


def mean_over(total: Union[torch.Tensor, float], count: int) -> Union[torch.Tensor, float]:
    r"""The mean of a subset of ``count`` rows from their sum, as the JAX
    package's ``masked_mean`` takes it: divided by ``count + 1e-12``, so that
    an empty subset gives 0."""
    return total / (count + 1e-12)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.detach().double().sum()


def reinforce_rows(
    inputs: torch.Tensor, reward: torch.Tensor, baseline: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    r"""REINFORCE's rows, ``inputs * (reward - baseline)`` (with gradient
    through ``inputs``), and the detached float64 sums of the term
    (``elbo``), the reward (``reinforce_reward``) and the centered reward
    (``centered_reward``, for :func:`baseline_update`)."""
    centered = reward.detach() - baseline
    term = inputs * centered
    return term, {"elbo": _sum(term), "reinforce_reward": _sum(reward),
                  "centered_reward": _sum(centered)}


def elbo_rows(
    inference_likelihood: torch.Tensor,
    reconstruction_likelihood: torch.Tensor,
    reinforce_reward: torch.Tensor,
    baseline: torch.Tensor,
    beta: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    r"""The fully-Monte-Carlo ELBO of each row (reference ``elbo.py:61-89``),
    with gradient: kl = REINFORCE(inference_ll, reward) - beta *
    inference_ll, elbo = reconstruction_ll - kl; and the detached float64
    sums over the rows of its diagnostics and of the centered reward. The
    caller divides them by the global subset's count (:func:`mean_over`)."""
    term, sums = reinforce_rows(inference_likelihood, reinforce_reward, baseline)
    kl_divergence = term - beta * inference_likelihood
    elbo = reconstruction_likelihood - kl_divergence
    sums.update(reconstruction_likelihood=_sum(reconstruction_likelihood),
                kl_divergence=_sum(kl_divergence), elbo=_sum(elbo))
    return elbo, sums


def baseline_update(baseline: torch.Tensor, centered_sum: torch.Tensor, count: int,
                    decay: float) -> torch.Tensor:
    r"""The baseline's update from the centered reward's sum over the
    global subset of ``count`` rows: ``baseline + decay * mean``, taken in
    float64 and stored in the baseline's dtype, on its device (no host
    sync). Ranks that hold the same sum compute the same bits."""
    return (baseline.double() + decay * mean_over(centered_sum, count)).to(baseline.dtype)
