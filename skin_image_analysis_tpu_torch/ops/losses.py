"""Loss functions (port of the JAX package's ``ops.losses``)."""

from __future__ import annotations

import torch


def nll_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Negative log-likelihood over log-probabilities: the mean of
    ``-log_p[label]``, or with class weights
    ``sum(w[y_i] * loss_i) / sum(w[y_i])`` (torch ``NLLLoss``)."""
    losses = -log_probs.gather(1, labels.long()[:, None])[:, 0]
    if class_weights is None:
        return losses.mean()
    w = torch.as_tensor(class_weights, dtype=log_probs.dtype,
                        device=log_probs.device)[labels.long()]
    return (w * losses).sum() / w.sum()


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Softmax cross-entropy from raw logits: the log-softmax (max
    subtracted first), then :func:`nll_loss`."""
    log_probs = logits - logits.amax(dim=-1, keepdim=True)
    log_probs = log_probs - torch.log(
        torch.exp(log_probs).sum(dim=-1, keepdim=True))
    return nll_loss(log_probs, labels, class_weights)
