"""Losses: bias-weighted asymmetric BCE (+ per-example hardness signal),
asymmetric focal loss, logit regularisation, the raw BCE, and the
distillation loss.

The counterpart of `nanowakeword_tpu/train/loss.py`, as functions of torch
tensors. Masked means `sum(term * mask) / max(sum(mask), 1)` stand in for
boolean indexing, as there.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def bias_weighted_loss(logits: torch.Tensor, labels: torch.Tensor,
                       loss_bias: float, smoothing: float = 0.05):
    """Asymmetric BCE with class weighting and targets-only label smoothing;
    masks come from the hard labels.

    Returns (total loss, per-example loss [B] detached, with the same class
    weighting)."""
    pos_mask = (labels > 0.5).float()
    neg_mask = 1.0 - pos_mask
    soft = labels * (1.0 - smoothing) + 0.5 * smoothing
    yp = torch.sigmoid(logits)
    pos_term = -soft * torch.log(torch.clamp(yp, min=EPS))
    neg_term = -(1.0 - soft) * torch.log(torch.clamp(1.0 - yp, min=EPS))
    total = (loss_bias * _masked_mean(neg_term, neg_mask)
             + (1.0 - loss_bias) * _masked_mean(pos_term, pos_mask))
    per_example = torch.where(pos_mask > 0, (1.0 - loss_bias) * pos_term,
                              loss_bias * neg_term)
    return total, per_example.detach()


def asymmetric_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                          loss_bias: float, gamma_pos: float = 0.0,
                          gamma_neg: float = 4.0, smoothing: float = 0.05):
    """Asymmetric focal loss (Ridnik et al., 2021): easy negatives are
    down-weighted by p^gamma_neg."""
    pos_mask = (labels > 0.5).float()
    neg_mask = 1.0 - pos_mask
    soft = labels * (1.0 - smoothing) + 0.5 * smoothing
    p = torch.sigmoid(logits)
    p_pos = torch.clamp(p, min=EPS)
    pos_term = -soft * (1.0 - p_pos) ** gamma_pos * torch.log(p_pos)
    p_neg = torch.clamp(1.0 - p, min=EPS)
    neg_term = -(1.0 - soft) * p ** gamma_neg * torch.log(p_neg)
    total = (loss_bias * _masked_mean(neg_term, neg_mask)
             + (1.0 - loss_bias) * _masked_mean(pos_term, pos_mask))
    per_example = torch.where(pos_mask > 0, (1.0 - loss_bias) * pos_term,
                              loss_bias * neg_term)
    return total, per_example.detach()


def logit_regularisation(logits: torch.Tensor, labels: torch.Tensor,
                         margin: float) -> torch.Tensor:
    """Penalise positive logits above +margin and negative logits below
    -margin."""
    pos_mask = (labels >= 0.5).float()
    neg_mask = 1.0 - pos_mask
    excess_pos = torch.clamp(logits - margin, min=0.0)
    excess_neg = torch.clamp(-logits - margin, min=0.0)
    return (_masked_mean(excess_pos ** 2, pos_mask)
            + _masked_mean(excess_neg ** 2, neg_mask))


def raw_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unweighted per-example BCE-with-logits, the hardness signal."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, temperature: float,
                 alpha: float) -> torch.Tensor:
    """alpha * T^2 * binaryKL(teacher_soft, student_soft)
    + (1 - alpha) * BCE(student, labels)."""
    t_soft = torch.sigmoid(teacher_logits / temperature)
    s_soft = torch.sigmoid(student_logits / temperature)
    soft = -(t_soft * torch.log(s_soft + EPS)
             + (1.0 - t_soft) * torch.log(1.0 - s_soft + EPS)).mean()
    soft = soft * temperature ** 2
    hard = raw_bce(student_logits, labels).mean()
    return alpha * soft + (1.0 - alpha) * hard


LOSS_FUNCTIONS = {
    "bias_weighted": bias_weighted_loss,
    "asymmetric_focal": asymmetric_focal_loss,
}
