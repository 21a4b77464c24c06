"""Loss functions in float32 (``repurpose_tpu/ops/losses.py``).

- sigmoid focal loss (RetinaNet), alpha 0.7, gamma 2;
- 1-D center-offset Distance-IoU loss (the reference trains without it;
  ``TrainConfig.reg_loss_weight`` turns it on);
- the masked sums the train step divides by its denominator.

Plain PyTorch: the JAX package has no Pallas kernel here (its elementwise
chain fuses into XLA's neighbouring ops), so there is no kernel to port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(
    inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.7, gamma: float = 2.0
) -> torch.Tensor:
    """Elementwise focal loss (no reduction), float32:
    alpha_t * BCE(x, y) * (1 - p_t)^gamma."""
    x = inputs.float()
    y = targets.float()
    p = torch.sigmoid(x)
    # numerically stable BCE-with-logits: max(x, 0) - x*y + log1p(exp(-|x|))
    ce = F.relu(x) - x * y + torch.log1p(torch.exp(-x.abs()))
    p_t = p * y + (1.0 - p) * (1.0 - y)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * y + (1.0 - alpha) * (1.0 - y)) * loss
    return loss


def ctr_diou_loss_1d(
    input_offsets: torch.Tensor, target_offsets: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Distance-IoU loss on (left, right) offsets around a shared center,
    elementwise over the leading dims."""
    inp = input_offsets.float()
    tgt = target_offsets.float()
    lp, rp = inp[..., 0], inp[..., 1]
    lg, rg = tgt[..., 0], tgt[..., 1]
    intsctk = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    unionk = (lp + rp) + (lg + rg) - intsctk
    iouk = intsctk / unionk.clamp(min=eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return 1.0 - iouk + (rho / len_c.clamp(min=eps)) ** 2


def masked_cls_loss(
    cls_logits: torch.Tensor,  # [B, T, 1]
    labels: torch.Tensor,  # [B, T]
    mask: torch.Tensor,  # [B, T]
    alpha: float = 0.7,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Summed focal loss over valid timesteps."""
    focal = sigmoid_focal_loss(cls_logits[..., 0], labels, alpha=alpha, gamma=gamma)
    return (focal * mask.float()).sum()


def masked_reg_loss(
    offsets: torch.Tensor,  # [B, T, 2]
    gt_offsets: torch.Tensor,  # [B, T, 2]
    labels: torch.Tensor,  # [B, T]: supervised on positive seconds only
    mask: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """Summed DIoU loss over valid positive timesteps."""
    diou = ctr_diou_loss_1d(offsets, gt_offsets)
    return (diou * (mask.float() * labels.float())).sum()
