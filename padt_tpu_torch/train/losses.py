"""Training losses (port of `padt_tpu/train/losses.py`): box (GIoU + L1),
score, mask (dice + sigmoid focal) and the robust token cross-entropy.

Same formulas as the reference trainer (`padt_sft_trainer.py:252-328,
490-539`) on static padded shapes with validity masks: elementwise box
IoU/GIoU, the dice/focal denominators with the `(count > 0) + 1e-5` quirk,
MSE(sigmoid(score) * 2 - 1, detached GIoU), and a per-token NLL whose VRT
positions leave the object's other ground-truth patches out of the softmax.
All reductions in fp32; masked logits are -1e30, not -inf, so an all-masked
row keeps finite gradients.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG_BIG = -1e30


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def elementwise_box_iou(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU and union of aligned xyxy box pairs."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / (union + 1e-9), union


def elementwise_giou(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized IoU of aligned pairs (the diagonal of the pairwise matrix)."""
    iou, union = elementwise_box_iou(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / (hull + 1e-9), iou


def bbox_losses(pred_cxcywh: torch.Tensor, gt_xyxy: torch.Tensor, valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(1 - GIoU) + L1 on cxcywh, averaged over valid objects."""
    pred, gt = pred_cxcywh.float(), gt_xyxy.float()
    vf = valid.float()
    n = vf.sum()
    giou, iou = elementwise_giou(box_cxcywh_to_xyxy(pred), gt)
    giou, iou = giou * vf, iou * vf
    giou_loss = 1.0 - giou.sum() / (n + 1e-4)
    l1 = ((pred - box_xyxy_to_cxcywh(gt)).abs() * vf[:, None]).sum() / (n + 1e-4)
    return {
        "bbox_loss": giou_loss + l1,
        "giou": giou,  # (N,) per object, 0 on invalid ones (the score loss's target)
        "iou_mean": iou.sum() / (n + 1e-4),
        "giou_mean": giou.sum() / (n + 1e-4),
    }


def score_loss(pred_score: torch.Tensor, giou: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    vf = valid.float()
    p = torch.sigmoid(pred_score[:, 0].float()) * 2.0 - 1.0
    err = (p - giou.detach()) ** 2 * vf
    return err.sum() / (vf.sum() + 1e-4)


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """inputs: mask logits (N, H, W); targets and loss_mask the same shape."""
    n = inputs.shape[0]
    p = torch.sigmoid(inputs.float()).reshape(n, -1)
    t = targets.float().reshape(n, -1)
    m = loss_mask.float().reshape(n, -1)
    num = 2.0 * (p * t * m).sum(-1)
    den = (p * m).sum(-1) + (t * m).sum(-1)
    loss = 1.0 - (num + 1.0) / (den + 1.0)
    obj_count = ((m.sum(-1) > 0).float() + 1e-5).sum()
    return loss.sum() / obj_count


def sigmoid_focal_loss(
    inputs: torch.Tensor, targets: torch.Tensor, loss_mask: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0,
) -> torch.Tensor:
    x, t, m = inputs.float(), targets.float(), loss_mask.float()
    prob = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))  # BCE with logits
    p_t = prob * t + (1 - prob) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    per_obj = (loss * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) + 1e-5)
    obj_count = ((m.sum(dim=(1, 2)) > 0).float() + 1e-5).sum()
    return per_obj.sum() / obj_count


def sft_token_loss(
    logits,  # (B, Lc, V + M) fp32, or the ((B, Lc, V), (B, Lc, M)) pair
    target_ids: torch.Tensor,  # (B, Lc) (local VRT ids: vocab_size + patch)
    completion_mask: torch.Tensor,  # (B, Lc) {0, 1}
    vrt_penalty_mask: torch.Tensor,  # (B, Lc, M) bool: True = leave this slot out
    vocab_size: int,
    use_vp_mask: bool = True,
) -> torch.Tensor:
    """Per-sample mean NLL over completion tokens, (B,). The pair form never
    concatenates the vocab axis: log Z = logaddexp(lse(text), lse(VRT))."""
    tgt = target_ids.long()
    is_vrt = tgt >= vocab_size
    if isinstance(logits, tuple):
        lt, lv = (x.float() for x in logits)
    else:
        full = logits.float()
        lt, lv = full[..., :vocab_size], full[..., vocab_size:]
    if use_vp_mask:
        lv = lv.masked_fill(vrt_penalty_mask.bool() & is_vrt[:, :, None], NEG_BIG)
    logz = torch.logaddexp(torch.logsumexp(lt, dim=-1), torch.logsumexp(lv, dim=-1))
    tgt_t = torch.gather(lt, -1, tgt.clamp(0, vocab_size - 1)[:, :, None])[..., 0]
    tgt_v = torch.gather(lv, -1, (tgt - vocab_size).clamp(0, lv.shape[-1] - 1)[:, :, None])[..., 0]
    nll = (logz - torch.where(is_vrt, tgt_v, tgt_t)) * completion_mask
    return nll.sum(-1) / (completion_mask.sum(-1) + 1e-4)
