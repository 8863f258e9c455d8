"""SSL losses on PyTorch tensors (the port of ``losses.py``).

The same fixed-shape formulations as ``losses.py``: the cross entropies are
computed at every frame and weighted by the mask, so no shape depends on the
data.  The cross entropies and the contrastive logits are taken in float32
whatever the logits' type, as the port's other losses take theirs.

``sample_negatives`` draws its indices from an explicit ``torch.Generator`` on
the generator's own device; ``gather_negatives`` does the rest from given
draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["gather_negatives", "hubert_loss", "sample_negatives", "wav2vec2_loss"]


def _masked_ce(logits: torch.Tensor, target: Optional[torch.Tensor], mask: torch.Tensor,
               reduction: str) -> torch.Tensor:
    """Cross entropy over the frames where ``mask`` is set; logits (B, T, C), the target class
    ``target`` (B, T), or class 0 without one."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if target is None:
        nll = -logp[..., 0]
    else:
        nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    nll = nll * mask
    if reduction == "mean":
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.sum()


def hubert_loss(
    logit_m: Optional[torch.Tensor],
    logit_u: Optional[torch.Tensor],
    feature_penalty: torch.Tensor,
    label: Optional[torch.Tensor] = None,
    mask_m: Optional[torch.Tensor] = None,
    mask_u: Optional[torch.Tensor] = None,
    masked_weight: float = 1.0,
    unmasked_weight: float = 0.0,
    feature_weight: float = 10.0,
    reduction: str = "sum",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HuBERT's masked and unmasked cross entropies plus the feature penalty; returns (loss,
    num_frames).  Logits are (B, T, C); ``label`` (B, T) holds the cluster ids (None: class 0).
    Under ``"sum"`` the penalty is scaled by the frame count, under ``"mean"`` it is not."""
    dev = feature_penalty.device
    num_frame = torch.zeros((), device=dev)
    loss = torch.zeros((), device=dev)
    for logits, mask, weight in ((logit_m, mask_m, masked_weight), (logit_u, mask_u, unmasked_weight)):
        if logits is None:
            continue
        m = mask if mask is not None else torch.ones(logits.shape[:-1], dtype=torch.bool, device=logits.device)
        loss = loss + weight * _masked_ce(logits, label, m, reduction)
        num_frame = num_frame + m.sum()
    penalty_scale = num_frame if reduction == "sum" else 1.0
    return loss + feature_penalty * feature_weight * penalty_scale, num_frame


def gather_negatives(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Negatives from given draws: ``idx`` (N, B, T) in [0, T - 1); a draw at or past its own
    position moves up by one (mod T), so no negative is its own frame.  features (B, T, D) ->
    (N, B, T, D)."""
    n, b, t = idx.shape
    pos = torch.arange(t, device=idx.device)
    idx = torch.where(idx >= pos, idx + 1, idx) % t
    d = features.shape[-1]
    return torch.gather(features.expand(n, b, t, d), 2, idx[..., None].expand(n, b, t, d))


def sample_negatives(features: torch.Tensor, num_negatives: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``num_negatives`` negatives for every frame, from other frames of the same utterance:
    features (B, T, D) -> (num_negatives, B, T, D).  The draws come from ``generator`` (torch's
    default one of the features' device if None), on its own device."""
    b, t, _ = features.shape
    draw_on = generator.device if generator is not None else features.device
    idx = torch.randint(0, t - 1, (num_negatives, b, t), generator=generator, device=draw_on)
    return gather_negatives(features, idx.to(features.device))


def wav2vec2_loss(
    x: torch.Tensor,
    mask_indices: torch.Tensor,
    positives: torch.Tensor,
    negatives: torch.Tensor,
    reduction: str = "sum",
    logit_temp: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav2vec 2.0's contrastive (InfoNCE) loss over the frames ``mask_indices`` sets; returns
    (loss, sample_size).  x and positives (B, T, D), negatives (N, B, T, D).  A negative equal to
    its positive gets the lowest float32 logit."""
    neg_is_pos = (positives[None] == negatives).all(-1)  # (N, B, T)
    targets = torch.cat([positives[None], negatives], dim=0).float()  # (N + 1, B, T, D)

    def unit(a):
        # rsqrt(|a|^2 + eps) keeps the gradient finite for all-zero (padded) frames
        return a * torch.rsqrt(a.pow(2).sum(-1, keepdim=True) + 1e-12)

    logits = (unit(x.float())[None] * unit(targets)).sum(-1) / logit_temp
    lowest = torch.finfo(torch.float32).min
    logits = torch.cat([logits[:1], logits[1:].masked_fill(neg_is_pos, lowest)], dim=0)
    logp = torch.log_softmax(logits, dim=0)
    nll = -logp[0] * mask_indices
    sample_size = mask_indices.sum()
    if reduction == "mean":
        return nll.sum() / torch.clamp(sample_size, min=1), sample_size
    return nll.sum(), sample_size
