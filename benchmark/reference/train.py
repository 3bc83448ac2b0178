"""Reference training: the batch order, the augmentation, the ground-truth
encoding, the three losses and Adam, in plain float32 PyTorch.

Written from the reference's description (notebook 03's recipe): a shuffled
epoch order from the loader's seed; per sample a horizontal-flip coin (>= 0.5
flips) and per batch four colour scalars, drawn in that order from one
generator on the device seeded like the loader's; TF's hue / saturation /
contrast / brightness adjustments; SSD matching with the +1 pixel-index
IoU; the weighted cross-entropy of the mask summed over the plane, the
confidence loss with hard negatives mined over the whole batch (3 per
positive), smooth L1 over positive anchors; Keras batch means; Adam
(0.9, 0.999, 1e-8) with its bias corrections.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = 1e-7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RGB_RANGES = ((-0.05, 0.05), (0.95, 1.05), (0.90, 1.10), (-0.10, 0.10))


def epoch_order(n_samples: int, batch: int, seed: int, epoch: int = 0) -> List[np.ndarray]:
    """Epoch ``epoch``'s batches of sample indices: NumPy's default
    generator seeded ``seed`` shuffles ``range(n_samples)`` afresh each
    epoch; the order is cut into whole batches."""
    rng = np.random.default_rng(seed)
    for _ in range(epoch + 1):
        order = np.arange(n_samples)
        rng.shuffle(order)
    n = n_samples // batch
    return np.split(order[: n * batch], max(n, 1))


def draws(generator: torch.Generator, batch: int, flip_on: bool, rgb_on: bool):
    """(flip (B,) bool, colour scalars (4,)) of one batch, each None when
    that augmentation is off: the coins first, then the scalars."""
    flip = scalars = None
    if flip_on:
        flip = torch.rand(batch, generator=generator, device=generator.device) >= 0.5
    if rgb_on:
        u = torch.rand(4, generator=generator, device=generator.device)
        low = u.new_tensor([r[0] for r in RGB_RANGES])
        high = u.new_tensor([r[1] for r in RGB_RANGES])
        scalars = low + u * (high - low)
    return flip, scalars


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(c == 0, torch.ones_like(c), c)
    sector = torch.where(v == r, torch.remainder((g - b) / safe, 6.0),
                         torch.where(v == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(c == 0, torch.zeros_like(c), sector / 6.0)
    s = torch.where(v > 0, c / torch.where(v == 0, torch.ones_like(v), v), torch.zeros_like(v))
    return h, s, v


def _hsv_to_rgb(h, s, v):
    h = torch.remainder(h, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], -1)


def colour(images, hue, saturation, contrast, brightness):
    """TF's adjust_hue, adjust_saturation, adjust_contrast (per channel,
    mean over the plane), adjust_brightness, then a clip to [0, 255]."""
    h, s, v = _rgb_to_hsv(images)
    images = _hsv_to_rgb(torch.remainder(h + hue, 1.0), s, v)
    h, s, v = _rgb_to_hsv(images)
    images = _hsv_to_rgb(h, (s * saturation).clamp(0, 1), v)
    mean = images.mean(dim=(-3, -2), keepdim=True)
    images = (images - mean) * contrast + mean
    return (images + brightness).clamp(0.0, 255.0)


def encode(labels, boxes, valid, anchor_corners, classes: int, iou_threshold: float, stds):
    """SSD targets of a batch: one-hot labels (B, N, C) and standardised
    offsets (B, N, 4).  Each ground truth claims its best anchor (if its IoU
    is above 0; on a collision the highest ground-truth index wins); each
    anchor whose best IoU is above the threshold claims that ground truth
    (ties to the lowest index), which overrides."""
    a = anchor_corners
    inter_w = (torch.minimum(a[:, None, 2], boxes[:, None, :, 2])
               - torch.maximum(a[:, None, 0], boxes[:, None, :, 0]) + 1).clamp_min(0)
    inter_h = (torch.minimum(a[:, None, 3], boxes[:, None, :, 3])
               - torch.maximum(a[:, None, 1], boxes[:, None, :, 1]) + 1).clamp_min(0)
    inter = inter_w * inter_h
    area_a = ((a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1))[:, None]
    area_g = ((boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1))[:, None, :]
    iou = inter / (area_a + area_g - inter)                       # (B, N, G)
    masked = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    n, g = iou.shape[1:]
    best_anchor = iou.argmax(dim=1)                               # (B, G)
    claims = valid & (masked.amax(dim=1) > 0)
    hit = (best_anchor[:, :, None] == torch.arange(n, device=iou.device)) & claims[:, :, None]
    gt_side = torch.where(hit, torch.arange(g, device=iou.device)[:, None], -1).amax(dim=1)
    assigned = torch.where(masked.amax(dim=2) > iou_threshold, masked.argmax(dim=2), gt_side)
    matched = assigned >= 0
    safe = assigned.clamp_min(0)
    cls = torch.where(matched, torch.gather(labels.long(), 1, safe), 0)
    onehot = (cls[..., None] == torch.arange(classes, device=cls.device)).float()
    gb = torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4))

    def centroids(x):
        return ((x[..., 2] + x[..., 0]) / 2, (x[..., 3] + x[..., 1]) / 2,
                x[..., 2] - x[..., 0] + 1, x[..., 3] - x[..., 1] + 1)

    acx, acy, aw, ah = centroids(a)
    gcx, gcy, gw, gh = centroids(gb)
    off = torch.stack([(gcx - acx) / aw / stds[0], (gcy - acy) / ah / stds[1],
                       torch.log(gw / aw + 1) / stds[2], torch.log(gh / ah + 1) / stds[3]], -1)
    return onehot, torch.where(matched[..., None], off, torch.zeros_like(off))


def transform(raw, generator, anchor_corners, enc: Dict, flip_on: bool, rgb_on: bool):
    """(images f32 (B, H, W, 3), targets) of one raw uint8 batch."""
    images_u8, masks_u8, labels, boxes, valid = raw
    images = images_u8.float()
    masks = F.one_hot(masks_u8.long(), enc["num_classes"]).float()
    boxes = boxes.float()
    flip, scalars = draws(generator, images.shape[0], flip_on, rgb_on)
    if flip_on:
        width = float(enc["image_shape"][1])
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
        masks = torch.where(flip[:, None, None, None], masks.flip(2), masks)
        flipped = torch.stack([width - boxes[..., 2], boxes[..., 1], width - boxes[..., 0],
                               boxes[..., 3]], -1)
        boxes = torch.where(flip[:, None, None], flipped, boxes)
    if rgb_on:
        images = colour(images, *scalars.unbind(0))
    onehot, offsets = encode(labels, boxes, valid.bool(), anchor_corners, enc["num_classes"],
                             enc["iou_threshold"], enc["standard_deviations"])
    return images, {"mask": masks, "labels": onehot, "boxes": offsets}


def losses(mask, labels, boxes, targets, train: Dict):
    """(total, mask, labels, boxes) batch means, weighted as Keras does."""
    w = torch.tensor(train["mask_class_weights"], device=mask.device)
    ce = -(targets["mask"] * torch.log(mask.clamp(EPSILON, 1 - EPSILON))).sum(dim=(1, 2))
    l_mask = (ce * w).sum(-1).mean()

    y = targets["labels"]
    background = y[:, :, 0]
    positive = 1.0 - background
    ce = -(y * torch.log(labels.clamp(EPSILON, 1 - EPSILON))).sum(-1)
    pos = (ce * positive).sum(-1)
    flat = (ce * background).detach().reshape(-1)
    k = min(int(train["hnm_negatives_ratio"] * float(positive.sum())), int(background.sum()))
    keep = torch.zeros_like(flat)
    keep[torch.sort(-flat, stable=True).indices[:k]] = 1.0
    neg = (ce * background * keep.reshape(ce.shape)).sum(-1)
    n_pos = positive.sum(-1).clamp_min(1.0)
    l_labels = ((pos + neg) / n_pos).mean()

    t = targets["boxes"]
    on = (t.abs().sum(-1) > 0).float()
    err = (t - boxes).abs()
    smooth = torch.where(err < 1.0, 0.5 * err * err, err - 0.5).sum(-1) * on
    l_boxes = (smooth.sum(-1) / on.sum(-1).clamp_min(1.0)).mean()
    return (train["loss_weight_mask"] * l_mask + train["loss_weight_labels"] * l_labels
            + train["loss_weight_boxes"] * l_boxes), l_mask, l_labels, l_boxes


def adam(params: Dict[str, torch.Tensor], grads, mu, nu, step: int, lr: float) -> None:
    """One Adam update in place; ``step`` counts the updates before it."""
    t = step + 1
    c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
    for k, g in grads.items():
        mu[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        params[k].sub_(lr * (mu[k] / c1) / ((nu[k] / c2).sqrt() + ADAM_EPS))


def train_steps(net, weights: Dict[str, torch.Tensor], raw_batches, generator, anchor_corners,
                enc: Dict, train: Dict, flip_on: bool, rgb_on: bool, dtype=torch.float32,
                moments=None, count: int = 0):
    """Follow ``len(raw_batches)`` steps from ``weights``, with Adam's
    ``moments`` (mu, nu) after ``count`` updates (None: zero): (losses of
    each step, the first step's gradients, the parameters after the last).
    ``dtype`` bfloat16 runs the network in bf16 (f32 parameters, losses and
    update): a witness of what bf16 rounding alone does, not the reference."""
    names = [n for n, _ in net.named_parameters()]
    params = {n: weights[n].detach().float().clone() for n in names}
    if moments is None:
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
    else:
        mu, nu = ({n: m[n].detach().float().clone() for n in names} for m in moments)
    net.train()
    step_losses, first = [], None
    for step, raw in enumerate(raw_batches):
        images, targets = transform(raw, generator, anchor_corners, enc, flip_on, rgb_on)
        leaves = {n: p.to(dtype).requires_grad_() for n, p in params.items()}
        mask, labels, boxes = torch.func.functional_call(net, leaves, (images.to(dtype),))
        total, *_ = losses(mask.float(), labels.float(), boxes.float(), targets, train)
        grads = {n: g.float() for n, g in
                 zip(names, torch.autograd.grad(total, [leaves[n] for n in names]))}
        step_losses.append(float(total.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            adam(params, grads, mu, nu, count + step, train["learning_rate"])
        del leaves, mask, labels, boxes, total, grads
    return step_losses, first, params
