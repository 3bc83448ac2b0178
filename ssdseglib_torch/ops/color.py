"""Color-space augmentation ops (PyTorch), counterpart of
ssdseglib_tpu/ops/color.py (reference ssdseglib/datacoder.py:434-466): small
random hue / saturation / contrast / brightness shifts followed by a
[0, 255] clip.  TF semantics:

- one scalar draw per transform per batch (the reference augments after
  ``.batch()``, so a whole batch shares one draw)
- hue and saturation go through an HSV round trip (H and S are
  scale-invariant, so [0, 255] images need no rescaling)
- contrast is per-channel mean-preserving: ``(x - mean_hw) * f + mean_hw``
- brightness adds a raw delta (on a [0, 255] image a +-0.1 delta is almost a
  no-op: a reference quirk that is kept)

`apply_rgb_augmentation` is the pure function of the four scalars;
`augmentation_rgb_channels` draws them from a ``torch.Generator``.  The
scalars may be Python floats or 0-d tensors on the images' device.
"""

from __future__ import annotations

import torch

# (low, high) of the uniform draws: hue, saturation, contrast, brightness
RANGES = ((-0.05, 0.05), (0.95, 1.05), (0.90, 1.10), (-0.10, 0.10))


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) -> HSV (..., 3); hue in [0, 1), TF-compatible."""
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    grey = c == 0.0
    safe_c = torch.where(grey, torch.ones_like(c), c)
    # ties go to red, then green, as nested selects decide them
    sector = torch.where(
        v == r,
        torch.remainder((g - b) / safe_c, 6.0),
        torch.where(v == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0),
    )
    h = torch.where(grey, torch.zeros_like(c), sector / 6.0)
    s = torch.where(v > 0.0, c / torch.where(v == 0.0, torch.ones_like(v), v),
                    torch.zeros_like(v))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV (..., 3) -> RGB (..., 3); hue wraps modulo 1."""
    h, s, v = hsv.unbind(-1)
    h = torch.remainder(h, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices: torch.Tensor) -> torch.Tensor:
        """choices[i], elementwise (i is in 0..5 by construction)."""
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def adjust_hue(image: torch.Tensor, delta) -> torch.Tensor:
    h, s, v = rgb_to_hsv(image).unbind(-1)
    return hsv_to_rgb(torch.stack([torch.remainder(h + delta, 1.0), s, v], dim=-1))


def adjust_saturation(image: torch.Tensor, factor) -> torch.Tensor:
    h, s, v = rgb_to_hsv(image).unbind(-1)
    return hsv_to_rgb(torch.stack([h, (s * factor).clamp(0.0, 1.0), v], dim=-1))


def adjust_contrast(image: torch.Tensor, factor) -> torch.Tensor:
    """Per-channel mean-preserving contrast; mean over the spatial dims."""
    mean = image.mean(dim=(-3, -2), keepdim=True)
    return (image - mean) * factor + mean


def adjust_brightness(image: torch.Tensor, delta) -> torch.Tensor:
    return image + delta


def apply_rgb_augmentation(images: torch.Tensor, hue, saturation, contrast,
                           brightness) -> torch.Tensor:
    """The four adjustments in the reference's order on a [0, 255] float
    image batch (B, H, W, 3), clipped to [0, 255]."""
    images = adjust_hue(images, hue)
    images = adjust_saturation(images, saturation)
    images = adjust_contrast(images, contrast)
    images = adjust_brightness(images, brightness)
    return images.clamp(0.0, 255.0)


def draw_rgb_scalars(generator: torch.Generator) -> torch.Tensor:
    """(4,) f32 on the generator's device: hue +-0.05, saturation
    [0.95, 1.05), contrast [0.90, 1.10), brightness +-0.10, one draw each
    (reference datacoder.py:452-464)."""
    u = torch.rand(4, generator=generator, device=generator.device)
    low = u.new_tensor([r[0] for r in RANGES])
    high = u.new_tensor([r[1] for r in RANGES])
    return low + u * (high - low)


def augmentation_rgb_channels(generator: torch.Generator,
                              images: torch.Tensor) -> torch.Tensor:
    """Random hue/saturation/contrast/brightness on a [0, 255] image batch,
    one scalar draw per transform per batch, from ``generator`` (on the
    images' device, or on the CPU)."""
    scalars = draw_rgb_scalars(generator).to(images.device)
    return apply_rgb_augmentation(images, *scalars.unbind(0))
