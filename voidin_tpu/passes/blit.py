"""Blit utilities: format conversion, resize, mip generation.

Equivalent of the reference Blitter (components/src/blitter.rs:9-240): the
final present blit with optional sRGB encode, and mip generation by
iterated 2x2 downsampling (blitter.rs:139-200). Here these are dense
array ops; the "formats" are dtypes."""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.texture import linear_to_srgb


def present(hdr: jnp.ndarray, srgb: bool = True, to_uint8: bool = False):
    """HDR (H, W, 3) -> displayable frame (the swapchain blit, app.rs:334-340)."""
    img = linear_to_srgb(hdr) if srgb else jnp.clip(hdr, 0.0, 1.0)
    if to_uint8:
        img = (img * 255.0 + 0.5).astype(jnp.uint8)
    return img


def downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """One mip step: 2x2 box filter (blitter.rs generate_mipmaps step)."""
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return (
        x.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3)).reshape(
            h // 2, w // 2, *img.shape[2:]
        )
    )


def generate_mipmaps(img: jnp.ndarray):
    """Full mip chain down to 1x1-ish."""
    mips = [img]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        mips.append(downsample2x(mips[-1]))
    return mips


def resize_bilinear(img: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Bilinear resize (the blitter's scaling copy)."""
    import jax

    return jax.image.resize(img, (height, width, *img.shape[2:]), "bilinear")
