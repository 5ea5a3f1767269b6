"""Fullscreen raymarched fractal (src/bin/fractal.rs + fractal.wgsl
equivalent): a pure-jnp 'fullscreen shader' demo — no geometry, just the
camera/globals plumbing and a per-pixel kernel."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--time", type=float, default=1.5)
    ap.add_argument("--out", default="fractal.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from voidin_tpu.io.image import save_png
    from voidin_tpu.scene.texture import linear_to_srgb

    H, W = args.height, args.width

    def sdf(p, t):
        # mandelbulb-ish folded box distance field
        def body(i, carry):
            z, dr = carry
            z = jnp.clip(z, -1.0, 1.0) * 2.0 - z  # box fold
            r2 = jnp.sum(z * z, axis=-1, keepdims=True)
            k = jnp.clip(1.0 / jnp.maximum(r2, 0.25), 1.0, 4.0)
            z = z * k * 2.2 + p * (0.4 + 0.1 * jnp.sin(t))
            dr = dr * jnp.abs(k[..., 0]) * 2.2 + 1.0
            return z, dr

        z, dr = jax.lax.fori_loop(0, 10, body, (p, jnp.ones(p.shape[:-1])))
        return (jnp.linalg.norm(z, axis=-1) - 2.0) / dr

    @jax.jit
    def render(t):
        u = (jnp.arange(W) + 0.5) / W * 2 - 1
        v = (1 - (jnp.arange(H) + 0.5) / H * 2) * H / W
        uu, vv = jnp.meshgrid(u, v)
        ro = jnp.array([0.0, 0.0, -6.0])
        rd = jnp.stack([uu, vv, jnp.ones_like(uu)], -1)
        rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)

        def march(i, tt):
            p = ro + rd * tt[..., None]
            d = sdf(p, t)
            return tt + d * 0.7

        tt = jax.lax.fori_loop(0, 64, march, jnp.full((H, W), 2.0))
        p = ro + rd * tt[..., None]
        eps = 1e-3
        n = jnp.stack(
            [
                sdf(p + jnp.array([eps, 0, 0]), t) - sdf(p - jnp.array([eps, 0, 0]), t),
                sdf(p + jnp.array([0, eps, 0]), t) - sdf(p - jnp.array([0, eps, 0]), t),
                sdf(p + jnp.array([0, 0, eps]), t) - sdf(p - jnp.array([0, 0, eps]), t),
            ],
            -1,
        )
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        lit = jnp.clip(jnp.sum(n * jnp.array([0.5, 0.7, -0.5]), -1), 0, 1)
        hit = tt < 20.0
        fog = jnp.exp(-0.08 * tt)
        base = jnp.stack([lit * 0.9 + 0.05, lit * 0.6 + 0.08, lit * 0.4 + 0.15], -1)
        col = jnp.where(hit[..., None], base * fog[..., None], 0.02)
        return linear_to_srgb(col)

    img = render(jnp.float32(args.time))
    save_png(args.out, np.asarray(img))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
