"""Browser live viewer — the winit-window + egui-overlay analogue served
over HTTP (crates/app/src/lib.rs:120-205 event loop, app.rs:601-651 egui
debug window). Open the printed URL; frames stream live, the page overlays
fps/camera stats, and WASD/QE + drag (or arrows) fly the camera.

Run:  python examples/web_viewer.py --cpu            (laptop-friendly)
      python examples/web_viewer.py --width 640 --height 360   (GPU)
"""

import argparse

import voidin_tpu as vt
from voidin_tpu.framework.app import App
from voidin_tpu.framework.webviewer import run_web
from voidin_tpu.passes.raster import RasterConfig

from viewer import Spin  # the same demo scene as the terminal viewer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: until Esc//quit)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax

    cfg = RasterConfig(
        width=args.width, height=args.height,
        tri_capacity=1 << 15, pair_capacity=1 << 17,
        interpret=jax.default_backend() == "cpu",
    )
    cam = vt.Camera(position=[0, 2.5, 0.0], pitch=-14.0,
                    aspect=args.width / args.height)
    app = App(Spin(), camera=cam, config=cfg)
    print(f"serving http://127.0.0.1:{args.port}/  (Esc in page quits)")
    n = run_web(app, port=args.port, max_frames=args.frames)
    print(f"viewer closed after {n} frames")


if __name__ == "__main__":
    main()
