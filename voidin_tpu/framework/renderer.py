"""The Renderer: one jitted frame function over device-resident scene state.

Equivalent of the reference App + frame loop (crates/app/src/app.rs:292-358):
where the reference records passes into a command encoder and submits once
per frame, here every pass is a pure function and the whole frame — update,
cull, raster, resolve, shade, TAA, postprocess — is a single ``jax.jit``
program: "GPU-driven, no CPU roundtrip" as one compiled XLA program.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core.camera import Camera, CameraUniform
from ..core.jitter import JitterSequence
from ..passes import cull as cull_pass
from ..passes import postprocess as post_pass
from ..passes import raster as raster_pass
from ..passes import resolve as resolve_pass
from ..passes import shading as shading_pass
from ..passes import taa as taa_pass
from ..passes import update as update_pass
from ..passes.raster import RasterConfig
from ..scene.scene import SceneData
from ..scene.texture import linear_to_srgb


@struct.dataclass
class Globals:
    """Per-frame globals (global_ubo.rs Uniform)."""

    resolution: jnp.ndarray  # (2,) f32
    frame: jnp.ndarray  # () i32
    time: jnp.ndarray  # () f32
    dt: jnp.ndarray  # () f32
    custom: jnp.ndarray  # () f32

    @classmethod
    def make(cls, width, height, frame=0, time=0.0, dt=0.0, custom=0.0):
        return cls(
            resolution=jnp.asarray([width, height], jnp.float32),
            frame=jnp.asarray(frame, jnp.int32),
            time=jnp.asarray(time, jnp.float32),
            dt=jnp.asarray(dt, jnp.float32),
            custom=jnp.asarray(custom, jnp.float32),
        )


@struct.dataclass
class FrameState:
    """Functional render state carried across frames (ViewTarget ping-pong +
    TAA history in the reference)."""

    history: jnp.ndarray  # (H, W, 3) f32 TAA history color
    history_valid: jnp.ndarray  # () bool — False on the first frame

    @classmethod
    def initial(cls, width, height):
        return cls(
            history=jnp.zeros((height, width, 3), jnp.float32),
            history_valid=jnp.asarray(False),
        )


def render_frame(
    scene: SceneData,
    camera: CameraUniform,
    globals_: Globals,
    state: FrameState,
    moving_ids: jnp.ndarray,
    config: RasterConfig,
    enable_cull: bool = True,
    enable_taa: bool = True,
    enable_post: bool = True,
    enable_rt_shadows: bool = False,
    rt_shadow_scale: int = 1,
    area_light_scale: int = 1,
    mesh=None,
    joint_mats=None,
):
    """Full frame. Returns (srgb_image, new_state, new_scene, aux).

    With `mesh` (a jax.sharding.Mesh over the 'rows' axis) the dense
    per-pixel stages are sharded over screen rows; XLA SPMD inserts the
    halo collectives for the stencil passes. `joint_mats` ((J, 4, 4)
    world-joint @ inverseBind, host-composed per frame) drives any
    skinning regions in the scene.
    """
    from ..parallel import sharding as shard_mod
    # 1. compute_update: animate moving instances on device; vertex
    # skinning re-computes the skinned pool ranges from joint matrices.
    instances = update_pass.compute_update(
        scene.instances, moving_ids, globals_.time, globals_.dt
    )
    scene = scene.replace(instances=instances)
    if scene.skins and joint_mats is not None:
        from ..scene.skin import apply_skins, refit_tlas

        scene = scene.replace(
            meshes=apply_skins(scene.meshes, scene.skins, joint_mats)
        )
        if scene.tlas is not None:
            # skinned AABBs moved: re-fit the TLAS so traced shadows track
            # the pose (BLAS refit happened inside apply_skins)
            scene = scene.replace(
                tlas=refit_tlas(scene.tlas, scene.meshes, scene.instances)
            )

    # 2. emit_draws: frustum cull + compaction.
    if enable_cull:
        draws = cull_pass.emit_draws(scene.meshes, scene.instances, camera)
    else:
        n = scene.instances.count
        draws = cull_pass.DrawList(
            instance=jnp.arange(n, dtype=jnp.int32), count=jnp.asarray(n, jnp.int32)
        )

    # 3. visibility raster + G-buffer resolve. Multi-device: the production
    # Pallas raster runs row-PARTITIONED under shard_map (each device bins
    # + rasterizes its own tile rows — parallel/sharding.py); the XLA twin
    # path shards only the output images.
    inst_rec = None
    if getattr(config, "slim_rec", False):
        # slim_rec: the f16 instance record rides the draw record so setup
        # can fold basis-transformed world normals + the material payload
        # into the single 96 B slim resolve record (RasterConfig.slim_rec)
        inst_rec = resolve_pass._inst_rec_f16(scene)
    elif getattr(config, "fused_inst_rec", False):
        if not (config.fused_resolve_rec
                and getattr(config, "inst_rec_f16", False)):
            raise ValueError(
                "fused_inst_rec requires fused_resolve_rec + inst_rec_f16"
            )
        # f16 instance+material record folded into the resolve record at
        # setup — resolve then runs with 2 per-pixel gathers, not 3
        inst_rec = resolve_pass._inst_rec_f16(scene)
    if mesh is not None and config.backend == "pallas":
        vis = shard_mod.rasterize_sharded(
            scene.meshes, scene.instances, draws, camera, config, mesh,
            materials=scene.materials, inst_rec=inst_rec,
        )
    else:
        vis = raster_pass.rasterize(
            scene.meshes, scene.instances, draws, camera, config,
            materials=scene.materials, inst_rec=inst_rec,
        )
        if mesh is not None:
            vis = vis.replace(
                tri_id=shard_mod.shard_rows(mesh, vis.tri_id),
                depth=shard_mod.shard_rows(mesh, vis.depth),
                tri_id2=None if vis.tri_id2 is None
                else shard_mod.shard_rows(mesh, vis.tri_id2),
                depth2=None if vis.depth2 is None
                else shard_mod.shard_rows(mesh, vis.depth2),
            )
    if mesh is not None and (
        getattr(config, "quad_rate_resolve", False)
        or getattr(config, "tap_block", False)
        or getattr(config, "slot_resolve", False)
    ):
        # The coherence paths' compaction (global argsort) + row scatters do
        # not partition row-locally under SPMD — keep the sharded frame on
        # the per-pixel resolve/tap (same images: the paths are
        # bit-identical). Applies equally to tap_block's edge-quad batch.
        config = dataclasses.replace(
            config, quad_rate_resolve=False, tap_block=False,
            slot_resolve=False,
        )
    gbuffer, aux_r = resolve_pass.resolve_gbuffer(scene, vis, camera, config)
    if mesh is not None:
        gbuffer = gbuffer.replace(
            normal_uv=shard_mod.shard_rows(mesh, gbuffer.normal_uv),
            material=shard_mod.shard_rows(mesh, gbuffer.material),
            depth=shard_mod.shard_rows(mesh, gbuffer.depth),
        )

    # 4. deferred shading (HDR); optionally with TLAS-traced shadows.
    if enable_rt_shadows:
        hdr = shading_pass.shade_raytraced(
            scene, gbuffer, camera, aux=aux_r,
            shadow_scale=rt_shadow_scale,
            rt_packet=getattr(config, "rt_packet", 0),
            rt_threaded=getattr(config, "rt_threaded", False),
            rt_unroll=getattr(config, "rt_unroll", 1),
        )
    else:
        hdr = shading_pass.shade(
            scene, gbuffer, camera, aux=aux_r,
            area_light_scale=area_light_scale,
        )
    if mesh is not None:
        hdr = shard_mod.shard_rows(mesh, hdr)

    # 5. TAA (reproject + resolve into history).
    taa_overflow = None
    if enable_taa:
        # quad-block history fetch: compaction + scatters don't partition
        # row-locally under SPMD (same reason as quad_rate_resolve)
        tq = getattr(config, "taa_quad_history", False) and mesh is None
        # in-window fetch: the fallback compaction + scatter don't
        # partition row-locally under SPMD (same reason as quad_history)
        tw = getattr(config, "taa_inwindow", False) and mesh is None
        hdr, state, taa_overflow = taa_pass.taa(
            hdr, gbuffer, camera, state, quad_history=tq,
            edge_capacity=getattr(config, "taa_edge_capacity", 0),
            inwindow=tw,
            block_capacity=getattr(config, "taa_block_capacity", 0),
            quad_select="where" if getattr(config, "taa_quad_where", False)
            else "einsum",
        )
        if mesh is not None:
            hdr = shard_mod.shard_rows(mesh, hdr)

    # 6. postprocess (sharpen + tonemap) + sRGB encode (final blit).
    ldr = post_pass.postprocess(hdr) if enable_post else hdr
    srgb = linear_to_srgb(ldr)

    overflow = vis.overflow
    if aux_r is not None and aux_r.overflow is not None:
        overflow = overflow + aux_r.overflow  # alpha-fallback capacity
    if taa_overflow is not None:
        overflow = overflow + taa_overflow  # quad-history edge capacity
    aux = dict(
        draw_count=draws.count,
        overflow=overflow,
        depth=gbuffer.depth,
        vis_coverage=jnp.sum((vis.tri_id >= 0).astype(jnp.int32)),
    )
    return srgb, state, scene, aux


def production_slim(img, state, scene, aux):
    """Slim the frame outputs to the leaves the host actually carries
    across frames.

    `render_frame` returns the full scene pytree (47 leaves, ~87 MB at the
    north-star scale), but the ONLY cross-frame device state is
    ``scene.instances`` (compute_update mutates transforms incrementally;
    skinned meshes / BLAS / TLAS AABBs are recomputed every frame from static
    rest-pose data + joint matrices — scene/skin.py) and the TAA history in
    ``state``; re-emitting the other ~45 output buffers every frame is pure
    memory traffic. The reference has the same shape: one submission per
    frame mutates buffers in place, it never re-emits the scene
    (crates/app/src/app.rs:342-346).

    Also drops the full-res depth plane from aux (scalars only) — no host
    caller reads it (only tests use render_frame's full aux directly).
    """
    slim_aux = dict(
        draw_count=aux["draw_count"],
        overflow=aux["overflow"],
        vis_coverage=aux["vis_coverage"],
    )
    return img, state, scene.instances, slim_aux


def frame_sources():
    """Source files whose edits must re-trace the frame pipeline — the
    import_mapping of the frame 'shader' (pipeline.rs:35-36)."""
    from ..parallel import sharding as shard_mod
    from ..scene import skin as skin_mod

    mods = [
        cull_pass, post_pass, raster_pass, resolve_pass, shading_pass,
        taa_pass, update_pass, shard_mod, skin_mod,
    ]
    files = [m.__file__ for m in mods if getattr(m, "__file__", None)]
    files.append(__file__)
    return files


class Renderer:
    """Host-side driver: owns the jitted frame fn and functional state."""

    def __init__(
        self,
        scene: SceneData,
        config: Optional[RasterConfig] = None,
        enable_cull: bool = True,
        enable_taa: bool = True,
        enable_post: bool = True,
        enable_rt_shadows: bool = False,
        rt_shadow_scale: int = 1,
        area_light_scale: int = 1,
        moving_ids: Optional[np.ndarray] = None,
        mesh=None,
        pipeline_cache=None,
    ):
        self.scene = scene
        self.config = dataclasses.replace(
            config or RasterConfig(),
            # second-candidate tracking only when the scene has per-texel
            # alpha-masked materials (visibility.wgsl:79-81 semantics)
            alpha_mask=getattr(scene, "alpha_masked", False),
        )
        if getattr(self.config, "slim_rec", False):
            # slim_rec only fits scenes with no normal maps, const-folded
            # 1x1 emissive/mr textures, no alpha masking, and f16-exact
            # pool ids; otherwise fall back to the equivalent general
            # option set (fused record + f16 instance record) so a tuned
            # variant stays applicable across presets.
            slim_ok = (
                getattr(scene, "no_normal_maps", False)
                and getattr(scene, "emissive_const", False)
                and getattr(scene, "mr_const", False)
                and not getattr(scene, "alpha_masked", False)
                and scene.materials.albedo.shape[0] <= 2048
                and scene.textures.size.shape[0] <= 2048
            )
            if not slim_ok:
                self.config = dataclasses.replace(
                    self.config, slim_rec=False,
                    fused_resolve_rec=True, inst_rec_f16=True,
                )
        self.enable_taa = enable_taa
        self.state = FrameState.initial(self.config.width, self.config.height)
        self.moving_ids = jnp.asarray(
            moving_ids if moving_ids is not None else np.zeros(0, np.int32)
        )
        self.jitter = JitterSequence()
        self.frame_count = 0
        self.time = 0.0

        def build():
            # Re-resolve render_frame from the live module so a reload of
            # any pass module (or this one) is picked up at re-trace time —
            # the PipelineArena hot-swap semantics (app/pipeline.rs:253-351).
            import importlib

            live = importlib.import_module(__name__)
            rf = live.render_frame
            slim = live.production_slim
            cfg = self.config

            def frame(scene_, camera_, globals__, state_, moving_, jm_):
                from ..core import checks

                # thread-local, set for the duration of THIS trace only
                checks.set_bounds_enabled(cfg.debug_bounds)
                try:
                    return slim(*rf(
                        scene_, camera_, globals__, state_, moving_,
                        config=cfg,
                        enable_cull=enable_cull,
                        enable_taa=enable_taa,
                        enable_post=enable_post,
                        enable_rt_shadows=enable_rt_shadows,
                        rt_shadow_scale=rt_shadow_scale,
                        area_light_scale=area_light_scale,
                        mesh=mesh,
                        joint_mats=jm_,
                    ))
                finally:
                    checks.set_bounds_enabled(False)

            if cfg.debug_bounds:
                from jax.experimental import checkify

                checked = checkify.checkify(
                    frame, errors=checkify.user_checks
                )

                def frame_checked(*a):
                    return checked(*a)  # (error, outputs)

                return frame_checked
            return frame

        # Only the TAA history state is consumed-and-re-emitted (donatable);
        # the scene is NOT donated — its static leaves stay device-resident
        # across frames, and only the small instances pytree is re-emitted
        # (production_slim). Donating the scene would invalidate the static
        # leaves the next frame reuses.
        jit_kwargs = dict(donate_argnums=(3,))
        if pipeline_cache is not None:
            self._fn = pipeline_cache.register(
                "frame",
                build,
                sources=frame_sources(),
                jit_kwargs=jit_kwargs,
            )
        else:
            self._fn = jax.jit(build(), **jit_kwargs)

    def _frame_args(self, camera: Camera, dt: float, joint_mats):
        if self.enable_taa:
            camera.jitter = self.jitter.get_jitter(
                self.frame_count, self.config.width, self.config.height
            )
        uniform = camera.uniform(previous=getattr(self, "_prev_uniform", None))
        globals_ = Globals.make(
            self.config.width,
            self.config.height,
            frame=self.frame_count,
            time=self.time,
            dt=dt,
        )
        if self.scene.skins:
            if joint_mats is None:
                raise ValueError(
                    "scene has skinning regions: pass joint_mats "
                    "(e.g. from io.gltf.GltfAnimator.joint_matrices)"
                )
            jm = jnp.asarray(joint_mats, jnp.float32)
        else:
            jm = jnp.zeros((0, 4, 4), jnp.float32)
        return (self.scene, uniform, globals_, self.state, self.moving_ids,
                jm)

    def lower(self, camera: Camera, dt: float = 1.0 / 60.0,
              joint_mats=None):
        """The frame program lowered for the next frame's arguments
        (jax.stages.Lowered: .as_text() is its HLO)."""
        return self._fn.lower(*self._frame_args(camera, dt, joint_mats))

    def render(self, camera: Camera, dt: float = 1.0 / 60.0,
               joint_mats=None) -> jnp.ndarray:
        args = self._frame_args(camera, dt, joint_mats)
        self._prev_uniform = args[1]
        if self.config.debug_bounds:
            err, (img, self.state, instances, self.aux) = self._fn(*args)
            err.throw()  # raises with the failing check_index's name
        else:
            img, self.state, instances, self.aux = self._fn(*args)
        self.scene = self.scene.replace(instances=instances)
        self.frame_count += 1
        self.time += dt
        return img
