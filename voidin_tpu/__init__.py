"""voidin-tpu: a real-time rendering framework in JAX/XLA/Pallas.

A from-scratch rebuild of the capabilities of the wgpu renderer
pudnax/voidin: the whole frame — instance update,
frustum culling + compacted draw emission, software visibility-buffer
rasterization, deferred shading with LTC area lights, temporal AA, and
postprocessing — is one jitted function over device-resident scene state.
"""

from .core import camera, color, encoding, jitter, mathx
from .core.camera import Camera, CameraUniform, build_uniform
from .scene.scene import SceneData, World
from .scene import mesh, instance, material, light, texture

__version__ = "0.1.0"
