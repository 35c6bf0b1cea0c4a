"""rtm_tpu — a differentiable, progressive path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
Ray-Tracing-Machine reference engine (see SURVEY.md): camera rays with
depth-of-field, sphere + mesh (glTF/OBJ, SAH-BVH) intersection, multi-bounce
diffuse/metallic/dielectric scattering, emissives, textures, HDR sky maps,
progressive accumulation — plus what the reference lacks: autodiff inverse
rendering, multi-chip sharding, tests and benchmarks.
"""

from .config import RenderConfig
from .models.camera import Camera, CameraSpec
from .models.material import Material, Materials
from .models.mesh import Mesh, MeshInstance, Triangle
from .models.scene import Scene, SphereDef, TracerScene, build_tracer_scene
from .models.scenes import load_scene
from .ops.trace_ref import render_dispatch
from .runtime.renderer import ProgressiveRenderer, accumulate_step

__version__ = "0.1.0"
