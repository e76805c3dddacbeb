"""xraytracer — a differentiable, wavefront Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA rebuild with the capabilities of the reference
C++ renderer (neross666/xRayTracer): the reference's recursive, per-ray,
virtual-dispatch design becomes a wavefront, struct-of-arrays, fixed-depth
pipeline — rays are ``(N, 3)`` batches, the scene is a set of flat device
tables, integrators are masked ``lax`` loops, and randomness is counter-based
(pure function of pixel id) so renders are bitwise deterministic at any
device count.

Layer map (mirrors SURVEY.md §1 L0..L8):
  math/         L0 vector/matrix/optics math
  geometry/     L1+L3 ray/hit records + batched intersection sweeps
  sampling/     L2 counter-based RNG, warps, discrete distributions
  materials.py  L4 BSDF tables (Lambert/Mirror/Glass)
  lights.py     L4 delta + area light tables
  media/        L4 phase functions, homogeneous + heterogeneous media, grids
  scene/        L5 flat scene tables, OBJ loader, presets
  integrators/  L6 Normal/Direct/Indirect/GI/Whitted/VolumePT/VolumePT-NEE
  renderer.py   L7 spp-chunked wavefront execution, film
  parallel/     L7 device-mesh sharding (the ParallelRenderer analogue)
  cli.py        L8 one CLI replacing the reference's five example mains
"""

__version__ = "0.1.0"

from . import constants
from . import math  # noqa: F401
from . import sampling  # noqa: F401
from . import geometry  # noqa: F401
from . import scene  # noqa: F401
from . import materials  # noqa: F401
from . import lights  # noqa: F401
from . import media  # noqa: F401
from . import integrators  # noqa: F401
from . import renderer  # noqa: F401
from .camera import PinholeCamera
from .film import write_image

__all__ = [
    "constants", "math", "sampling", "geometry", "scene", "materials",
    "lights", "media", "integrators", "renderer", "PinholeCamera",
    "write_image", "__version__",
]
