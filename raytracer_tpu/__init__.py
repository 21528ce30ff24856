"""raytracer_tpu — a differentiable wavefront ray tracer for the GPU.

Brand-new JAX/XLA/Pallas implementation of the capabilities of
bitfrozen/rendering-algorithms-raytracer (a CPU/SSE Miro-style C++ tracer):
binned-SAH BVH (host build, device traversal), Moller-Trumbore intersection,
Lambert/Blinn shading with Fresnel reflection/refraction/dispersion,
point/rectangle/HDR-dome lights with importance sampling, texture maps
(color/alpha/normal/specular), motion blur, two-level instancing, adaptive
supersampling — re-architected as a differentiable wavefront path tracer
sharded over device meshes.
"""

from .core.types import (Camera, RenderSettings, Scene, MAT_BLINN,
                         MAT_LAMBERT)
from .geometry.build import SceneBuilder
from .render.renderer import render, render_adaptive, render_center, to_u8

__version__ = '0.1.0'
