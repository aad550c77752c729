"""project3_cuda_path_tracer_tpu_torch — the path tracer in PyTorch and CUDA.

The port of project3_cuda_path_tracer_tpu (the JAX package beside it, which
stays the reference) to PyTorch with hand-written CUDA kernels for NVIDIA
Hopper. It imports torch and never jax.

Quick start:
    from project3_cuda_path_tracer_tpu_torch import load_scene, Renderer
    r = Renderer(load_scene("scenes/cornell.txt"), device="cuda")
    r.render(100)
    r.save("cornell")
"""
from .scene.parser import load_scene  # noqa: F401
from .scene import types as scene_types  # noqa: F401
from .render.integrator import Renderer, render_samples  # noqa: F401

__version__ = "0.1.0"
