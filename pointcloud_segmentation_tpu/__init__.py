"""Accelerator-native point-cloud segmentation framework.

A from-scratch JAX/XLA rebuild of the capabilities of
DJacquemont/pointcloud_segmentation: streaming ToF point clouds -> persistent
3D wireframe map of steel structures (window/voxel pre-processing, iterative
3D Hough line extraction, PCA gating, drone->world transform, weighted
segment fusion, pairwise intersections), with reference-compatible YAML
config and CSV outputs.
"""

from ._malloc import cap_malloc_arenas as _cap_malloc_arenas
from .config import PipelineConfig, StaticShapes, default_config, NUM_DIRECTIONS

# Apply before anything (jax, XLA thread pools) can create extra arenas —
# late application still plateaus but ramps first (see _malloc.py).
_cap_malloc_arenas()

__version__ = "0.1.0"

_LAZY = {
    # jax-importing entry points, loaded on first use so the numpy-only
    # oracle/config/io surface stays importable without initializing jax
    "SegmentationEngine": ("pointcloud_segmentation_tpu.runtime.engine",
                           "SegmentationEngine"),
    "process_frame": ("pointcloud_segmentation_tpu.pipeline", "process_frame"),
    "make_process_frame": ("pointcloud_segmentation_tpu.pipeline",
                           "make_process_frame"),
    "init_world": ("pointcloud_segmentation_tpu.pipeline", "init_world"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PipelineConfig",
    "StaticShapes",
    "default_config",
    "NUM_DIRECTIONS",
    "SegmentationEngine",
    "process_frame",
    "make_process_frame",
    "init_world",
    "__version__",
]
