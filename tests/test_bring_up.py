"""Device tagging, the compile-cache location, the flat YAML config reader
and the native library's build key: the plumbing that places a run on the
GPU and makes it reproducible from the committed files alone."""

import importlib
import os
import sys

import numpy as np
import pytest

from pointcloud_segmentation_tpu import compile_cache, devices
from pointcloud_segmentation_tpu.config import (
    PipelineConfig, StaticShapes, read_flat_yaml, write_flat_yaml)
from pointcloud_segmentation_tpu.native import build as native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_YAML = os.path.join(ROOT, "configs", "config.yaml")


# ---------------------------------------------------------------- devices

def test_device_tag_names_the_cpu_backend(monkeypatch):
    monkeypatch.setattr(devices, "NVIDIA_SMI_QUERY", ("/nonexistent/smi",))
    tag = devices.device_tag()
    assert tag["platform"] == "cpu"
    assert tag["count"] == 8                  # tests/conftest.py's mesh
    assert isinstance(tag["kind"], str) and tag["kind"]
    assert tag["gpu"] == []                   # no nvidia-smi -> no cards


def test_require_gpu_refuses_cpu():
    with pytest.raises(devices.NoGpuError, match="needs a GPU"):
        devices.require_gpu()


def test_bench_refuses_cpu_without_a_result(capsys):
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    assert bench.main() == 1
    assert capsys.readouterr().out == ""      # no result line printed


# ---------------------------------------------------------------- cache

def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []                        # JAX reads the env itself


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    import jax

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_compile_cache_path_stable_across_cwd_and_reload(monkeypatch,
                                                         tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    monkeypatch.chdir(tmp_path)
    again = importlib.reload(compile_cache).compile_cache_dir()
    assert first == again == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_off_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.enable_compile_cache() is None


# ---------------------------------------------------------------- YAML

def _generated_configs():
    return [
        PipelineConfig(),
        PipelineConfig(radius_sizes=(0.05, 0.1), granularity=4,
                       path_to_output="./out dir"),
        PipelineConfig(min_weight=1e-5, rad_2_leaf_ratio=2.0,
                       opt_nlines=0, verbose_level=2),
        PipelineConfig(radius_sizes=(0.012, 0.03, 1.5e-4),
                       path_to_output="'quoted' # not a comment"),
        PipelineConfig(floor_trim_height=-0.25, path_to_output="true"),
    ]


def test_flat_yaml_reads_carried_config_like_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = open(CONFIG_YAML).read()
    assert read_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("idx", range(5))
@pytest.mark.parametrize("writer", ["flat", "pyyaml"])
def test_flat_yaml_matches_pyyaml_on_generated(idx, writer):
    yaml = pytest.importorskip("yaml")
    d = _generated_configs()[idx].to_dict()
    text = (write_flat_yaml(d) if writer == "flat"
            else yaml.safe_dump(d, sort_keys=False))
    assert read_flat_yaml(text) == yaml.safe_load(text) == d


def test_flat_yaml_comments_and_rejections():
    assert read_flat_yaml("# c\na: 1  # trailing\nb:\n- 2\n- x\n") == \
        {"a": 1, "b": [2, "x"]}
    for bad in ("a:\n  b: 1\n", "- 1\n", "a: [1, 2]\n", "novalue\n"):
        with pytest.raises(ValueError):
            read_flat_yaml(bad)


# ---------------------------------------------------------------- native

def test_native_library_name_keyed_by_source_hash(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    n1 = native_build.library_name(str(src))
    assert n1 == native_build.library_name(str(src))
    assert n1.startswith("libpcs_runtime-") and n1.endswith(".so")
    os.utime(src, (0, 0))                     # mtime plays no part
    assert native_build.library_name(str(src)) == n1
    src.write_text("int f() { return 2; }\n")
    assert native_build.library_name(str(src)) != n1


def test_native_library_built_from_committed_source():
    path = native_build.library_path()
    assert path is not None
    src = os.path.join(ROOT, "native", "pcs_runtime.cpp")
    assert os.path.basename(path) == native_build.library_name(src)
    assert os.path.dirname(path) == os.path.join(ROOT, "build")
