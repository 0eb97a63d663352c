import math
import os

import pytest

from pointcloud_segmentation_tpu.config import PipelineConfig, default_config


def test_defaults_match_shipped_yaml():
    # config_pc_seg/config.yaml shipped values
    cfg = default_config()
    assert cfg.verbose_level == 0
    assert cfg.floor_trim_height == 0.3
    assert cfg.min_pca_coeff == 0.995
    assert cfg.min_weight == 0.01
    assert cfg.rad_2_leaf_ratio == 1.5
    assert cfg.opt_minvotes == 12
    assert cfg.granularity == 6
    assert cfg.opt_nlines == 10
    assert cfg.radius_sizes == (0.05,)


def test_derived_params():
    # node.cpp:241-243
    cfg = default_config()
    assert cfg.leaf_size == pytest.approx(0.05 / 1.5)
    assert cfg.diag_voxel == pytest.approx(math.sqrt(3) * 0.05 / 1.5)
    assert cfg.opt_dx == cfg.diag_voxel
    # reference takes min(first, last), not global min
    cfg2 = cfg.replace(radius_sizes=(0.1, 0.01, 0.2))
    assert cfg2.leaf_size == pytest.approx(0.1 / 1.5)


def test_yaml_roundtrip(tmp_path):
    cfg = default_config(granularity=4, radius_sizes=(0.1, 0.05))
    p = tmp_path / "config.yaml"
    cfg.to_yaml(str(p))
    cfg2 = PipelineConfig.from_yaml(str(p))
    assert cfg2.granularity == 4
    assert cfg2.radius_sizes == (0.1, 0.05)
    assert cfg2.opt_minvotes == cfg.opt_minvotes


def test_reference_yaml_loads():
    # the shipped reference config (carried verbatim in configs/) parses
    # with identical semantics
    cfg = PipelineConfig.from_yaml(os.path.join(
        os.path.dirname(__file__), "..", "configs", "config.yaml"))
    assert cfg.granularity == 6
    assert cfg.radius_sizes == (0.05,)
    assert cfg.opt_minvotes == 12


def test_num_x_bound():
    cfg = default_config()
    # window 3.0 m: diagonal sqrt(1.5^2 + 3^2 + 3^2) = 4.5
    assert cfg.num_x_max >= int(4.5 / cfg.opt_dx)


def test_validation():
    with pytest.raises(ValueError):
        default_config(granularity=9)
    with pytest.raises(ValueError):
        default_config(radius_sizes=())
