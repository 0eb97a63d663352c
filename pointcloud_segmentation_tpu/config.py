"""Configuration for the compiled point-cloud segmentation pipeline.

Key-for-key compatible with the reference node's ``config_pc_seg/config.yaml``
(reference: config_pc_seg/config.yaml:1-35, loaded at
src/pointcloud_segmentation_node.cpp:181-258).  Derived parameters follow
node.cpp:241-243:

    leaf_size  = min(radius_sizes[0], radius_sizes[-1]) / rad_2_leaf_ratio
    diag_voxel = sqrt(3) * leaf_size
    opt_dx     = sqrt(3) * leaf_size

On top of the reference keys, :class:`StaticShapes` pins the fixed capacities
the XLA-compiled path needs (everything under ``jit`` is traced once with
static shapes; dynamic point/segment counts are carried as validity masks).
"""

from __future__ import annotations

import dataclasses
import math

# Direction counts per granularity level of the tessellated-icosahedron
# direction discretization (reference: hough_3d_lines.h:192).
NUM_DIRECTIONS = (12, 21, 81, 321, 1281, 5121, 20481)

# Side length of the pre-processing crop window in metres
# (reference: node.cpp:25 `WINDOW_FILTERING_SIZE`).
WINDOW_FILTERING_SIZE = 3.0

# Verbosity levels (reference: node.cpp:23 `enum verbose {NONE, INFO, WARN}`).
VERBOSE_NONE, VERBOSE_INFO, VERBOSE_WARN = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class StaticShapes:
    """Fixed capacities for the jit-compiled device pipeline.

    The reference's dynamically sized ``std::vector`` state becomes
    fixed-capacity padded arrays + validity masks so a single compiled XLA
    program serves every frame.
    """

    max_raw_points: int = 8192     # capacity of the raw ToF cloud buffer
    max_points: int = 4096         # capacity after window crop + voxel grid
    max_world_segments: int = 64   # capacity of the persistent world map
    max_iters: int = 24            # hard bound on Hough extraction iterations
                                   # (used when opt_nlines == 0, which the
                                   # reference runs unbounded)

    def __post_init__(self):
        if self.max_raw_points <= 0 or self.max_points <= 0:
            raise ValueError("point capacities must be positive")
        if self.max_world_segments <= 0 or self.max_iters <= 0:
            raise ValueError("segment/iteration capacities must be positive")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full pipeline configuration (reference-compatible keys + capacities)."""

    # --- reference config.yaml keys (identical names & semantics) ---
    verbose_level: int = 0
    path_to_output: str = "."
    floor_trim_height: float = 0.3
    min_pca_coeff: float = 0.995
    min_weight: float = 0.01
    rad_2_leaf_ratio: float = 1.5
    opt_minvotes: int = 12
    granularity: int = 6
    opt_nlines: int = 10
    radius_sizes: tuple = (0.05,)

    # --- compiled-pipeline additions ---
    shapes: StaticShapes = dataclasses.field(default_factory=StaticShapes)
    window_size: float = WINDOW_FILTERING_SIZE
    # Parity mode: "float64" runs the device pipeline in f64 (requires
    # jax_enable_x64; GPUs with native FP64 such as the H100 run it on the
    # card), keeping the oracle's deliberate f32 stages (vote binning, cell
    # decode, scatter eigensolves — reference h:129 MatrixXf) pinned to
    # f32.  The perf default is full-f32.
    compute_dtype: str = "float32"
    # Voting accumulator strategy (ops/hough.py): "carry" keeps the exact
    # (B, num_x, num_x) histogram on device (the reference's Hough
    # add/subtract); "lazy" keeps only (best, key, bound) per direction —
    # O(B) state, the histogram never materializes — and re-examines the
    # few directions whose bound could beat the global max.  None = auto:
    # lazy when the carry would exceed 48 MB (granularity 6 / small-radius
    # configs, where the carry is 0.5-5+ GB), carry otherwise.  The 48 MB
    # threshold was tuned before the move to the GPU and awaits a sweep
    # there.
    voting: str | None = None
    # Accuracy extension (opt-in, beyond the reference): compensate the
    # report's §6.3 "Ground Truth Offset" — ToF returns lie on the beam
    # SURFACE facing the sensor, so every fitted axis is biased toward the
    # sensor by ~one beam radius.  When True, each accepted frame segment's
    # axis is shifted by its matched radius along the sensor->line
    # perpendicular (drone frame, pre-fusion).  Default False = reference
    # behavior (documented deviation E-OFFSET in README.md).
    surface_offset_correction: bool = False

    def __post_init__(self):
        object.__setattr__(self, "radius_sizes", tuple(float(r) for r in self.radius_sizes))
        if not self.radius_sizes:
            raise ValueError("radius_sizes must be non-empty")
        if not 0 <= self.granularity <= 6:
            raise ValueError("granularity must be in [0, 6]")
        if self.rad_2_leaf_ratio <= 0:
            raise ValueError("rad_2_leaf_ratio must be positive")
        if self.compute_dtype not in ("float32", "float64"):
            raise ValueError("compute_dtype must be 'float32' or 'float64'")
        if self.voting not in (None, "carry", "lazy"):
            raise ValueError("voting must be None, 'carry' or 'lazy'")

    # Derived parameters (reference: node.cpp:241-243).  Note the reference
    # takes min(first, last) of radius_sizes, not the global min — reproduced.
    @property
    def leaf_size(self) -> float:
        return min(self.radius_sizes[0], self.radius_sizes[-1]) / self.rad_2_leaf_ratio

    @property
    def diag_voxel(self) -> float:
        return math.sqrt(3.0) * self.leaf_size

    @property
    def opt_dx(self) -> float:
        return math.sqrt(3.0) * self.leaf_size

    @property
    def num_directions(self) -> int:
        return NUM_DIRECTIONS[self.granularity]

    @property
    def voting_mode(self) -> str:
        """Resolved voting strategy ("carry" or "lazy"); see `voting`."""
        if self.voting in ("carry", "lazy"):
            return self.voting
        carry_bytes = self.num_directions * self.num_x_max ** 2 * 4
        return "lazy" if carry_bytes > 48 * 2 ** 20 else "carry"

    @property
    def max_lines(self) -> int:
        """Static bound on Hough iterations / per-frame output segments."""
        if self.opt_nlines > 0:
            return self.opt_nlines
        return self.shapes.max_iters

    @property
    def num_x_max(self) -> int:
        """Static upper bound on the accumulator's x'/y' bin count.

        The dynamic bin count is num_x = floor(d / opt_dx + 0.5) where d is
        the cloud's bbox diagonal (reference: hough_3d_lines.h:214).  After
        the window crop the diagonal is bounded by the crop box diagonal,
        so a static worst case exists.
        """
        half = self.window_size / 2.0
        d_max = math.sqrt(half * half + self.window_size**2 * 2.0)
        return int(math.floor(d_max / self.opt_dx + 0.5)) + 1

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    # --- YAML round-trip with reference-identical schema ---
    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "PipelineConfig":
        with open(path) as f:
            raw = read_flat_yaml(f.read())
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, **overrides) -> "PipelineConfig":
        # Same defaulting behaviour as the reference param loader
        # (node.cpp:181-239): every missing key falls back to a default.
        kw = {}
        for key in ("verbose_level", "path_to_output", "floor_trim_height",
                    "min_pca_coeff", "min_weight", "rad_2_leaf_ratio",
                    "opt_minvotes", "granularity", "opt_nlines"):
            if key in raw:
                kw[key] = raw[key]
        if "radius_sizes" in raw:
            kw["radius_sizes"] = tuple(float(r) for r in raw["radius_sizes"])
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> dict:
        return {
            "verbose_level": self.verbose_level,
            "path_to_output": self.path_to_output,
            "floor_trim_height": self.floor_trim_height,
            "min_pca_coeff": self.min_pca_coeff,
            "min_weight": self.min_weight,
            "rad_2_leaf_ratio": self.rad_2_leaf_ratio,
            "opt_minvotes": self.opt_minvotes,
            "granularity": self.granularity,
            "opt_nlines": self.opt_nlines,
            "radius_sizes": list(self.radius_sizes),
        }

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(write_flat_yaml(self.to_dict()))


# --- the reference's flat YAML schema (configs/config.yaml) -------------
# Top-level `key: scalar` lines and `key:` followed by `- scalar` block-list
# items; `#` comments and blank lines are ignored.  Scalars resolve like
# YAML 1.1's core types as used by the reference: int, float, bool, null,
# else string (quotes stripped).  Anything else (nesting, flow collections,
# anchors) is rejected rather than guessed at.

_YAML_TRUE = ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")
_YAML_FALSE = ("false", "False", "FALSE", "no", "No", "NO", "off", "Off",
               "OFF")
_YAML_NULL = ("", "~", "null", "Null", "NULL")


def _parse_scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if tok in _YAML_NULL:
        return None
    if tok in _YAML_TRUE:
        return True
    if tok in _YAML_FALSE:
        return False
    if tok[:1] in "[{&*!|>":
        raise ValueError(f"unsupported YAML value {tok!r}")
    try:
        return int(tok)
    except ValueError:
        pass
    # YAML 1.1 floats need a '.' in the mantissa ("1e-5" stays a string)
    mant = tok.lower().split("e")[0]
    if "." in mant:
        try:
            return float(tok)
        except ValueError:
            pass
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_flat_yaml(text: str) -> dict:
    """Parse the reference config's flat YAML subset into a dict."""
    out: dict = {}
    list_key = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        body = line.lstrip()
        if body.startswith("- ") or body == "-":
            if list_key is None:
                raise ValueError(f"line {n}: list item outside a list key")
            out[list_key].append(_parse_scalar(body[1:]))
            continue
        if line[0] in " \t":
            raise ValueError(f"line {n}: nested YAML is not supported")
        key, sep, val = line.partition(":")
        if not sep or not key.strip():
            raise ValueError(f"line {n}: expected 'key: value'")
        key = key.strip()
        if val.strip():
            out[key] = _parse_scalar(val)
            list_key = None
        else:
            out[key] = []
            list_key = key
    # a bare `key:` with no items is YAML null
    return {k: (None if v == [] else v) for k, v in out.items()}


def _format_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        s = repr(v)
        mant, e, exp = s.partition("e")
        if e and "." not in mant:   # keep it a float for YAML 1.1 readers
            s = f"{mant}.0e{exp}"
        return s
    s = str(v)
    if _parse_scalar(s) != s or s != s.strip() or ": " in s or "#" in s:
        return "'" + s.replace("'", "''") + "'"
    return s


def write_flat_yaml(d: dict) -> str:
    """Inverse of read_flat_yaml (lists as `- item` blocks, key order kept)."""
    lines = []
    for k, v in d.items():
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:")
            lines.extend(f"- {_format_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_format_scalar(v)}")
    return "\n".join(lines) + "\n"


def default_config(**overrides) -> PipelineConfig:
    """The shipped reference configuration (config_pc_seg/config.yaml)."""
    return PipelineConfig(**overrides)
