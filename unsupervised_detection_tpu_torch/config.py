"""Configuration for the PyTorch port.

`Config` holds only the fields the port reads, each with the JAX package's
flag name and default (unsupervised_detection_tpu/config.py:18-95); a later
slice adds the fields it starts to read. The TPU-only knobs (`use_pallas`,
`warp_method`, `mesh_data`, `mesh_model`) are absent: the port always runs
its CUDA kernels on a CUDA device and has no mesh, and `parse_flags` rejects
them as unknown flags. `parse_flags` accepts gflags-style arguments
(--name=value, --name value, --bool/--nobool), as the JAX parser does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # --- Sizes and batch ---
    img_width: int = 384
    img_height: int = 192
    batch_size: int = 16
    reader_height: int = 384
    reader_width: int = 640
    max_temporal_len: int = 2
    min_temporal_len: int = 1
    num_threads: int = 6

    # --- Paths ---
    root_dir: str = "/your/path/to/DAVIS_2016"
    dataset: str = "DAVIS2016"

    # --- Flow scale and testing ---
    flow_normalizer: float = 80.0
    generate_visualization: bool = False
    test_crop: float = 0.9
    test_temporal_shift: int = 1
    ckpt_file: str = ""
    test_partition: str = "val"
    test_save_dir: str = ""

    # --- Extensions of the JAX package that the port keeps ---
    compute_dtype: str = "float32"       # "bfloat16" for throughput
    # PWC internal resolution divisor (1 = reference parity at 640x384).
    flow_resolution_divisor: int = 1
    pwc_pyr_lvls: int = 6
    pwc_flow_pred_lvl: int = 2
    pwc_search_range: int = 4
    # accepted for the JAX CLI's flag surface; evaluation reads no seed (the
    # JAX CLI seeds only a state that the checkpoint restore overwrites)
    seed: int = 8964

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def parse_flags(argv, base: Optional[Config] = None) -> Config:
    """Parse gflags-style argv (excluding argv[0]) into a Config."""
    cfg = dataclasses.asdict(base or Config())
    it = iter(argv)
    for raw in it:
        if not raw.startswith("--"):
            raise SystemExit(f"Unrecognized argument: {raw!r}")
        name, sep, value = raw[2:].partition("=")
        # gflags boolean negation: --nogenerate_visualization
        if name.startswith("no") and name[2:] in _FIELDS and _FIELDS[name[2:]].type == "bool":
            cfg[name[2:]] = False
            continue
        if name not in _FIELDS:
            raise SystemExit(f"Unknown flag: --{name}")
        if _FIELDS[name].type == "bool":
            cfg[name] = not sep or value.lower() in ("1", "true", "t", "yes", "y")
            continue
        if not sep:
            value = next(it, None)
            if value is None:
                raise SystemExit(f"Flag --{name} expects a value")
        caster = {"int": int, "float": float, "str": str}[_FIELDS[name].type]
        cfg[name] = caster(value)
    return Config(**cfg)
