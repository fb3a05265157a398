"""Configuration for the PyTorch port.

`Config` holds only the fields the port reads, each with the JAX package's
flag name and default (unsupervised_detection_tpu/config.py:18-95); a later
slice adds the fields it starts to read. The TPU-only knobs (`use_pallas`,
`warp_method`, `mesh_data`, `mesh_model`) are absent: the port always runs
its CUDA kernels on a CUDA device and has no mesh, and `parse_flags` rejects
them as unknown flags. `parse_flags` accepts gflags-style arguments
(--name=value, --name value).
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

    # --- Flow scale and test-time crop ---
    flow_normalizer: float = 80.0
    test_crop: float = 0.9

    # --- Extensions of the JAX package that the port keeps ---
    compute_dtype: str = "float32"       # "bfloat16" for throughput
    # PWC internal resolution divisor (1 = reference parity at 640x384).
    flow_resolution_divisor: int = 1
    pwc_pyr_lvls: int = 6
    pwc_flow_pred_lvl: int = 2
    pwc_search_range: int = 4

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
        if name not in _FIELDS:
            raise SystemExit(f"Unknown flag: --{name}")
        if not sep:
            value = next(it, None)
            if value is None:
                raise SystemExit(f"Flag --{name} expects a value")
        caster = {"int": int, "float": float, "str": str}[_FIELDS[name].type]
        cfg[name] = caster(value)
    return Config(**cfg)
