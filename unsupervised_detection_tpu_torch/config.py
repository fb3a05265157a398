"""Configuration for the PyTorch port.

`Config` holds only the fields the port reads, each with the JAX package's
flag name and default (unsupervised_detection_tpu/config.py:18-95). The
TPU-only knobs (`use_pallas`, `warp_method`) are absent: the port always
runs its CUDA kernels on a CUDA device, and `parse_flags` refuses them.
`mesh_data` and `mesh_model` shape the mesh of a run under torchrun
(parallel/mesh.py). `parse_flags` accepts
gflags-style arguments (--name=value, --name value, --bool/--nobool), as
the JAX parser does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # --- Train parameters (reference common_flags.py:5-25) ---
    img_width: int = 384
    img_height: int = 192
    batch_size: int = 16
    beta1: float = 0.9
    max_epochs: int = 40
    num_samples_train: int = 5000
    train_crop: float = 0.9
    reader_height: int = 384
    reader_width: int = 640
    max_temporal_len: int = 2
    min_temporal_len: int = 1
    cbn: float = 0.5
    epsilon: float = 75.0
    iters_rec: int = 1
    iters_gen: int = 3
    num_threads: int = 6
    resume_train: bool = False

    # --- Paths ---
    root_dir: str = "/your/path/to/DAVIS_2016"
    train_partition: str = "trainval"
    dataset: str = "DAVIS2016"
    recover_ckpt: str = ""
    flow_ckpt: str = ""
    full_model_ckpt: str = ""
    checkpoint_dir: str = ""

    # --- Log parameters ---
    summary_freq: int = 30
    save_freq: int = 5

    # --- Flow scale and testing ---
    flow_normalizer: float = 80.0
    generate_visualization: bool = False
    test_crop: float = 0.9
    test_temporal_shift: int = 1
    ckpt_file: str = ""
    test_partition: str = "val"
    test_save_dir: str = ""

    # --- Extensions of the JAX package that the port keeps ---
    learning_rate: float = 1e-4
    adam_epsilon: float = 1e-8
    # one Adam bias-correction step shared by both players, as the
    # reference's single AdamOptimizer (train/optim.py)
    adam_shared_step: bool = True
    gradient_clip: float = 0.2
    grad_noise_threshold: float = 1e-5
    compute_dtype: str = "float32"       # "bfloat16" for throughput
    # PWC internal resolution divisor (1 = reference parity at 640x384).
    flow_resolution_divisor: int = 1
    pwc_pyr_lvls: int = 6
    pwc_flow_pred_lvl: int = 2
    pwc_search_range: int = 4
    # training against a random PWC net needs this explicitly
    allow_random_flow: bool = False
    # seeds the train pipeline's shuffle and the torch.Generator of the
    # augmentation and gradient-noise draws; evaluation reads no seed
    seed: int = 8964
    debug_nans: bool = False             # raise on a non-finite loss
    # the (data, model) mesh over torchrun's processes (parallel/mesh.py)
    mesh_data: int = 0                   # 0 = every rank on the data axis
    mesh_model: int = 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}
# flags of the JAX package that select TPU machinery the port does not have
_TPU_ONLY = {
    "use_pallas": "the port always runs its CUDA kernels on a CUDA device",
    "warp_method": "the port has one warp, its CUDA kernel",
}


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
        if name in _TPU_ONLY:
            raise SystemExit(f"Unsupported flag: --{name} ({_TPU_ONLY[name]})")
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
