"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; all sharding tests use
`--xla_force_host_platform_device_count=8` as the stand-in backend.
Must run before the first `import jax` anywhere in the test session.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# Silence benign XLA:CPU AOT cache-load E-lines (machine-feature tuning
# hints); must be set before the XLA C++ library loads.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
# Legacy Keras restores tf.compat.v1.layers (Keras 3 removed it), which the
# reference-oracle tests need to build the reference's actual TF1 graphs.
# Must be set before the first tensorflow import in the process.
os.environ.setdefault("TF_USE_LEGACY_KERAS", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The installed TPU plugin overrides JAX_PLATFORMS at import time; force the
# CPU backend explicitly so the virtual 8-device mesh is used.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: PWC-sized programs take minutes to compile
# cold on this 1-core host; caching amortizes them across test runs.
jax.config.update("jax_compilation_cache_dir",
                  os.path.expanduser("~/.cache/jax_compilation"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA device (the PyTorch port's kernels); "
                   "skipped without one")
