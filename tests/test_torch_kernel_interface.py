"""The ctypes declarations of the port's kernel library against its C sources.

Every `extern "C" int udt_*(...)` in `csrc/*.cu` must be declared by
`ops/_build.py::_declare` with the same argument list: `c_void_p` for each
pointer (the stream included), `c_int` for each int, and an `int` result.
A declaration that falls behind a changed signature would pass a 64-bit
pointer as a 32-bit int, or shift every later argument, with no error.
Runs on the CPU: no nvcc, no card, no library.
"""

import ctypes
import glob
import os
import re
import types

import pytest

from unsupervised_detection_tpu_torch.ops import _build

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(udt_\w+)\s*\(([^)]*)\)', re.S)


def _c_signatures() -> dict:
    """{name: [ctypes type per argument]} of every int-returning udt_*."""
    sigs = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for name, args in _EXTERN.findall(src):
            types_ = []
            for arg in args.split(","):
                decl = " ".join(arg.split())
                if "*" in decl:
                    types_.append(ctypes.c_void_p)
                elif re.fullmatch(r"(const )?int \w+", decl):
                    types_.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{name}: argument {decl!r} is neither a pointer "
                                         "nor an int")
            sigs[name] = types_
    return sigs


class _StandIn:
    """Takes the attributes `_declare` sets, in place of a loaded library."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_parser_reads_every_source():
    sigs = _c_signatures()
    assert {"udt_cost_volume", "udt_warp", "udt_cost_volume_backward", "udt_warp_backward",
            "udt_dynamic_copy"} <= set(sigs)


@pytest.mark.parametrize("name", sorted(_c_signatures()))
def test_declared_arguments_match_the_source(name):
    lib = _StandIn()
    _build._declare(lib)
    declared = getattr(lib, name)
    assert list(declared.argtypes) == _c_signatures()[name]
    assert declared.restype is ctypes.c_int
