"""ctypes bindings of the port over the repository's native C++ solvers
(`native/densecrf/densecrf.cpp`, `native/pyflow/coarse2fine.cpp`) and its
own crc32c of TF1 bundles (`crc32c.cpp` here), each built with g++ at its
first use into the port's build directory (`_build.py`). Importing a
binding builds nothing."""
