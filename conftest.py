"""Set-up shared by the whole test suite.

``swnerf_tpu/native/searchsorted.py`` compiles its C++ library with g++ on
first use, straight into ``swnerf_tpu/native/build/``, and treats any file
there that is newer than the source as built. Under pytest-xdist every
worker imports ``tests/test_native.py`` while it collects, and that import
builds the library when it is missing: a worker that opens the library
while another worker's linker is still writing it gets an ``OSError``,
``native_available()`` returns False, and the module's 33 tests skip.

So the controlling process builds the library once, before any worker
starts; the workers then find it complete. The module is loaded by path so
that ``swnerf_tpu`` (and with it JAX) is not imported before
``tests/conftest.py`` sets ``XLA_FLAGS``. Without g++ nothing is built and
the tests skip as before.
"""

import importlib.util
import os
import subprocess


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller has built it
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "swnerf_tpu", "native", "searchsorted.py")
    spec = importlib.util.spec_from_file_location("_swnerf_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    try:
        module._build_lib()
    except (OSError, subprocess.CalledProcessError):
        pass  # no toolchain: tests/test_native.py skips, as it always has
