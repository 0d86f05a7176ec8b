"""Load the reference package's JAX-free host modules without importing JAX.

`halo2_tpu.frontend` and `halo2_tpu.native` import no JAX through their
package path, so the port imports them as usual.  A few other reference
modules are JAX-free themselves but live in a package whose `__init__`
pulls JAX in (`compat/`, `msm/`, `plonk/`).  `load_ref` executes such a
module straight from its file, with `__package__` set to the reference
package so its relative imports resolve to `halo2_tpu.frontend` /
`halo2_tpu.native`, and never runs the package `__init__`.

The module is registered in `sys.modules` under its reference name (the
dataclasses in it need that), so a process that imports the reference
package as well shares the one module object.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_REF_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "halo2_tpu")


def load_ref(relpath: str):
    """Execute `halo2_tpu/<relpath>` (e.g. "compat/plonk_api.py") as a
    module of the reference package, once per process."""
    package = "halo2_tpu." + os.path.dirname(relpath).replace("/", ".")
    name = package + "." + os.path.splitext(os.path.basename(relpath))[0]
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(_REF_ROOT, relpath))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return mod


def plonk_api():
    return load_ref("compat/plonk_api.py")


def bn254_pairing():
    return load_ref("compat/bn254_pairing.py")


def pinned():
    return load_ref("compat/pinned.py")


def host_msm():
    return load_ref("msm/host_msm.py")


def errors():
    return load_ref("plonk/errors.py")
