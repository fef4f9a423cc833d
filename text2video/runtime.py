"""Process set-up shared by the entry points (CLI, ``bench.py``,
``chip_smoke.py``): the persistent compile cache, the accelerator check,
the card's identity, and the rule for which third-party packages the
program may load.

Nothing here runs at import; entry points call these functions.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import sysconfig
from typing import List, Set

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What the program may import beside the standard library: JAX and the
# packages installed on every machine it runs on, plus cv2, which the GPU
# machine also has (opencv-python-headless) and which serves the
# host-side rasterizer and the non-streamed mux paths. A module counts as
# theirs when importing them loads it (their own dependencies and
# plugins) or when it lives inside their package directories. scipy.io
# and scipy.signal are the scipy modules the program uses.
ALLOWED_IMPORTS = (
    "jax", "jax.numpy", "numpy", "scipy", "scipy.io", "scipy.signal",
    "optax", "chex", "einops", "pytest", "hypothesis", "cv2",
)


def use_compile_cache() -> str:
    """Keep JAX's persistent compilation cache at a fixed path.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache is ``<checkout>/.jaxcache``
    (the path is part of the cache key, so it must not move).
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jaxcache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first JAX device if it is a GPU; otherwise SystemExit(2).

    Measurement and smoke paths never fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); refusing to run on it",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line.

    nvidia-smi does not touch JAX, so it can run beside a process that
    holds the card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip()


def import_allowed() -> Set[str]:
    """Import ALLOWED_IMPORTS (skipping any that are not installed) and
    return the top-level modules loaded so far. Call it before importing
    the program: what it loads belongs to the allowed packages."""
    for name in ALLOWED_IMPORTS:
        try:
            importlib.import_module(name)
        except ImportError:
            pass
    return {k.split(".")[0] for k in list(sys.modules)}


def _is_stdlib_or_own(top: str) -> bool:
    if top in sys.stdlib_module_names or top.startswith("__"):
        return True
    path = getattr(sys.modules.get(top), "__file__", None)
    if not path:
        return True  # builtin or namespace package
    path = os.path.abspath(path)
    stdlib = os.path.abspath(sysconfig.get_paths()["stdlib"]) + os.sep
    return path.startswith(stdlib) or path.startswith(REPO_ROOT + os.sep)


def third_party_modules() -> List[str]:
    """Loaded top-level modules that are neither standard library nor
    this checkout's own."""
    tops = sorted({n.split(".")[0] for n in list(sys.modules)})
    return [t for t in tops if not _is_stdlib_or_own(t)]


def foreign_modules(allowed: Set[str]) -> List[str]:
    """Loaded third-party top-level modules outside ``allowed`` (from
    :func:`import_allowed`) and outside its packages' directories."""
    dirs = []
    for top in allowed:
        path = getattr(sys.modules.get(top), "__file__", None)
        if path and os.path.basename(path) == "__init__.py":
            dirs.append(os.path.dirname(os.path.abspath(path)) + os.sep)
    out = []
    for top in third_party_modules():
        if top in allowed:
            continue
        path = os.path.abspath(sys.modules[top].__file__)
        if not any(path.startswith(d) for d in dirs):
            out.append(top)
    return out
