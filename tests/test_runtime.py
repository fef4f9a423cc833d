"""Process set-up: compile cache, native build, accelerator check, and the
packages the main path may load (text2video/runtime.py, chip_smoke.py)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from text2video import runtime
from text2video.frontend import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set_is_used_as_is(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache/from/env")
    assert runtime.use_compile_cache() == "/cache/from/env"
    assert jax.config.jax_compilation_cache_dir is None  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jaxcache")
    assert runtime.use_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_native_library_rebuilds_when_sources_change(tmp_path, monkeypatch):
    # $CXX/$CC are ignored: the library must link the libstdc++ that the
    # Python process's other C++ extensions share.
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    monkeypatch.setenv("CC", "/nonexistent/cc")
    src = str(tmp_path / "native")
    shutil.copytree(os.path.join(REPO, "native"), src,
                    ignore=shutil.ignore_patterns("build"))
    lib = native.ensure_built(src)
    stamp_file = os.path.join(src, "build", "sources.sha256")
    first = os.stat(lib).st_mtime_ns
    assert open(stamp_file).read() == native.source_stamp(src)

    assert native.ensure_built(src) == lib
    assert os.stat(lib).st_mtime_ns == first  # current: no rebuild

    with open(os.path.join(src, "align", "g2p.cc"), "a") as f:
        f.write("\n// edited\n")
    native.ensure_built(src)
    assert open(stamp_file).read() == native.source_stamp(src)
    assert os.stat(lib).st_mtime_ns > first


def test_chip_smoke_refuses_cpu_only_process():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def _run_python(code: str):
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO, timeout=300,
        check=True,
    )
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_main_path_loads_only_allowed_packages():
    # As chip_smoke.py does: the allowed packages first, then the program.
    foreign = _run_python(
        "import json\n"
        "from text2video.runtime import import_allowed, foreign_modules\n"
        "allowed = import_allowed()\n"
        "import text2video.pipeline, text2video.render\n"
        "print(json.dumps(foreign_modules(allowed)))\n"
    )
    assert foreign == []
    # The main path itself needs neither the training-only nor the
    # pixel-path packages.
    direct = _run_python(
        "import json, sys\n"
        "import text2video.pipeline, text2video.render\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    for pkg in ("flax", "orbax", "cv2", "PIL"):
        assert pkg not in direct, pkg
