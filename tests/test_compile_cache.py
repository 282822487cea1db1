"""Persistent-compile-cache plumbing tests.

The XLA compile cache (surfjax/utils/compile_cache.py) lets a process
load the large programs an earlier one compiled. These tests pin the
config plumbing (enabled by default at import, env knobs honored,
JAX_COMPILATION_CACHE_DIR taking over entirely) in subprocesses so
import-time state is exercised for real.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = (
    "import surfjax, jax, json;"
    "print(json.dumps({'dir': jax.config.jax_compilation_cache_dir}))"
)


def _run(extra_env: dict) -> dict:
    import json
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cache_on_by_default():
    res = _run({"SURFJAX_COMPILE_CACHE": ""})
    assert res["dir"] is not None
    # layout: .jax_cache/<12-hex context fingerprint> — entries from a
    # different machine/stack must never be AOT-loaded here
    parent, fp = os.path.split(res["dir"])
    assert parent.endswith(".jax_cache")
    assert len(fp) == 12 and int(fp, 16) >= 0
    assert os.path.isdir(res["dir"])  # created eagerly
    # a fixed path inside the checkout
    assert os.path.commonpath([res["dir"], REPO]) == REPO


def test_cache_env_off():
    res = _run({"SURFJAX_COMPILE_CACHE": "off"})
    assert not res["dir"]


def test_cache_env_custom_dir(tmp_path):
    custom = str(tmp_path / "cachedir")
    res = _run({"SURFJAX_COMPILE_CACHE": custom})
    # the custom root is honored but the context fingerprint still
    # applies — relocating the cache must not reintroduce cross-context
    # entry sharing
    assert os.path.dirname(res["dir"]) == custom


def test_cache_fingerprint_separates_contexts(tmp_path):
    # same root, different compile contexts (XLA_FLAGS differ) -> two
    # disjoint cache dirs, so an entry compiled under one can never be
    # deserialized under the other
    custom = str(tmp_path / "cachedir")
    res_a = _run({"SURFJAX_COMPILE_CACHE": custom,
                  "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    res_b = _run({"SURFJAX_COMPILE_CACHE": custom,
                  "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert os.path.dirname(res_a["dir"]) == custom
    assert res_a["dir"] != res_b["dir"]


def test_cache_explicit_jax_setting_wins(tmp_path):
    # JAX_COMPILATION_CACHE_DIR is used as given, and surfjax sets no
    # other directory: its own default root is never created
    custom = str(tmp_path / "jaxlevel")
    root = tmp_path / "surfjax_root"
    code = ("import surfjax, jax, json;"
            "print(json.dumps({'dir': jax.config.jax_compilation_cache_dir,"
            " 'min': jax.config.jax_persistent_cache_min_compile_time_secs"
            "}))")
    import json
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SURFJAX_COMPILE_CACHE=str(root),
               JAX_COMPILATION_CACHE_DIR=custom)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dir"] == custom
    assert res["min"] == 1.0  # JAX's own default, untouched
    assert not root.exists()
