"""Entry points refuse to report from the wrong place.

  1. ``python bench.py`` and ``python chip_smoke.py`` measure a GPU: on
     the CPU they exit non-zero without printing a result line, and
     chip_smoke.py alone in a directory (without the package) fails too;
  2. the ``dryrun_multichip`` parent path never imports jax — it re-execs
     into a forced-CPU child with the requested virtual device count.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_device_scripts_refuse_cpu(script):
    proc = subprocess.run(
        [sys.executable, script], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr, proc.stderr[-2000:]
    assert '"ok"' not in proc.stdout and '"value"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repository beside it the script has nothing to run:
    it must fail, not report success."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _graft_entry():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.remove(REPO)
    return ge


class TestDryrunHardening:
    def test_parent_path_never_imports_jax(self, monkeypatch):
        """With SURFJAX_DRYRUN_CHILD unset, dryrun_multichip must go
        straight to the subprocess re-exec — no jax touch in parent."""
        ge = _graft_entry()
        calls = []
        monkeypatch.delenv("SURFJAX_DRYRUN_CHILD", raising=False)
        monkeypatch.setattr(ge, "_dryrun_in_subprocess",
                            lambda n: calls.append(n))
        ge.dryrun_multichip(8)
        assert calls == [8]

    def test_child_env_forces_virtual_cpu_mesh(self, monkeypatch):
        """The child runs on the CPU with exactly the requested device
        count, replacing a smaller count already in XLA_FLAGS."""
        ge = _graft_entry()
        seen = {}

        class Done:
            returncode = 0

        def fake_run(cmd, env, cwd, timeout):
            seen.update(env=env, cmd=cmd)
            return Done()

        monkeypatch.setattr(subprocess, "run", fake_run)
        monkeypatch.setenv("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=2")
        ge._dryrun_in_subprocess(4)
        env = seen["env"]
        assert env["JAX_PLATFORMS"] == "cpu"
        assert env["SURFJAX_DRYRUN_CHILD"] == "1"
        assert env["XLA_FLAGS"] == "--xla_force_host_platform_device_count=4"
        assert "dryrun_multichip(4)" in seen["cmd"][-1]

    def test_dryrun_end_to_end_small(self, monkeypatch):
        """Full re-exec path with a tiny 2-device mesh (opt-in: ~40s)."""
        if not os.environ.get("SURFJAX_SLOW"):
            pytest.skip("set SURFJAX_SLOW=1 for the end-to-end dryrun")
        ge = _graft_entry()
        monkeypatch.delenv("SURFJAX_DRYRUN_CHILD", raising=False)
        ge.dryrun_multichip(2)
