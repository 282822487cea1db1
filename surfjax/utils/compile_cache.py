"""Persistent XLA compilation cache (SURVEY.md §5.6 config system).

A process that renders compiles large programs first (the fused frame
kernel, the jnp march loops); JAX's persistent cache
(``jax_compilation_cache_dir``) lets a later process load them instead.
Entries are keyed on the serialized HLO + compile options + platform, so
code or flag changes miss cleanly and recompile; a hit replays the exact
executable XLA produced.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX uses that directory and this
  module sets nothing (no other directory, no other cache option).
- otherwise ``<checkout>/.jax_cache/<fingerprint>`` (gitignored), a
  fixed path, so one checkout finds its own entries again.

Why the ``<fingerprint>`` subdirectory: JAX's cache key does not include
the host CPU's target features, so an XLA:CPU entry written on another
machine (the test suite's interpret-mode kernels run on XLA:CPU) would be
loaded blind; and on a GPU the key names the platform but not the card
model, so entries built for one card generation must not be replayed on
another. The fingerprint hashes the machine's CPU flags, the jax/jaxlib
build, XLA_FLAGS, JAX_PLATFORMS and the CUDA-visible device selection;
same-context replays still hit.

Env knob: ``SURFJAX_COMPILE_CACHE`` — a directory path overrides the
default root (the fingerprint subdir still applies); ``0``/``off``/
``none`` disables the cache entirely.
"""

from __future__ import annotations

import os

_ENABLED: bool | None = None


def context_fingerprint() -> str:
    """12-hex digest of everything that changes what an XLA compile
    produces but is NOT in JAX's cache key (module docstring)."""
    import hashlib
    import platform

    parts = [platform.machine()]
    try:
        import jax
        import jaxlib
        parts += [jax.__version__, jaxlib.__version__,
                  os.path.dirname(jax.__file__)]
    except Exception:  # pragma: no cover - jax always importable here
        parts.append("no-jax")
    for var in ("XLA_FLAGS", "JAX_PLATFORMS", "CUDA_VISIBLE_DEVICES"):
        parts.append(os.environ.get(var, ""))
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    parts.append(line.strip())
                    break
    except OSError:  # pragma: no cover - non-/proc platforms
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def enable_persistent_cache() -> bool:
    """Idempotently point JAX at the persistent compile cache.

    Returns True when the cache is active. Called from
    ``surfjax/__init__`` so every entry point shares one cache; safe
    before or after backend initialization (JAX reads the config per
    compile call).
    """
    global _ENABLED
    if _ENABLED is not None:
        return _ENABLED
    knob = os.environ.get("SURFJAX_COMPILE_CACHE", "")
    if knob.lower() in ("0", "off", "none", "disable", "disabled"):
        _ENABLED = False
        return False
    import jax

    # an explicit JAX-level setting wins untouched: JAX_COMPILATION_CACHE_DIR
    # or jax.config set before `import surfjax`
    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir):
        _ENABLED = True
        return True
    root = knob or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")
    cache_dir = os.path.join(root, context_fingerprint())
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:  # read-only checkout: run without the cache
        import sys
        print(f"surfjax: persistent compile cache disabled ({e})",
              file=sys.stderr)
        _ENABLED = False
        return False
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache anything that took >=0.5 s to compile (the default 1.0 s
    # would skip many of the suite's small CPU kernels; going lower
    # bloats the dir with trivial entries)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _ENABLED = True
    return True
