"""Process-environment helpers: virtual CPU devices and the compile cache."""

from __future__ import annotations

import os
from typing import Dict, Optional

# <repo root>/.jax_cache — a fixed path: the cache is keyed by the
# directory, so a per-process or time-stamped path would never hit
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def virtual_cpu_env(n_devices: int,
                    base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A subprocess env that exposes ``n_devices`` virtual CPU devices
    (the CPU tests' meshes and ``scripts/bench_scaling.py``)."""
    env = dict(os.environ if base is None else base)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that
    directory and nothing is overridden. Otherwise the cache goes to
    ``<repo root>/.jax_cache`` (git-ignored). Compiled executables are
    then reused across processes: a restarted server or a repeated
    training run skips its cold compiles. Call before the first compile.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    # cache even fast compiles: restart latency is dominated by the many
    # small executables around the hot step, not just the big one
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return path
