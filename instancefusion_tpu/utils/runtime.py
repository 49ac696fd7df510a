"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py).

Nothing here runs at package import: each entry point calls `setup` once,
before its first computation.
"""

from __future__ import annotations

import os
import pathlib

# The checkout root (the directory holding the `instancefusion_tpu` package).
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache across processes.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is left
    alone; otherwise the cache goes to a fixed `<checkout>/.jax_cache` (the
    path is part of the cache key, so it must not move).  Returns the
    directory in use.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def setup(platform: str | None = None):
    """Select the platform, enable the compile cache, return device 0.

    With no `platform` the run needs a GPU and raises `RuntimeError` when
    JAX finds none, instead of silently running on the CPU.  `platform`
    (e.g. "cpu") selects that platform explicitly.  The persistent cache
    is enabled for GPU runs only: XLA:CPU executables reloaded from it are
    tied to the compiling host's CPU features.
    """
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    dev = jax.devices()[0]
    if dev.platform == "gpu":
        enable_compile_cache()
    elif not platform:
        raise RuntimeError(
            f"no GPU found (JAX platform {dev.platform!r}); pass "
            "--platform cpu to run on the CPU"
        )
    return dev
