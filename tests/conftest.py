"""Test configuration: the CPU backend with 8 virtual devices.

Per SURVEY.md §5 the sharded paths (shard_map block tables, halo exchange,
Schur psum) are exercised on a virtual 8-device CPU mesh — ``shard_map`` is
backend-agnostic, so this is the same code path as on the GPUs of a host.

Tests run on the CPU (`JAX_PLATFORMS=cpu`, the default here).  Tests that
need the card carry the `gpu` marker and skip without one; on the card run
them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# NO persistent compile cache for tests: XLA:CPU executables reloaded from
# the cache are tied to the compiling host's CPU features, and reloading
# entries written under other features has crashed jaxlib mid-suite.
# In-memory (per-process) jit caching is unaffected.
