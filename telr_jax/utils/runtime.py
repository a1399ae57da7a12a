"""Process-level JAX setup shared by every entry point: the platform
switch and the persistent compile cache."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_platform() -> str:
    """The JAX platform the program runs on: "gpu" (device path) or "cpu"
    (host engine).  Any other platform is an error."""
    import jax
    platform = jax.devices()[0].platform
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: telr_jax runs its "
            "device path on an NVIDIA GPU and its host engine on the CPU")
    return platform


def init_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory and
    return it: JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself,
    nothing is set here), else <checkout>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
