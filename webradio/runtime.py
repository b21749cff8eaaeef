"""Process-level JAX setup shared by every entry point: backend choice,
the persistent compile cache, and a one-line device description.

Call :func:`select_platform` and :func:`configure_compile_cache` before
the first JAX computation (the backend and the cache directory are read
when the backend initializes).
"""

from __future__ import annotations

import os
import pathlib

#: the checkout root (the directory holding the ``webradio`` package)
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent

#: ``--platform`` values and the JAX platform each selects
PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def select_platform(name: str | None) -> None:
    """Pin the JAX backend (``cuda``/``gpu`` or ``cpu``). With a GPU
    pinned, a machine without one fails at the first JAX call instead of
    silently running on the CPU. ``None`` keeps JAX's own choice."""
    if name is None:
        return
    if name not in PLATFORMS:
        raise ValueError(
            f"unknown platform {name!r}; choose one of {sorted(PLATFORMS)}")
    import jax

    jax.config.update("jax_platforms", PLATFORMS[name])


def compile_cache_dir() -> pathlib.Path:
    """Where the persistent compile cache lives: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.cache/jax``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else CHECKOUT / ".cache" / "jax"


def configure_compile_cache() -> pathlib.Path:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only the fallback is
    set here, so a directory given in the environment always wins."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", str(path))
    return path


def describe_devices() -> str:
    """``platform=<p> kind=<device_kind> count=<n>`` of the live backend."""
    import jax

    devs = jax.devices()
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)}")
