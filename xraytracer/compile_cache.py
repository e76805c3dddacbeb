"""Persistent XLA compilation cache, placed in one way for every entry point.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; where it is set, nothing
here overrides it. Otherwise the cache lives at ``<checkout>/.jax_cache``
(listed in ``.gitignore``): a fixed path, because the directory is part of
what later processes look up.
"""

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache():
    """Turn the persistent compilation cache on and return its directory."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
