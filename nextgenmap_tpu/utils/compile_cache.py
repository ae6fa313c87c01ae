"""Where compiled device programs persist between runs.

A mapping run compiles its device steps once per process; the persistent
cache lets the next run of the same shapes load them instead.
"""

from __future__ import annotations

import os
from pathlib import Path

# fixed path at the root of a source checkout (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at CACHE_DIR.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here.  The default applies only to a source checkout (CACHE_DIR's
    parent holds pyproject.toml and is writable); an installed package sets
    no cache.  Call before the first jit.  Returns the directory set here,
    or None when none was set.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = CACHE_DIR.parent
    if not ((root / "pyproject.toml").is_file() and os.access(root, os.W_OK)):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
