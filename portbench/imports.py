"""The check that nothing the benchmark ran loaded JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot), whole: the port's package name begins with the JAX package's
name and must not match it.
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "opensearch_jvector_tpu")


def forbidden_loaded(module_names) -> list[str]:
    """The forbidden top-level names among `module_names`, sorted."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops.intersection(FORBIDDEN))
