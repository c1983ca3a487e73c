"""Process-global runtime: init/finalize and live-object registry.

Mirrors the reference runtime singleton (ref: src/internal/runtime.c:101
hypredrv_RuntimeInitialize, :232 DestroyAllLiveObjects): a once-only device
initialization plus a registry of live driver handles so ``finalize`` can
sweep leaked objects.

JAX mapping: instead of HYPRE_Initialize + MPI we (optionally) call
``jax.distributed.initialize`` for multi-controller runs, enable the
persistent compile cache, and register live
:class:`~hypredrive_tpu.api.HypreDrive` objects.
"""

from __future__ import annotations

import atexit
import os
import weakref
from typing import Optional

# fixed default location of the persistent compile cache (the path is
# part of the cache key, so it must not move between runs)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_state = {
    "initialized": False,
    "distributed": False,
    "live": None,  # weak set of live driver objects
}


def is_initialized() -> bool:
    return _state["initialized"]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX itself
    reads it and nothing is set in code; otherwise the cache lives at
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def initialize(distributed: Optional[bool] = None, **dist_kwargs):
    """Initialize the runtime (ref: HYPREDRV_Initialize, src/HYPREDRV.c:915).

    ``distributed=True`` calls ``jax.distributed.initialize`` (the
    multi-controller analogue of MPI_Init); by default it is enabled only
    when the standard cluster env vars are present.
    """
    if _state["initialized"]:
        return
    _state["live"] = weakref.WeakSet()
    # solver cores are while_loops whose first compile is expensive;
    # the persistent cache makes repeat CLI runs fast
    enable_compile_cache()
    if distributed is None:
        distributed = bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if distributed:
        import jax

        jax.distributed.initialize(**dist_kwargs)
        _state["distributed"] = True
    _state["initialized"] = True


def register_live(obj) -> None:
    if _state["live"] is None:
        _state["live"] = weakref.WeakSet()
    _state["live"].add(obj)


def unregister_live(obj) -> None:
    live = _state["live"]
    if live is not None:
        live.discard(obj)


def finalize():
    """Destroy leaked live objects and shut down
    (ref: hypredrv_RuntimeDestroyAllLiveObjects, src/internal/runtime.c:232)."""
    live = _state["live"]
    if live is not None:
        for obj in list(live):
            try:
                obj.destroy()
            except Exception:
                pass
        live.clear()
    if _state["distributed"]:
        try:
            import jax

            jax.distributed.shutdown()
        except Exception:
            pass
        _state["distributed"] = False
    _state["initialized"] = False


atexit.register(finalize)
