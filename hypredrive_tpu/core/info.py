"""System information report.

The reference's ``-i`` report enumerates hosts, CPUs, GPUs, bindings and
loaded libraries (ref: src/internal/info.c).  The JAX equivalent reports
the platform, device inventory (GPU compute capability and memory),
process layout, and library versions.
"""

from __future__ import annotations

import platform
import socket
import sys


def system_info() -> str:
    lines = []
    bar = "=" * 84
    lines.append(bar)
    lines.append("SYSTEM INFORMATION")
    lines.append(bar)
    lines.append(f"Host            : {socket.gethostname()}")
    lines.append(f"OS              : {platform.platform()}")
    lines.append(f"Python          : {sys.version.split()[0]}")

    try:
        import numpy

        lines.append(f"numpy           : {numpy.__version__}")
    except ImportError:
        pass
    try:
        import scipy

        lines.append(f"scipy           : {scipy.__version__}")
    except ImportError:
        pass
    try:
        import jax

        lines.append(f"jax             : {jax.__version__}")
        lines.append(f"backend         : {jax.default_backend()}")
        lines.append(f"process         : {jax.process_index()} / {jax.process_count()}")
        devs = jax.devices()
        lines.append(f"devices         : {len(devs)} total, "
                     f"{jax.local_device_count()} local")
        for d in devs[:16]:
            extra = ""
            cc = getattr(d, "compute_capability", None)
            if cc is not None:
                extra = f"  compute capability {cc}"
            lines.append(f"  [{d.id}] {d.device_kind} (process {d.process_index})"
                         f"{extra}")
        if len(devs) > 16:
            lines.append(f"  ... and {len(devs) - 16} more")
        mem = devs[0].memory_stats()   # None on the CPU backend
        if mem and "bytes_limit" in mem:
            lines.append(
                f"memory limit    : {mem['bytes_limit'] / 2**30:.1f} GiB "
                "per device")
    except Exception as exc:  # pragma: no cover - jax import issues
        lines.append(f"jax             : unavailable ({exc})")

    from ..version import __version__

    lines.append(f"hypredrive_tpu  : {__version__}")
    lines.append(bar)
    return "\n".join(lines)


def library_banner() -> str:
    """One-line version banner (ref: hypredrv_PrintLibInfo, info.c:4596)."""
    from ..version import __version__

    return f"hypredrive-tpu v{__version__} (JAX/XLA)"
