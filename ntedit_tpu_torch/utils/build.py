"""Build a C++ or CUDA source into a shared library, once per content.

The library goes into the package's ``_build/`` directory (gitignored),
named by a digest of the source and the command, so an edited source or
changed flags build anew and an unchanged one loads the earlier build.
A failed build raises with the compiler's output; a build that succeeds
keeps it beside the library, as ``<library>.log``.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from typing import Callable

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_lock = threading.Lock()


def host_cpu() -> str:
    """The host CPU's model and flags: what ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read().split("\n\n")[0]
    except OSError:
        return platform.processor() or platform.machine()
    return "\n".join(l for l in info.splitlines() if l.startswith(("model name", "flags")))


def build_library(name: str, source: str, command: Callable[[str, str], list],
                  force: bool = False, salt: str = "") -> str:
    """Compile ``source`` with ``command(source, output)`` (an argv list)
    into ``_build/lib<name>-<digest>.so`` and return its path.  ``salt``
    joins the digest, e.g. the host CPU for a ``-march=native`` build."""
    with open(source, "rb") as f:
        text = f.read()
    key = text + " ".join(command("", "")).encode() + salt.encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    with _lock:
        if os.path.exists(out) and not force:
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(command(source, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} from {source} failed:\n{proc.stdout}{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent processes never see half a file
    return out
