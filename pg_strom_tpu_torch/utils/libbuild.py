"""The publish step of the port's two libraries built at first use (the
native runtime, native/, and the CUDA kernels, ops/cuda/)."""

from __future__ import annotations

import os


def publish(tmp: str, so: str) -> str:
    """Give the library built at `tmp` its name `so` with a hard link and
    drop `tmp`.  Where another process published `so` first, its library
    is kept and this build dropped: `so` is never replaced, so a process
    that has it mapped never reads a deleted file.  Returns `so`."""
    try:
        os.link(tmp, so)
    except FileExistsError:
        pass
    finally:
        os.unlink(tmp)
    return so
