"""Build a shared library from sources in the checkout, once per change.

Both native pieces of the port are compiled at first use into the
git-ignored ``infinistore_tpu_torch/_build/`` directory: the store's C++ core
(``_native``, with ``g++``) and the Hopper kernels (``cuda/_ext.py``, with
``nvcc``). Several processes may import the package at once (the test suite
runs under pytest-xdist), so a build holds an ``fcntl`` lock on a file beside
its target, compiles to a temporary name and ``os.replace``s it into place:
a reader never maps a half-written library, and a process that waited on the
lock finds the target fresh and builds nothing.
"""

import fcntl
import os
import subprocess
from typing import Callable, List, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def _is_stale(target: str, inputs: Sequence[str]) -> bool:
    """True when ``target`` is missing or older than any of ``inputs``."""
    if not os.path.exists(target):
        return True
    built = os.path.getmtime(target)
    return any(os.path.getmtime(p) > built for p in inputs)


def build_once(
    target: str,
    inputs: Sequence[str],
    compile_to: Callable[[str], List[List[str]]],
) -> str:
    """Bring ``target`` up to date with ``inputs`` and return its path.

    ``compile_to(tmp_path)`` returns the command lines that write the library
    to ``tmp_path``; all but the last run in parallel, then the last one (the
    link) runs alone. A failing command raises ``RuntimeError`` with the
    compiler's output."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if not _is_stale(target, inputs):
        return target
    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _is_stale(target, inputs):
                return target  # another process built it while we waited
            tmp = f"{target}.tmp{os.getpid()}"
            commands = compile_to(tmp)
            _run_parallel(commands[:-1])
            _run_parallel(commands[-1:])
            os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _run_parallel(commands: List[List[str]]) -> None:
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for cmd in commands
    ]
    failures = []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))
