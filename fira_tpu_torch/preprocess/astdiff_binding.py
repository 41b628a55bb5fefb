"""ctypes binding for the native astdiff library (counterpart of the JAX
package's ``preprocess/astdiff_binding.py``, over its own copy of the C++
sources in ``astdiff/``).

The reference shells out to a vendored Java GumTree per chunk, two JVM
launches per update hunk (Preprocess/get_ast_root_action.py:70,124). Here
the C++ library is loaded once per process and called in-process.

Python surface (each returns None on unparseable input, like the
reference's degradation at process_data_ast_parallel.py:204-217):

    tokenize(src)   -> [token_text]            (javalang.tokenizer stand-in)
    parse_json(src) -> {"root": {...}}         (`parse` CLI contract payload)
    diff_lines(a,b) -> ["Match ...", ...]      (`diff` CLI contract lines)

Build: the host C++ compiler (``$CXX``, else ``g++``) compiles the sources
directly with ``CXXFLAGS`` into two artifacts, the shared library
(``LIB_FLAGS``) and the ``astdiff parse|diff`` CLI binary
(``-DASTDIFF_MAIN``, the GumTree-compatible surface kept for differential
testing). Both go to
``build/astdiff/`` at the root of the checkout (git-ignored), named by a
digest of the sources and the flags, so an edited source is rebuilt and an
unchanged one reused. Builders that race (test workers, the pipeline's
spawned pool) serialise on an exclusive file lock, and each compile writes
a private name that is renamed into place, so no process can load a
half-written library. A missing compiler or a failed compile raises
``AstdiffBuildError`` with the compiler's output. Nothing is built or
loaded at import: the first call does it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent / "astdiff"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "astdiff"
HEADERS = ("astdiff.hpp",)
UNITS = ("lexer.cpp", "parser.cpp", "matcher.cpp", "capi.cpp")
CXXFLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra", "-fPIC")
# --exclude-libs: a toolchain that links libstdc++ statically (the CUDA
# host compiler's on the H100 machine does) leaves its copy's symbols
# global, and in a process that already loaded the shared libstdc++
# (torch does) the two copies' symbols cross and the first parse
# segfaults; kept local, each copy stays whole. No effect when libstdc++
# is linked as a shared library.
LIB_FLAGS = ("-shared", "-Wl,--exclude-libs,ALL")
CLI_FLAGS = ("-DASTDIFF_MAIN",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class AstdiffBuildError(RuntimeError):
    pass


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise AstdiffBuildError(
            f"C++ compiler {cxx!r} not found ($CXX, else g++ on the PATH): "
            f"the astdiff library is built from source at first use")
    return found


def artifact_paths() -> Tuple[Path, Path]:
    """(shared library, CLI binary) under ``BUILD_DIR``, named by a digest
    of the sources and the flags."""
    h = hashlib.sha256()
    for name in HEADERS + UNITS:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    h.update(" ".join(CXXFLAGS + LIB_FLAGS + CLI_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"libastdiff_{tag}.so", BUILD_DIR / f"astdiff_{tag}"


def build() -> Path:
    """Build the library and the CLI binary if either is missing; returns
    the library's path. The two compiles run side by side."""
    lib, cli = artifact_paths()
    if lib.exists() and cli.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / ".astdiff.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)   # released when the file closes
        cxx = compiler()
        units = [str(SRC_DIR / u) for u in UNITS]
        procs = []
        for out, extra in ((lib, LIB_FLAGS), (cli, CLI_FLAGS)):
            if out.exists():   # a peer built it while this one waited
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXXFLAGS, *extra, "-o", str(tmp), *units]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out))
        failed = []
        for proc, tmp, out in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{cxx} failed for {out.name} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise AstdiffBuildError("astdiff build failed:\n"
                                    + "\n".join(failed))
    return lib


def cli_path() -> Path:
    """The ``astdiff parse|diff`` CLI binary, built first if needed."""
    build()
    return artifact_paths()[1]


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), its C entry points
    typed; one build check and one load per process."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(path))
            for fn in ("astdiff_parse", "astdiff_tokenize"):
                getattr(lib, fn).argtypes = [ctypes.c_char_p]
                getattr(lib, fn).restype = ctypes.c_void_p
            lib.astdiff_diff.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.astdiff_diff.restype = ctypes.c_void_p
            lib.astdiff_free.argtypes = [ctypes.c_void_p]
            lib.astdiff_free.restype = None
            _lib = lib
    return _lib


def take(lib: ctypes.CDLL, ptr: Optional[int]) -> Optional[str]:
    """Copy a malloc'd C string into Python and free it."""
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.astdiff_free(ptr)


def tokenize(src: str) -> Optional[List[str]]:
    lib = load()
    out = take(lib, lib.astdiff_tokenize(src.encode("utf-8")))
    if out is None:
        return None
    return [t for t in out.split("\n") if t]


def parse_json(src: str) -> Optional[dict]:
    lib = load()
    out = take(lib, lib.astdiff_parse(src.encode("utf-8")))
    if out is None:
        return None
    try:
        return json.loads(out)
    except RecursionError:
        # The parser bounds tree depth well inside json.loads' budget, but if
        # the caller runs under a lowered recursion limit, degrade like any
        # other unparseable chunk instead of blowing up the worker.
        return None


def diff_lines(src_old: str, src_new: str) -> Optional[List[str]]:
    lib = load()
    out = take(lib, lib.astdiff_diff(src_old.encode("utf-8"),
                                     src_new.encode("utf-8")))
    if out is None:
        return None
    return [ln for ln in out.splitlines() if ln.strip()]
