"""Build the native engine library from the repository's ``native/``
sources.

The engines (``native/fastpath.cpp``, the HTTP/1.1 proxy loop, and
``native/h2_fastpath.cpp``, the h2/gRPC proxy loop, with
``native/l5d_native.cpp``, the in-data-plane scorer's exports, and the
headers they include) compile with ``g++`` into one shared library with
a plain C interface, loaded with ``ctypes``, as ``native/build.py`` links
them for the reference; ``native/h2bench.cpp`` compiles the same way
into the gRPC echo server and the load generators of a saturation
reading.
The sources are copied into a directory of ``_build/`` beside this file
together with the port's own ``huffman_table.h`` and compiled there: a
quoted include resolves against the including file's directory first,
so the copy never picks up a header generated next to the originals,
and ``native/`` is never written. Each output is named by a hash of
what it is built from, so an edited source is never served a stale
build. A file lock serialises concurrent builds (test workers,
processes of one run) and an output appears under its name by an
atomic rename. Nothing is built at import time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from linkerd_tpu_torch.native.huffman import huffman_header

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# target -> (sources, headers they include, flags of the output, its name)
TARGETS = {
    "engine": (("l5d_native.cpp", "fastpath.cpp", "h2_fastpath.cpp"),
               ("h2_core.h", "scorer.h", "stream_track.h",
                "tenant_guard.h", "tls_engine.h", "tls_shim.h"),
               ["-shared", "-fPIC"], "libl5d_native-{}.so"),
    # the gRPC echo server (``h2bench serve``) and the closed-loop load
    # generators (``h2bench load``, ``h2bench h1load``) of a saturation
    # reading
    "h2bench": (("h2bench.cpp",), ("h2_core.h", "tls_shim.h"), [],
                "h2bench-{}"),
}
GXX_FLAGS = ["-O3", "-std=c++17", "-Wall"]
LIBS = ["-lpthread", "-ldl"]


def build(target: str = "engine") -> Path:
    """Compile ``target`` unless this exact input is already built;
    returns the output's path. Raises ``RuntimeError`` with the
    compiler's output when ``g++`` fails or is missing."""
    sources, headers, out_flags, out_name = TARGETS[target]
    files = {name: (NATIVE_DIR / name).read_bytes()
             for name in sources + headers}
    files["huffman_table.h"] = huffman_header().encode()
    flags = GXX_FLAGS + out_flags
    h = hashlib.sha256(" ".join(flags + LIBS).encode())
    for name in sorted(files):
        h.update(name.encode() + b"\0" + files[name])
    out = BUILD_DIR / out_name.format(h.hexdigest()[:16])
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native engine builds from "
                           "native/ with a C++17 compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released if the holder dies
        if out.exists():  # built by whoever held the lock before us
            return out
        src = Path(tempfile.mkdtemp(prefix="src-", dir=BUILD_DIR))
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
        os.close(fd)
        try:
            for name, data in files.items():
                (src / name).write_bytes(data)
            # one compiler a source, all at once, then the link
            procs = [subprocess.Popen(
                [gxx, *flags, "-c", str(src / s), "-o", str(src / f"{s}.o")],
                stderr=subprocess.PIPE, text=True) for s in sources]
            errs = [p.communicate()[1] for p in procs]
            if any(p.returncode for p in procs):
                raise RuntimeError(f"g++ failed building {target}:\n"
                                   + "".join(errs))
            proc = subprocess.run(
                [gxx, *flags, *(str(src / f"{s}.o") for s in sources),
                 "-o", tmp, *LIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed linking {target}:\n{proc.stderr}")
            os.chmod(tmp, 0o755)
            os.replace(tmp, out)
        finally:
            shutil.rmtree(src, ignore_errors=True)
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out
