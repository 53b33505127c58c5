"""Build and load the port's CUDA kernels and its host library.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (and
the PTX helpers of ``csrc/hopper.cuh``). It is compiled with ``nvcc`` for
``sm_90a`` into a shared library under the checkout's ``build/kernels/``
the first time it is needed, named by a hash of its sources so that an
edited source is rebuilt, and loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import every
module on machines that have no ``nvcc``.

The host route builds ``csrc/<name>.cc`` (the JPEG decoder) the same way
with ``g++``, linked against libjpeg: the system's where its headers and
``-ljpeg`` are there, else the libjpeg-turbo that PIL's wheel bundles
(``pillow.libs/libjpeg-*.so.62*``, the jpeg62 ABI), compiled against the
jpeg62 headers in ``csrc/third_party/libjpeg/`` with an rpath to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

CXX = "g++"
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBJPEG_HEADERS = CSRC_DIR / "third_party" / "libjpeg"

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: one file per hash of the source
    and of the shared headers ``csrc/*.cuh``."""
    digest = hashlib.sha256()
    for source in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(source.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(cmd: list[str], out: Path, what: str) -> Path:
    """Run ``cmd`` with the output path ``out``'s temporary name appended,
    then rename it to ``out``, so that concurrent processes never load a
    half-written library. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                              text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{what} timed out") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    return _compile([_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")],
                    out, f"nvcc of {name}.cu")


def build_all(names) -> list[Path]:
    """Build several sources at once, one ``nvcc`` process each."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


# -- the host route: csrc/<name>.cc with g++, linked against libjpeg --------


class HostLibrary(NamedTuple):
    lib: ctypes.CDLL
    route: str  # which libjpeg it links: "system" or "pillow"
    path: Path


def pillow_libjpeg() -> Path | None:
    """The libjpeg-turbo that PIL's wheel bundles, if PIL is installed
    from one (found without importing PIL)."""
    try:
        spec = importlib.util.find_spec("PIL")
    except (ImportError, ValueError):  # blocked, or a None module entry
        return None
    if spec is None or not spec.origin:
        return None
    libs = sorted((Path(spec.origin).parent.parent / "pillow.libs").glob(
        "libjpeg-*.so.62*"))
    return libs[0] if libs else None


def libjpeg_routes() -> list[tuple[str, list[str]]]:
    """(route, g++ flags) of each way to link libjpeg, in the order tried:
    the system's, then PIL's bundled copy where there is one."""
    routes = [("system", ["-ljpeg"])]
    lib = pillow_libjpeg()
    if lib is not None:
        routes.append(("pillow", ["-I", str(LIBJPEG_HEADERS), str(lib),
                                  f"-Wl,-rpath,{lib.parent}"]))
    return routes


def host_library_path(name: str, route: str, flags: list[str]) -> Path:
    """Where ``csrc/<name>.cc`` is built for ``route``: one file per hash
    of the source, the vendored headers and the link flags (which name
    the libjpeg it loads, so that a library built on another machine is
    not taken for this one's)."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cc").read_bytes())
    for header in sorted(LIBJPEG_HEADERS.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update("\0".join(flags).encode())
    return BUILD_DIR / f"{name}-{route}-{digest.hexdigest()[:16]}.so"


def build_host(name: str, route: str, flags: list[str]) -> Path:
    """Compile ``csrc/<name>.cc`` with g++ for one libjpeg route unless its
    library already exists."""
    out = host_library_path(name, route, flags)
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found; the port's JPEG decoder is "
                           f"built from source at first use")
    return _compile([cxx, *HOST_FLAGS, str(CSRC_DIR / f"{name}.cc"), *flags],
                    out, f"{CXX} of {name}.cc, libjpeg route {route},")


def load_host(name: str, routes=None) -> HostLibrary:
    """The first of ``routes`` (by default :func:`libjpeg_routes`) whose
    library builds and loads. Raises RuntimeError naming every failure."""
    errors = []
    for route, flags in libjpeg_routes() if routes is None else routes:
        try:
            path = build_host(name, route, flags)
            return HostLibrary(ctypes.CDLL(str(path)), route, path)
        except (RuntimeError, OSError) as e:
            errors.append(f"[{route}] {e}")
    raise RuntimeError(f"no libjpeg route built {name}.cc:\n"
                       + "\n".join(errors))
