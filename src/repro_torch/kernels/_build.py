"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/lib<name>_<digest>.so csrc/<name>.cu

The build directory is ``build/repro_torch/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it).  Libraries are named by a
digest of their source and flags, so an edited source rebuilds and an
unchanged one loads the library already built.  All missing libraries
build at once, one nvcc process per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points per source: name -> (argtypes, restype)
SIGNATURES = {
    "genasm_dc": {
        # (texts, patterns, d_min, out, batch, w, k, device, stream)
        "genasm_dc_v1": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
        "genasm_dc_v2": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
        "genasm_dc_max_k": ((), _I),
        # (batch, w, k, out int[3]: warps, blocks, shared bytes per block)
        "genasm_dc_v1_geometry": ((_I, _I, _I, _P), _I),
        "genasm_dc_v2_geometry": ((_I, _I, _I, _P), _I),
    },
    "bitalign": {
        # (bases, succ_bits, patterns, p_lens, dists, r_out or NULL,
        #  batch, n, m_bits, k, device, stream)
        "bitalign_dc": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
        "bitalign_max_k": ((), _I),
        # (batch, m_bits, k, store_r, device, out int[3]: warps, blocks,
        #  shared bytes per block)
        "bitalign_geometry": ((_I, _I, _I, _I, _I, _P), _I),
    },
    "myers": {
        # (texts, patterns, m_lens, out, batch, n, m_bits, global_mode,
        #  device, stream)
        "myers_distance": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
        "myers_max_m_bits": ((_I,), _I),
        # (batch, m_bits, device, out int[6]: warps, blocks, shared bytes
        #  per block, words a lane, lanes a pair, warps a pair)
        "myers_distance_geometry": ((_I, _I, _I, _P), _I),
    },
    "bitap_filter": {
        # (ref, ref_len, starts, reads, read_stride, read_lens, dist, off,
        #  lanes, cands, m_bits, region, k, device, stream)
        "bitap_filter": ((_P, _L, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                          _P), _I),
        "bitap_filter_max_k": ((), _I),
        # (lanes, m_bits, k, out int[3]: warps, blocks, shared bytes per block)
        "bitap_filter_geometry": ((_L, _I, _I, _P), _I),
    },
    "word_ops": {
        # (out, threads, n, device, stream)
        "word_ops_dc": ((_P, _I, _I, _I, _P), _I),
        # (out, threads, n, cin, off, device, stream)
        "word_ops_myers": ((_P, _I, _I, ctypes.c_uint, _I, _I, _P), _I),
        # (out int[4]: words a window, DC rows, windows a thread, threads
        #  a block)
        "word_ops_shape": ((_P,), _I),
    },
}


class BuildInfo(NamedTuple):
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register/spill report)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_builds: dict[str, BuildInfo] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def build_all(names=None) -> list[BuildInfo]:
    """Compile every listed source whose library is missing, in parallel.

    Raises RuntimeError with nvcc's output if a compile fails.
    """
    names = list(SIGNATURES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _builds]
        procs = {}
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        for n in todo:
            target = _target(n)
            if target.exists():
                _builds[n] = BuildInfo(n, target, 0.0, "")
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, target)
        for n, (proc, tmp, target) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{n}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, target)
            _builds[n] = BuildInfo(n, target, time.perf_counter() - t0, log)
        return [_builds[n] for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    info = build_all([name])[0]
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(info.path))
            for fn_name, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[name] = lib
        return _libs[name]


GEOMETRY_KEYS = ("warps", "blocks", "smem_bytes")


def geometry(fn, *args, keys=GEOMETRY_KEYS) -> dict:
    """Call a ``*_geometry`` C entry point: the launch its kernel makes for
    ``args``, as ``{"warps", "blocks", "smem_bytes"}`` (per block) and any
    further ``keys`` the entry point writes."""
    out = (ctypes.c_int * len(keys))()
    check(fn(*args, ctypes.cast(out, ctypes.c_void_p)), fn.__name__)
    return dict(zip(keys, out))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")
