"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc``, one process per source started
together, and link into one shared library with a plain C interface,
loaded with ctypes. The build runs at first use, never at import, into
``build/`` beside the package (a directory git ignores); the library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. A failed build raises.
``build`` also takes another source directory, so a measurement script
can build a variant of the sources beside the package's own.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda): the CUDA toolkit is needed to build csrc/*.cu"
    )


def build(csrc_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Build the library from ``csrc_dir``'s sources into ``build_dir``,
    unless a build of the same sources and flags is there; returns its
    path."""
    sources = sorted(csrc_dir.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(csrc_dir.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = build_dir / f"libpecanpy_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{err}")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"kernel link failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return bind(ctypes.CDLL(str(build())))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on ``lib``."""
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    for name in ("pecanpy_apply_sorted_f32", "pecanpy_apply_sorted_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ptr, ptr, ptr,  # table, ids, upd
            i64, i64, i32,  # R, N, D
            ctypes.c_uint,  # seed
            ptr, i64,  # scratch, its length in long longs
            ptr,  # stream
        ]
        fn.restype = ctypes.c_int
    lib.pecanpy_apply_sorted_scratch.argtypes = [i64]  # R
    lib.pecanpy_apply_sorted_scratch.restype = i64
    lib.pecanpy_apply_long_rows.argtypes = []
    lib.pecanpy_apply_long_rows.restype = i32
    for name in ("pecanpy_apply_windowed_f32", "pecanpy_apply_windowed_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ptr, ptr, ptr,  # table, ids, upd
            i64, i64, i32,  # R, N, D
            ctypes.c_uint, ptr,  # seed, stream
        ]
        fn.restype = ctypes.c_int
    lib.pecanpy_apply_windowed_grid.argtypes = [ptr, ptr, i32, i32]  # table, upd, D, bf16
    lib.pecanpy_apply_windowed_grid.restype = ctypes.c_int
    lib.pecanpy_trial_lanes_per_block.argtypes = []
    lib.pecanpy_trial_lanes_per_block.restype = i32
    lib.pecanpy_trial_propose.argtypes = [
        ptr, i64, i32, i32, ptr,  # fused, row stride, dpad, cdf_off, deg
        ptr, i64, ptr, ptr,  # edge_pack, n_slots, kk, u
        ptr, ptr, ptr, ptr, ptr, ptr,  # theta, wp, prev, cur, x_out, w_out
        i64, i32, i32, ctypes.c_uint, ptr,  # B, T, num_nodes, grid, stream
    ]
    lib.pecanpy_trial_accept.argtypes = [
        ptr, i64, i32, ptr,  # fused, row stride, dpad, deg
        ptr, i64,  # hbuckets, n_buckets
        ptr, ptr, ptr, ptr, ptr,  # xs, ws, u, prev, force_ok
        f32, f32, f32, i32,  # inv_p, inv_q, alpha_np, use_atom
        ptr, ptr, ptr,  # chosen, got, chosen_w
        i64, i32, i32, ctypes.c_uint, ptr,  # B, T, num_nodes, grid, stream
    ]
    for name in ("pecanpy_trial_propose", "pecanpy_trial_accept"):
        getattr(lib, name).restype = ctypes.c_int
    lib.pecanpy_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pecanpy_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.pecanpy_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
