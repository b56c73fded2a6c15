"""ctypes bindings for the native host library (``native/*.cpp``).

Copied from ``pecanpy_tpu/native/loader.py``: the edgelist parser, the
sequential SGNS trainer, the reference walker and the hub-table builder,
with the same C ABI and the same ``g++`` flags. Three things differ:

* the library builds into ``build/`` beside the package (a directory git
  ignores), never next to its sources;
* its file name carries a hash of the sources and flags, so an edited
  source rebuilds and an unchanged one is reused;
* it is written under a temporary name and moved into place with
  ``os.replace``, so processes that build at the same time never load a
  half-written file.

The build runs at first use, never at import. Without a working ``g++``
the library is unavailable: ``native_available()`` is False, a warning
says why, and callers take their Python paths or raise.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent.parent / "build"
SOURCES = tuple(
    NATIVE_DIR / f"{name}.cpp"
    for name in ("edgelist", "hubtables", "seqsgns", "refwalker")
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpecanpy_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a build of them is there; returns the
    library's path. Raises ``OSError`` or ``CalledProcessError``."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, lib_path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", "") or ""
        warnings.warn(f"native edgelist parser unavailable: {exc} {detail}".strip())
        _build_failed = True
        return None
    return _bind(lib)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on ``lib``."""
    lib.pp_parse_edgelist.restype = ctypes.c_void_p
    lib.pp_parse_edgelist.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.pp_error.restype = ctypes.c_char_p
    lib.pp_error.argtypes = [ctypes.c_void_p]
    for name in (
        "pp_num_nodes",
        "pp_num_edges",
        "pp_dropped_nonpositive",
        "pp_duplicate_conflicts",
        "pp_ids_bytes",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.pp_fill_csr.restype = None
    lib.pp_fill_csr.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.pp_fill_ids.restype = None
    lib.pp_fill_ids.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pp_free.restype = None
    lib.pp_free.argtypes = [ctypes.c_void_p]

    lib.pp_build_hub_tables.restype = ctypes.c_void_p
    lib.pp_build_hub_tables.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    for name in ("pp_hub_edge_rows", "pp_hub_buckets"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.pp_hub_fill.restype = None
    lib.pp_hub_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pp_hub_free.restype = None
    lib.pp_hub_free.argtypes = [ctypes.c_void_p]

    lib.pp_train_sgns_sequential.restype = ctypes.c_longlong
    lib.pp_train_sgns_sequential.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # walks
        ctypes.POINTER(ctypes.c_int32),  # eff_len
        ctypes.c_longlong,  # n_walks
        ctypes.c_longlong,  # t_cols
        ctypes.POINTER(ctypes.c_float),  # w_in
        ctypes.POINTER(ctypes.c_float),  # w_out
        ctypes.c_longlong,  # n_nodes
        ctypes.c_longlong,  # dim
        ctypes.POINTER(ctypes.c_float),  # keep_prob
        ctypes.POINTER(ctypes.c_int32),  # neg_table
        ctypes.c_longlong,  # neg_table_size
        ctypes.c_int,  # window
        ctypes.c_int,  # negative
        ctypes.c_float,  # alpha
        ctypes.c_float,  # min_alpha
        ctypes.c_double,  # total_tokens
        ctypes.c_int,  # epochs
        ctypes.c_uint64,  # seed
    ]
    lib.pp_train_sgns_sequential_mt.restype = ctypes.c_longlong
    lib.pp_train_sgns_sequential_mt.argtypes = (
        lib.pp_train_sgns_sequential.argtypes + [ctypes.c_int]  # workers
    )

    lib.pp_walk_node2vec.restype = None
    lib.pp_walk_node2vec.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # indptr
        ctypes.POINTER(ctypes.c_int32),  # indices
        ctypes.POINTER(ctypes.c_float),  # data
        ctypes.POINTER(ctypes.c_int32),  # starts
        ctypes.c_longlong,  # n_walks
        ctypes.c_int,  # walk_length
        ctypes.c_double,  # p
        ctypes.c_double,  # q
        ctypes.c_uint64,  # seed
        ctypes.c_int,  # workers
        ctypes.POINTER(ctypes.c_int32),  # out_walks
        ctypes.POINTER(ctypes.c_int32),  # out_eff
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _load()
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded (builds it on first call)."""
    return _get_lib() is not None


def parse_edgelist_native(
    path: str,
    weighted: bool,
    directed: bool,
    delimiter: str = "\t",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Parse an .edg file into (indptr, indices, data, node_ids).

    Same contract as ``AdjlstGraph.read`` + ``to_csr`` except that
    per-edge warnings (non-positive drops, duplicate conflicts) are
    reported as two summary warnings with counts.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native parser unavailable")

    handle = lib.pp_parse_edgelist(
        path.encode(), int(weighted), int(directed), delimiter.encode()
    )
    try:
        err = lib.pp_error(handle)
        if err:
            raise ValueError(err.decode())

        dropped = lib.pp_dropped_nonpositive(handle)
        if dropped:
            warnings.warn(
                f"Non-positive edge ignored: {dropped} edge(s) dropped",
                RuntimeWarning,
                stacklevel=2,
            )
        conflicts = lib.pp_duplicate_conflicts(handle)
        if conflicts:
            warnings.warn(
                f"{conflicts} duplicate edge(s) re-specified with a "
                "different weight; the last value wins.",
                RuntimeWarning,
                stacklevel=2,
            )

        n = lib.pp_num_nodes(handle)
        e = lib.pp_num_edges(handle)
        indptr = np.empty(n + 1, dtype=np.uint32)
        indices = np.empty(e, dtype=np.uint32)
        data = np.empty(e, dtype=np.float32)
        lib.pp_fill_csr(
            handle,
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        nbytes = lib.pp_ids_bytes(handle)
        raw = ctypes.create_string_buffer(int(nbytes))
        lib.pp_fill_ids(handle, raw)
        ids = raw.raw.decode("utf-8").split("\n")[:-1]
        return indptr, indices, data, ids
    finally:
        lib.pp_free(handle)


def train_sgns_sequential_native(
    walks: np.ndarray,
    eff_len: np.ndarray,
    w_in: np.ndarray,
    w_out: np.ndarray,
    keep_prob: np.ndarray,
    neg_table: np.ndarray,
    window: int,
    negative: int,
    alpha: float,
    min_alpha: float,
    total_tokens: float,
    epochs: int,
    seed: int,
    workers: int = 1,
) -> int:
    """Train ``w_in``/``w_out`` IN PLACE with gensim's sequential SGNS
    loop (``native/seqsgns.cpp``); returns the trained pair count.

    ``workers=1`` is strictly sequential and deterministic;
    ``workers>1`` runs gensim-style hogwild threads (lock-free racing
    updates, nondeterministic, as gensim with several workers).
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native sequential SGNS trainer unavailable")
    walks = np.ascontiguousarray(walks, dtype=np.int32)
    eff_len = np.ascontiguousarray(eff_len, dtype=np.int32)
    keep_prob = np.ascontiguousarray(keep_prob, dtype=np.float32)
    neg_table = np.ascontiguousarray(neg_table, dtype=np.int32)
    if not (
        w_in.dtype == np.float32
        and w_in.flags.c_contiguous
        and w_out.dtype == np.float32
        and w_out.flags.c_contiguous
    ):
        raise ValueError("w_in/w_out must be C-contiguous float32")
    n = w_in.shape[0]
    if w_in.shape != w_out.shape or keep_prob.size < n:
        raise ValueError(
            f"w_in {w_in.shape}, w_out {w_out.shape} and keep_prob "
            f"{keep_prob.shape} must cover the same nodes"
        )
    valid = np.arange(walks.shape[1])[None, :] < eff_len[:, None]
    for name, ids in (("walks", walks[valid]), ("neg_table", neg_table)):
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"{name} holds node ids outside [0, {n})")
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    args = (
        walks.ctypes.data_as(i32p),
        eff_len.ctypes.data_as(i32p),
        walks.shape[0],
        walks.shape[1],
        w_in.ctypes.data_as(f32p),
        w_out.ctypes.data_as(f32p),
        w_in.shape[0],
        w_in.shape[1],
        keep_prob.ctypes.data_as(f32p),
        neg_table.ctypes.data_as(i32p),
        neg_table.size,
        int(window),
        int(negative),
        float(alpha),
        float(min_alpha),
        float(total_tokens),
        int(epochs),
        int(seed),
    )
    if workers > 1:
        return int(lib.pp_train_sgns_sequential_mt(*args, int(workers)))
    return int(lib.pp_train_sgns_sequential(*args))


def walk_node2vec_native(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    starts: np.ndarray,
    walk_length: int,
    p: float,
    q: float,
    seed: int = 0,
    workers: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-semantics scalar CPU walker (``native/refwalker.cpp``).

    One scalar walker per thread, the exact second-order node2vec law,
    early termination and resting emission, as PecanPy's Numba walk loop.
    Returns (walks [W, L+1] i32, eff_len [W] i32).

    Precondition: every CSR row's indices are sorted ascending (the
    invariant ``AdjlstGraph.to_csr`` and every in-repo builder keep).
    Unsorted rows silently misclassify common neighbors as out-edges.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native walker unavailable")
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    n_walks = starts.size
    walks = np.empty((n_walks, walk_length + 1), dtype=np.int32)
    eff = np.empty(n_walks, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pp_walk_node2vec(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(i32p),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        starts.ctypes.data_as(i32p),
        n_walks,
        int(walk_length),
        float(p),
        float(q),
        int(seed),
        int(workers if workers and workers > 0 else os.cpu_count() or 1),
        walks.ctypes.data_as(i32p),
        eff.ctypes.data_as(i32p),
    )
    return walks, eff


def build_hub_tables_native(indptr, indices, data, hub_ids):
    """Native (C++) hub-structure builder; see ``ops/hubs.py``.

    Returns (edge_pack [E_hub, 8] f32, hub_base [n_hubs] i32,
    hkey8 [NB, 8] i32, hval8 [NB, 8] f32, bucket_base, bucket_log). The
    hash tables are byte-identical to the Python builders'; the alias
    rows are an equally exact Vose construction whose ties near q == 1
    may differ, because it sums the weights in another order.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native hub builder unavailable")

    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    hub_ids = np.ascontiguousarray(hub_ids, dtype=np.int32)

    handle = lib.pp_build_hub_tables(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hub_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hub_ids.size,
    )
    try:
        e_hub = lib.pp_hub_edge_rows(handle)
        nb = lib.pp_hub_buckets(handle)
        edge_pack = np.empty((e_hub, 8), dtype=np.float32)
        hub_base = np.empty(hub_ids.size, dtype=np.int32)
        hkey = np.empty((nb, 8), dtype=np.int32)
        hval = np.empty((nb, 8), dtype=np.float32)
        bucket_base = np.empty(hub_ids.size, dtype=np.int32)
        bucket_log = np.empty(hub_ids.size, dtype=np.int32)
        lib.pp_hub_fill(
            handle,
            edge_pack.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hub_base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hkey.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hval.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            bucket_base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bucket_log.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return edge_pack, hub_base, hkey, hval, bucket_base, bucket_log
    finally:
        lib.pp_hub_free(handle)
