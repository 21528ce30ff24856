"""Native host components (C++ via ctypes) with lazy on-demand compilation.

The reference's hot host-side paths are native C++ (BVH build src/BVH.cpp,
OBJ load src/TriangleMeshLoad.cpp); this package provides their
equivalents here. The shared library is built from rt_native.cpp with g++ on first
use and cached next to the source; every caller has a pure-numpy fallback, so
a missing toolchain only costs speed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'rt_native.cpp')
_LIB = os.path.join(_HERE, 'librt_native.so')
_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> bool:
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', _SRC, '-o', _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_LIB) or \
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _failed = True
            return None
        c_i64 = ctypes.c_int64
        c_i32 = ctypes.c_int32
        fp = np.ctypeslib.ndpointer
        lib.rt_build_bvh.restype = c_i64
        lib.rt_build_bvh.argtypes = [
            fp(np.float32, flags='C'), fp(np.float32, flags='C'), c_i64,
            c_i32, c_i32, c_i64, c_i64,
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.int32, flags='C'), fp(np.int32, flags='C'),
            fp(np.int64, flags='C'), c_i64,
            ctypes.POINTER(c_i32)]
        lib.rt_build_clusters.restype = c_i64
        lib.rt_build_clusters.argtypes = [
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.int32, flags='C'), fp(np.int64, flags='C'),
            c_i64, c_i32, c_i32, c_i64,
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.float32, flags='C'),
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.float32, flags='C'),
            fp(np.int32, flags='C')]
        lib.rt_obj_count.restype = ctypes.c_int
        lib.rt_obj_count.argtypes = [ctypes.c_char_p, fp(np.int64, flags='C')]
        lib.rt_obj_fill.restype = ctypes.c_int
        lib.rt_obj_fill.argtypes = [
            ctypes.c_char_p,
            fp(np.float32, flags='C'), fp(np.float32, flags='C'),
            fp(np.float32, flags='C'),
            fp(np.int32, flags='C'), fp(np.int32, flags='C'),
            fp(np.int32, flags='C')]
        _lib = lib
        return _lib


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int,
                     branch: int, prim_off: int, node_base: int):
    """Native subtree build -> (node_min, node_max, child, count, order,
    depth) or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(bmin)
    cap = 2 * n + 8
    node_min = np.empty((cap, branch, 3), np.float32)
    node_max = np.empty((cap, branch, 3), np.float32)
    child = np.empty((cap, branch), np.int32)
    count = np.empty((cap, branch), np.int32)
    order = np.empty(n, np.int64)
    depth = ctypes.c_int32(0)
    n_nodes = lib.rt_build_bvh(
        np.ascontiguousarray(bmin, np.float32),
        np.ascontiguousarray(bmax, np.float32),
        n, leaf_size, branch, prim_off, node_base,
        node_min.reshape(-1), node_max.reshape(-1),
        child.reshape(-1), count.reshape(-1), order, cap,
        ctypes.byref(depth))
    if n_nodes < 0:
        return None
    return (node_min[:n_nodes], node_max[:n_nodes], child[:n_nodes],
            count[:n_nodes], order, int(depth.value))


def build_clusters_native(verts: np.ndarray, verts_t1: np.ndarray,
                          faces: np.ndarray, tri_ids: np.ndarray,
                          cluster_size: int, has_mb: bool):
    """Native cluster-table build (binned SAH, leaf=C, SoA MT basis pack).

    Returns (bb_min, bb_max, p0, e1, e2, q0, q1, q2, tri) with M exact
    cluster rows (q* are the p* arrays themselves when not has_mb), or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(tri_ids)
    C = cluster_size
    va = np.ascontiguousarray(verts, np.float32).reshape(-1)
    vb = np.ascontiguousarray(verts_t1, np.float32).reshape(-1)
    fa = np.ascontiguousarray(faces, np.int32).reshape(-1)
    ta = np.ascontiguousarray(tri_ids, np.int64)
    # SAH leaves average well above C/4 tris; worst case (degenerate
    # splits) is n singleton leaves — grow on overflow instead of
    # allocating for it up front
    cap = max(8 * ((n + C - 1) // C) + 8, 8)
    while True:
        bb_min = np.empty((cap, 3), np.float32)
        bb_max = np.empty((cap, 3), np.float32)
        p0 = np.empty((cap, 3, C), np.float32)
        e1 = np.empty((cap, 3, C), np.float32)
        e2 = np.empty((cap, 3, C), np.float32)
        if has_mb:
            q0 = np.empty((cap, 3, C), np.float32)
            q1 = np.empty((cap, 3, C), np.float32)
            q2 = np.empty((cap, 3, C), np.float32)
        else:  # never written (has_mb=0); 1-row dummies keep the ABI simple
            q0 = q1 = q2 = np.empty((1, 3, C), np.float32)
        tri = np.empty((cap, C), np.int32)
        m = lib.rt_build_clusters(
            va, vb, fa, ta, n, C, int(has_mb), cap,
            bb_min.reshape(-1), bb_max.reshape(-1),
            p0.reshape(-1), e1.reshape(-1), e2.reshape(-1),
            q0.reshape(-1), q1.reshape(-1), q2.reshape(-1),
            tri.reshape(-1))
        if m >= 0:
            break
        if cap >= n + 8:
            return None
        cap = min(cap * 4, n + 8)
    out = (bb_min[:m], bb_max[:m], p0[:m], e1[:m], e2[:m])
    if has_mb:
        return out + (q0[:m], q1[:m], q2[:m], tri[:m])
    return out + (p0[:m], e1[:m], e2[:m], tri[:m])


def parse_obj_native(path: str):
    """Native OBJ parse -> dict of raw arrays, or None."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.zeros(6, np.int64)
    if lib.rt_obj_count(path.encode(), counts) != 0:
        return None
    nv, nvt, nvn, ntri, has_t, has_n = [int(x) for x in counts]
    if nv == 0 or ntri == 0:
        return None
    v = np.empty((max(nv, 1), 3), np.float32)
    vt = np.empty((max(nvt, 1), 2), np.float32)
    vn = np.empty((max(nvn, 1), 3), np.float32)
    fv = np.empty((ntri, 3), np.int32)
    ft = np.empty((ntri, 3), np.int32)
    fn = np.empty((ntri, 3), np.int32)
    if lib.rt_obj_fill(path.encode(), v.reshape(-1), vt.reshape(-1),
                       vn.reshape(-1), fv.reshape(-1), ft.reshape(-1),
                       fn.reshape(-1)) != 0:
        return None
    return dict(v=v[:nv], vt=vt[:nvt], vn=vn[:nvn], fv=fv, ft=ft, fn=fn,
                has_t=bool(has_t), has_n=bool(has_n))
