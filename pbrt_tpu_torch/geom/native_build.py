"""ctypes loader for the native SAH BVH builder (native/bvh_builder.cc,
a copy of the JAX package's builder). Compiled with g++ at first use
into the git-ignored native/build/, keyed by a hash of the source. A
failed build raises: the builder decides the clusters, and no silent
fallback may change them."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "bvh_builder.cc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "native", "build")
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libbvh-{tag}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC}:\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.bvh_build_sah
        fn.restype = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int, fp, fp, ip, ip, ip, ip]
        _lib = lib
        return lib


def build_bvh_sah(prim_min, prim_max, max_leaf=4):
    """Binned-SAH BVH over primitive bounds. Returns (bounds_min,
    bounds_max, rp, n, axis, order) numpy arrays (flattened node SoA:
    left child i+1, right child / leaf offset rp[i], leaf count n[i])."""
    lib = _load()
    t = len(prim_min)
    prim_min = np.ascontiguousarray(prim_min, np.float32)
    prim_max = np.ascontiguousarray(prim_max, np.float32)
    est = 2 * t + 2
    bmin = np.empty((est, 3), np.float32)
    bmax = np.empty((est, 3), np.float32)
    rp = np.empty(est, np.int32)
    n = np.empty(est, np.int32)
    axis = np.empty(est, np.int32)
    order = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    m = lib.bvh_build_sah(prim_min.ctypes.data_as(fp), prim_max.ctypes.data_as(fp),
                          t, max_leaf, bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
                          rp.ctypes.data_as(ip), n.ctypes.data_as(ip),
                          axis.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if m <= 0:
        raise RuntimeError(f"bvh_build_sah returned {m}")
    return bmin[:m].copy(), bmax[:m].copy(), rp[:m].copy(), n[:m].copy(), \
        axis[:m].copy(), order
