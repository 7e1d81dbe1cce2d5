"""Native (C++) host kernels, loaded via ctypes with a JAX/numpy fallback.

The reference keeps its host-side pack/quantize loops in C++/CUDA
(``quantize.cuh:289-475``); ours live in ``csrc/mxmoe_pack.cpp`` and are
used by the checkpoint converter where Python-loop packing would dominate
load time. Every entry point falls back to the pure-JAX implementation
when the shared library hasn't been built (``python -m
mxmoe.native.build``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(__file__), "libmxmoe_pack.so")


def _load():
    global _LIB
    if _LIB is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mxmoe_rtn_quant.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.mxmoe_pack_int4.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
        ]
        lib.mxmoe_transpose_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.mxmoe_bf16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rtn_quant(
    w: np.ndarray, gsize: int, bits: int, sym: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-grouped RTN quant of [rows, k] float32 -> (codes i8, scales, zps).

    Semantics identical to quant.rtn.quantize + packing signed recentring.
    """
    lib = _load()
    rows, k = w.shape
    g = k if gsize == -1 else gsize
    ng = k // g
    if lib is None:
        import jax.numpy as jnp

        from ..quant.packing import quantize_weight_kn
        from ..quant.schemes import QLinearConfig

        p = quantize_weight_kn(
            jnp.asarray(w).T,  # [k, rows] kernel layout
            QLinearConfig(w_bits=bits, w_gsize=gsize, w_sym=sym),
        )
        return (
            np.asarray(p.values, np.int8).T.copy(),
            np.asarray(p.scale, np.float32).T.copy(),
            np.asarray(p.zp, np.float32).T.copy(),
        )
    w = np.ascontiguousarray(w, np.float32)
    codes = np.empty((rows, k), np.int8)
    scales = np.empty((rows, ng), np.float32)
    zps = np.empty((rows, ng), np.float32)
    lib.mxmoe_rtn_quant(
        _ptr(w, ctypes.c_float), rows, k, g, bits, int(sym),
        _ptr(codes, ctypes.c_int8), _ptr(scales, ctypes.c_float),
        _ptr(zps, ctypes.c_float),
    )
    return codes, scales, zps


def pack_int4(codes_kn: np.ndarray) -> np.ndarray:
    """[k, n] signed int4-in-int8 -> [k/2, n] nibble-packed int8."""
    lib = _load()
    k, n = codes_kn.shape
    if lib is None:
        import jax.numpy as jnp

        from ..quant.packing import pack_int4_rows

        return np.asarray(pack_int4_rows(jnp.asarray(codes_kn)))
    codes_kn = np.ascontiguousarray(codes_kn, np.int8)
    out = np.empty((k // 2, n), np.int8)
    lib.mxmoe_pack_int4(_ptr(codes_kn, ctypes.c_int8), k, n, _ptr(out, ctypes.c_int8))
    return out


def transpose_f32(a: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(a.T)
    a = np.ascontiguousarray(a, np.float32)
    rows, cols = a.shape
    out = np.empty((cols, rows), np.float32)
    lib.mxmoe_transpose_f32(_ptr(a, ctypes.c_float), rows, cols, _ptr(out, ctypes.c_float))
    return out


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32."""
    lib = _load()
    if lib is None:
        return (raw.astype(np.uint32) << 16).view(np.float32)
    raw = np.ascontiguousarray(raw, np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib.mxmoe_bf16_to_f32(_ptr(raw, ctypes.c_uint16), raw.size, _ptr(out, ctypes.c_float))
    return out
