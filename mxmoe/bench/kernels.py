"""Scheme -> kernel launcher factory, shared by profiler / bench / solver.

Centralizes which kernel executes a quant scheme (the analog of the
reference's kernel registry, ``registry.cuh:72-107``): given a scheme
string and a grouped workload, builds deterministic operands and returns a
launcher. Per-channel symmetric w×a schemes run the Triton int8 grouped
kernel; the other families run their plain-XLA forms (``ops.gmm``). Used by
the performance-table profiler and the check/bench harness.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import gmm as gmm_ops
from ..ops import pallas_gmm
from ..quant.schemes import parse_scheme, QLinearConfig
from .workloads import GroupGemmWorkload


@dataclasses.dataclass(frozen=True)
class TileSpec:
    bm: int = 128
    bn: int = 128

    def __repr__(self) -> str:
        return f"bm{self.bm}-bn{self.bn}"


# Triton tiles are powers of two; bn <= 256 divides every qwen2_moe width
DEFAULT_TILES = (
    TileSpec(64, 128),
    TileSpec(128, 128),
    TileSpec(128, 256),
)


def scheme_kind(cfg: QLinearConfig, packed: bool = False) -> str:
    if cfg.w_bits >= 16 and cfg.a_bits >= 16:
        return "bf16"
    if cfg.a_bits >= 16:
        return "weight_only_packed" if packed else "weight_only"
    if cfg.w_gsize == -1:
        if packed:
            return "int8_packed"    # nibble-packed w4 × int8 acts
        return "int8"           # wXaY per-channel/per-token (sym or asym)
    return "int8_grouped"       # grouped wXaX (gmm_w8a8_grouped)


def _is_packed(scheme) -> bool:
    """Scheme-grammar suffix ``_packed`` selects nibble-packed w4 storage
    (half the weight HBM traffic; pack via quant.packing.pack_int4_halves)."""
    return isinstance(scheme, str) and scheme.endswith("_packed")


def build_operands(
    wl: GroupGemmWorkload, scheme: str, key=None, interpret: bool = False
):
    """Deterministic operands for one scheme on one workload (seed-42
    uniform(-1,1) like the reference bench, ``test.cu:914-915``)."""
    key = key if key is not None else jax.random.PRNGKey(42)
    cfg = parse_scheme(scheme) if isinstance(scheme, str) else scheme
    kind = scheme_kind(cfg, _is_packed(scheme))
    m, k, n, e = wl.m_total, wl.k, wl.n, wl.num_experts
    k1, k2 = jax.random.split(key)
    gs = jnp.array(wl.group_sizes, jnp.int32)

    a = jax.random.uniform(k1, (m, k), jnp.float32, -1, 1)
    w = jax.random.uniform(k2, (e, k, n), jnp.float32, -1, 1)

    if kind == "bf16":
        return {"lhs": a.astype(jnp.bfloat16), "rhs": w.astype(jnp.bfloat16), "gs": gs}
    if kind in ("int8", "int8_grouped", "int8_packed"):
        from ..quant.packing import pack_int4_halves
        from ..quant.qparams import quantize_act_per_token, quantize_expert_weights

        if kind == "int8_grouped":
            g = cfg.a_gsize if cfg.a_gsize > 0 else cfg.w_gsize
            upper = float((1 << (int(cfg.a_bits) - 1)) - 1)
            ag = a.reshape(m, k // g, g)
            asc = jnp.maximum(jnp.max(jnp.abs(ag), axis=-1), 1e-8) / upper
            aq = jnp.round(ag / asc[..., None]).reshape(m, k).astype(jnp.int8)
        else:
            aq, asc = quantize_act_per_token(a, int(cfg.a_bits))
        qp = quantize_expert_weights(w, cfg)
        rhs = pack_int4_halves(qp.q) if kind == "int8_packed" else qp.q
        return {"lhs": aq, "lhs_sc": asc, "rhs": rhs, "rhs_sc": qp.scale,
                "rhs_zp": qp.zp, "gs": gs}
    # weight-only (int8-stored or nibble-packed)
    from ..quant.packing import pack_int4_halves
    from ..quant.qparams import quantize_expert_weights

    qp = quantize_expert_weights(w, cfg)
    rhs = pack_int4_halves(qp.q) if kind == "weight_only_packed" else qp.q
    return {"lhs": a.astype(jnp.bfloat16), "rhs": rhs, "rhs_sc": qp.scale,
            "rhs_zp": qp.zp, "gs": gs}


def make_launcher(
    scheme: str | QLinearConfig,
    tile: TileSpec = TileSpec(),
    interpret: bool = False,
):
    """Returns fn(operands_dict) -> out for the scheme's kernel. ``tile``
    applies to the Triton kernel; the XLA families choose their own."""
    cfg = parse_scheme(scheme) if isinstance(scheme, str) else scheme
    kind = scheme_kind(cfg, _is_packed(scheme))
    tkw = dict(bm=tile.bm, bn=tile.bn, interpret=interpret)
    if kind == "bf16":
        return lambda ops: gmm_ops.gmm(ops["lhs"], ops["rhs"], ops["gs"])
    if kind == "int8" and not cfg.w_sym:
        return lambda ops: gmm_ops.gmm_w8a8_grouped(
            ops["lhs"], ops["lhs_sc"], ops["rhs"], ops["rhs_sc"], ops["gs"],
            rhs_zp=ops["rhs_zp"])
    if kind == "int8":
        return lambda ops: pallas_gmm.gmm_w8a8(
            ops["lhs"], ops["lhs_sc"], ops["rhs"], ops["rhs_sc"], ops["gs"],
            **tkw)
    if kind == "int8_packed":
        return lambda ops: pallas_gmm.gmm_w4a8_packed(
            ops["lhs"], ops["lhs_sc"], ops["rhs"], ops["rhs_sc"], ops["gs"],
            **tkw)
    if kind in ("weight_only", "weight_only_packed"):
        def fn(ops):
            q = ops["rhs"]
            if kind == "weight_only_packed":
                from ..quant.packing import unpack_int4_halves

                q = unpack_int4_halves(q)
            return gmm_ops.gmm_dequant(ops["lhs"], q, ops["rhs_sc"],
                                       ops["rhs_zp"], ops["gs"])
        return fn
    if kind == "int8_grouped":
        return lambda ops: gmm_ops.gmm_w8a8_grouped(
            ops["lhs"], ops["lhs_sc"], ops["rhs"], ops["rhs_sc"], ops["gs"],
            rhs_zp=None if cfg.w_sym else ops["rhs_zp"])
    raise NotImplementedError(f"kernel kind {kind} for scheme {cfg.scheme_name}")


def reference_output(ops: dict, scheme: str | QLinearConfig) -> jax.Array:
    """Check-mode oracle: dense reference on the fake-quantized operands
    (reference semantics: CUTLASS on dequantized inputs, ``test.cu:725-729``)."""
    from ..ops.gmm import gmm_dense_reference

    cfg = parse_scheme(scheme) if isinstance(scheme, str) else scheme
    packed = _is_packed(scheme)
    kind = scheme_kind(cfg, packed)
    if kind == "bf16":
        return gmm_dense_reference(
            ops["lhs"].astype(jnp.float32), ops["rhs"].astype(jnp.float32), ops["gs"]
        )

    def codes():
        if packed:
            from ..quant.packing import unpack_int4_halves

            return unpack_int4_halves(ops["rhs"])
        return ops["rhs"]

    if kind in ("int8", "int8_grouped", "int8_packed"):
        lsc = ops["lhs_sc"]
        if kind == "int8_grouped":
            m_, k_ = ops["lhs"].shape
            g = k_ // lsc.shape[-1]
            a = (ops["lhs"].reshape(m_, -1, g).astype(jnp.float32)
                 * lsc[..., None]).reshape(m_, k_)
        else:
            a = ops["lhs"].astype(jnp.float32) * lsc
        q = codes()
        k = q.shape[1]
        gsz = k if cfg.w_gsize == -1 else cfg.w_gsize
        from ..quant.packing import PackedTensor, dequantize_weight_kn

        w = dequantize_weight_kn(PackedTensor(
            q, ops["rhs_sc"], ops["rhs_zp"], int(cfg.w_bits), gsz, cfg.w_sym
        ))
        return gmm_dense_reference(a, w, ops["gs"])
    # weight-only (int8-stored or packed)
    q = codes()
    k = q.shape[1]
    gsz = k if cfg.w_gsize == -1 else cfg.w_gsize
    from ..quant.packing import PackedTensor, dequantize_weight_kn

    w = dequantize_weight_kn(PackedTensor(
        q, ops["rhs_sc"], ops["rhs_zp"], int(cfg.w_bits), gsz, cfg.w_sym
    ))
    return gmm_dense_reference(ops["lhs"].astype(jnp.float32), w, ops["gs"])
