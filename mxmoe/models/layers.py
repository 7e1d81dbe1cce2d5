"""Functional transformer building blocks (RMSNorm, RoPE, GQA attention,
MoE FFN) for the supported decoder families.

Everything is a pure function of (params, inputs): quantization, rotation
and calibration become pytree transforms instead of module surgery + hooks
(the reference's approach, ``quant.py:126-131``, ``rotation.py:435-469``).

Weight layout convention: all matmul weights are stored **[in, out]** so a
projection is ``x @ w`` (HF checkpoints hold [out, in]; the loader
transposes). MoE expert weights are stacked [E, in, out] and gate/up are
fused into one [E, H, 2N] operand — the same fused gate_up GEMM the
reference benchmarks (``gen_workload.py:95``: shapes [M, 2N, K]).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .configs import MoEConfig
from ..ops.dispatch import route_topk, make_dispatch, gather_tokens, combine_tokens
from ..ops import gmm as gmm_ops


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    dt = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(dt) * weight


def rope_frequencies(head_dim: int, theta: float, positions: jax.Array) -> tuple[jax.Array, jax.Array]:
    """cos/sin tables [S, head_dim] in the HF half-rotation convention."""
    inv_freq = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim))
    angles = positions.astype(jnp.float32)[:, None] * inv_freq[None, :]  # [S, hd/2]
    emb = jnp.concatenate([angles, angles], axis=-1)
    return jnp.cos(emb), jnp.sin(emb)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: [B, S, nH, hd]; cos/sin: [S, hd] (HF rotate_half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    c = cos[None, :, None, :].astype(x.dtype)
    s = sin[None, :, None, :].astype(x.dtype)
    return x * c + rotated * s


def attention(
    q: jax.Array,       # [B, S, nH, hd]
    k: jax.Array,       # [B, S, nKV, hd]
    v: jax.Array,       # [B, S, nKV, hd]
    causal: bool = True,
    backend: str = "xla",
    ring_fn=None,
) -> jax.Array:
    """GQA attention; keys/values broadcast across query groups.

    backend 'xla': einsum softmax (materializes S×S scores — fine for
    short calibration windows). 'fused': ``jax.nn.dot_product_attention``,
    which reaches cuDNN's fused attention on the GPU (O(S) memory for
    long-sequence eval / prefill) and its XLA form elsewhere. 'ring':
    sequence-parallel ring attention over a device mesh (context
    parallelism for prefill beyond one device's sequence budget) —
    ``ring_fn`` is the shard_map-wrapped kernel from
    ``parallel.ring_attention.make_ring_attention_fn`` (carried on
    ``MoEImpl.ring_attn``; built by ``parallel.sharded.
    make_sp_prefill_forward``).
    """
    b, s, n_h, hd = q.shape
    n_kv = k.shape[2]
    groups = n_h // n_kv

    if backend == "ring":
        assert ring_fn is not None, (
            "attn_backend='ring' needs MoEImpl.ring_attn (build the "
            "forward with parallel.sharded.make_sp_prefill_forward)")
        assert causal, "ring attention is causal-only"
        return ring_fn(q, k, v)

    if backend == "fused":
        impl = "cudnn" if jax.default_backend() == "gpu" else "xla"
        return jax.nn.dot_product_attention(q, k, v, is_causal=causal,
                                            implementation=impl)

    qg = q.reshape(b, s, n_kv, groups, hd)
    scores = jnp.einsum("bsngh,btnh->bngst", qg, k).astype(jnp.float32)
    scores = scores / jnp.sqrt(float(hd))
    if causal:
        t = k.shape[1]
        mask = jnp.tril(jnp.ones((s, t), dtype=bool), k=t - s)
        scores = jnp.where(mask[None, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    out = jnp.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(b, s, n_h, hd)


@dataclasses.dataclass(frozen=True)
class MoEImpl:
    """How the expert FFN is executed.

    kind:
      'dense'  — every expert runs on every token (einsum, tiny tests only)
      'ragged' — sort + grouped matmul (``ops.gmm.gmm``: the Triton
                 grouped kernel on the GPU, ragged_dot elsewhere)

    quant: a QLinearConfig scheme for the routed expert linears ("mixed"
    for per-expert schemes). When set (and the layer params carry
    quantized weights, see :mod:`mxmoe.quant.qparams`), the expert FFN
    runs through the quantized grouped matmuls with dynamic per-token
    activation quant. Attention, router and shared expert stay
    high-precision unless quantized separately — same scope as the
    reference (expert linears only, ``quant.py:319-359``).
    interpret: run the Pallas kernel in interpreter mode; None = decide
    from the backend (``utils.device.interpret_kernels``).
    """

    kind: str = "ragged"
    gmm_backend: str = "auto"        # ops.gmm.gmm backend
    quant: object | None = None      # QLinearConfig | "mixed"
    interpret: bool | None = None
    online_had: bool = False         # online Hadamard on down-proj inputs
                                     # (QuaRot R4; down weights must be
                                     # pre-rotated, rotation.rotate_down_weights)
    attn_backend: str = "xla"        # 'xla' | 'fused' | 'ring'
    dispatch_align: int | None = None  # pad each expert's rows to this
                                     # multiple (= kernel bm): tiles never
                                     # straddle experts (see make_dispatch)
    mixed_weight_only: bool = False  # mixed layers contain a16 weight-only
                                     # experts: route through
                                     # ops.gmm.gmm_mixed_wo_wxa
    ep_moe: object = None            # multi-device routed MoE block
                                     # ((x [B,S,H], lp, cfg) -> y, built by
                                     # parallel.ep.make_ep_moe_block): the
                                     # cached decode/forward paths run the
                                     # EP all-to-all inside the step when
                                     # set (serving over a device mesh)
    stack_weights: object = None     # decode weight-stack layout: None =
                                     # auto (stack iff NOT interpret: the
                                     # loop-constant stack removes the
                                     # per-step slice copy a kernel operand
                                     # forces, but the Pallas INTERPRETER
                                     # pays O(full operand) per call);
                                     # True/False force it (tests)
    ring_attn: object = None         # shard_map ring-attention callable
                                     # ((q,k,v) -> out) for
                                     # attn_backend="ring" (sequence-
                                     # parallel prefill; built by
                                     # parallel.sharded.
                                     # make_sp_prefill_forward)

    @property
    def use_interpret(self) -> bool:
        if self.interpret is not None:
            return self.interpret
        from ..utils.device import interpret_kernels

        return interpret_kernels()


def silu_mul(gate_up: jax.Array) -> jax.Array:
    """Fused SwiGLU activation on a [.., 2N] gate_up projection."""
    n = gate_up.shape[-1] // 2
    gate, up = gate_up[..., :n], gate_up[..., n:]
    return jax.nn.silu(gate) * up


def moe_ffn_dense(x2d: jax.Array, layer_params: dict, cfg: MoEConfig) -> jax.Array:
    """Reference-fidelity O(E) dense MoE execution (test oracle)."""
    logits = x2d @ layer_params["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    gate_up = layer_params["expert_gate_up"]  # [E, H, 2N]
    down = layer_params["expert_down"]        # [E, N, H]
    h = jnp.einsum("th,ehn->etn", x2d, gate_up)
    h = silu_mul(h)
    out_all = jnp.einsum("etn,enh->eth", h, down)  # [E, T, H]
    one_hot = jax.nn.one_hot(routing.expert_ids, cfg.num_experts, dtype=x2d.dtype)  # [T,k,E]
    w = (routing.weights.astype(x2d.dtype)[..., None] * one_hot).sum(1)  # [T, E]
    return jnp.einsum("eth,te->th", out_all, w)


def _act_fq_per_row(x: jax.Array, bits_per_row: jax.Array) -> jax.Array:
    """Per-token symmetric fake-quant with a per-row bitwidth (16 = off).

    Vectorized analog of the reference's per-linear act-quant hooks
    (``quant.py:126-131``) for mixed-precision eval: each expert's rows get
    that expert's activation width.
    """
    upper = jnp.exp2(bits_per_row.astype(jnp.float32) - 1.0) - 1.0   # [M]
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
    scale = jnp.maximum(amax, 1e-10) / upper
    q = jnp.round(x.astype(jnp.float32) / scale[:, None]) * scale[:, None]
    keep = (bits_per_row >= 16)[:, None]
    return jnp.where(keep, x.astype(jnp.float32), q).astype(x.dtype)


def _act_fq_per_row_flex(x: jax.Array, bits_per_row: jax.Array,
                         row_gsize: jax.Array, gsize: int) -> jax.Array:
    """FLEX fake-quant: per-row bitwidth AND per-row grouping (rows of
    grouped-act experts quantize per k-group of ``gsize``; others
    per-token). Dequantizes exactly the codes·scales the REAL flex path
    computes (``qparams.quantize_act_rows_flex``), so flex real-vs-fake
    ppl comparisons see identical activation transforms. 16-bit rows pass
    through."""
    from ..quant.qparams import quantize_act_rows_flex

    q, scale = quantize_act_rows_flex(x, bits_per_row, row_gsize, gsize)
    m, k = x.shape
    deq = (q.astype(jnp.float32).reshape(m, k // gsize, gsize)
           * scale[..., None]).reshape(m, k)
    keep = (bits_per_row >= 16)[:, None]
    return jnp.where(keep, x.astype(jnp.float32), deq).astype(x.dtype)


def moe_ffn_ragged(
    x2d: jax.Array,
    layer_params: dict,
    cfg: MoEConfig,
    impl: MoEImpl,
) -> jax.Array:
    """Production path: sort tokens by expert, two grouped matmuls, combine.

    When the layer params carry ``act_bits_gateup``/``act_bits_down`` [E]
    arrays (mixed fake-quant eval, see quant/quantizer.py), activations are
    fake-quantized per expert row group before each grouped matmul.
    """
    logits = x2d @ layer_params["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    disp = make_dispatch(routing, cfg.num_experts, align=impl.dispatch_align)
    xs = gather_tokens(x2d, disp)                                   # [T*k, H]
    mixed_act = "act_bits_gateup" in layer_params

    def _fq(acts, bits_key, ag_key):
        row_bits = jnp.take(layer_params[bits_key], row_expert)
        ag = layer_params.get(ag_key)      # [E, G] per-expert a_gsize or None
        if ag is None:
            return _act_fq_per_row(acts, row_bits)
        return _act_fq_per_row_flex(
            acts, row_bits, jnp.take(ag[:, 0], row_expert),
            acts.shape[-1] // ag.shape[-1])

    if mixed_act:
        row_expert = jnp.repeat(
            jnp.arange(cfg.num_experts, dtype=jnp.int32), disp.group_sizes,
            total_repeat_length=xs.shape[0],
        )
        xs = _fq(xs, "act_bits_gateup", "act_gsize_gateup")
    h = gmm_ops.gmm(xs, layer_params["expert_gate_up"], disp.group_sizes,
                    backend=impl.gmm_backend)                       # [T*k, 2N]
    h = silu_mul(h)
    if impl.online_had:
        from ..quant.hadamard import matmul_hadU

        h = matmul_hadU(h)
    if mixed_act:
        h = _fq(h, "act_bits_down", "act_gsize_down")
    out = gmm_ops.gmm(h, layer_params["expert_down"], disp.group_sizes,
                      backend=impl.gmm_backend)                     # [T*k, H]
    return combine_tokens(out, disp, x2d.shape[0])


_EXPERT_STACK_KEYS = tuple(
    p + s for p in ("expert_gate_up", "expert_down")
    for s in ("_qcat", "_q", "_q_packed", "_sc", "_zp"))


def split_expert_stack(layers: dict, flatten: bool = True) -> tuple[dict, dict]:
    """Partition stacked layer params into scan-xs (small, per-layer) and
    the expert-weight STACK: flattened ``[L*E, ...]`` (``[L*R, N]`` for the
    ragged packed buffer) views passed as loop CONSTANTS and indexed
    in-kernel by a layer offset (``group_base`` / layer-global block
    offsets in ``ops.pallas_gmm.gmm_int8``).

    Why: XLA cannot fuse a scan iteration's dynamic-slice into a custom
    kernel's operand, so carrying expert weights as scan-xs materializes a
    copy of the layer's quantized weights every step — at decode that copy
    moves as many bytes as the kernel itself reads. The reshape here is
    layout-free; only tiny metadata varies per layer.

    ``flatten=False`` keeps stack arrays at their full ``[L, E, ...]``
    shape (the EP serving path: expert dim 1 must stay a shardable axis —
    shards flatten locally inside the shard_map, parallel.ep).

    A weight family (``expert_gate_up_*`` or ``expert_down_*``) whose
    flattened stack the kernel could not address safely
    (``ops.pallas_gmm.offsets_overflow``: 2-4 GiB) stays per layer.
    """
    from ..ops.pallas_gmm import offsets_overflow

    def family(k):
        return k.rsplit("_", 2 if k.endswith("_q_packed") else 1)[0]

    unsafe = {family(k) for k, v in layers.items()
              if flatten and k in _EXPERT_STACK_KEYS and offsets_overflow(v)}
    xs, stack = {}, {}
    for k, v in layers.items():
        if k in _EXPERT_STACK_KEYS and family(k) not in unsafe:
            stack[k] = v.reshape((-1,) + v.shape[2:]) if flatten else v
        else:
            xs[k] = v
    if stack:
        stack["_num_layers"] = next(iter(layers.values())).shape[0]
    return xs, stack


def moe_ffn_ragged_quant(
    x2d: jax.Array,
    layer_params: dict,
    cfg: MoEConfig,
    impl: MoEImpl,
) -> jax.Array:
    """Real-quantized expert FFN: per-token act quant + quantized gmm.

    Per-channel symmetric w×a schemes (a_bits <= 8; int8-stored, nibble-
    packed or a per-expert mix of both) run the Triton int8 grouped kernel
    (:func:`mxmoe.ops.pallas_gmm.gmm_int8`), bit widths as data. The
    other scheme families — grouped scales, asymmetric weights, weight-only
    a16 — run as plain XLA (:mod:`mxmoe.ops.gmm`).

    When ``layer_params`` carries ``_expert_stack``/``_layer_index`` (set
    by the forwards' layer scans, see :func:`split_expert_stack`), weight
    operands come from the flattened all-layer stack and the kernels get
    a layer offset instead of per-layer slices.
    """
    from ..quant.qparams import (quantize_act_grouped, quantize_act_rtn,
                                 quantize_act_per_row_bits,
                                 quantize_act_rows_flex)
    from ..quant.packing import unpack_int4_halves
    from ..ops import pallas_gmm
    from ..ops.gmm import (gmm_dequant, gmm_mixed_wo_wxa, gmm_w8a8_grouped,
                           ragged_to_dense_int8)

    qcfg = impl.quant
    e = cfg.num_experts
    stack = layer_params.get("_expert_stack") or {}
    g_base = None
    if stack:
        n_layers = stack["_num_layers"]
        g_base = jnp.asarray(layer_params["_layer_index"], jnp.int32) * e

    def _w(key):
        """Weight-side param: the flattened all-layer stack when present."""
        return stack[key] if key in stack else layer_params.get(key)

    def _has(key):
        return key in stack or key in layer_params

    logits = x2d @ layer_params["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    disp = make_dispatch(routing, e, align=impl.dispatch_align)
    xs = gather_tokens(x2d, disp)                                   # [T*k, H]
    mixed = "act_bits_gateup" in layer_params and (
        _has("expert_gate_up_q")
        or _has("expert_gate_up_q_packed")
        or _has("expert_gate_up_qcat"))
    if mixed:
        row_expert = jnp.repeat(
            jnp.arange(e, dtype=jnp.int32), disp.group_sizes,
            total_repeat_length=xs.shape[0],
        )

    def qgemm(acts, prefix):
        sc = _w(f"{prefix}_sc")
        zp = _w(f"{prefix}_zp")
        k = acts.shape[-1]
        # this family rides the layer stack (split_expert_stack may leave
        # one family per layer)
        base = g_base if f"{prefix}_sc" in stack else None
        bits_key = ("act_bits_gateup" if prefix == "expert_gate_up"
                    else "act_bits_down")
        ag_key = ("act_gsize_gateup" if prefix == "expert_gate_up"
                  else "act_gsize_down")
        row_bits = (jnp.take(layer_params[bits_key], row_expert)
                    if mixed else None)

        def _blk_global(qcat_rows):
            """Ragged-buffer block starts, layer-global when stacked."""
            blk = layer_params[f"{prefix}_blk"]
            if base is not None:
                units = qcat_rows // n_layers // (k // 2)
                blk = blk + (jnp.asarray(layer_params["_layer_index"],
                                         jnp.int32) * units)
            return blk

        def _codes():
            """This family's weight codes as an int8 [E(or L*E), K, N]."""
            if _has(f"{prefix}_qcat"):
                qcat = _w(f"{prefix}_qcat")
                return ragged_to_dense_int8(
                    qcat, layer_params[f"{prefix}_pf"],
                    _blk_global(qcat.shape[0]), k)
            if _has(f"{prefix}_q_packed"):
                return unpack_int4_halves(_w(f"{prefix}_q_packed"))
            return _w(f"{prefix}_q")

        xla_kw = dict(group_base=base, out_dtype=acts.dtype)
        if mixed and (ag_key in layer_params or impl.mixed_weight_only):
            # grouped / asymmetric / a16 members: per-expert (bits, gsize,
            # sym) are all data — act codes+scales [M, G] from the per-row
            # flex quant, weight scales/zp [E, G, N] (per-channel experts
            # replicated), one XLA product
            gdim = sc.shape[-2]
            ag = layer_params.get(ag_key)
            row_ag = (jnp.take(ag[:, 0], row_expert) if ag is not None
                      else jnp.full_like(row_bits, -1.0))
            aq, asc = quantize_act_rows_flex(acts, row_bits, row_ag, k // gdim)
            if impl.mixed_weight_only:
                return gmm_mixed_wo_wxa(acts, aq, asc, _codes(), sc,
                                        row_bits >= 16, disp.group_sizes,
                                        rhs_zp=zp, **xla_kw)
            return gmm_w8a8_grouped(aq, asc, _codes(), sc, disp.group_sizes,
                                    rhs_zp=zp, **xla_kw)
        if not mixed and qcfg.a_bits >= 16:
            # weight-only a16: activations stay at full precision
            return gmm_dequant(acts, _codes(), sc, zp, disp.group_sizes,
                               **xla_kw)
        if not mixed and qcfg.w_gsize != -1:
            # g128-class w×a: per-(token, k-group) act scales, same group
            # size both sides (the reference's w4a4_g128)
            aq, asc = quantize_act_grouped(acts, int(qcfg.a_bits),
                                           qcfg.w_gsize)
            return gmm_w8a8_grouped(aq, asc, _codes(), sc, disp.group_sizes,
                                    rhs_zp=None if qcfg.w_sym else zp,
                                    **xla_kw)
        if mixed:
            aq, asc = quantize_act_per_row_bits(acts, row_bits)
        else:
            aq, asc = quantize_act_rtn(acts, qcfg)
        if not mixed and not qcfg.w_sym:
            return gmm_w8a8_grouped(aq, asc, _codes(), sc, disp.group_sizes,
                                    rhs_zp=zp, **xla_kw)
        # per-channel symmetric w×a: the Triton int8 kernel. Decode-sized
        # launches (a few rows per expert) use short row tiles so a tile
        # straddling many tiny groups does little wasted work.
        kw = dict(bm=16 if acts.shape[0] <= 1024 else 128,
                  bn=128 if acts.shape[0] <= 1024 else 64,
                  out_dtype=acts.dtype, interpret=impl.interpret,
                  group_base=0 if base is None else base)
        if _has(f"{prefix}_qcat"):
            qcat = _w(f"{prefix}_qcat")
            return pallas_gmm.gmm_int8(
                aq, asc, qcat, sc, disp.group_sizes,
                layer_params[f"{prefix}_pf"], _blk_global(qcat.shape[0]), **kw)
        if _has(f"{prefix}_q_packed"):
            return pallas_gmm.gmm_w4a8_packed(
                aq, asc, _w(f"{prefix}_q_packed"), sc, disp.group_sizes, **kw)
        return pallas_gmm.gmm_w8a8(aq, asc, _w(f"{prefix}_q"), sc,
                                   disp.group_sizes, **kw)

    h = qgemm(xs, "expert_gate_up")                                  # [T*k, 2N]
    h = silu_mul(h)
    if impl.online_had:
        from ..quant.hadamard import matmul_hadU

        h = matmul_hadU(h)
    out = qgemm(h, "expert_down")                                    # [T*k, H]
    return combine_tokens(out, disp, x2d.shape[0])


def shared_int8_dot(aq: jax.Array, wq: jax.Array) -> jax.Array:
    """Dense int8 × int8 -> int32 product of the shared expert (cuBLAS)."""
    return jnp.dot(aq, wq, preferred_element_type=jnp.int32)


def shared_expert_ffn(x2d: jax.Array, layer_params: dict, cfg: MoEConfig
                      ) -> jax.Array:
    if "shared_gate_up_q" in layer_params:
        # REAL-quantized shared expert (quantize_model_experts_mixed) —
        # the reference's shared expert is one more problem row in the
        # fused launch (gen_workload.py:93-103), so every integer scheme
        # stores codes for real here too:
        #   per-channel sym w×a  -> dense int8 dot (int32 accumulation)
        #   grouped / asym  w×a  -> one-group XLA grouped product
        #   a16 weight-only      -> one-group XLA weight-only product
        #                           (shared_wo marks the domain statically)
        from ..ops.gmm import gmm_dequant, gmm_w8a8_grouped
        from ..quant.qparams import (quantize_act_per_row_bits,
                                     quantize_act_rows_flex)

        t = x2d.shape[0]
        bits = layer_params["act_bits_shared"]          # [2]
        sc_g = layer_params["shared_gate_up_sc"]
        grouped = (sc_g.shape[-2] > 1
                   or "shared_gate_up_zp" in layer_params
                   or "shared_down_zp" in layer_params)
        one_group = jnp.full((1,), t, jnp.int32)

        def qdot(acts, name, b):
            aq, asc = quantize_act_per_row_bits(
                acts, jnp.full((t,), b, jnp.float32))
            acc = shared_int8_dot(aq, layer_params[f"{name}_q"])
            return (acc.astype(jnp.float32) * asc
                    * layer_params[f"{name}_sc"]).astype(x2d.dtype)

        def qdot_grouped(acts, name, b):
            sc = layer_params[f"{name}_sc"]             # [G, N]
            zp = layer_params.get(f"{name}_zp")
            gsize = acts.shape[-1] // sc.shape[-2]
            # act quant stays PER-TOKEN (row_gsize -1; scales replicate
            # across G) — the fake shared protocol quantizes per token,
            # and real-vs-fake ppl must compare the same act transform
            aq, asc = quantize_act_rows_flex(
                acts, jnp.full((t,), b, jnp.float32),
                jnp.full((t,), -1.0, jnp.float32), gsize)
            return gmm_w8a8_grouped(
                aq, asc, layer_params[f"{name}_q"][None], sc[None],
                one_group, rhs_zp=None if zp is None else zp[None],
                out_dtype=x2d.dtype)

        def qdot_wo(acts, name):
            sc = layer_params[f"{name}_sc"]
            zp = layer_params.get(f"{name}_zp")
            return gmm_dequant(
                acts, layer_params[f"{name}_q"][None], sc[None],
                None if zp is None else zp[None], one_group,
                out_dtype=x2d.dtype)

        if "shared_wo" in layer_params:
            h = silu_mul(qdot_wo(x2d, "shared_gate_up"))
            out = qdot_wo(h, "shared_down")
        elif grouped:
            h = silu_mul(qdot_grouped(x2d, "shared_gate_up", bits[0]))
            out = qdot_grouped(h, "shared_down", bits[1])
        else:
            h = silu_mul(qdot(x2d, "shared_gate_up", bits[0]))
            out = qdot(h, "shared_down", bits[1])
    else:
        x_in = x2d
        if "act_bits_shared" in layer_params:
            bits = layer_params["act_bits_shared"]  # [2] (gate_up, down input)
            x_in = _act_fq_per_row(x2d, jnp.full((x2d.shape[0],), bits[0]))
        h = silu_mul(x_in @ layer_params["shared_gate_up"])
        if "act_bits_shared" in layer_params:
            h = _act_fq_per_row(h, jnp.full((h.shape[0],), bits[1]))
        out = h @ layer_params["shared_down"]
    if cfg.has_shared_expert_gate:
        gate = jax.nn.sigmoid(x2d @ layer_params["shared_gate"])  # [T, 1]
        out = out * gate.astype(out.dtype)
    return out


def moe_block(
    x: jax.Array,                # [B, S, H]
    layer_params: dict,
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
) -> jax.Array:
    b, s, h = x.shape
    x2d = x.reshape(-1, h)
    qkeys = ("expert_gate_up_q", "expert_gate_up_q_packed",
             "expert_gate_up_qcat")
    estack = layer_params.get("_expert_stack") or {}
    if impl.kind == "dense":
        y = moe_ffn_dense(x2d, layer_params, cfg)
    elif impl.quant is not None and any(
            k in layer_params or k in estack for k in qkeys):
        y = moe_ffn_ragged_quant(x2d, layer_params, cfg, impl)
    else:
        y = moe_ffn_ragged(x2d, layer_params, cfg, impl)
    if cfg.shared_expert_intermediate_size > 0:
        y = y + shared_expert_ffn(x2d, layer_params, cfg)
    return y.reshape(b, s, h)


def rope_frequencies_interleaved(
    rope_dim: int, theta: float, positions: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """cos/sin [S, rope_dim/2] for the interleaved (complex) convention
    used by DeepSeek-V2 MLA (HF ``apply_rotary_emb`` with view_as_complex)."""
    inv_freq = 1.0 / (theta ** (jnp.arange(0, rope_dim, 2, dtype=jnp.float32) / rope_dim))
    angles = positions.astype(jnp.float32)[:, None] * inv_freq[None, :]
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope_interleaved(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x [B, S, nH, d] rotated pairwise: (x[2i], x[2i+1]) as complex.

    cos/sin [S, d/2].
    """
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[None, :, None, :].astype(jnp.float32)
    s = sin[None, :, None, :].astype(jnp.float32)
    xf1 = x1.astype(jnp.float32)
    xf2 = x2.astype(jnp.float32)
    out = jnp.stack([xf1 * c - xf2 * s, xf1 * s + xf2 * c], axis=-1)
    return out.reshape(x.shape).astype(x.dtype)


def mla_attention_block(
    x: jax.Array,               # [B, S, H]
    layer_params: dict,
    cfg: MoEConfig,
    cos: jax.Array,             # [S, rope_dim/2] interleaved tables
    sin: jax.Array,
) -> jax.Array:
    """Multi-head Latent Attention (DeepSeek-V2, q_lora_rank=None variant).

    HF semantics (``modeling_deepseek_v2.py``, DeepseekV2Attention.forward):
    q = x W_q split (nope, rope); compressed kv = x W_kva split
    (c_kv -> RMSNorm -> W_kvb -> (k_nope, v), k_rope shared across heads);
    interleaved RoPE on the rope parts; scale = qk_head_dim^-1/2.
    """
    b, s, _ = x.shape
    n_h = cfg.num_heads
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d_qk = d_nope + d_rope

    q = (x @ layer_params["wq"]).reshape(b, s, n_h, d_qk)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]

    ckv = x @ layer_params["kv_a"]                      # [B, S, lora + rope]
    c_kv, k_pe = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, layer_params["kv_a_norm"], cfg.rms_norm_eps)
    kv = (c_kv @ layer_params["kv_b"]).reshape(b, s, n_h, d_nope + d_v)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]

    q_pe = apply_rope_interleaved(q_pe, cos, sin)
    k_pe = apply_rope_interleaved(k_pe[:, :, None, :], cos, sin)   # [B,S,1,dr]
    k_pe = jnp.broadcast_to(k_pe, (b, s, n_h, d_rope))

    q_full = jnp.concatenate([q_nope, q_pe], axis=-1)
    k_full = jnp.concatenate([k_nope, k_pe], axis=-1)

    scores = jnp.einsum("bsnd,btnd->bnst", q_full, k_full).astype(jnp.float32)
    scores = scores / jnp.sqrt(float(d_qk))
    mask = jnp.tril(jnp.ones((s, s), dtype=bool))
    scores = jnp.where(mask[None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    out = jnp.einsum("bnst,btnd->bsnd", probs, v)
    return out.reshape(b, s, n_h * d_v) @ layer_params["wo"]


def dense_mlp_block(x: jax.Array, layer_params: dict, cfg: MoEConfig) -> jax.Array:
    """Plain SwiGLU MLP for ds2's first dense layer(s).

    Honors the dense pseudo-expert's activation widths (``act_bits_dense``
    [2] = gate_up input / down input) when the quantizer assigned the layer
    a scheme (qconfig key ``dense-<i>``)."""
    b, s, h = x.shape
    x2d = x.reshape(-1, h)
    x_in = x2d
    fq = "act_bits_dense" in layer_params
    if fq:
        bits = layer_params["act_bits_dense"]
        x_in = _act_fq_per_row(x2d, jnp.full((x2d.shape[0],), bits[0]))
    hmid = silu_mul(x_in @ layer_params["mlp_gate_up"])
    if fq:
        hmid = _act_fq_per_row(hmid, jnp.full((hmid.shape[0],), bits[1]))
    y = hmid @ layer_params["mlp_down"]
    return y.reshape(b, s, h)


def attention_block(
    x: jax.Array,               # [B, S, H]
    layer_params: dict,
    cfg: MoEConfig,
    cos: jax.Array,
    sin: jax.Array,
    attn_backend: str = "xla",
    ring_fn=None,
) -> jax.Array:
    b, s, _ = x.shape
    q = x @ layer_params["wq"]
    k = x @ layer_params["wk"]
    v = x @ layer_params["wv"]
    if cfg.attention_bias:
        q = q + layer_params["bq"]
        k = k + layer_params["bk"]
        v = v + layer_params["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attention(q, k, v, causal=True, backend=attn_backend,
                    ring_fn=ring_fn)
    return out.reshape(b, s, -1) @ layer_params["wo"]



def make_rope_tables(cfg: MoEConfig, positions: jax.Array):
    """cos/sin tables matching the model family's rope convention."""
    if cfg.attention_type == "mla":
        return rope_frequencies_interleaved(
            cfg.qk_rope_head_dim, cfg.rope_theta, positions
        )
    return rope_frequencies(cfg.head_dim, cfg.rope_theta, positions)


def attention_dispatch(x, layer_params, cfg, cos, sin, attn_backend="xla"):
    """GQA or MLA attention per the config."""
    if cfg.attention_type == "mla":
        return mla_attention_block(x, layer_params, cfg, cos, sin)
    return attention_block(x, layer_params, cfg, cos, sin, attn_backend=attn_backend)

def decoder_layer(
    x: jax.Array,
    layer_params: dict,
    cfg: MoEConfig,
    cos: jax.Array,
    sin: jax.Array,
    impl: MoEImpl = MoEImpl(),
    dense_mlp: bool = False,
) -> jax.Array:
    if cfg.attention_type == "mla":
        h_attn = mla_attention_block(
            rms_norm(x, layer_params["input_norm"], cfg.rms_norm_eps),
            layer_params, cfg, cos, sin,
        )
    else:
        h_attn = attention_block(
            rms_norm(x, layer_params["input_norm"], cfg.rms_norm_eps),
            layer_params, cfg, cos, sin, attn_backend=impl.attn_backend,
            ring_fn=impl.ring_attn,
        )
    h = x + h_attn
    norm_h = rms_norm(h, layer_params["post_attn_norm"], cfg.rms_norm_eps)
    if dense_mlp:
        return h + dense_mlp_block(norm_h, layer_params, cfg)
    return h + moe_block(norm_h, layer_params, cfg, impl)
