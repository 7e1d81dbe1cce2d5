"""Model quantization orchestrator — the MoeModelQuantizer analog.

Reference: ``mxmoe/quant/quant.py:224-679`` (methods rtn / gptq /
rtn-had / gptq-had; per-(layer, expert, linear) schemes from a
QModelConfig; forward-pre-hooks for activation fake-quant). Functional
redesign: quantization is a pytree transform producing

  * fake-quantized expert weights (mixed per-expert schemes), and
  * per-layer ``act_bits_gateup`` / ``act_bits_down`` [E] (+
    ``act_bits_shared`` [2]) arrays the ragged forward applies per row
    group (models/layers.py::_act_fq_per_row),

so accuracy eval runs the standard forward with no hooks or module
surgery. GPTQ propagates layer inputs through already-quantized layers
(sequential semantics of ``llama_sequential``, gptq.py:297-424).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.configs import MoEConfig
from ..models.layers import make_rope_tables
from .calibrate import layer_forward_fp
from .gptq import accumulate_hessian, gptq_quantize_kn
from .rtn import fake_quant
from .rotation import rotate_model_hadamard
from .schemes import QLinearConfig, QModelConfig


def _fq_weight_kn(w_kn: jax.Array, cfg: QLinearConfig) -> jax.Array:
    """Fake-quant [.., K, N] weights grouped along K per output column."""
    if cfg.w_bits >= 16:
        return w_kn
    w_nk = jnp.swapaxes(w_kn, -1, -2)
    w_nk = fake_quant(w_nk, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip)
    return jnp.swapaxes(w_nk, -1, -2)


def _scheme_buckets(layer_cfg, num_experts: int, linear: str):
    """expert-id lists per distinct scheme for one linear family."""
    buckets: dict[str, list[int]] = {}
    for e in range(num_experts):
        c = layer_cfg.experts[str(e)].qmap()[linear]
        buckets.setdefault(c.scheme_name, []).append(e)
    return buckets


def act_gsize_arrays(qmodel_cfg, cfg: MoEConfig, num_layers: int) -> dict:
    """FLEX markers for mixed eval/serving: per-family ``act_gsize_gateup``
    / ``act_gsize_down`` [L, E, G] arrays (values = per-expert a_gsize or
    -1, replicated along the last axis so the static group count G rides
    the array SHAPE through the layer scan). Emitted only for families
    whose scheme set is flex (grouped or asym — schemes.flex_family_info);
    shared by the fake (quantizer) and real (qparams) emitters so the two
    paths apply bitwise-identical activation transforms."""
    from .schemes import flex_family_info

    out = {}
    e = cfg.num_experts
    for lin, key, kdim in (
            ("gate", "act_gsize_gateup", cfg.hidden_size),
            ("down", "act_gsize_down", cfg.moe_intermediate_size)):
        any_flex, g_min, _ = flex_family_info(qmodel_cfg, num_layers, e,
                                              lin, kdim)
        if not any_flex:
            continue
        gdim = kdim // g_min
        ag = np.full((num_layers, e, gdim), -1.0, np.float32)
        for l in range(num_layers):
            lcfg = qmodel_cfg.layer(l)
            for ei in range(e):
                c = lcfg.experts[str(ei)].qmap()[lin]
                if c.a_gsize != -1 and c.a_bits < 16:
                    assert c.a_gsize == g_min, (c.a_gsize, g_min)
                    ag[l, ei, :] = float(c.a_gsize)
        out[key] = jnp.asarray(ag)
    return out


def _act_bits_arrays(layer_cfg, num_experts: int):
    gb = np.full(num_experts, 16.0, np.float32)
    db = np.full(num_experts, 16.0, np.float32)
    for e in range(num_experts):
        qm = layer_cfg.experts[str(e)].qmap()
        assert qm["gate"].a_bits == qm["up"].a_bits, "gate/up act widths tied"
        gb[e] = float(qm["gate"].a_bits)
        db[e] = float(qm["down"].a_bits)
    return jnp.asarray(gb), jnp.asarray(db)


def make_moe_hessian_fn(cfg: MoEConfig, backend: str):
    """Jitted per-layer GPTQ Hessian accumulator (routed + shared expert)
    — shared by the fake-quant GPTQ sweep and the real-quant GPTQ path so
    the two can never diverge on Hessian semantics."""
    from ..models.layers import silu_mul
    from ..ops import gmm as gmm_ops
    from ..ops.dispatch import gather_tokens, make_dispatch, route_topk

    @jax.jit
    def hessians_for_layer(x2d, lp):
        logits = x2d @ lp["router"]
        routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                             cfg.routed_scaling_factor)
        disp = make_dispatch(routing, cfg.num_experts)
        xs = gather_tokens(x2d, disp)
        h_pre = silu_mul(gmm_ops.gmm(xs, lp["expert_gate_up"],
                                     disp.group_sizes, backend=backend))
        out = {
            "expert_gate_up": accumulate_hessian(xs, disp.group_sizes,
                                                 cfg.num_experts),
            "expert_down": accumulate_hessian(h_pre, disp.group_sizes,
                                              cfg.num_experts),
        }
        if "shared_gate_up" in lp:
            sh = silu_mul(x2d @ lp["shared_gate_up"])
            out["shared_gate_up"] = accumulate_hessian(x2d)
            out["shared_down"] = accumulate_hessian(sh)
        return out

    return hessians_for_layer


def quantize_model_fake(
    params: dict,
    cfg: MoEConfig,
    qmodel_cfg: QModelConfig,
    method: str = "rtn",
    calib_tokens: jax.Array | None = None,
    rotation_key: jax.Array | None = None,
    backend: str = "auto",
) -> dict:
    """Mixed-scheme fake quantization of routed + shared expert linears.

    method: 'rtn' | 'gptq' | 'rtn-had' | 'gptq-had' (reference method set,
    ``quant.py:248``). GPTQ requires calib_tokens.
    Returns a param pytree ready for accuracy eval with the standard
    forward (act quant arrays included).
    """
    if method.endswith("-had"):
        params = rotate_model_hadamard(params, cfg, rotation_key)
        method = method[:-4]
    assert method in ("rtn", "gptq")
    if method == "gptq":
        assert calib_tokens is not None, "GPTQ needs calibration tokens"
        return _quantize_gptq(params, cfg, qmodel_cfg, calib_tokens, backend)
    return _quantize_rtn(params, cfg, qmodel_cfg)


def _apply_buckets_kn(w: jax.Array, buckets: dict[str, list[int]],
                      layer_cfg, linear: str, hessian=None) -> jax.Array:
    """w [E, K, N]: fake-quant each scheme bucket (RTN or GPTQ w/ hessian)."""
    out = w
    for scheme, eids in buckets.items():
        c = layer_cfg.experts[str(eids[0])].qmap()[linear]
        if c.w_bits >= 16:
            continue
        idx = jnp.asarray(eids, jnp.int32)
        sub = jnp.take(w, idx, axis=0)
        if hessian is None:
            fq = _fq_weight_kn(sub, c)
        else:
            h_sub = jnp.take(hessian, idx, axis=0)
            fq = gptq_quantize_kn(sub, h_sub, c).w_fq
        out = out.at[idx].set(fq.astype(w.dtype))
    return out


def _shared_cfgs(layer_cfg, num_experts: int):
    key = str(num_experts)  # shared expert = index E (reference convention)
    if key in layer_cfg.experts:
        return layer_cfg.experts[key].qmap()
    return None


def _quantize_layer_params(lp: dict, cfg: MoEConfig, layer_cfg,
                           hessians: dict | None = None) -> dict:
    e = cfg.num_experts
    out = dict(lp)
    # gate/up tied (solver constraint): the fused [E, H, 2N] gate_up weight
    # quantizes with the gate scheme; down with its own.
    for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
        buckets = _scheme_buckets(layer_cfg, e, lin)
        h = None if hessians is None else hessians[name]
        out[name] = _apply_buckets_kn(lp[name], buckets, layer_cfg, lin, h)

    sh = _shared_cfgs(layer_cfg, e)
    if sh is not None and "shared_gate_up" in lp:
        for name, c in (("shared_gate_up", sh["gate"]), ("shared_down", sh["down"])):
            if c.w_bits >= 16:
                continue
            if hessians is not None and name in hessians:
                out[name] = gptq_quantize_kn(
                    lp[name][None], hessians[name][None], c
                ).w_fq[0].astype(lp[name].dtype)
            else:
                out[name] = _fq_weight_kn(lp[name], c)

    gb, db = _act_bits_arrays(layer_cfg, e)
    out["act_bits_gateup"] = gb
    out["act_bits_down"] = db
    if sh is not None and "shared_gate_up" in lp:
        out["act_bits_shared"] = jnp.asarray(
            [float(sh["gate"].a_bits), float(sh["down"].a_bits)], jnp.float32
        )
    return out


def _dense_cfgs(qmodel_cfg, dl: int):
    """Scheme slot for ds2's dense first layer dl (qconfig key dense-<dl>,
    single pseudo-expert '0'; reference layer-0 special case,
    ``moe_utils.py:94-128``)."""
    lc = qmodel_cfg.layers.get(f"dense-{dl}")
    if lc is None:
        return None
    return lc.experts["0"].qmap()


def _quantize_dense_layer(dlp: dict, qm: dict, hessians: dict | None = None):
    """Fake-quant one dense layer's MLP in place (gate/up tied via the
    fused mlp_gate_up operand, like the routed expert convention)."""
    out = dict(dlp)
    cg, cd = qm["gate"], qm["down"]
    if cg.w_bits < 16:
        if hessians is not None:
            out["mlp_gate_up"] = gptq_quantize_kn(
                dlp["mlp_gate_up"][None], hessians["mlp_gate_up"][None], cg
            ).w_fq[0].astype(dlp["mlp_gate_up"].dtype)
        else:
            out["mlp_gate_up"] = _fq_weight_kn(dlp["mlp_gate_up"], cg)
    if cd.w_bits < 16:
        if hessians is not None:
            out["mlp_down"] = gptq_quantize_kn(
                dlp["mlp_down"][None], hessians["mlp_down"][None], cd
            ).w_fq[0].astype(dlp["mlp_down"].dtype)
        else:
            out["mlp_down"] = _fq_weight_kn(dlp["mlp_down"], cd)
    act_bits = jnp.asarray([float(cg.a_bits), float(cd.a_bits)], jnp.float32)
    return out, act_bits


def _quantize_dense_stack_rtn(params: dict, qmodel_cfg) -> dict:
    """RTN path for the dense_layers subtree; emits act_bits_dense [Ld, 2]."""
    if "dense_layers" not in params:
        return params
    dls = params["dense_layers"]
    n_dense = dls["input_norm"].shape[0]
    if not any(f"dense-{dl}" in qmodel_cfg.layers for dl in range(n_dense)):
        return params
    new = {k: [] for k in dls}
    act = []
    for dl in range(n_dense):
        dlp = jax.tree_util.tree_map(lambda a: a[dl], dls)
        qm = _dense_cfgs(qmodel_cfg, dl)
        if qm is not None:
            dlp, ab = _quantize_dense_layer(dlp, qm)
        else:
            ab = jnp.asarray([16.0, 16.0], jnp.float32)
        for k in new:
            new[k].append(dlp[k])
        act.append(ab)
    out = dict(params)
    out["dense_layers"] = {k: jnp.stack(v) for k, v in new.items()}
    out["dense_layers"]["act_bits_dense"] = jnp.stack(act)
    return out


def _quantize_rtn(params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig) -> dict:
    params = _quantize_dense_stack_rtn(params, qmodel_cfg)
    num_layers = params["layers"]["router"].shape[0]
    new_layers = {k: [] for k in params["layers"]}
    extra = {"act_bits_gateup": [], "act_bits_down": []}
    has_shared = "shared_gate_up" in params["layers"]
    if has_shared:
        extra["act_bits_shared"] = []
    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], params["layers"])
        qlp = _quantize_layer_params(lp, cfg, qmodel_cfg.layer(l))
        for k in new_layers:
            new_layers[k].append(qlp[k])
        for k in extra:
            extra[k].append(qlp[k])
    stacked = {k: jnp.stack(v) for k, v in new_layers.items()}
    stacked.update({k: jnp.stack(v) for k, v in extra.items()})
    stacked.update(act_gsize_arrays(qmodel_cfg, cfg, num_layers))
    out = dict(params)
    out["layers"] = stacked
    return out


def _quantize_gptq(params, cfg, qmodel_cfg, tokens, backend):
    """Layer-streamed GPTQ: Hessians from the FP pass of each layer, inputs
    propagated through already-quantized layers."""
    from ..ops.dispatch import route_topk, make_dispatch, gather_tokens
    from ..ops import gmm as gmm_ops
    from ..models.layers import silu_mul

    b, s = tokens.shape
    positions = jnp.arange(s)
    cos, sin = make_rope_tables(cfg, positions)
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    new_dense = None
    if "dense_layers" in params:
        from .calibrate import dense_layer_forward_fp

        dense_fwd = jax.jit(partial(dense_layer_forward_fp, cfg=cfg,
                                    cos=cos, sin=sin))
        dls = params["dense_layers"]
        new_dls = {k: [] for k in dls}
        act_dense = []
        any_dense_cfg = False
        for dl in range(dls["input_norm"].shape[0]):
            dlp = jax.tree_util.tree_map(lambda a: a[dl], dls)
            _, dx2d = dense_fwd(x, dlp)
            qm = _dense_cfgs(qmodel_cfg, dl)
            if qm is not None:
                any_dense_cfg = True
                nd = dlp["mlp_gate_up"].shape[-1] // 2
                sh_mid = jax.nn.silu(dx2d @ dlp["mlp_gate_up"][:, :nd]) * \
                    (dx2d @ dlp["mlp_gate_up"][:, nd:])
                hs = {"mlp_gate_up": accumulate_hessian(dx2d),
                      "mlp_down": accumulate_hessian(sh_mid)}
                dlp, ab = _quantize_dense_layer(dlp, qm, hessians=hs)
            else:
                ab = jnp.asarray([16.0, 16.0], jnp.float32)
            for k in new_dls:
                new_dls[k].append(dlp[k])
            act_dense.append(ab)
            # propagate through the QUANTIZED dense layer
            x, _ = dense_fwd(x, dlp)
        if any_dense_cfg:
            new_dense = {k: jnp.stack(v) for k, v in new_dls.items()}
            new_dense["act_bits_dense"] = jnp.stack(act_dense)
    fwd = jax.jit(partial(layer_forward_fp, cfg=cfg, backend=backend))

    hessians_for_layer = make_moe_hessian_fn(cfg, backend)

    num_layers = params["layers"]["router"].shape[0]
    new_layers = {k: [] for k in params["layers"]}
    extra = {"act_bits_gateup": [], "act_bits_down": []}
    if "shared_gate_up" in params["layers"]:
        extra["act_bits_shared"] = []
    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], params["layers"])
        _, x2d = fwd(x, lp, cos=cos, sin=sin)
        hs = hessians_for_layer(x2d, lp)
        qlp = _quantize_layer_params(lp, cfg, qmodel_cfg.layer(l), hessians=hs)
        for k in new_layers:
            new_layers[k].append(qlp[k])
        for k in extra:
            extra[k].append(qlp[k])
        # propagate through the QUANTIZED layer (llama_sequential semantics)
        x, _ = fwd(x, {k: qlp[k] for k in lp}, cos=cos, sin=sin)
    stacked = {k: jnp.stack(v) for k, v in new_layers.items()}
    stacked.update({k: jnp.stack(v) for k, v in extra.items()})
    stacked.update(act_gsize_arrays(qmodel_cfg, cfg, num_layers))
    out = dict(params)
    out["layers"] = stacked
    if new_dense is not None:
        out["dense_layers"] = new_dense
    return out


def quantize_model_experts_mixed_gptq(
    params: dict,
    cfg: MoEConfig,
    qmodel_cfg: QModelConfig,
    calib_tokens: jax.Array,
    backend: str = "auto",
    pack_w4: bool = False,
    rotation_key: jax.Array | None = None,
    hadamard: bool = False,
    act_order: bool = False,
) -> dict:
    """REAL-quantize routed (+shared) experts with GPTQ-optimized codes.

    The RTN real quantizer (``qparams.quantize_model_experts_mixed``)
    serves RTN codes; this variant runs the same layer-streamed GPTQ
    sweep as the fake-quant eval path (Hessians from the FP pass, inputs
    propagated through already-quantized layers — llama_sequential
    semantics) but keeps the INTEGER CODES and per-channel scales for the
    one-launch kernels instead of dequantized weights. The served model
    then carries exactly the accuracy the gptq eval rows measure — the
    reference never connects its GPTQ quantizer to its kernels
    (``quant.py:319-359`` fake hooks vs ``test.cu`` bench weights).

    Scheme domain matches the RTN variant (incl. FLEX): w<=8 with a<=8 or
    a16, grouped and asymmetric schemes included — grouped codes use
    STATIC GROUPS (per-group params from the original weights,
    reference ``gptq.py:196-206``) so scales stay aligned to original
    K-groups and are servable by the grouped/packed kernels even with
    ``act_order=True``. ``hadamard=True`` rotates the model first
    (gptq-had); the returned pytree is the ROTATED model with quantized
    experts — serve it as-is. Dense-first pseudo-layers (ds2) keep
    fake-quant handling: unsupported here, asserted away.
    """
    from ..ops.dispatch import route_topk, make_dispatch, gather_tokens
    from ..ops import gmm as gmm_ops
    from ..models.layers import silu_mul
    from .gptq import accumulate_hessian, gptq_quantize_kn

    assert "dense_layers" not in params, (
        "GPTQ real-quant does not handle dense-first pseudo-layers yet; "
        "use the RTN real quantizer or fake-quant eval for ds2")
    if hadamard:
        if isinstance(params["layers"]["router"], np.ndarray):
            # numpy pytree (convert's as_numpy load at real depths):
            # layer-streamed in-place rotation, peak = pytree + one f32
            # layer instead of a full f32 model copy
            from .rotation import rotate_model_hadamard_host

            params = rotate_model_hadamard_host(params, cfg, rotation_key)
        else:
            params = rotate_model_hadamard(params, cfg, rotation_key)

    e = cfg.num_experts
    b, s = calib_tokens.shape
    positions = jnp.arange(s)
    cos, sin = make_rope_tables(cfg, positions)
    x = jnp.take(params["embed"], calib_tokens, axis=0, mode="clip")
    fwd = jax.jit(partial(layer_forward_fp, cfg=cfg, backend=backend))

    hessians_for_layer = make_moe_hessian_fn(cfg, backend)

    num_layers = params["layers"]["router"].shape[0]
    layers = params["layers"]
    acc = {}      # name -> per-layer HOST-staged (np) results
    gb = np.zeros((num_layers, e), np.float32)
    db = np.zeros((num_layers, e), np.float32)
    pf_all = {"expert_gate_up": [], "expert_down": []}
    from .schemes import flex_family_info

    flex_info = {
        "expert_gate_up": flex_family_info(qmodel_cfg, num_layers, e,
                                           "gate", cfg.hidden_size),
        "expert_down": flex_family_info(qmodel_cfg, num_layers, e,
                                        "down", cfg.moe_intermediate_size),
    }
    # shared-expert real quant is all-or-nothing (mixed fp/int8 layers
    # would complicate the forward): decide from the FULL config upfront.
    # Grouped/asym shared schemes fall back to FAKE-quantized (GPTQ) bf16
    # shared weights + act bits — same numerics as the fake protocol.
    shared_all_cfgs = "shared_gate_up" in layers and all(
        _shared_cfgs(qmodel_cfg.layer(l), e) is not None
        for l in range(num_layers))
    def _shared_pc_sym(l):
        sc = _shared_cfgs(qmodel_cfg.layer(l), e)
        return all(q.w_bits <= 8 and q.w_sym and q.w_gsize == -1
                   and q.a_bits <= 8 for q in (sc["gate"], sc["down"]))

    shared_ok = shared_all_cfgs and all(
        _shared_pc_sym(l) for l in range(num_layers))
    shared_fake = shared_all_cfgs and not shared_ok
    sb = np.zeros((num_layers, 2), np.float32)

    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], layers)
        _, x2d = fwd(x, lp, cos=cos, sin=sin)
        hs = hessians_for_layer(x2d, lp)
        lcfg = qmodel_cfg.layer(l)
        qlp = dict(lp)

        for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
            w = lp[name]                                      # [E, K, N]
            any_flex, g_min, any_asym = flex_info[name]
            gdim = w.shape[-2] // g_min if any_flex else 1
            buckets: dict[str, list[int]] = {}
            pf_l = [0] * e
            for ei in range(e):
                c = lcfg.experts[str(ei)].qmap()[lin]
                assert (c.w_bits <= 8
                        and (c.a_bits <= 8 or c.a_bits >= 16)), (
                    f"GPTQ real-quant supports int w<=8 w×a (a<=8) and "
                    f"weight-only (a>=16) schemes, got {c.scheme_name}")
                if pack_w4:
                    assert c.a_bits <= 8, (
                        "pack_w4 requires pure w×a mixes, got "
                        f"{c.scheme_name}")
                    pf_l[ei] = int(c.w_bits <= 4)
                buckets.setdefault(c.scheme_name, []).append(ei)
            pf_all[name].append(pf_l)
            # HOST-staged results (same rationale as the RTN variant:
            # whole-stack device accumulators OOM real-model depths);
            # only the fake weights needed for propagation stay on device
            q_l = np.zeros(w.shape, np.int8)
            sc_l = np.zeros((e, gdim, w.shape[-1]), np.float32)
            zp_l = np.zeros_like(sc_l)
            fq_l = jnp.zeros(w.shape, jnp.float32)
            for scheme, eids in buckets.items():
                c = lcfg.experts[str(eids[0])].qmap()[lin]
                idx = jnp.asarray(eids, jnp.int32)
                sub = jnp.take(w, idx, axis=0)
                h_sub = jnp.take(hs[name], idx, axis=0)
                # grouped schemes: STATIC groups — original-K-group-
                # aligned scales, servable by the grouped/packed kernels
                res = gptq_quantize_kn(sub, h_sub, c, act_order=act_order,
                                       static_groups=(c.w_gsize != -1))
                codes = res.codes                             # [e, K, N]
                scale_kn = jnp.swapaxes(res.scale, -1, -2)    # [e, K//g, N]
                zp_kn = jnp.swapaxes(res.zp, -1, -2)
                from .packing import _to_signed_storage

                codes, scale_kn, zp_kn = _to_signed_storage(
                    codes, scale_kn, zp_kn, c.w_bits,
                    c.w_sym or c.w_bits == 1.5)
                rep = gdim // scale_kn.shape[-2]
                q_l[np.asarray(eids)] = np.asarray(codes, np.int8)
                sc_l[np.asarray(eids)] = np.repeat(
                    np.asarray(scale_kn, np.float32), rep, axis=-2)
                zp_l[np.asarray(eids)] = np.repeat(
                    np.asarray(zp_kn, np.float32), rep, axis=-2)
                fq_l = fq_l.at[idx].set(res.w_fq)
            acc.setdefault(f"{name}_q", []).append(q_l)
            acc.setdefault(f"{name}_sc", []).append(sc_l)
            acc.setdefault(f"{name}_zp", []).append(zp_l)
            qlp[name] = fq_l.astype(w.dtype)

        for ei in range(e):
            qm = lcfg.experts[str(ei)].qmap()
            gb[l, ei] = float(qm["gate"].a_bits)
            db[l, ei] = float(qm["down"].a_bits)

        if shared_ok:
            sh_cfg = _shared_cfgs(lcfg, e)
            for name, lin in (("shared_gate_up", "gate"),
                              ("shared_down", "down")):
                res = gptq_quantize_kn(lp[name][None], hs[name][None],
                                       sh_cfg[lin])
                acc.setdefault(f"{name}_q", []).append(
                    np.asarray(res.codes[0], np.int8))
                acc.setdefault(f"{name}_sc", []).append(
                    np.asarray(jnp.swapaxes(res.scale[0], -1, -2)))
                qlp[name] = res.w_fq[0].astype(lp[name].dtype)
            sb[l] = [float(sh_cfg["gate"].a_bits),
                     float(sh_cfg["down"].a_bits)]
        elif shared_fake:
            sh_cfg = _shared_cfgs(lcfg, e)
            for name, lin in (("shared_gate_up", "gate"),
                              ("shared_down", "down")):
                res = gptq_quantize_kn(
                    lp[name][None], hs[name][None], sh_cfg[lin],
                    act_order=act_order,
                    static_groups=(sh_cfg[lin].w_gsize != -1))
                fq = res.w_fq[0].astype(lp[name].dtype)
                acc.setdefault(f"{name}_fake", []).append(np.asarray(fq))
                qlp[name] = fq
            sb[l] = [float(sh_cfg["gate"].a_bits),
                     float(sh_cfg["down"].a_bits)]

        # propagate through the QUANTIZED layer (llama_sequential); qlp is
        # NOT retained — the fake weights only exist for this propagation
        x, _ = fwd(x, qlp, cos=cos, sin=sin)

    new = dict(layers)
    for name in ("expert_gate_up", "expert_down"):
        del new[name]
        sc_acc = jnp.asarray(np.stack(acc[f"{name}_sc"]))
        any_flex, _, any_asym = flex_info[name]
        zp_acc = jnp.asarray(np.stack(acc[f"{name}_zp"]))
        if pack_w4:
            from .packing import pack_ragged_stack

            (new[f"{name}_qcat"], new[f"{name}_blk"],
             new[f"{name}_pf"]) = pack_ragged_stack(acc[f"{name}_q"],
                                                    pf_all[name])
            new[f"{name}_sc"] = sc_acc
            if any_asym:
                new[f"{name}_zp"] = zp_acc
        else:
            new[f"{name}_q"] = jnp.asarray(np.stack(acc[f"{name}_q"]))
            new[f"{name}_sc"] = sc_acc
            if any_asym or not any_flex:
                new[f"{name}_zp"] = zp_acc
    new["act_bits_gateup"] = jnp.asarray(gb)
    new["act_bits_down"] = jnp.asarray(db)
    new.update(act_gsize_arrays(qmodel_cfg, cfg, num_layers))
    if shared_ok and "shared_gate_up_q" in acc:
        for name in ("shared_gate_up", "shared_down"):
            del new[name]
            new[f"{name}_q"] = jnp.asarray(np.stack(acc[f"{name}_q"]))
            new[f"{name}_sc"] = jnp.asarray(np.stack(acc[f"{name}_sc"]))
        new["act_bits_shared"] = jnp.asarray(sb)
    elif shared_fake and "shared_gate_up_fake" in acc:
        for name in ("shared_gate_up", "shared_down"):
            new[name] = jnp.asarray(np.stack(acc[f"{name}_fake"]))
        new["act_bits_shared"] = jnp.asarray(sb)

    out = dict(params)
    out["layers"] = new
    return out
