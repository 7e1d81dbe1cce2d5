"""Per-linear-block quantization-loss calibration (layer_out_norm).

Reference semantics (``quant.py:516-612``): for each layer, compare the FP
layer output against the output with exactly one expert linear block
(gate | up | down) fake-quantized — weights AND that linear's input
activations — feeding every layer FP inputs; record
``‖q_out − fp_out‖_F`` over the whole calibration tensor. Output JSON:
``{layer: {expert: [gate_err, up_err, down_err]}}`` — the exact schema the
bitwidth solver ingests (``bits_solver.py:86-96``).

Redesign of the reference: instead of E×3 sequential layer re-forwards, a
quantized block only perturbs rows routed to that expert, and the MoE
combine is linear in expert outputs. So ONE grouped-matmul pass per
(linear, scheme) yields the loss for ALL experts simultaneously:

    δ_down_out = gmm(δh, W_down);  err²[e] = Σ_{rows of e} ‖w_combine·δ‖²

— an O(E) speedup with bitwise-equivalent semantics (verified against a
direct per-expert oracle in tests/test_calibrate.py).
"""

from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.configs import MoEConfig
from ..models.layers import (attention_dispatch, decoder_layer, make_rope_tables,
                             rms_norm, silu_mul, shared_expert_ffn)
from ..ops.dispatch import route_topk, make_dispatch, gather_tokens
from ..ops import gmm as gmm_ops
from .rtn import fake_quant
from .schemes import QLinearConfig, LINEAR_NAMES


def _fq_weight(w: jax.Array, cfg: QLinearConfig) -> jax.Array:
    """Fake-quant stacked [E, K, N] weights, grouped along K per column."""
    if cfg.w_bits >= 16:
        return w
    w_nk = jnp.swapaxes(w, -1, -2)
    w_nk = fake_quant(w_nk, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip)
    return jnp.swapaxes(w_nk, -1, -2)


def _fq_act(x: jax.Array, cfg: QLinearConfig) -> jax.Array:
    if cfg.a_bits >= 16:
        return x
    return fake_quant(x, cfg.a_bits, cfg.a_gsize, cfg.a_sym, cfg.a_clip)


def moe_calib_errors(
    x2d: jax.Array,            # [T, H] MoE-block inputs (post-norm)
    layer_params: dict,
    cfg: MoEConfig,
    qcfg: QLinearConfig,
    backend: str = "auto",
    fq_weights: dict | None = None,
    only: str | None = None,
) -> jax.Array:
    """Squared layer-out error for every (expert, linear) under one scheme.

    Returns err2 [E, 3] (gate, up, down order = LINEAR_NAMES); with
    ``only`` in {"gate", "up", "down"}: [E, 1] for that linear — the
    staged path calibrates ONE linear at a time so only one fq weight set
    is resident (57B widths: FP weights + two fq sets fill an ~8 GB device
    before the down sweep starts).
    fq_weights optionally supplies pre-quantized weights (GPTQ path):
    keys gate/up/down [E, K, N] (+ shared_gate/shared_up/shared_down);
    absent keys fall back to RTN fake-quant.
    """
    e = cfg.num_experts
    n = cfg.moe_intermediate_size
    gate_up = layer_params["expert_gate_up"]       # [E, H, 2N]
    wg, wu = gate_up[..., :n], gate_up[..., n:]
    wd = layer_params["expert_down"]               # [E, N, H]
    fqw = fq_weights or {}

    def fq_w(w, name):
        return fqw[name] if name in fqw else _fq_weight(w, qcfg)

    logits = x2d @ layer_params["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    disp = make_dispatch(routing, e)
    xs = gather_tokens(x2d, disp)                  # [T*k, H]
    gs = disp.group_sizes
    w_comb = disp.combine_weights[:, None].astype(jnp.float32)
    row_expert = jnp.repeat(
        jnp.arange(e, dtype=jnp.int32), gs, total_repeat_length=xs.shape[0]
    )

    run = partial(gmm_ops.gmm, group_sizes=gs, backend=backend)

    g_fp = run(xs, wg)
    u_fp = run(xs, wu)
    h_fp = jax.nn.silu(g_fp) * u_fp
    d_fp = run(h_fp, wd)

    xs_fq = _fq_act(xs, qcfg)

    def per_expert_sq(delta_rows: jax.Array) -> jax.Array:
        contrib = jnp.sum((w_comb * delta_rows.astype(jnp.float32)) ** 2, axis=-1)
        return jax.ops.segment_sum(contrib, row_expert, num_segments=e)

    cols = []
    if only in (None, "gate"):
        # gate quantized: affects h via silu(gate), flows through FP down
        g_q = run(xs_fq, fq_w(wg, "gate"))
        dh = jax.nn.silu(g_q) * u_fp - h_fp
        cols.append(per_expert_sq(run(dh, wd)))
    if only in (None, "up"):
        u_q = run(xs_fq, fq_w(wu, "up"))
        dh = jax.nn.silu(g_fp) * u_q - h_fp
        cols.append(per_expert_sq(run(dh, wd)))
    if only in (None, "down"):
        # down quantized: its input is h_fp, act-fake-quantized
        d_q = run(_fq_act(h_fp, qcfg), fq_w(wd, "down"))
        cols.append(per_expert_sq(d_q - d_fp))

    errs = jnp.stack(cols, axis=-1)  # [E, 3] (or [E, 1] with `only`)

    # Shared expert (reference treats it as expert index E with its own
    # scheme assignment: ``moe_utils.py:116-123``, ``bits_solver.py:566-575``)
    if cfg.shared_expert_intermediate_size > 0:
        ns = cfg.shared_expert_intermediate_size
        sg_up = layer_params["shared_gate_up"]
        swg, swu = sg_up[..., :ns], sg_up[..., ns:]
        swd = layer_params["shared_down"]
        gate_mult = (
            jax.nn.sigmoid(x2d @ layer_params["shared_gate"]).astype(jnp.float32)
            if cfg.has_shared_expert_gate else 1.0
        )
        sg = x2d @ swg
        su = x2d @ swu
        sh = jax.nn.silu(sg) * su
        sd = sh @ swd
        x_fq2 = _fq_act(x2d, qcfg)

        def tot_sq(delta):
            return jnp.sum((gate_mult * delta.astype(jnp.float32)) ** 2)

        se = []
        if only in (None, "gate"):
            g_q = x_fq2 @ (fqw["shared_gate"] if "shared_gate" in fqw else _fq_weight(swg, qcfg))
            se.append(tot_sq((jax.nn.silu(g_q) * su - sh) @ swd))
        if only in (None, "up"):
            u_q = x_fq2 @ (fqw["shared_up"] if "shared_up" in fqw else _fq_weight(swu, qcfg))
            se.append(tot_sq((jax.nn.silu(sg) * u_q - sh) @ swd))
        if only in (None, "down"):
            d_qq = _fq_act(sh, qcfg) @ (fqw["shared_down"] if "shared_down" in fqw else _fq_weight(swd, qcfg))
            se.append(tot_sq(d_qq - sd))
        errs = jnp.concatenate([errs, jnp.stack(se)[None]], axis=0)

    return errs  # [E(+1 shared), 3]


def dense_calib_errors(
    x2d: jax.Array,            # [T, H] dense-MLP inputs (post-attn-norm)
    dlp: dict,                 # one dense layer's params (mlp_gate_up/down)
    cfg: MoEConfig,
    qcfg: QLinearConfig,
    fq_weights: dict | None = None,
) -> jax.Array:
    """Squared layer-out error [1, 3] for a dense first layer's MLP — the
    ds2 layer-0 pseudo-expert (reference special-cases it in
    ``moe_utils.py:94-128``; here it gets its own calib row ``dense-<i>``)."""
    nd = dlp["mlp_gate_up"].shape[-1] // 2
    wg, wu = dlp["mlp_gate_up"][..., :nd], dlp["mlp_gate_up"][..., nd:]
    wd = dlp["mlp_down"]
    fqw = fq_weights or {}

    g_fp = x2d @ wg
    u_fp = x2d @ wu
    h_fp = jax.nn.silu(g_fp) * u_fp
    d_fp = h_fp @ wd
    x_fq = _fq_act(x2d, qcfg)

    def tot_sq(delta):
        return jnp.sum(delta.astype(jnp.float32) ** 2)

    g_q = x_fq @ (fqw["gate"] if "gate" in fqw else _fq_weight(wg, qcfg))
    e_g = tot_sq((jax.nn.silu(g_q) * u_fp - h_fp) @ wd)
    u_q = x_fq @ (fqw["up"] if "up" in fqw else _fq_weight(wu, qcfg))
    e_u = tot_sq((jax.nn.silu(g_fp) * u_q - h_fp) @ wd)
    d_q = _fq_act(h_fp, qcfg) @ (fqw["down"] if "down" in fqw else _fq_weight(wd, qcfg))
    e_d = tot_sq(d_q - d_fp)
    return jnp.stack([e_g, e_u, e_d])[None]     # [1, 3]


def dense_layer_forward_fp(
    x: jax.Array, dlp: dict, cfg: MoEConfig, cos, sin,
) -> tuple[jax.Array, jax.Array]:
    """FP dense decoder layer returning (layer_out, mlp_input_2d)."""
    h = x + attention_dispatch(
        rms_norm(x, dlp["input_norm"], cfg.rms_norm_eps), dlp, cfg, cos, sin,
    )
    mlp_in = rms_norm(h, dlp["post_attn_norm"], cfg.rms_norm_eps)
    b, s, hid = mlp_in.shape
    x2d = mlp_in.reshape(-1, hid)
    y = silu_mul(x2d @ dlp["mlp_gate_up"]) @ dlp["mlp_down"]
    return h + y.reshape(b, s, hid), x2d


def layer_forward_fp(
    x: jax.Array, layer_params: dict, cfg: MoEConfig, cos, sin,
    backend: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """FP decoder layer returning (layer_out, moe_block_input_2d)."""
    h = x + attention_dispatch(
        rms_norm(x, layer_params["input_norm"], cfg.rms_norm_eps),
        layer_params, cfg, cos, sin,
    )
    moe_in = rms_norm(h, layer_params["post_attn_norm"], cfg.rms_norm_eps)
    b, s, hid = moe_in.shape
    x2d = moe_in.reshape(-1, hid)

    logits = x2d @ layer_params["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    disp = make_dispatch(routing, cfg.num_experts)
    xs = gather_tokens(x2d, disp)
    hh = gmm_ops.gmm(xs, layer_params["expert_gate_up"], disp.group_sizes, backend=backend)
    hh = silu_mul(hh)
    outr = gmm_ops.gmm(hh, layer_params["expert_down"], disp.group_sizes, backend=backend)
    from ..ops.dispatch import combine_tokens

    y = combine_tokens(outr, disp, x2d.shape[0])
    if cfg.shared_expert_intermediate_size > 0:
        y = y + shared_expert_ffn(x2d, layer_params, cfg)
    return h + y.reshape(b, s, hid), x2d


def calibrate_model(
    params: dict,
    tokens: jax.Array,            # [B, S] calibration token ids
    cfg: MoEConfig,
    schemes: dict[str, QLinearConfig],
    save_dir: str | None = None,
    model_id: str = "model",
    method: str = "rtn",
    backend: str = "auto",
    resume: bool = False,
    stage_host: bool | None = None,
) -> dict[str, dict]:
    """Layer-streamed calibration over all layers × schemes.

    Returns {scheme_name: {layer: {expert: [g, u, d]}}} and (optionally)
    incrementally writes one JSON per scheme after each layer — the
    reference's crash-resumable per-layer checkpointing
    (``quant.py:603-607``).

    ``stage_host`` (default: auto — on whenever the default backend is an
    accelerator): keep the full parameter pytree on the HOST and move ONE
    layer to the device per iteration — the reference's per-layer
    ``layer.to(cuda)`` staging (``quant.py:551-552``). A 24-layer model at
    real widths is ~29 GB bf16, more than a small device holds, and CPU
    execution of the L x E x 3 re-forward hot loop is ~40 min/layer.
    """
    if stage_host is None:
        stage_host = jax.default_backend() != "cpu"
    if stage_host:
        # numpy-ify FIRST (no-op view when the loader already returned
        # numpy via as_numpy=True), so the rotation below can run streamed
        # and in place instead of materializing a full jax f32 copy
        def host(t):
            def w(a):
                a = np.asarray(a)
                return a if a.flags.writeable else np.array(a)
            return jax.tree_util.tree_map(w, t)

        params = dict(params)
        params["layers"] = host(params["layers"])
        if "dense_layers" in params:
            params["dense_layers"] = host(params["dense_layers"])
    rotate_stage = None
    if method.endswith("-had"):
        # reference: ModelRotator rotates the whole model at quantizer
        # init (quant.py:262-279) — the calibration measures rotated
        # blocks. Unstaged, do the same up front. Staged, the rotation
        # RIDES THE STAGING TRANSFER instead: fuse+R1 is layer-local, so
        # each layer is rotated on device right after its host->device
        # copy, and x enters rotated coordinates via one [T, H] @ Q after
        # the embed gather (Q acts on the hidden axis; take() picks rows,
        # so gather-then-rotate == rotate-then-gather). This avoids any
        # full rotated copy of the model on the host.
        base_method = method[:-4]
        if stage_host:
            from .hadamard import random_hadamard_matrix
            from .rotation import _fuse_rotate_one_layer

            q_rot = random_hadamard_matrix(
                cfg.hidden_size, jax.random.PRNGKey(0), dtype=jnp.float32)
            rotate_stage = jax.jit(_fuse_rotate_one_layer)
        else:
            from .rotation import rotate_model_hadamard

            params = rotate_model_hadamard(params, cfg)
    else:
        base_method = method
    assert base_method in ("rtn", "gptq")
    if stage_host:
        params["embed"] = jnp.asarray(np.asarray(params["embed"]))

    b, s = tokens.shape
    positions = jnp.arange(s)
    cos, sin = make_rope_tables(cfg, positions)
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    if rotate_stage is not None:
        x = (x.astype(jnp.float32) @ q_rot).astype(x.dtype)
    if stage_host:
        # the embedding table ([V, H] ~620 MB at qwen2_moe widths) is only
        # needed for this one gather; DELETE it so the device buffer frees
        # once the enqueued gather completes. del (not = None) keeps the
        # invariant explicit: any later embed access raises KeyError
        # instead of silently operating on None (advisor round-4 low)
        del params["embed"]

    fwd = jax.jit(partial(layer_forward_fp, cfg=cfg, backend=backend))
    errf = {
        name: jax.jit(partial(moe_calib_errors, cfg=cfg, qcfg=qc, backend=backend))
        for name, qc in schemes.items()
    }
    errf_lin = {
        (name, lin): jax.jit(partial(moe_calib_errors, cfg=cfg, qcfg=qc,
                                     backend=backend, only=lin))
        for name, qc in schemes.items() for lin in ("gate", "up", "down")
    }

    losses: dict[str, dict] = {name: {} for name in schemes}

    if "dense_layers" in params:
        # ds2: first dense layer(s) are calibrated as pseudo-experts
        # (layer key "dense-<i>", single expert "0") while propagating FP
        dense_fwd = jax.jit(partial(dense_layer_forward_fp, cfg=cfg,
                                    cos=cos, sin=sin))
        derrf = {
            name: jax.jit(partial(dense_calib_errors, cfg=cfg, qcfg=qc))
            for name, qc in schemes.items()
        }
        for dl in range(params["dense_layers"]["input_norm"].shape[0]):
            dlp = jax.tree_util.tree_map(lambda a: a[dl], params["dense_layers"])
            if stage_host:
                dlp = jax.device_put(dlp)
                if rotate_stage is not None:
                    dlp = rotate_stage(dlp, q_rot)
            x, dx2d = dense_fwd(x, dlp)
            for name, qc in schemes.items():
                fqw = None
                if base_method == "gptq":
                    fqw = _gptq_dense_fq_weights(dx2d, dlp, qc)
                err2 = np.asarray(derrf[name](dx2d, dlp, fq_weights=fqw),
                                  np.float64)
                err = np.sqrt(err2)
                losses[name][f"dense-{dl}"] = {
                    "0": [float(v) for v in err[0]]
                }
    if resume and save_dir:
        prior = load_resumable(save_dir, model_id, method, schemes)
        for name, d in prior.items():
            losses[name].update(d)
    paths = {}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        for name in schemes:
            paths[name] = os.path.join(
                save_dir, f"{model_id}-MOE-layer_out_norm-{method}-{name}.json"
            )

    gptq_fq = None
    if base_method == "gptq":
        # out_dtype: fake-quant weights held at the MODEL dtype (the
        # reference keeps them in the model's fp16, quant.py:385-466);
        # f32 copies of three [E,K,N] linears were ~2 GB of an 8 GB
        # device during staged calibration
        gptq_fq = partial(
            _gptq_layer_fq_weights, cfg=cfg, backend=backend,
            out_dtype=params["layers"]["expert_gate_up"].dtype,
        )

    import time as _time

    num_layers = params["layers"]["router"].shape[0]
    t0 = _time.time()
    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], params["layers"])
        if stage_host:
            # ONE host->device transfer per layer (reference layer.to(cuda),
            # quant.py:551); every jitted call below then reuses it
            lp = jax.device_put(lp)
            if rotate_stage is not None:
                lp = rotate_stage(lp, q_rot)
        x_next, x2d = fwd(x, lp, cos=cos, sin=sin)
        if resume and all(str(l) in losses[name] for name in schemes):
            x = x_next  # already calibrated (crash-resume); propagate only
            continue
        for name, qc in schemes.items():
            if gptq_fq is not None and stage_host:
                # ONE LINEAR AT A TIME on the staged device: FP weights
                # plus a single fq set is the whole residency (full-width
                # 57B: FP + gate + up fq sets fill an ~8 GB device before
                # the down sweep starts). The sync readbacks keep async
                # enqueue from overlapping the GPTQ and error-pass peaks.
                cols = []
                for lin in ("gate", "up", "down"):
                    fqw = gptq_fq(x2d, lp, qcfg=qc, only=lin)
                    jax.device_get(jax.tree_util.tree_leaves(fqw)[0].ravel()[0])
                    cols.append(np.asarray(
                        errf_lin[(name, lin)](x2d, lp, fq_weights=fqw),
                        dtype=np.float64))
                    del fqw
                err2 = np.concatenate(cols, axis=1)
            else:
                fqw = gptq_fq(x2d, lp, qcfg=qc) if gptq_fq is not None else None
                err2 = np.asarray(errf[name](x2d, lp, fq_weights=fqw),
                                  dtype=np.float64)
                del fqw
            err = np.sqrt(err2)
            losses[name][str(l)] = {
                str(e): [float(v) for v in err[e]] for e in range(err.shape[0])
            }
            if save_dir:
                with open(paths[name], "w") as f:
                    json.dump(losses[name], f)
        x = x_next
        print(f"[calibrate +{_time.time() - t0:.0f}s] layer {l + 1}/"
              f"{num_layers} done", flush=True)

    return losses


def _gptq_dense_fq_weights(x2d, dlp, qcfg: QLinearConfig) -> dict:
    """GPTQ-quantize one dense layer's MLP linears (hessian from x2d)."""
    from .gptq import accumulate_hessian, gptq_quantize_kn

    if qcfg.w_bits >= 16:
        return {}
    nd = dlp["mlp_gate_up"].shape[-1] // 2
    wg, wu = dlp["mlp_gate_up"][..., :nd], dlp["mlp_gate_up"][..., nd:]
    wd = dlp["mlp_down"]
    sh = jax.nn.silu(x2d @ wg) * (x2d @ wu)
    h_x = accumulate_hessian(x2d)[None]
    h_s = accumulate_hessian(sh)[None]
    return {
        "gate": gptq_quantize_kn(wg[None], h_x, qcfg).w_fq[0],
        "up": gptq_quantize_kn(wu[None], h_x, qcfg).w_fq[0],
        "down": gptq_quantize_kn(wd[None], h_s, qcfg).w_fq[0],
    }


def _gptq_layer_fq_weights(x2d, lp, qcfg: QLinearConfig, cfg: MoEConfig,
                           backend: str = "auto",
                           expert_chunk: int = 16,
                           out_dtype=None, only: str | None = None) -> dict:
    """GPTQ-quantize every expert linear of one layer for one scheme.

    Hessians come from the FP layer pass over the calibration rows
    (reference llama_sequential add_batch semantics, gptq.py:165-176).

    Memory discipline (8 GB device, staged calibration): the batched GPTQ runs
    ``expert_chunk`` experts at a time — the Cholesky chain holds ~3
    [E', K, K] f32 buffers, which at E=60, K=2048 would be ~3 GB in one
    shot — and every fake-quant result is cast to ``out_dtype`` (the
    model dtype, matching the reference's fp16 fake-quant weights,
    quant.py:385-466) per CHUNK so at most one chunk exists in f32.
    """
    from .gptq import accumulate_hessian, gptq_quantize_kn

    if qcfg.w_bits >= 16:
        return {}
    e = cfg.num_experts
    n = cfg.moe_intermediate_size

    def fq_kn(wslice, kdim, n_out, n_e, rows):
        # Hessians AND weight slices are produced PER EXPERT CHUNK
        # (accumulate_hessian expert_slice; ``wslice(a, b)`` returns
        # [b-a, K, n_out]): the all-expert [E, K, K] f32 Hessian at 57B
        # widths is 3.3 GB, the full-width gate/up slice copies another
        # 2.35 GB — both tipped staged calibration over a 15.75 GB device
        # (same OOM class as the ds2 dense solve, same fix discipline).
        # The chunk size adapts to the linear's width: the sweep holds
        # ~6 [E', N, K] f32 copies + 3 [E', K, K] factors (qwen/ds2
        # widths keep chunk 16; 57B drops to ~6).
        per_e = n_out * kdim * 4 * 6 + kdim * kdim * 4 * 3
        chunk = max(1, min(expert_chunk, int(1.5e9 // per_e)))
        parts = []
        for s in range(0, n_e, chunk):
            hi = min(s + chunk, n_e)
            h_c = accumulate_hessian(rows, disp.group_sizes, e,
                                     expert_slice=(s, hi))
            r = gptq_quantize_kn(wslice(s, hi), h_c, qcfg).w_fq
            del h_c
            r = r if out_dtype is None else r.astype(out_dtype)
            # serialize chunks on-device: the next chunk's Hessian einsum
            # otherwise enqueues while this chunk's Cholesky chain still
            # holds its f32 working set (two peaks live at once)
            jax.device_get(r[0, 0, 0])
            if os.environ.get("MXMOE_CALIB_DEBUG_MEM"):
                live = jax.live_arrays()
                tot = sum(a.nbytes for a in live) / 2**30
                big = sorted(((a.nbytes, a.shape, str(a.dtype))
                              for a in live), reverse=True)[:8]
                print(f"[mem] chunk {s}:{hi} live={tot:.2f}G top={big}",
                      flush=True)
            parts.append(r)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)

    gate_up = lp["expert_gate_up"]
    wd = lp["expert_down"]
    h = gate_up.shape[1]

    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    disp = make_dispatch(routing, e)
    xs = gather_tokens(x2d, disp)
    h_fp = jax.nn.silu(
        gmm_ops.gmm(xs, gate_up[..., :n], disp.group_sizes, backend=backend)
    ) * gmm_ops.gmm(xs, gate_up[..., n:], disp.group_sizes, backend=backend)

    out = {}
    if only in (None, "gate"):
        out["gate"] = fq_kn(lambda a, b: gate_up[a:b, :, :n], h, n, e, xs)
    if only in (None, "up"):
        out["up"] = fq_kn(lambda a, b: gate_up[a:b, :, n:], h, n, e, xs)
    if only in (None, "down"):
        out["down"] = fq_kn(lambda a, b: wd[a:b], n, h, e, h_fp)
    if cfg.shared_expert_intermediate_size > 0 and "shared_gate_up" in lp:
        ns = cfg.shared_expert_intermediate_size
        swg, swu = lp["shared_gate_up"][..., :ns], lp["shared_gate_up"][..., ns:]
        swd = lp["shared_down"]
        sh = jax.nn.silu(x2d @ swg) * (x2d @ swu)
        # shared expert: single dense hessian, no chunking needed
        h_x = accumulate_hessian(x2d)[None]
        h_s = accumulate_hessian(sh)[None]

        def fq_shared(w, h):
            r = gptq_quantize_kn(w[None], h, qcfg).w_fq[0]
            return r if out_dtype is None else r.astype(out_dtype)

        if only in (None, "gate"):
            out["shared_gate"] = fq_shared(swg, h_x)
        if only in (None, "up"):
            out["shared_up"] = fq_shared(swu, h_x)
        if only in (None, "down"):
            out["shared_down"] = fq_shared(swd, h_s)
    return out


def _main():
    import argparse

    from ..models import configs, model as model_mod

    ap = argparse.ArgumentParser(
        description="layer_out_norm quant-loss calibration (reference CLI: "
        "python -m mxmoe.quant.quant calib)"
    )
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--method", default="rtn", choices=["rtn", "rtn-had", "gptq", "gptq-had"])
    ap.add_argument("--qcfg", nargs="+", default=["w8a8_g-1_sym", "w4a4_g-1_sym"])
    ap.add_argument("--ckpt", default=None, help="safetensors dir (None = random init)")
    ap.add_argument("--nsamples", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None, help="truncate depth (smoke)")
    ap.add_argument("--save_dir", default="calib")
    ap.add_argument("--w_clip", default=None, choices=[None, "mse"],
                    help="mse = grid-searched weight clip on every scheme "
                         "(reference find_params mse branch, "
                         "gptq.py:96-110); equivalent to the _mse scheme "
                         "suffix")
    args = ap.parse_args()

    from .schemes import parse_scheme

    cfg = configs.config_for(args.model)
    if args.layers:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    import contextlib

    # accelerator backend: LOAD on the host CPU backend and let
    # calibrate_model stage one layer to the device at a time (the full
    # 24-layer pytree is ~29 GB bf16 vs ~8 GB of device HBM)
    stage = jax.default_backend() != "cpu"
    devctx = (jax.default_device(jax.devices("cpu")[0]) if stage
              else contextlib.nullcontext())
    with devctx:
        if args.ckpt:
            from ..models.hf_loader import params_from_safetensors

            # numpy leaves when staging: calibrate_model streams one layer
            # to the device at a time; a jax copy would double host RSS
            params = params_from_safetensors(args.ckpt, cfg, as_numpy=stage)
        else:
            params = model_mod.init_params(cfg, jax.random.PRNGKey(0),
                                           dtype=jnp.float32)

    from .data import get_calibration_tokens

    tokens = get_calibration_tokens(
        args.nsamples, args.seqlen, vocab_size=cfg.vocab_size
    )
    schemes = {name: parse_scheme(name) for name in args.qcfg}
    if args.w_clip == "mse":
        import dataclasses as _dc

        schemes = {n: _dc.replace(c, w_clip="mse") for n, c in schemes.items()}
    calibrate_model(
        params, tokens, cfg, schemes,
        save_dir=args.save_dir, model_id=args.model, method=args.method,
        resume=True, stage_host=stage,
    )


# ---------------------------------------------------------------------------
# model_out_norm metric (reference quant.py:614-660) + resume support
# ---------------------------------------------------------------------------

def model_out_norm_errors(
    params: dict,
    tokens: jax.Array,
    cfg: MoEConfig,
    qcfg: QLinearConfig,
    layer_idx: int,
    backend: str = "auto",
) -> np.ndarray:
    """‖model_out_q − model_out_fp‖_F per (expert, linear) of one layer.

    The reference's alternative metric: quantizing one block and re-running
    the WHOLE model (nonlinear downstream propagation — no vectorization
    shortcut exists, so this is L×E×3 forwards; use layer_out_norm unless
    end-to-end fidelity of the loss signal matters).
    Returns err [E(+1 shared), 3].
    """
    from ..models import model as model_mod
    from ..models.layers import MoEImpl

    impl = MoEImpl(kind="ragged", gmm_backend=backend)
    fwd = jax.jit(lambda p: model_mod.forward_hidden(p, tokens, cfg, impl))
    ref = fwd(params)

    n = cfg.moe_intermediate_size
    e_tot = cfg.num_experts
    has_shared = cfg.shared_expert_intermediate_size > 0 and \
        "shared_gate_up" in params["layers"]
    errs = np.zeros((e_tot + (1 if has_shared else 0), 3))

    def perturbed(name, block_slice, value):
        layers = dict(params["layers"])
        layers[name] = layers[name].at[block_slice].set(value)
        p2 = dict(params)
        p2["layers"] = layers
        return p2

    gate_up = params["layers"]["expert_gate_up"]   # [L, E, H, 2N]
    down = params["layers"]["expert_down"]
    for e in range(e_tot):
        for bi, lin in enumerate(LINEAR_NAMES):
            if lin == "gate":
                w = gate_up[layer_idx, e, :, :n]
                fq = _fq_weight(w[None], qcfg)[0]
                p2 = perturbed("expert_gate_up", (layer_idx, e, slice(None), slice(0, n)), fq)
            elif lin == "up":
                w = gate_up[layer_idx, e, :, n:]
                fq = _fq_weight(w[None], qcfg)[0]
                p2 = perturbed("expert_gate_up", (layer_idx, e, slice(None), slice(n, 2 * n)), fq)
            else:
                w = down[layer_idx, e]
                fq = _fq_weight(w[None], qcfg)[0]
                p2 = perturbed("expert_down", (layer_idx, e), fq)
            out = fwd(p2)
            errs[e, bi] = float(jnp.sqrt(jnp.sum(
                (out.astype(jnp.float32) - ref.astype(jnp.float32)) ** 2)))
    if has_shared:
        ns = cfg.shared_expert_intermediate_size
        for bi, (name, sl) in enumerate((
            ("shared_gate_up", (layer_idx, slice(None), slice(0, ns))),
            ("shared_gate_up", (layer_idx, slice(None), slice(ns, 2 * ns))),
            ("shared_down", (layer_idx,)),
        )):
            w = params["layers"][name][sl]
            fq = _fq_weight(w[None], qcfg)[0]
            p2 = perturbed(name, sl, fq)
            out = fwd(p2)
            errs[e_tot, bi] = float(jnp.sqrt(jnp.sum(
                (out.astype(jnp.float32) - ref.astype(jnp.float32)) ** 2)))
    return errs


def fisher_errors(*args, **kw):
    """Fisher-information metric — a stub in the reference too
    (``quant.py:662``); layer_out_norm is the production metric."""
    raise NotImplementedError("fisher metric is a stub (reference parity)")


def load_resumable(save_dir: str, model_id: str, method: str,
                   schemes: dict) -> dict[str, dict]:
    """Load per-layer calibration checkpoints for resume: returns partial
    losses {scheme: {layer: ...}} from existing JSON files."""
    out = {}
    for name in schemes:
        path = os.path.join(
            save_dir, f"{model_id}-MOE-layer_out_norm-{method}-{name}.json"
        )
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)
    return out


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    _main()      # AFTER all defs: the CLI calls load_resumable, which is
                 # defined below _main in source order
