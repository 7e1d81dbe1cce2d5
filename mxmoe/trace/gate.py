"""Per-expert gate activation tracing.

Counterpart of the reference's ``MoETracer`` (``moe_tracer.py:28-243``):
instead of forward hooks on router modules, the functional forward exposes
routing directly — we run the decoder layer-by-layer, take top-k off the
router logits, and accumulate per-layer per-expert access frequency and
combine-weight sums. Output JSON is schema-compatible with
``calib/gate/<model>/<ds>/<len>/moe-gate.json`` (consumed by the workload
generator and the ILP solver).
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.configs import MoEConfig
from ..models.layers import decoder_layer, make_rope_tables, rope_frequencies
from ..ops.dispatch import route_topk
from ..quant.calibrate import layer_forward_fp


@dataclasses.dataclass
class GateTrace:
    access_freq: np.ndarray   # [L, E] int64 — top-k hits per expert
    weights_sum: np.ndarray   # [L, E] float64 — Σ combine weights
    num_tokens: int
    num_samples: int
    topk: int
    nk: tuple[int, int]       # (moe_intermediate, hidden)
    num_shared_experts: int
    # ds2-style dense first layers: count + (dense_intermediate, hidden);
    # extra keys on top of the reference schema (superset-compatible)
    first_dense_layers: int = 0
    dense_nk: tuple[int, int] | None = None

    def freq_probs(self) -> np.ndarray:
        tot = self.access_freq.sum(axis=1, keepdims=True)
        return self.access_freq / np.maximum(tot, 1)


def _percentile_stats(freq: np.ndarray) -> dict:
    qs = [0, 25, 50, 75, 90, 99, 100]
    return {f"p{q}": float(np.percentile(freq, q)) for q in qs}


def trace_gate_stats(
    params: dict,
    tokens: jax.Array,        # [B, S]
    cfg: MoEConfig,
    backend: str = "auto",
) -> GateTrace:
    b, s = tokens.shape
    positions = jnp.arange(s)
    cos, sin = make_rope_tables(cfg, positions)
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    if "dense_layers" in params:
        from functools import partial as _p

        dense_fwd = jax.jit(_p(decoder_layer, cfg=cfg, cos=cos, sin=sin,
                               dense_mlp=True))
        for dl in range(params["dense_layers"]["input_norm"].shape[0]):
            dlp = jax.tree_util.tree_map(lambda a: a[dl], params["dense_layers"])
            x = dense_fwd(x, dlp)

    fwd = jax.jit(partial(layer_forward_fp, cfg=cfg, backend=backend))

    @jax.jit
    def layer_stats(x2d, router):
        logits = x2d @ router
        routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
        flat = routing.expert_ids.reshape(-1)
        freq = jnp.bincount(flat, length=cfg.num_experts)
        wsum = jax.ops.segment_sum(
            routing.weights.reshape(-1), flat, num_segments=cfg.num_experts
        )
        return freq, wsum

    num_layers = params["layers"]["router"].shape[0]
    freq = np.zeros((num_layers, cfg.num_experts), np.int64)
    wsum = np.zeros((num_layers, cfg.num_experts), np.float64)
    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], params["layers"])
        x_next, x2d = fwd(x, lp, cos=cos, sin=sin)
        f, w = layer_stats(x2d, lp["router"])
        freq[l] = np.asarray(f)
        wsum[l] = np.asarray(w, np.float64)
        x = x_next

    n_shared = (
        cfg.shared_expert_intermediate_size // cfg.moe_intermediate_size
        if cfg.shared_expert_intermediate_size > 0 else 0
    )
    return GateTrace(
        access_freq=freq,
        weights_sum=wsum,
        num_tokens=b * s,
        num_samples=b,
        topk=cfg.top_k,
        nk=(cfg.moe_intermediate_size, cfg.hidden_size),
        num_shared_experts=n_shared,
        first_dense_layers=cfg.first_dense_layers,
        dense_nk=((cfg.dense_intermediate_size, cfg.hidden_size)
                  if cfg.first_dense_layers else None),
    )


def dump_gate_trace(trace: GateTrace, path: str) -> None:
    """Reference-schema JSON (``moe_tracer.py:174-211``)."""
    num_layers = trace.access_freq.shape[0]
    data = {
        "topk": trace.topk,
        "NK": list(trace.nk),
        "num_layers": num_layers,
        "num_tokens": trace.num_tokens,
        "num_samples": trace.num_samples,
        "num_shared_experts": trace.num_shared_experts,
    }
    if trace.first_dense_layers:
        data["first_dense_layers"] = trace.first_dense_layers
        data["dense_NK"] = list(trace.dense_nk)
    for i in range(num_layers):
        data[f"layer-{i}"] = {
            "access_freq": trace.access_freq[i].tolist(),
            "weights_sum": trace.weights_sum[i].tolist(),
            "percentile_stats": _percentile_stats(trace.access_freq[i]),
        }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_gate_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def plot_gate_heatmap(trace: GateTrace, path: str) -> bool:
    """Expert-access heatmap (reference ``moe_tracer.py:253-316``)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    probs = trace.freq_probs()
    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(probs, aspect="auto", cmap="viridis")
    ax.set_xlabel("expert")
    ax.set_ylabel("layer")
    fig.colorbar(im, ax=ax, label="routing probability")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def _main():
    import argparse

    from ..models import configs, model as model_mod
    from ..quant.data import get_calibration_tokens

    ap = argparse.ArgumentParser(description="gate tracing (reference CLI: python -m mxmoe.quant.moe_tracer)")
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dataset", default="auto")
    ap.add_argument("--nsamples", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--heatmap", action="store_true")
    args = ap.parse_args()

    cfg = configs.config_for(args.model)
    if args.layers:
        import dataclasses as dc

        cfg = dc.replace(cfg, num_layers=args.layers)
    if args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        # numpy leaves: the trace loop streams one layer per jit call, so
        # there is no need for a second full jax copy of the checkpoint
        # (the 24-layer runbook trace peaked 116 GB host RSS without this)
        params = params_from_safetensors(args.ckpt, cfg, as_numpy=True)
    else:
        params = model_mod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    tokens = get_calibration_tokens(
        args.nsamples, args.seqlen, args.dataset, vocab_size=cfg.vocab_size
    )
    trace = trace_gate_stats(params, tokens, cfg)
    out = args.out or (
        f"calib/gate/{args.model}/{args.dataset}/{args.seqlen}/moe-gate.json"
    )
    dump_gate_trace(trace, out)
    if args.heatmap:
        plot_gate_heatmap(trace, out.replace(".json", ".png"))
    print(f"gate trace -> {out}")


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    _main()


# ---------------------------------------------------------------------------
# Activation tracing (reference moe_tracer.trace_activation, :388-435)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActivationTrace:
    """Per-layer distribution stats of the MoE-block inputs."""

    amax: np.ndarray          # [L] max |x|
    channel_amax: np.ndarray  # [L, H] per-channel max |x| (outlier map)
    percentiles: np.ndarray   # [L, len(QS)] of |x|
    qs: tuple = (50.0, 90.0, 99.0, 99.9, 100.0)


def trace_activation_stats(
    params: dict,
    tokens: jax.Array,
    cfg: MoEConfig,
    backend: str = "auto",
) -> ActivationTrace:
    """Capture |activation| distribution entering each MoE block — the
    outlier evidence motivating Hadamard rotation (QuaRot); reference
    plots these from raw captures, we reduce on device."""
    b, s = tokens.shape
    positions = jnp.arange(s)
    cos, sin = make_rope_tables(cfg, positions)
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    if "dense_layers" in params:
        from functools import partial as _p

        dense_fwd = jax.jit(_p(decoder_layer, cfg=cfg, cos=cos, sin=sin,
                               dense_mlp=True))
        for dl in range(params["dense_layers"]["input_norm"].shape[0]):
            dlp = jax.tree_util.tree_map(lambda a: a[dl], params["dense_layers"])
            x = dense_fwd(x, dlp)
    fwd = jax.jit(partial(layer_forward_fp, cfg=cfg, backend=backend))

    qs = (50.0, 90.0, 99.0, 99.9, 100.0)

    @jax.jit
    def stats(x2d):
        a = jnp.abs(x2d.astype(jnp.float32))
        return (
            jnp.max(a),
            jnp.max(a, axis=0),
            jnp.percentile(a.reshape(-1), jnp.asarray(qs)),
        )

    num_layers = params["layers"]["router"].shape[0]
    amax = np.zeros(num_layers)
    ch = np.zeros((num_layers, cfg.hidden_size))
    pct = np.zeros((num_layers, len(qs)))
    for l in range(num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[l], params["layers"])
        x_next, x2d = fwd(x, lp, cos=cos, sin=sin)
        m, c, p = stats(x2d)
        amax[l], ch[l], pct[l] = float(m), np.asarray(c), np.asarray(p)
        x = x_next
    return ActivationTrace(amax=amax, channel_amax=ch, percentiles=pct, qs=qs)


def plot_activation_outliers(trace: ActivationTrace, path: str) -> bool:
    """Channel-amax heatmap (outlier channels) per layer."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    im = ax1.imshow(np.log10(trace.channel_amax + 1e-9), aspect="auto", cmap="magma")
    ax1.set_xlabel("hidden channel")
    ax1.set_ylabel("layer")
    fig.colorbar(im, ax=ax1, label="log10 channel amax")
    for i, q in enumerate(trace.qs):
        ax2.plot(trace.percentiles[:, i], label=f"p{q}")
    ax2.set_xlabel("layer")
    ax2.set_ylabel("|activation|")
    ax2.set_yscale("log")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
