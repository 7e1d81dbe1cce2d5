"""HF checkpoint -> mxmoe param pytree conversion.

Counterpart of the reference's model loading layer (``moe_utils.py:281-316``
``load_hf_model`` + the weight-name maps at ``moe_utils.py:181-207``), but
producing a stacked functional pytree instead of a live torch module.

Two entry points:
  * :func:`params_from_state_dict` — any mapping name->numpy array (used by
    parity tests against a live ``transformers`` model, and by
    :func:`params_from_safetensors`).
  * :func:`params_from_safetensors` — stream tensors from ``*.safetensors``
    shards on disk (zero-egress friendly; no torch needed).

Name schema handled (qwen2_moe / mixtral):
  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight[.bias]
  model.layers.{i}.{input,post_attention}_layernorm.weight
  qwen2_moe: model.layers.{i}.mlp.gate.weight (router)
             model.layers.{i}.mlp.experts.{e}.{gate,up,down}_proj.weight
             model.layers.{i}.mlp.shared_expert.{gate,up,down}_proj.weight
             model.layers.{i}.mlp.shared_expert_gate.weight
  mixtral:   model.layers.{i}.block_sparse_moe.gate.weight
             model.layers.{i}.block_sparse_moe.experts.{e}.w{1,2,3}.weight
             (w1=gate, w3=up, w2=down — reference MOE_WEIGHT_NAME_MAP,
              ``moe_utils.py:196-207``)
"""

from __future__ import annotations

import glob
import os
from typing import Mapping

import numpy as np
import jax.numpy as jnp

from .configs import MoEConfig


class _Stacker:
    """Write-in-place stacked staging: one preallocated ``[L, ...]`` numpy
    buffer per key, filled layer by layer.

    Replaces list-append + ``np.stack`` (which held TWO full copies of the
    biggest key at the conversion crossover; the 24-layer runbook load
    peaked 95-116 GB host RSS that way). Peak is now one stacked copy plus
    at most one jnp conversion copy of a single key."""

    def __init__(self, num_layers: int):
        self.L = num_layers
        self.buf: dict[str, np.ndarray] = {}

    def put(self, key: str, i: int, arr: np.ndarray) -> None:
        if key not in self.buf:
            self.buf[key] = np.empty((self.L,) + arr.shape, arr.dtype)
        self.buf[key][i] = arr

    def put_halves(self, key: str, i: int,
                   g: np.ndarray, u: np.ndarray) -> None:
        """Fused gate|up staging: write the two halves straight into the
        [L, H, 2N] buffer (no intermediate concatenate copy)."""
        h, n = g.shape
        if key not in self.buf:
            self.buf[key] = np.empty((self.L, h, 2 * n), g.dtype)
        self.buf[key][i, :, :n] = g
        self.buf[key][i, :, n:] = u

    def put_expert_halves(self, key: str, i: int, e: int, num_experts: int,
                          g: np.ndarray, u: np.ndarray) -> None:
        h, n = g.shape
        if key not in self.buf:
            self.buf[key] = np.empty((self.L, num_experts, h, 2 * n), g.dtype)
        self.buf[key][i, e, :, :n] = g
        self.buf[key][i, e, :, n:] = u

    def put_expert(self, key: str, i: int, e: int, num_experts: int,
                   arr: np.ndarray) -> None:
        if key not in self.buf:
            self.buf[key] = np.empty((self.L, num_experts) + arr.shape, arr.dtype)
        self.buf[key][i, e] = arr

    def finish(self, dtype, as_numpy: bool) -> dict:
        """Convert biggest keys first, freeing each staged buffer as it
        converts (bounds the crossover at staged + one converted key)."""
        if as_numpy:
            npdt = np.dtype(dtype)
            return {k: (v if v.dtype == npdt else v.astype(npdt))
                    for k, v in self.buf.items()}
        out: dict = {}
        for k in sorted(self.buf, key=lambda k: -self.buf[k].nbytes):
            out[k] = jnp.asarray(self.buf[k], dtype)
            self.buf[k] = None
        return out


def params_from_state_dict(
    sd: Mapping[str, np.ndarray],
    cfg: MoEConfig,
    dtype=jnp.float32,
    as_numpy: bool = False,
) -> dict:
    """Convert an HF state-dict (numpy values, HF [out, in] layout) into the
    stacked [in, out] pytree used by :mod:`mxmoe.models.model`.

    ``as_numpy=True`` returns numpy leaves (no jnp conversion copy) — the
    input format for the host-staged CLIs (trace, calibrate) that stream
    one layer to the device at a time."""

    get = lambda name: np.asarray(sd[name])

    if cfg.model_type == "deepseek_v2":
        return _ds2_params_from_state_dict(sd, cfg, dtype, as_numpy)

    if cfg.model_type == "mixtral":
        moe_prefix = "block_sparse_moe"
        expert_names = {"gate": "w1", "up": "w3", "down": "w2"}
    else:
        moe_prefix = "mlp"
        expert_names = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}

    L, E = cfg.num_layers, cfg.num_experts
    st = _Stacker(L)

    for i in range(L):
        p = f"model.layers.{i}"
        st.put("wq", i, get(f"{p}.self_attn.q_proj.weight").T)
        st.put("wk", i, get(f"{p}.self_attn.k_proj.weight").T)
        st.put("wv", i, get(f"{p}.self_attn.v_proj.weight").T)
        st.put("wo", i, get(f"{p}.self_attn.o_proj.weight").T)
        if cfg.attention_bias:
            st.put("bq", i, get(f"{p}.self_attn.q_proj.bias"))
            st.put("bk", i, get(f"{p}.self_attn.k_proj.bias"))
            st.put("bv", i, get(f"{p}.self_attn.v_proj.bias"))
        st.put("input_norm", i, get(f"{p}.input_layernorm.weight"))
        st.put("post_attn_norm", i, get(f"{p}.post_attention_layernorm.weight"))
        st.put("router", i, get(f"{p}.{moe_prefix}.gate.weight").T)

        for e in range(E):
            ep = f"{p}.{moe_prefix}.experts.{e}"
            st.put_expert_halves(
                "expert_gate_up", i, e, E,
                get(f"{ep}.{expert_names['gate']}.weight").T,   # [H, N]
                get(f"{ep}.{expert_names['up']}.weight").T,
            )
            st.put_expert("expert_down", i, e, E,
                          get(f"{ep}.{expert_names['down']}.weight").T)  # [N, H]

        if cfg.shared_expert_intermediate_size > 0:
            sp = f"{p}.mlp.shared_expert"
            st.put_halves("shared_gate_up", i,
                          get(f"{sp}.gate_proj.weight").T,
                          get(f"{sp}.up_proj.weight").T)
            st.put("shared_down", i, get(f"{sp}.down_proj.weight").T)
            if cfg.has_shared_expert_gate:
                st.put("shared_gate", i, get(f"{p}.mlp.shared_expert_gate.weight").T)

    conv = ((lambda a: np.asarray(a).astype(np.dtype(dtype), copy=False))
            if as_numpy else (lambda a: jnp.asarray(a, dtype)))
    params = {
        "embed": conv(get("model.embed_tokens.weight")),
        "final_norm": conv(get("model.norm.weight")),
    }
    params["layers"] = st.finish(dtype, as_numpy)
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = params["embed"].T
    else:
        params["lm_head"] = conv(get("lm_head.weight").T)
    return params


def _ds2_params_from_state_dict(sd, cfg: MoEConfig, dtype,
                                as_numpy: bool = False) -> dict:
    """DeepSeek-V2(-Lite) name schema (HF ``modeling_deepseek_v2``):
    self_attn.{q_proj,kv_a_proj_with_mqa,kv_a_layernorm,kv_b_proj,o_proj};
    layer<first_k_dense: mlp.{gate,up,down}_proj (dense);
    else mlp.gate (router), mlp.experts.{e}.*, mlp.shared_experts.*."""
    get = lambda name: np.asarray(sd[name])
    L, E, D = cfg.num_layers, cfg.num_experts, cfg.first_dense_layers

    def put_common(st, j, i):
        p = f"model.layers.{i}.self_attn"
        st.put("wq", j, get(f"{p}.q_proj.weight").T)
        st.put("kv_a", j, get(f"{p}.kv_a_proj_with_mqa.weight").T)
        st.put("kv_a_norm", j, get(f"{p}.kv_a_layernorm.weight"))
        st.put("kv_b", j, get(f"{p}.kv_b_proj.weight").T)
        st.put("wo", j, get(f"{p}.o_proj.weight").T)
        q = f"model.layers.{i}"
        st.put("input_norm", j, get(f"{q}.input_layernorm.weight"))
        st.put("post_attn_norm", j, get(f"{q}.post_attention_layernorm.weight"))

    dense_st = _Stacker(D)
    for i in range(D):
        put_common(dense_st, i, i)
        p = f"model.layers.{i}.mlp"
        dense_st.put_halves("mlp_gate_up", i,
                            get(f"{p}.gate_proj.weight").T,
                            get(f"{p}.up_proj.weight").T)
        dense_st.put("mlp_down", i, get(f"{p}.down_proj.weight").T)

    moe_st = _Stacker(L - D)
    for i in range(D, L):
        j = i - D
        put_common(moe_st, j, i)
        p = f"model.layers.{i}.mlp"
        moe_st.put("router", j, get(f"{p}.gate.weight").T)
        for e in range(E):
            ep = f"{p}.experts.{e}"
            moe_st.put_expert_halves("expert_gate_up", j, e, E,
                                     get(f"{ep}.gate_proj.weight").T,
                                     get(f"{ep}.up_proj.weight").T)
            moe_st.put_expert("expert_down", j, e, E,
                              get(f"{ep}.down_proj.weight").T)
        moe_st.put_halves("shared_gate_up", j,
                          get(f"{p}.shared_experts.gate_proj.weight").T,
                          get(f"{p}.shared_experts.up_proj.weight").T)
        moe_st.put("shared_down", j, get(f"{p}.shared_experts.down_proj.weight").T)

    conv = ((lambda a: np.asarray(a).astype(np.dtype(dtype), copy=False))
            if as_numpy else (lambda a: jnp.asarray(a, dtype)))
    params = {
        "embed": conv(get("model.embed_tokens.weight")),
        "layers": moe_st.finish(dtype, as_numpy),
        "dense_layers": dense_st.finish(dtype, as_numpy),
        "final_norm": conv(get("model.norm.weight")),
    }
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = params["embed"].T
    else:
        params["lm_head"] = conv(get("lm_head.weight").T)
    return params


def params_from_torch_model(torch_model, cfg: MoEConfig, dtype=jnp.float32) -> dict:
    """Parity-test helper: live transformers model -> pytree."""
    sd = {k: v.detach().to("cpu").float().numpy() for k, v in torch_model.state_dict().items()}
    return params_from_state_dict(sd, cfg, dtype)


def params_from_safetensors(ckpt_dir: str, cfg: MoEConfig, dtype=jnp.bfloat16,
                            as_numpy: bool = False) -> dict:
    """Load from a directory of ``*.safetensors`` shards."""
    from safetensors import safe_open  # lazy; available via transformers dep

    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors shards under {ckpt_dir}")
    class _LazySD(Mapping):
        def __init__(self, files):
            self.index = {}
            self.handles = []
            for fp in files:
                h = safe_open(fp, framework="numpy")
                self.handles.append(h)
                for key in h.keys():
                    self.index[key] = h

        def __getitem__(self, k):
            return self.index[k].get_tensor(k)

        def __iter__(self):
            return iter(self.index)

        def __len__(self):
            return len(self.index)

        def __contains__(self, k):
            return k in self.index

    return params_from_state_dict(_LazySD(files), cfg, dtype, as_numpy)
