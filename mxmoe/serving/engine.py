"""Slot-based generation engine (continuous batching scaffold).

A fixed pool of B slots over one compiled prefill fn ([B, P] chunks) and
one compiled decode fn ([B, 1]): requests occupy free slots, finished
sequences free them — arrivals never retrace. Host-side bookkeeping is a
plain queue; device work is two jitted calls per step class.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl
from .decode import forward_cached, sample_tokens
from .kv_cache import KVCache, init_kv_cache


def _slice_slot_cache(cache, slot):
    """View one slot's cache as a batch-1 cache (all cache leaves carry the
    batch at axis 1; lengths at axis 0)."""
    arrays = list(cache)
    out = [jax.lax.dynamic_slice_in_dim(a, slot, 1, axis=1)
           for a in arrays[:-1]]
    out.append(jax.lax.dynamic_slice_in_dim(arrays[-1], slot, 1, axis=0))
    return type(cache)(*out)


def _unslice_slot_cache(cache, cache1, slot):
    arrays, arrays1 = list(cache), list(cache1)
    out = [jax.lax.dynamic_update_slice_in_dim(a, a1, slot, axis=1)
           for a, a1 in zip(arrays[:-1], arrays1[:-1])]
    out.append(jax.lax.dynamic_update_slice_in_dim(
        arrays[-1], arrays1[-1], slot, axis=0))
    return type(cache)(*out)


def _prefill_slot(params, tokens, cache, slot, valid, *, cfg, impl):
    """Prefill ONE slot with a batch-1 forward against its cache slice.

    vs the round-1 full-width prefill: (a) no other slot's cache rows are
    ever written (the clamped dynamic_update_slice could overwrite a
    near-full slot's real KV history with dummy rows — round-1 advisor
    finding), and (b) prefill costs 1/B of the batched-forward FLOPs.
    """
    c1 = _slice_slot_cache(cache, slot)
    logits, c1 = forward_cached(params, tokens, c1, cfg=cfg, impl=impl,
                                valid_lengths=valid)
    return logits, _unslice_slot_cache(cache, c1, slot)


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4
    max_len: int = 1024
    prefill_chunk: int = 256
    temperature: float = 0.0
    top_k: int = 0
    eos_token: int | None = None
    cache_dtype = jnp.bfloat16
    int8_kv: bool = False        # int8 KV cache (QuantKVCache): 2x less
                                 # cache memory/bandwidth, scales folded
                                 # into the attention contractions


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    generated: list = dataclasses.field(default_factory=list)
    max_new: int = 0


class Engine:
    """Minimal continuous-batching loop over the cached forward."""

    def __init__(self, params, cfg: MoEConfig, ecfg: EngineConfig = EngineConfig(),
                 impl: MoEImpl = MoEImpl(), mesh=None, ep_cfg=None,
                 gate_freq=None):
        """``mesh``: serve over a device mesh — params get EP shardings
        (experts split over the mesh axis, dense parts replicated), the KV
        cache is sharded over SLOTS on the same axis, and every cached
        step runs the routed experts through the EP all-to-all
        (parallel.ep.make_ep_moe_block). batch_slots must be a multiple of
        the mesh size. Single-axis hybrid layout per the scaling-book
        recipe (SURVEY §2.3); round-2 verdict #6.

        ``gate_freq``: traced per-expert access frequencies (gate trace
        ``access_freq``, any scale). When given (and ``ep_cfg`` is not),
        the EP capacity factor is DERIVED from the measured routing skew
        (capacity_factor_from_freq) instead of guessed — assignments
        beyond capacity are silently dropped and decode would diverge
        from single-chip. Without a trace the default is 4.0 (matching
        generate/dryrun headroom), never the old 2.0 constant."""
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.ep import (EPConfig, capacity_factor_from_freq,
                                       make_ep_moe_block, pad_expert_arrays)
            from ..parallel.sharded import ep_param_shardings

            (axis,) = mesh.axis_names
            assert ecfg.batch_slots % mesh.size == 0, (
                ecfg.batch_slots, mesh.size)
            if ep_cfg is None:
                cap = (capacity_factor_from_freq(gate_freq, mesh.size,
                                                 margin=1.5)
                       if gate_freq is not None else 4.0)
                # decode batches are tiny (a few assignments per shard):
                # keep at least the old headroom so per-step variance
                # can't drop tokens even under a uniform trace
                ep_cfg = EPConfig(axis=axis, capacity_factor=max(cap, 2.0))
            lp = params["layers"]
            if "expert_gate_up_qcat" in lp and "act_bits_gateup" in lp:
                mb = max(float(np.asarray(lp["act_bits_gateup"]).max()),
                         float(np.asarray(lp["act_bits_down"]).max()))
                if mb > 8:
                    raise ValueError(
                        "mesh serving of PACKED a16-containing mixes is "
                        f"unsupported (max act bits {mb:g}): the packed "
                        "ragged layout has no weight-only kernel — "
                        "convert without --pack-int4 (int8-stored codes "
                        "serve a16 mixes over the mesh via the wo path).")
            if "expert_gate_up_qcat" in lp:
                # packed mixed artifact: reshard the GLOBAL ragged buffers
                # into per-shard buffers with local block offsets (once,
                # host-side) so every shard streams its w<=4 experts at
                # half the weight bytes through gmm_int8
                from ..quant.packing import shard_ragged_mixed

                new_lp = dict(lp)
                for prefix, kdim in (
                    ("expert_gate_up", cfg.hidden_size),
                    ("expert_down", cfg.moe_intermediate_size),
                ):
                    qcat = lp[f"{prefix}_qcat"]
                    blk = np.asarray(lp[f"{prefix}_blk"])
                    pf = np.asarray(lp[f"{prefix}_pf"])
                    cats, blks = [], []
                    for l in range(qcat.shape[0]):
                        c, b = shard_ragged_mixed(qcat[l], blk[l], pf[l],
                                                  kdim, mesh.size)
                        cats.append(c)
                        blks.append(b)
                    r_max = max(c.shape[1] for c in cats)
                    cats = [jnp.pad(c, ((0, 0), (0, r_max - c.shape[1]),
                                        (0, 0))) for c in cats]
                    new_lp[f"{prefix}_qcat"] = jnp.stack(cats)  # [L,ep,R,N]
                    # [L, E_pad] local offsets (phantom-padded when E does
                    # not divide the mesh — shard_ragged_mixed docstring)
                    new_lp[f"{prefix}_blk"] = jnp.asarray(blks, jnp.int32)
                params = {**params, "layers": new_lp}
                lp = new_lp
                quantized = "mixed-packed"
            elif "expert_gate_up_q" in lp and "act_bits_gateup" in lp:
                quantized = "mixed"     # per-expert schemes over the A2A
                max_bits = max(float(np.asarray(lp["act_bits_gateup"]).max()),
                               float(np.asarray(lp["act_bits_down"]).max()))
                if max_bits > 8:
                    # a16 weight-only experts: ship bf16 rows over the
                    # A2A and run the fused wo+w×a launch per shard
                    # (parallel.ep.moe_ffn_ep_wo) — the int8 wire would
                    # silently clip their act bits. mixed_weight_only is
                    # forced so the decode path skips the weight stack
                    # (flags16 are per-layer) and prefill matches.
                    quantized = "mixed-wo"
                    ep_cfg = dataclasses.replace(ep_cfg, wo_mix=True)
                    impl = dataclasses.replace(impl, mixed_weight_only=True)
            else:
                quantized = "expert_gate_up_q" in lp
            # non-divisible expert counts (the flagship's 60 on a power-of-
            # two mesh): grow never-routed phantom experts so every
            # expert_* array shards evenly; the EP block's ceil e_local
            # keeps routing ids consistent with the padded layout
            padded = pad_expert_arrays(lp, cfg.num_experts, mesh.size)
            if padded is not lp:
                params = {**params, "layers": padded}
                lp = padded
            impl = dataclasses.replace(
                impl, ep_moe=make_ep_moe_block(cfg, mesh, quantized, ep_cfg))
            params = jax.device_put(
                params, ep_param_shardings(params, mesh, quantized))
            self._mesh, self._axis = mesh, axis
            self.ep_cfg = ep_cfg
        else:
            self._mesh = self._axis = None
            self.ep_cfg = None
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.impl = impl
        if ecfg.int8_kv:
            from .kv_cache import init_quant_kv_cache

            self.cache = init_quant_kv_cache(cfg, ecfg.batch_slots,
                                             ecfg.max_len)
        else:
            self.cache = init_kv_cache(cfg, ecfg.batch_slots, ecfg.max_len,
                                       ecfg.cache_dtype)
        if self._mesh is not None:
            # cache sharded over SLOTS (batch axis 1 on every KV leaf,
            # axis 0 on lengths): decode data-parallelism rides the same
            # mesh axis the experts shard over
            from jax.sharding import NamedSharding, PartitionSpec as P

            def _shard(a, batch_axis):
                spec = [None] * a.ndim
                spec[batch_axis] = self._axis
                return jax.device_put(
                    a, NamedSharding(self._mesh, P(*spec)))

            arrays = list(self.cache)
            arrays = ([_shard(a, 1) for a in arrays[:-1]]
                      + [_shard(arrays[-1], 0)])
            self.cache = type(self.cache)(*arrays)
        self.slots = [_Slot() for _ in range(ecfg.batch_slots)]
        self.key = jax.random.PRNGKey(0)
        self._next_req = 0
        self._last_tokens = np.zeros((ecfg.batch_slots,), np.int32)
        self._results: dict[int, list[int]] = {}
        self._prompt_logits: dict[int, np.ndarray] = {}
        # Host mirror of per-slot cache lengths: under multi-process
        # serving the slot-sharded lengths are not addressable from one
        # process, and the device update (min(len + valid, max_len)) is
        # exactly reproducible on the host. Every process runs identical
        # bookkeeping, so engine decisions stay consistent cluster-wide.
        self._host_len = np.zeros((ecfg.batch_slots,), np.int64)
        self._zero_slots = jax.jit(lambda lens, idx: lens.at[idx].set(0))
        self._sample_last = jax.jit(lambda lg, key: sample_tokens(
            lg[:, -1], key, ecfg.temperature, ecfg.top_k))

        # donate the cache: without it every step copies the whole
        # stacked KV cache input->output (the copy the in-place scatter
        # protocol exists to avoid); the engine always adopts the
        # returned cache, so the old buffer is dead anyway
        self._prefill = jax.jit(partial(_prefill_slot, cfg=cfg, impl=impl),
                                donate_argnums=2)
        self._decode = jax.jit(partial(forward_cached, cfg=cfg, impl=impl),
                               donate_argnums=2)
        self._batch_prefill = None   # compiled lazily (submit_batch)
        self._decode_scan = {}       # chunk size -> jitted decode_scan

    # -- request management ------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        """Prefill a prompt into a free slot; returns request id."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if not free:
            raise RuntimeError("no free slots (drain first)")
        slot = free[0]
        rid = self._next_req
        self._next_req += 1

        p = self.ecfg.prefill_chunk
        prompt = prompt[-(self.ecfg.max_len - max_new_tokens - 1):]

        # zero this slot's length before prefill (fresh sequence);
        # in-place on device (multi-process arrays are not host-readable)
        self.cache = type(self.cache)(
            *self.cache[:-1],
            self._zero_slots(self.cache.lengths, self._rep([slot])))
        self._host_len[slot] = 0

        # long prompts stream through fixed-shape batch-1 chunks (compiled
        # once); only this slot's cache rows are touched
        last = None
        for off in range(0, len(prompt), p):
            piece = prompt[off: off + p]
            chunk = np.zeros((1, p), np.int32)
            chunk[0, : len(piece)] = piece
            logits, self.cache = self._prefill(
                self.params, self._rep(chunk), self.cache,
                self._rep(np.int32(slot)),
                self._rep(np.asarray([len(piece)], np.int32)),
            )
            last = self._to_np(logits)[0, len(piece) - 1]
            self._host_len[slot] = min(self._host_len[slot] + len(piece),
                                       self.ecfg.max_len)
        first_tok = int(np.argmax(last)) if self.ecfg.temperature <= 0 else (
            int(np.asarray(sample_tokens(jnp.asarray(last[None]),
                                         self._split_key(),
                                         self.ecfg.temperature,
                                         self.ecfg.top_k))[0])
        )
        st = self.slots[slot]
        st.active, st.request_id, st.max_new = True, rid, max_new_tokens
        st.generated = [first_tok]
        self._last_tokens[slot] = first_tok
        self._prompt_logits[rid] = last
        return rid

    def memory_analysis(self) -> dict:
        """``compiled.memory_analysis()`` of the prefill and decode steps at
        this engine's shapes (compiles both ahead of time)."""
        p = self.ecfg.prefill_chunk
        b = self.ecfg.batch_slots
        prefill = self._prefill.lower(
            self.params, self._rep(np.zeros((1, p), np.int32)), self.cache,
            self._rep(np.int32(0)), self._rep(np.asarray([p], np.int32)))
        decode = self._decode.lower(
            self.params, self._rep(np.zeros((b, 1), np.int32)), self.cache,
            valid_lengths=self._rep(np.ones((b,), np.int32)))
        return {"prefill": prefill.compile().memory_analysis(),
                "decode": decode.compile().memory_analysis()}

    def prompt_logits(self, rid: int) -> np.ndarray | None:
        """Logits [V] at the last prompt position of a ``submit`` request
        (the distribution its first generated token was drawn from)."""
        return self._prompt_logits.get(rid)

    def submit_batch(self, prompts: list[list[int]],
                     max_new_tokens: int = 32) -> list[int]:
        """Prefill SEVERAL prompts in one full-width [B, P] chunked pass.

        Amortizes the forward over concurrent arrivals (one launch instead
        of len(prompts)); safe for already-active slots because cache
        writes are masked per slot (scatter_layer_cache valid mask). Returns
        request ids in prompt order.
        """
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if len(free) < len(prompts):
            raise RuntimeError("not enough free slots (drain first)")
        if self._batch_prefill is None:
            self._batch_prefill = jax.jit(
                partial(forward_cached, cfg=self.cfg, impl=self.impl),
                donate_argnums=2)

        p = self.ecfg.prefill_chunk
        b = self.ecfg.batch_slots
        assigned = free[: len(prompts)]
        prompts = [
            pr[-(self.ecfg.max_len - max_new_tokens - 1):] for pr in prompts
        ]
        self.cache = type(self.cache)(
            *self.cache[:-1],
            self._zero_slots(self.cache.lengths, self._rep(assigned)))
        self._host_len[assigned] = 0

        rids = []
        maxlen = max(len(pr) for pr in prompts)
        last = {}
        for off in range(0, maxlen, p):
            chunk = np.zeros((b, p), np.int32)
            valid = np.zeros((b,), np.int32)
            for slot, pr in zip(assigned, prompts):
                piece = pr[off: off + p]
                chunk[slot, : len(piece)] = piece
                valid[slot] = len(piece)
            logits, self.cache = self._batch_prefill(
                self.params, self._rep(chunk), self.cache,
                valid_lengths=self._rep(valid),
            )
            logits = self._to_np(logits)
            for slot in range(b):
                self._host_len[slot] = min(
                    self._host_len[slot] + int(valid[slot]),
                    self.ecfg.max_len)
            for slot, pr in zip(assigned, prompts):
                n_new = valid[slot]
                if n_new > 0:
                    last[slot] = logits[slot, n_new - 1]

        for slot, pr in zip(assigned, prompts):
            rid = self._next_req
            self._next_req += 1
            first_tok = (
                int(np.argmax(last[slot])) if self.ecfg.temperature <= 0
                else int(np.asarray(sample_tokens(
                    jnp.asarray(last[slot][None]), self._split_key(),
                    self.ecfg.temperature, self.ecfg.top_k))[0])
            )
            st = self.slots[slot]
            st.active, st.request_id, st.max_new = True, rid, max_new_tokens
            st.generated = [first_tok]
            self._last_tokens[slot] = first_tok
            rids.append(rid)
        return rids

    def _split_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _rep(self, a):
        """Host value -> jit-ready operand. Multi-process meshes require
        every jit input to be a GLOBAL array; host values are identical
        on all processes, so a replicated device_put is exact."""
        if self._mesh is None or jax.process_count() == 1:
            return jnp.asarray(a)
        from jax.sharding import NamedSharding, PartitionSpec as P

        a = np.asarray(a)
        return jax.device_put(
            a, NamedSharding(self._mesh, P(*([None] * a.ndim))))

    def _to_np(self, a) -> np.ndarray:
        """Device -> host; allgathers first when this process cannot
        address every shard (multi-process mesh serving)."""
        if getattr(a, "is_fully_addressable", True):
            return np.asarray(a)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))

    # -- decode loop -------------------------------------------------------
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        toks = self._rep(self._last_tokens[:, None])
        valid = self._rep(np.asarray(
            [1 if s.active else 0 for s in self.slots], np.int32))
        logits, self.cache = self._decode(
            self.params, toks, self.cache, valid_lengths=valid,
        )
        nxt = self._to_np(self._sample_last(logits,
                                            self._rep(self._split_key())))
        for i in active:
            self._host_len[i] = min(self._host_len[i] + 1, self.ecfg.max_len)
        for i in active:
            tok = int(nxt[i])
            st = self.slots[i]
            st.generated.append(tok)
            self._last_tokens[i] = tok
            done = (
                len(st.generated) >= st.max_new
                or (self.ecfg.eos_token is not None and tok == self.ecfg.eos_token)
                or int(self._host_len[i]) >= self.ecfg.max_len - 1
            )
            if done:
                self._results[st.request_id] = st.generated
                st.active = False
        return sum(1 for s in self.slots if s.active)

    def step_chunk(self, n: int = 32) -> int:
        """``n`` decode steps for all active slots in ONE device dispatch
        (decode_scan) — one host round-trip per chunk instead of per
        token. EOS / max_new trimming happens here on the host; a slot's
        tokens past its stop point are discarded (its cache is
        re-prefilled from scratch on reuse). Returns #active."""
        from .decode import decode_scan

        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        n = min(n, max(1, min(
            s.max_new - len(s.generated) for s in self.slots if s.active)))
        if self._decode_scan.get(n) is None:
            self._decode_scan[n] = jax.jit(partial(
                decode_scan, n_steps=n, cfg=self.cfg, impl=self.impl,
                temperature=self.ecfg.temperature, top_k=self.ecfg.top_k,
            ), donate_argnums=2)
        valid = self._rep(np.asarray(
            [1 if s.active else 0 for s in self.slots], np.int32))
        toks, self.cache = self._decode_scan[n](
            self.params, self._rep(self._last_tokens), self.cache,
            valid=valid, rng=self._rep(self._split_key()))
        toks = self._to_np(toks)                      # [B, n]
        for i in active:
            self._host_len[i] = min(self._host_len[i] + n, self.ecfg.max_len)
        for i in active:
            st = self.slots[i]
            for t in toks[i]:
                tok = int(t)
                st.generated.append(tok)
                self._last_tokens[i] = tok
                if (len(st.generated) >= st.max_new
                        or (self.ecfg.eos_token is not None
                            and tok == self.ecfg.eos_token)):
                    self._results[st.request_id] = st.generated
                    st.active = False
                    break
            if st.active and int(self._host_len[i]) >= self.ecfg.max_len - 1:
                self._results[st.request_id] = st.generated
                st.active = False
        return sum(1 for s in self.slots if s.active)

    def run_to_completion(self, max_steps: int = 10_000,
                          chunk: int = 0) -> dict[int, list[int]]:
        """``chunk > 1`` decodes in on-device chunks (step_chunk)."""
        for _ in range(max_steps):
            n = self.step_chunk(chunk) if chunk > 1 else self.step()
            if n == 0:
                break
        return dict(self._results)

    def result(self, rid: int) -> list[int] | None:
        return self._results.get(rid)
