"""Calibration / evaluation data access.

Counterpart of the reference's ``data_utils.py`` (WikiText-2 + HumanEval-X
with pickle caches, seeded seqlen-4096 crops). Priority order:

  1. HF `datasets` (works when the dataset is in the local cache or the
     environment has egress),
  2. a local plain-text file (MXMOE_CALIB_TEXT env or explicit path),
  3. a deterministic synthetic token stream (seeded; zero-dependency) so
     every pipeline stage stays runnable in an air-gapped environment.

All loaders return token-id arrays shaped [nsamples, seqlen] (int32); seed
determinism mirrors ``data_utils.py:13-83``.
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import jax.numpy as jnp

_CACHE_DIR = os.environ.get("MXMOE_CACHE", os.path.expanduser("~/.cache/mxmoe"))


def _cache_path(tag: str) -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    return os.path.join(_CACHE_DIR, f"{tag}.pkl")


def _crop_samples(ids: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ids.shape[0] < seqlen + 1:
        reps = -(-(seqlen + 1) // ids.shape[0])
        ids = np.tile(ids, reps)
    starts = rng.integers(0, ids.shape[0] - seqlen, size=nsamples)
    return np.stack([ids[s: s + seqlen] for s in starts]).astype(np.int32)


def synthetic_tokens(
    nsamples: int, seqlen: int, vocab_size: int = 151936, seed: int = 42
) -> np.ndarray:
    """Zipf-distributed token stream with local repetition structure.

    Gives routing/activation statistics a long-tailed, bursty profile
    (unlike uniform noise) so gate traces and calibration losses are
    non-degenerate without any dataset on disk.
    """
    rng = np.random.default_rng(seed)
    total = nsamples * seqlen
    base = rng.zipf(1.3, size=total).astype(np.int64) % (vocab_size - 4) + 4
    # burstiness: repeat short n-grams
    out = base.copy()
    pos = 0
    while pos < total - 64:
        if rng.random() < 0.15:
            span = int(rng.integers(4, 32))
            out[pos + span: pos + 2 * span] = out[pos: pos + span]
            pos += 2 * span
        else:
            pos += int(rng.integers(16, 64))
    return out.reshape(nsamples, seqlen).astype(np.int32)


def synthetic_markov_tokens(
    nsamples: int, seqlen: int, vocab_size: int = 2048, seed: int = 7,
    branching: int = 8, structure_seed: int = 1,
) -> np.ndarray:
    """First-order Markov language with sparse transitions.

    Unlike :func:`synthetic_tokens` (statistics only), this is LEARNABLE:
    each token has ``branching`` fixed successors with Dirichlet weights, so
    the achievable perplexity (≈ branching-entropy, ppl ~4-6) sits far below
    the unigram floor (~vocab). ``structure_seed`` fixes the LANGUAGE
    (transition matrix); ``seed`` only varies the sampled trajectories, so
    train and held-out sets share one language. Used by the accuracy-anchor
    pipeline (eval/anchor.py) in this air-gapped environment.
    """
    lang = np.random.default_rng(structure_seed)
    succ = lang.integers(0, vocab_size, size=(vocab_size, branching))
    probs = lang.dirichlet(np.full(branching, 0.6), size=vocab_size)
    cdf = np.cumsum(probs, axis=1)

    rng = np.random.default_rng(seed)
    out = np.empty((nsamples, seqlen), np.int64)
    state = rng.integers(0, vocab_size, size=nsamples)
    for t in range(seqlen):
        u = rng.random((nsamples, 1))
        j = np.minimum((u > cdf[state]).sum(axis=1), branching - 1)
        state = succ[state, j]
        out[:, t] = state
    return out.astype(np.int32)


def tokens_from_text_file(
    path: str, tokenizer, nsamples: int, seqlen: int, seed: int = 42
) -> np.ndarray:
    text = open(path, encoding="utf-8").read()
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int64)
    return _crop_samples(ids, nsamples, seqlen, seed)


def get_wikitext2(
    nsamples: int,
    seqlen: int,
    tokenizer=None,
    split: str = "train",
    seed: int = 42,
) -> np.ndarray:
    """WikiText-2 crops (reference ``get_wikitext2``, data_utils.py:13-83).

    Requires `tokenizer` and dataset availability; raises otherwise.
    Results are pickle-cached per (split, nsamples, seqlen, tokenizer).
    """
    tok_id = getattr(tokenizer, "name_or_path", "none").replace("/", "_")
    tag = f"wikitext2-{split}-{nsamples}-{seqlen}-{seed}-{tok_id}"
    cp = _cache_path(hashlib.md5(tag.encode()).hexdigest()[:16] + "-" + tag[:64])
    if os.path.exists(cp):
        with open(cp, "rb") as f:
            return pickle.load(f)

    from datasets import load_dataset  # may hit local HF cache

    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    text = "\n\n".join(ds["text"])
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int64)
    out = _crop_samples(ids, nsamples, seqlen, seed)
    with open(cp, "wb") as f:
        pickle.dump(out, f)
    return out


def get_humaneval_x(
    nsamples: int, seqlen: int, tokenizer=None, seed: int = 42
) -> np.ndarray:
    """HumanEval-X calibration crops (reference data_utils.py:85-142)."""
    from datasets import load_dataset

    parts = []
    for lang in ("python", "cpp", "js", "java", "go"):
        ds = load_dataset("THUDM/humaneval-x", lang, split="test")
        parts.extend(r["prompt"] + r["canonical_solution"] for r in ds)
    text = "\n\n".join(parts)
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int64)
    return _crop_samples(ids, nsamples, seqlen, seed)


def get_calibration_tokens(
    nsamples: int,
    seqlen: int,
    dataset: str = "auto",
    tokenizer=None,
    vocab_size: int = 151936,
    seed: int = 42,
) -> jnp.ndarray:
    """Best-available calibration tokens; synthetic fallback, never fails."""
    if dataset in ("auto", "wikitext2") and tokenizer is not None:
        try:
            return jnp.asarray(get_wikitext2(nsamples, seqlen, tokenizer, seed=seed))
        except Exception:
            if dataset == "wikitext2":
                raise
    path = os.environ.get("MXMOE_CALIB_TEXT")
    if path and tokenizer is not None and os.path.exists(path):
        return jnp.asarray(tokens_from_text_file(path, tokenizer, nsamples, seqlen, seed))
    return jnp.asarray(synthetic_tokens(nsamples, seqlen, vocab_size, seed))
