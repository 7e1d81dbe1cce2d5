"""Device facts: published peaks per accelerator, kernel mode, compile cache.

``PEAKS`` is the one table of hardware rates the solver's cost models
divide by (and a benchmark's roofline share will). It is keyed by
``jax.Device.device_kind``; a kind that is not in it is a KeyError, never a
default.
"""

from __future__ import annotations

import dataclasses
import os

import jax


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    kind: str
    bf16_tflops: float      # dense tensor-core rate
    int8_tops: float        # dense tensor-core rate
    hbm_gbps: float         # device-memory bandwidth, GB/s
    hbm_bytes: int
    source: str


# NVIDIA H100 data sheet (SXM5 part, dense rates without sparsity, at the
# 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        kind="NVIDIA H100 80GB HBM3", bf16_tflops=989.0, int8_tops=1979.0,
        hbm_gbps=3350.0, hbm_bytes=80 * 10**9,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense"),
}


def interpret_kernels() -> bool:
    """Pallas kernels run in interpret mode exactly when JAX is on the CPU
    (tests, rehearsals); on the GPU they compile through Triton."""
    return jax.default_backend() == "cpu"


def require_gpu() -> jax.Device:
    """Entry points that measure the card refuse to fall back to the CPU."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {d.platform!r} "
                         f"({d.device_kind})")
    return d


def enable_compile_cache() -> str:
    """Persistent compilation cache shared by every entry point: the
    directory ``JAX_COMPILATION_CACHE_DIR`` names when set, else the fixed
    ``<repo>/.jax_cache`` (a fixed path, so repeat runs hit it)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def device_record() -> dict:
    """``platform``, ``device_kind`` and ``count`` for result lines."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs)}
