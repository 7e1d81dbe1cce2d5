"""Project-level registries: model topologies, paths, artifact locations.

JAX counterpart of the reference's ``project_config.py`` (model-id
registry, calibration artifact paths; see reference ``project_config.py:6-88``)
— but with repo-relative paths instead of hard-coded machine paths (a noted
defect of the reference, ``project_config.py:9-13``).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACT_DIR = pathlib.Path(os.environ.get("MXMOE_ARTIFACT_DIR", REPO_ROOT / "artifacts"))

# Artifact subdirectories (every pipeline stage writes a resumable file, the
# same file-as-interface design as the reference — SURVEY.md §1 dataflow).
GATE_TRACE_DIR = ARTIFACT_DIR / "gate"
CALIB_LOSS_DIR = ARTIFACT_DIR / "calib"
PERF_TABLE_DIR = ARTIFACT_DIR / "perf"
QCONFIG_DIR = ARTIFACT_DIR / "qconfigs"
WORKLOAD_DIR = ARTIFACT_DIR / "workloads"
BENCH_DIR = ARTIFACT_DIR / "bench"


@dataclasses.dataclass(frozen=True)
class MoEModelSpec:
    """Static topology of a supported MoE model family.

    Mirrors the model set of the reference (``project_config.py:6-14``,
    ``bits_solver.py:636-644``, ``gen_workload.py:16-21``):
      qwen2_moe     = Qwen1.5-MoE-A2.7B   (24L, 60 experts + shared, top-4)
      qwen2_moe_57b = Qwen2-57B-A14B      (28L, 64 experts + shared, top-8)
      mixtral       = Mixtral-8x7B        (32L, 8 experts, top-2)
      ds2           = DeepSeek-V2-Lite    (27L, 64 + 2 shared, top-6, layer0 dense)
    """

    model_id: str
    hf_name: str
    num_layers: int
    num_experts: int
    top_k: int
    hidden_size: int            # K of the expert GEMMs
    moe_intermediate_size: int  # N of the expert GEMMs
    # Shared-expert width expressed in units of moe_intermediate_size
    # (the reference calls this num_shared_experts; qwen2_moe's single shared
    # expert has intermediate 5632 = 4 x 1408 -> 4).
    num_shared_experts: int
    first_dense_layers: int = 0  # ds2: layer 0 is a dense MLP


MODEL_REGISTRY: dict[str, MoEModelSpec] = {
    "qwen2_moe": MoEModelSpec(
        model_id="qwen2_moe",
        hf_name="Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        num_experts=60,
        top_k=4,
        hidden_size=2048,
        moe_intermediate_size=1408,
        num_shared_experts=4,
    ),
    "qwen2_moe_57b": MoEModelSpec(
        model_id="qwen2_moe_57b",
        hf_name="Qwen/Qwen2-57B-A14B",
        num_layers=28,
        num_experts=64,
        top_k=8,
        hidden_size=3584,
        moe_intermediate_size=2560,
        num_shared_experts=8,
    ),
    "mixtral": MoEModelSpec(
        model_id="mixtral",
        hf_name="mistralai/Mixtral-8x7B-v0.1",
        num_layers=32,
        num_experts=8,
        top_k=2,
        hidden_size=4096,
        moe_intermediate_size=14336,
        num_shared_experts=0,
    ),
    "ds2": MoEModelSpec(
        model_id="ds2",
        hf_name="deepseek-ai/DeepSeek-V2-Lite",
        num_layers=27,
        num_experts=64,
        top_k=6,
        hidden_size=2048,
        moe_intermediate_size=1408,
        num_shared_experts=2,
        first_dense_layers=1,
    ),
}


def get_model_spec(model_id: str) -> MoEModelSpec:
    if model_id not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model id {model_id!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_id]
