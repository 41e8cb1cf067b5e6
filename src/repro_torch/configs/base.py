"""Architecture registry: full configs, reduced smoke configs, shapes.

Counterpart of ``repro.configs.base``.  Ported families: ``retrieval``
(colbert), ``lm`` (minitron-4b, stablelm-3b, qwen2.5-32b and the MoE
archs granite-moe-3b-a800m and mixtral-8x7b) and ``recsys``
(dlrm-rm2, dcn-v2, wide-deep, bert4rec); the GNN family is not ported
yet.  Every architecture module of the port exports
  CONFIG  — the exact public-literature configuration;
  SMOKE   — a reduced same-family config for CPU tests;
  SHAPES  — {shape_id: ShapeSpec} (the arch's own input-shape set);
and registers itself through :func:`register`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture x input shape) cell."""
    shape_id: str
    kind: str            # "train" | "prefill" | "decode" | "serve" | "retrieval"
    dims: dict
    skip: str | None = None   # reason string if this cell is skipped


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str          # "lm" | "gnn" | "recsys" | "retrieval"
    config: Any
    smoke: Any
    shapes: dict
    notes: str = ""


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.arch_id] = entry
    return entry


def get(arch_id: str) -> ArchEntry:
    import repro_torch.configs  # noqa: F401  (triggers module registration)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq_len": 524288, "global_batch": 1}),
}


def lm_shapes(*, long_ok: bool, long_skip_reason: str = "") -> dict:
    shapes = dict(LM_SHAPES)
    if not long_ok:
        shapes["long_500k"] = dataclasses.replace(
            shapes["long_500k"],
            skip=long_skip_reason or
            "pure full-attention arch: 512k decode requires sub-quadratic "
            "attention (DESIGN.md §7)")
    return shapes
