"""The configuration tree with CLI overrides — the counterpart of
`linkpred_tpu/config.py`, over the port's own family configs.

Every setting is one field of a nested frozen-dataclass tree, and any field
can be overridden by its dotted path:

    python -m linkpred_tpu_torch.cli --set twowl.epochs=500 --set seed=7 twowl

Values are parsed with the field's type (bools accept true/false/1/0 and
yes/on). The tree equals the JAX package's field for field and default for
default, with one field fewer: `twowl.chunk_epochs`, the TPU's 60-second
chunking of the fused epoch loop, has no counterpart here, so overriding it
raises the `unknown config field` error of any unknown key.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from linkpred_tpu_torch.pipelines.logistic_pipeline import LogisticConfig
from linkpred_tpu_torch.pipelines.seal_pipeline import SEALConfig
from linkpred_tpu_torch.pipelines.twowl_pipeline import TwoWLRunConfig


@dataclasses.dataclass(frozen=True)
class Paths:
    """Where inputs are found and outputs written."""

    data_dir: str | None = None  # None -> auto-discover (repo, then reference)
    records_dir: str = "records_auc"
    checkpoints_dir: str = "checkpoints"
    assets_dir: str = "assets/img"
    metrics_log: str = "logs/metrics.jsonl"
    hpo_log: str = "logs.json"


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 0
    paths: Paths = Paths()
    logistic: LogisticConfig = LogisticConfig()
    seal: SEALConfig = SEALConfig()
    twowl: TwoWLRunConfig = TwoWLRunConfig()
    twowl_trials: int = 10


def _parse_value(raw: str, typ: Any):
    if typ is bool or str(typ) == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    try:  # typing unions like `str | int`
        return int(raw)
    except (TypeError, ValueError):
        pass
    try:
        return float(raw)
    except (TypeError, ValueError):
        pass
    return raw


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply `a.b.c=value` overrides to a frozen-dataclass tree, returning a
    new tree."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        path, raw = ov.split("=", 1)
        cfg = _set_path(cfg, path.split("."), raw)
    return cfg


def _set_path(node: Any, keys: list[str], raw: str) -> Any:
    if not dataclasses.is_dataclass(node):
        raise ValueError(f"cannot descend into non-dataclass at {keys}")
    name = keys[0]
    fields = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields:
        raise ValueError(
            f"unknown config field {name!r}; valid: {sorted(fields)}"
        )
    cur = getattr(node, name)
    if len(keys) == 1:
        typ = type(cur) if cur is not None else fields[name].type
        value = _parse_value(raw, typ)
    else:
        value = _set_path(cur, keys[1:], raw)
    return dataclasses.replace(node, **{name: value})
