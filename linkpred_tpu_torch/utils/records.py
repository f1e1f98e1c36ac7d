"""Result record files in the reference format — the counterpart of
`linkpred_tpu/utils/records.py`.

`records_auc/<dataset>_auc_record_<family>.txt` holds append-only
`AUC:x   Time:y   ` lines (written by the pipelines, read back by `compare`
and `report`); `fpr.json`/`tpr.json` hold the best ROC curve; a
`MetricsLogger` file holds one JSON object per line. The bytes written are
the reference's.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

DEFAULT_RECORDS_DIR = "records_auc"


def record_path(dataset: str, family: str,
                records_dir: str = DEFAULT_RECORDS_DIR) -> str:
    return os.path.join(records_dir, f"{dataset}_auc_record_{family}.txt")


def write_record(dataset: str, family: str, auc: float, seconds: float,
                 records_dir: str = DEFAULT_RECORDS_DIR,
                 append: bool = True) -> str:
    os.makedirs(records_dir, exist_ok=True)
    path = record_path(dataset, family, records_dir)
    with open(path, "a" if append else "w") as f:
        f.write(f"AUC:{round(auc, 4)}   Time:{round(seconds, 4)}   \n")
    return path


def read_records(dataset: str, family: str,
                 records_dir: str = DEFAULT_RECORDS_DIR
                 ) -> List[Tuple[float, float]]:
    """Parse `[(auc, time), ...]` from a record file (empty if missing)."""
    path = record_path(dataset, family, records_dir)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            auc = float(parts[0].split(":")[1])
            t = float(parts[1].split(":")[1])
            out.append((auc, t))
    return out


def best_record(dataset: str, family: str,
                records_dir: str = DEFAULT_RECORDS_DIR
                ) -> Optional[Tuple[float, float]]:
    recs = read_records(dataset, family, records_dir)
    return max(recs, key=lambda r: r[0]) if recs else None


def write_roc_json(fpr, tpr, out_dir: str = ".") -> None:
    """Persist the best-model ROC curve as `fpr.json` and `tpr.json`."""
    with open(os.path.join(out_dir, "fpr.json"), "w") as f:
        json.dump([float(x) for x in fpr], f)
    with open(os.path.join(out_dir, "tpr.json"), "w") as f:
        json.dump([float(x) for x in tpr], f)


class MetricsLogger:
    """Structured jsonl metrics log (one object per event)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(kv) + "\n")
