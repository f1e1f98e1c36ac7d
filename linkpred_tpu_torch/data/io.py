"""Dataset loaders.

The port's own copy of `linkpred_tpu/data/io.py` (numpy only, same names and
behaviour; the port imports nothing of the JAX package).

Behavioral contract from the reference repo:
- `fb-pages-food` lives in `raw_data/fb-pages-food/` as a `.nodes` CSV with
  header `id,name,new_id` and a headerless `.edges`/`.csv` file of
  `u,v` int pairs (reference `constant.py:1-7`,
  `LogisticRegression_Linkprediction/data/understanding_data.py:10-28`).
- The reference's SEAL loader loses the first edge to a phantom header row
  (`SEAL/config/data.py:17` uses `pd.read_csv` with a default header on a
  headerless file) — a quirk we deliberately do NOT replicate.
- The karate-club edgelist demo ships at `node2vec/graph/karate.edgelist`
  (1-based ids, whitespace separated).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from linkpred_tpu_torch.data.graph import Graph

# Default search location for the fb-pages-food raw data: the copy that
# ships in this repository.
_DATA_DIRS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "raw_data", "fb-pages-food"),
]


def _find_data_file(name: str, data_dir: Optional[str] = None) -> str:
    dirs = [data_dir] if data_dir else _DATA_DIRS
    for d in dirs:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{name} not found in {dirs}")


def load_edge_csv(path: str) -> np.ndarray:
    """Read a headerless `u,v` CSV into an int64 [E, 2] array."""
    return np.loadtxt(path, delimiter=",", dtype=np.int64).reshape(-1, 2)


def load_edge_pairs(path: str):
    """Generic real-graph loader for the scale pipelines (`cli scale
    --edges-file`): one edge per line, comma- OR whitespace-separated,
    optional header row and extra columns (e.g. ogbl-collab dumps with
    year/weight) ignored, arbitrary node ids relabeled to a contiguous
    [0, n). Self-loops dropped, duplicate undirected pairs deduped.

    Returns `(lo, hi, num_nodes)` — the same contract as the synthetic
    generators in `data/synth.py`, so a real edge dump replaces
    the synthetic graph in `gcn_scale` / `seal_scale` / `twowl_scale`
    (the published-record pattern of the reference's
    `records_auc/fb-pages-food_auc_record_twowl.txt`).
    """
    with open(path) as f:
        first = f.readline()
    delim = "," if "," in first else None
    skip = 0
    try:
        [int(float(t)) for t in first.replace(",", " ").split()[:2]]
    except (ValueError, IndexError):
        skip = 1  # header row
    raw = np.loadtxt(path, delimiter=delim, skiprows=skip,
                     dtype=np.float64, ndmin=2)
    e = raw[:, :2].astype(np.int64)
    uniq, inv = np.unique(e.reshape(-1), return_inverse=True)
    e = inv.reshape(-1, 2)
    keep = e[:, 0] != e[:, 1]
    lo = np.minimum(e[keep, 0], e[keep, 1])
    hi = np.maximum(e[keep, 0], e[keep, 1])
    key = lo * len(uniq) + hi
    _, idx = np.unique(key, return_index=True)
    return lo[idx], hi[idx], int(len(uniq))


def load_fb_pages_food(
    data_dir: Optional[str] = None,
) -> Tuple[Graph, np.ndarray]:
    """Load the fb-pages-food graph.

    Returns (graph, edges) where `edges` is the raw [2102, 2] undirected edge
    list in file order (ids are already 0-based in the file) and `graph` is
    the symmetrized `Graph`.
    """
    path = _find_data_file("fb-pages-food.edges", data_dir)
    edges = load_edge_csv(path)
    g = Graph.from_undirected_edges(edges[:, 0], edges[:, 1])
    return g, edges


def load_node_names(data_dir: Optional[str] = None) -> dict:
    """Return {new_id: name} from the `.nodes` file (header id,name,new_id)."""
    path = _find_data_file("fb-pages-food.nodes", data_dir)
    names = {}
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) < 3:
                continue
            # name may itself contain commas; new_id is the last field
            names[int(parts[-1])] = ",".join(parts[1:-1])
    return names


def load_edgelist(
    path: str,
    one_based: bool = False,
    directed: bool = False,
    weighted: bool = False,
) -> Graph:
    """Load a whitespace-separated edgelist (e.g. the karate demo).

    Mirrors the reference node2vec CLI's read modes
    (`node2vec/src/main.py:66-76`): optional third weight column, directed
    or symmetrized. A file whose first line holds a comma (the
    fb-pages-food `.edges` dump) is read as comma-separated, which the JAX
    package's loader does not take.
    """
    with open(path) as f:
        delimiter = "," if "," in f.readline() else None
    raw = np.loadtxt(path, dtype=np.float64, delimiter=delimiter)
    raw = raw.reshape(-1, raw.shape[-1] if raw.ndim > 1 else 2)
    e = raw[:, :2].astype(np.int64)
    w = raw[:, 2].astype(np.float32) if (weighted and raw.shape[1] > 2) else None
    if one_based or e.min() == 1:
        e = e - 1
    if directed:
        return Graph.from_edges(e[:, 0], e[:, 1], weight=w)
    if w is not None:
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        return Graph.from_edges(src, dst, weight=np.concatenate([w, w]))
    return Graph.from_undirected_edges(e[:, 0], e[:, 1])
