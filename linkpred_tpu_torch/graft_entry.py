"""The single-device entry point of the port — the counterpart of `entry()`
in the repository's `__graft_entry__.py`.

`entry()` returns a forward step of the flagship model (TwoWL's LocalWLNet,
the best-AUC family) with example arguments, on the card by default:

    from linkpred_tpu_torch.graft_entry import entry
    fn, args = entry()              # on the card; entry("cpu") on the host
    scores = fn(*args)              # [pairs] sigmoid scores of the test split

The multi-device dry run beside it in the JAX package waits for the port's
multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import twowl as m


def _toy_twowl_data(n_nodes=24, seed=0, ei2_bucket=256):
    """A chain through every node plus 60 random pairs, split and built as
    the JAX entry point builds it."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], axis=1)
    extra = np.stack(
        [rng.integers(0, n_nodes, 60), rng.integers(0, n_nodes, 60)], axis=1
    )
    pairs = np.concatenate([chain, extra], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return build_twowl_data(pairs, n_nodes, rng=rng, ei2_bucket=ei2_bucket)


def entry(device=None, agg_1wl: str = "plan"):
    """(fn, example_args): the LocalWLNet forward scoring the toy graph's
    test split, `fn(*example_args)`, with parameters drawn from seed 0 on
    `device` (None: the visible card; no card raises). `agg_1wl='ell'` runs
    the 1-WL aggregation on kernel K1 and the 2-WL one on K3; 'plan', the
    default and the JAX entry point's choice, runs both in plain PyTorch."""
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    d = _toy_twowl_data()
    cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                        channels_2wl=8, depth1=2, depth2=2, agg_1wl=agg_1wl)
    params = m.init_params(cfg, torch.Generator().manual_seed(0), device)

    def fn(params, node_deg, arrays):
        return m.eval_scores(params, node_deg, arrays, cfg)

    args = (params, torch.as_tensor(d.node_deg, dtype=torch.long,
                                    device=device),
            m.SplitArrays.from_split(d.test, device))
    return fn, args
