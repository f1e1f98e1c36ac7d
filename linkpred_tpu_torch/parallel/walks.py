"""Sharded random walks over the ranks of a mesh — the counterpart of
`linkpred_tpu/parallel/walks.py`.

Two regimes, as in the reference:

- **Replicated tables, sharded walkers** (`sharded_walks`): every rank
  holds the whole `WalkEngine` and walks its contiguous slice of the
  `num_walks * N` starts; one all-gather at the end assembles the walk
  matrix in the reference's row order. No collective inside the walk.
- **Sharded tables, routed frontier** (`TableShardedWalker`): the node
  blocks, with their ELL rows, node alias tables and CSR ranges of edge
  tables, are split over the ranks of a mesh dim, and each step routes
  every walker to the owner of its current node with one int32
  all-to-all. A rank holds only its own shard (`TableShardedWalker.shard`,
  a `WalkerShard`), so the tables never need to fit one card.

The routed step needs every lookup to be owner-local. The 2nd-order alias
table of the directed edge e = (u -> v), drawn when standing at v having
come from u, is re-keyed on the host by the reverse edge id rev(e) = (v ->
u), which lies in v's CSR range; a walker carries rev and finds its table,
its neighbor row and the next hop's carried key (`rev_next[f] = rev(f)` for
the chosen edge f = (v -> w)) on the rank that owns v. This needs a
symmetric edge set.

Routing puts at most `capacity_per_dest` walkers a step into each
destination's bucket; a walker beyond it is dropped, and `walks` returns
the number of walkers lost. The default capacity is the reference's, 4x
the mean load of a pair of ranks plus 16: enough on fb-pages-food, not on
a graph whose hubs crowd one node block (the collab power-law graph loses
~5 % of its walkers at 4 ranks; twice the default loses none).

Three differences from the reference (ROADMAP, known faults in the
reference): `lost` counts each missing walker once (the reference adds the
overflow to a count that already holds it, and counts walkers dropped at
placement twice); each rank draws its step uniforms from its own stream
(the reference's replicated key gives walkers in the same buffer slot of
different shards the same draws); and the host placement of walkers is a
stable sort by owner, not a Python loop over every walker.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.ops.walk import AliasTables, WalkEngine, simulate_walks
from linkpred_tpu_torch.parallel.collectives import (all_gather_blocks,
                                                     all_to_all_blocks)
from linkpred_tpu_torch.parallel.mesh import (dim_rank, dim_size,
                                              mesh_device, seed_of, stream)

# the names of the walks' random streams (`mesh.stream`)
_WALKERS, _ROUTED = 3, 4
# payload columns of a routed walker: current node, carried reverse edge id
# (-1 before the first hop), alive flag, walker id, then the trajectory
_CUR, _REV, _ALIVE, _WID, _TRAJ = 0, 1, 2, 3, 4


@torch.no_grad()
def sharded_walks(mesh: DeviceMesh, engine: WalkEngine, generator,
                  num_walks: int, walk_length: int) -> torch.Tensor:
    """`num_walks` walks from every node with the walkers split over every
    rank of `mesh` (called on each): [num_walks * N, walk_length] int32 on
    the engine's device, the same on every rank, walk r of node v at row
    r * N + v. `engine` is this rank's whole `WalkEngine`; `generator` an
    int seed or a `torch.Generator` in the same state on every rank (each
    rank folds its index into the seed drawn from it)."""
    names = mesh.mesh_dim_names
    n_dev, k = dim_size(mesh, names), dim_rank(mesh, names)
    n = engine.graph.num_nodes
    total = num_walks * n
    per = -(-total // n_dev)
    starts = torch.arange(n, device=engine.device).repeat(num_walks)
    # padded walkers start at node 0, as the reference's
    starts = torch.nn.functional.pad(starts, (0, per * n_dev - total))
    out = simulate_walks(
        stream(seed_of(generator), (_WALKERS, k), engine.device),
        starts[k * per:(k + 1) * per], engine.nbr, engine.indptr,
        engine.degree, engine.node_J, engine.node_q, engine.edge_J,
        engine.edge_q, walk_length)
    for name in reversed(names):  # rank-major: the innermost dim first
        out = all_gather_blocks(out, mesh.get_group(name))
    return out[:total]


# ---------------------------------------------------------------------------
# table-sharded regime
# ---------------------------------------------------------------------------


def _reverse_edge_ids(g: Graph) -> np.ndarray:
    """rev[e] = edge id of (dst_e -> src_e). Edges are CSR-sorted by
    (src, dst), so ids resolve with one searchsorted. Raises unless every
    reverse edge exists (undirected-doubled edge sets)."""
    n = np.int64(g.num_nodes)
    key = g.src.astype(np.int64) * n + g.dst.astype(np.int64)
    rev_key = g.dst.astype(np.int64) * n + g.src.astype(np.int64)
    rev = np.searchsorted(key, rev_key)
    if not (key[np.minimum(rev, len(key) - 1)] == rev_key).all():
        raise ValueError("table-sharded walks need a symmetric edge set")
    return rev.astype(np.int32)


def _place_walkers(starts: np.ndarray, owners: np.ndarray, n_shards: int,
                   buffer_rows: int, walk_length: int
                   ) -> tuple[np.ndarray, int]:
    """Each walker in its start owner's buffer, in walker-id order: ([S,
    buffer_rows, 4 + walk_length] int32 payloads, -1 where empty; the
    number of walkers beyond a buffer, dropped). A stable sort by owner."""
    total = len(starts)
    buf = np.full((n_shards, buffer_rows, _TRAJ + walk_length), -1, np.int32)
    order = np.argsort(owners, kind="stable")
    owner = owners[order]
    pos = np.arange(total) - np.searchsorted(owner, np.arange(n_shards))[owner]
    fits = pos < buffer_rows
    wid, owner, pos = order[fits], owner[fits], pos[fits]
    buf[owner, pos, _CUR] = starts[wid]
    buf[owner, pos, _ALIVE] = 1
    buf[owner, pos, _WID] = wid
    buf[owner, pos, _TRAJ] = starts[wid]
    return buf, int(total - fits.sum())


def _bucket(dest: torch.Tensor, payload: torch.Tensor, cap: int,
            n_shards: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of `payload` [C, Pw] into per-destination buckets of `cap`
    rows, in row order: ([S, cap, Pw] with -1 in empty rows, the alive rows
    that found their bucket full [C] bool). Dead rows go nowhere. Each
    row's place is its rank among the rows for its destination (a cumsum
    over the one-hot destinations, as the reference's)."""
    alive = payload[:, _ALIVE] > 0
    dest = torch.where(alive, dest, n_shards)
    onehot = (dest[:, None] == torch.arange(n_shards, device=dest.device)
              ).int()
    rank = (onehot.cumsum(0) - onehot).gather(
        1, dest.clamp(max=n_shards - 1)[:, None])[:, 0]
    over = alive & (rank >= cap)
    slot = torch.where(alive & ~over, dest * cap + rank, n_shards * cap)
    send = payload.new_full((n_shards * cap + 1, payload.shape[1]), -1)
    send[slot] = payload  # the spare last row takes every unsent one
    return send[:-1].reshape(n_shards, cap, -1), over


def _route(dest, payload, cap, n_shards, group):
    """`_bucket`, then the all-to-all over `group`: this rank's new payload
    [S * cap, Pw] (the overflowed rows are gone; `walks` counts them among
    the walkers that never come back)."""
    send, _ = _bucket(dest, payload, cap, n_shards)
    return all_to_all_blocks(send, group).reshape(n_shards * cap, -1)


@dataclasses.dataclass(frozen=True)
class WalkerShard:
    """Shard `index` of a `TableShardedWalker` (node block [index * rows,
    (index + 1) * rows)): what its rank holds, and the routed walk."""

    index: int
    num_nodes: int
    rows: int
    n_shards: int
    nbr: np.ndarray  # [rows, D]
    degree: np.ndarray  # [rows]
    indptr: np.ndarray  # [rows] global edge-id offset of each node
    node_J: np.ndarray  # [rows, D]
    node_q: np.ndarray  # [rows, D] f32
    edge_J2: np.ndarray  # [e_cap, D] rekeyed by reverse id
    edge_q2: np.ndarray  # [e_cap, D] f32
    rev_next: np.ndarray  # [e_cap]
    edge_start: int  # global edge-id offset of the shard

    @torch.no_grad()
    def walks(self, mesh: DeviceMesh, generator, num_walks: int,
              walk_length: int, axis: str = "edge",
              capacity_per_dest: int | None = None
              ) -> tuple[np.ndarray, int]:
        """The routed walk, called on every rank of `mesh`, each with its
        own shard (this one on the rank of index `index` along `axis`):
        ([num_walks * N, walk_length] int32 walks on the host, walk r of
        node v at row r * N + v, all-zero rows for lost walkers; the number
        of walkers lost). `generator`: an int seed or a `torch.Generator` in
        the same state on every rank."""
        S = self.n_shards
        if dim_size(mesh, axis) != S or dim_rank(mesh, axis) != self.index:
            raise ValueError(f"shard {self.index} of {S} on rank "
                             f"{dim_rank(mesh, axis)} of "
                             f"{dim_size(mesh, axis)} along {axis!r}")
        device = mesh_device(mesh)
        group = mesh.get_group(axis)
        n, rows, k = self.num_nodes, self.rows, self.index
        total = num_walks * n
        # 4x the mean per-destination load plus headroom, as the reference
        cap = capacity_per_dest or (4 * (-(-total // S) // S) + 16)
        starts = np.tile(np.arange(n, dtype=np.int32), num_walks)
        payload = torch.as_tensor(_place_walkers(
            starts, starts // rows, S, S * cap, walk_length)[0][k],
            device=device)
        t_ = {f: torch.as_tensor(getattr(self, f), device=device)
              for f in ("nbr", "degree", "indptr", "node_J", "node_q",
                        "edge_J2", "edge_q2", "rev_next")}
        e_cap = t_["rev_next"].shape[0]
        gen = stream(seed_of(generator), (_ROUTED, k), device)
        for t in range(1, walk_length):
            cur = payload[:, _CUR].long()
            rev = payload[:, _REV].long()
            cur_l = (cur - k * rows).clamp(0, rows - 1)
            rev_l = (rev - self.edge_start).clamp(0, e_cap - 1)
            first = rev < 0  # the first hop draws from the node table
            d = t_["degree"][cur_l].long()
            u = torch.rand((2, payload.shape[0]), generator=gen,
                           device=device)
            kk = torch.minimum((u[0] * d).long(), (d - 1).clamp(min=0))
            qk = torch.where(first, t_["node_q"][cur_l, kk],
                             t_["edge_q2"][rev_l, kk])
            jk = torch.where(first, t_["node_J"][cur_l, kk],
                             t_["edge_J2"][rev_l, kk]).long()
            slot = torch.where(u[1] < qk, kk, jk)
            stalled = d == 0
            nxt = torch.where(stalled, cur, t_["nbr"][cur_l, slot].long())
            eid_l = (t_["indptr"][cur_l].long() - self.edge_start + slot
                     ).clamp(0, e_cap - 1)
            payload[:, _CUR] = nxt.int()  # this rank's buffer: in place
            payload[:, _REV] = torch.where(stalled, rev,
                                           t_["rev_next"][eid_l].long()).int()
            payload[:, _TRAJ + t] = nxt.int()
            payload = _route(nxt // rows, payload, cap, S, group)
        done = all_gather_blocks(payload[:, _WID:], group)
        ids, got = done[:, 0].long(), done[:, 0] >= 0
        walks = torch.zeros((total, walk_length), dtype=torch.int32,
                            device=device)
        walks[ids[got]] = done[got, 1:]
        return walks.cpu().numpy(), total - int(got.sum())


@dataclasses.dataclass(frozen=True)
class TableShardedWalker:
    """Host-built sharded table layout (numpy), equal field for field to
    the reference's: per shard k (node block [k * rows, (k + 1) * rows)),
    its ELL rows, degrees, global CSR offsets, node alias tables, and the
    edge-table rows REKEYED by reverse id (module docstring), padded to the
    largest shard's edge count. `shard(k)` is rank k's part; `walks` runs
    the routed walk with it."""

    num_nodes: int
    rows: int  # nodes per shard
    n_shards: int
    nbr: np.ndarray  # [S, rows, D]
    degree: np.ndarray  # [S, rows]
    indptr: np.ndarray  # [S, rows] global edge-id offset of each node
    node_J: np.ndarray  # [S, rows, D]
    node_q: np.ndarray  # [S, rows, D] f32
    edge_J2: np.ndarray  # [S, e_cap, D] rekeyed by reverse id
    edge_q2: np.ndarray  # [S, e_cap, D] f32
    rev_next: np.ndarray  # [S, e_cap] rev(e) per locally-owned edge e
    edge_start: np.ndarray  # [S] global edge-id offset of each shard

    @staticmethod
    def build(g: Graph, n_shards: int, p: float = 1.0, q: float = 1.0
              ) -> "TableShardedWalker":
        tables = AliasTables.build(g, p=p, q=q)
        rev = _reverse_edge_ids(g)
        n, d = g.nbr.shape
        rows = -(-n // n_shards)

        # rekey: the table for edge e = (u -> v) is stored at slot rev(e),
        # which lies in v's CSR range: the owner a walker standing at v is
        # routed to
        edge_J2 = np.zeros_like(tables.edge_J)
        edge_q2 = np.zeros_like(tables.edge_q)
        edge_J2[rev] = tables.edge_J
        edge_q2[rev] = tables.edge_q

        node_pad = rows * n_shards - n

        def pad_nodes(a):
            w = ((0, node_pad),) + ((0, 0),) * (a.ndim - 1)
            return np.pad(a, w).reshape((n_shards, rows) + a.shape[1:])

        # edge rows: contiguous CSR ranges per node block, padded to the
        # largest
        bounds = g.indptr[np.minimum(np.arange(n_shards + 1) * rows, n)]
        e_cap = max(int(np.diff(bounds).max()), 1)
        eJ = np.zeros((n_shards, e_cap, d), tables.edge_J.dtype)
        eq = np.zeros((n_shards, e_cap, d), tables.edge_q.dtype)
        rv = np.zeros((n_shards, e_cap), np.int32)
        for k in range(n_shards):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            eJ[k, : hi - lo] = edge_J2[lo:hi]
            eq[k, : hi - lo] = edge_q2[lo:hi]
            rv[k, : hi - lo] = rev[lo:hi]
        return TableShardedWalker(
            num_nodes=n, rows=rows, n_shards=n_shards,
            nbr=pad_nodes(g.nbr), degree=pad_nodes(g.degree),
            indptr=pad_nodes(g.indptr[:-1]),
            node_J=pad_nodes(tables.node_J), node_q=pad_nodes(tables.node_q),
            edge_J2=eJ, edge_q2=eq, rev_next=rv,
            edge_start=bounds[:-1].astype(np.int32),
        )

    def shard(self, k: int) -> WalkerShard:
        """Shard k's arrays, which are all that rank k needs."""
        return WalkerShard(
            index=k, num_nodes=self.num_nodes, rows=self.rows,
            n_shards=self.n_shards, nbr=self.nbr[k], degree=self.degree[k],
            indptr=self.indptr[k], node_J=self.node_J[k],
            node_q=self.node_q[k], edge_J2=self.edge_J2[k],
            edge_q2=self.edge_q2[k], rev_next=self.rev_next[k],
            edge_start=int(self.edge_start[k]))

    def walks(self, mesh: DeviceMesh, generator, num_walks: int,
              walk_length: int, axis: str = "edge",
              capacity_per_dest: int | None = None
              ) -> tuple[np.ndarray, int]:
        """`WalkerShard.walks` with this rank's shard (every rank holds the
        whole layout): (walks [num_walks * N, walk_length] int32, walkers
        lost)."""
        return self.shard(dim_rank(mesh, axis)).walks(
            mesh, generator, num_walks, walk_length, axis, capacity_per_dest)
