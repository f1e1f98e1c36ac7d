"""Multi-device training over `torch.distributed` — the counterpart of
`linkpred_tpu/parallel/` (meshes, multi-host set-up, data-parallel steps,
node- and edge-partitioned aggregation, the halo exchange).

The reference writes one program over a `jax.sharding.Mesh` and lets
`shard_map` and GSPMD place the collectives. Here every rank is a process
that runs the same code on its own shard: a `DeviceMesh` with named dims
(`mesh.make_mesh`, `distributed.hybrid_mesh`) gives each dim's process
group, the collectives are explicit calls on those groups, and where the
reference has a `custom_vjp` the port has a `torch.autograd.Function`
(`collectives`, `spmm_shard`, `halo`). The distributed node2vec:
`sgns` (corpus-sharded sampling, feature-sharded tables) and `walks`
(sharded walkers; sharded tables with a routed frontier).
"""

from linkpred_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
