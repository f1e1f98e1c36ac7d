"""Parity of the port's distributed SGNS (`linkpred_tpu_torch/parallel/
sgns.py`) with the JAX package's `linkpred_tpu/parallel/sgns.py`, on the
CPU.

Host arithmetic (the batch cap, the shard geometry, the step count) is
equal. The update of a feature slice is held against the JAX
`_slice_update` from shared numpy tables, indices, pool, lr and scores
(rtol 1e-6, atol 1e-7: the same f32 products in another library). Partial
scores of four feature slices add up to the whole scores (rtol 1e-5, atol
1e-6: f32 sums in another order). The mesh runs as 4 real gloo ranks
(`torch_ranks.sgns_mesh_job`, one job for the module) and is held to the
one-process replay of its sample stream at the JAX test's tolerance (atol
2e-4, rtol 1e-3: the all-reduced scores sum in another order); the streams
are torch's, so against JAX the runs are compared by what they learn (the
two-clique test, as `tests/test_sgns_mesh.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from linkpred_tpu.models import word2vec as jw2v
from linkpred_tpu.parallel import sgns as jsg
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.models import word2vec as w2v
from linkpred_tpu_torch.ops.walk import WalkEngine
from linkpred_tpu_torch.parallel import multihost
from linkpred_tpu_torch.parallel import sgns as tsg

torch.set_num_threads(1)

WORLD = 4
MESH_TOL = dict(atol=2e-4, rtol=1e-3)
SLICE_TOL = dict(rtol=1e-6, atol=1e-7)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)

CONFIGS = {
    "default": dict(),
    "mesh_test": dict(dim=32, window=4, negatives=5, epochs=1,
                      batch_size=512, ctx_per_center=4, neg_pool=64),
    "one_ctx": dict(dim=16, window=3, epochs=2, batch_size=100,
                    ctx_per_center=1, neg_pool=16),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return w2v.SGNSConfig(**kw), jw2v.SGNSConfig(**kw)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_geometry_and_step_count_equal(name, n_shards):
    ct, cj = _cfgs(name)
    walks = np.random.default_rng(0).integers(0, 50, (37, 9), np.int32)
    for num_nodes in (3, 50, 2000):
        got, ref = tsg._cap_batch(ct, num_nodes), jsg._cap_batch(cj,
                                                                 num_nodes)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert tsg._shard_geometry(got, n_shards) == jsg._shard_geometry(
            ref, n_shards)
        steps, w_in = tsg._steps_and_init(0, walks.size, num_nodes, got,
                                          n_shards)
        ref_steps, _, ref_in, ref_out = jsg._steps_and_init(
            jax.random.PRNGKey(0), walks, num_nodes, ref, n_shards)
        assert steps == ref_steps
        assert w_in.shape == ref_in.shape == ref_out.shape
        assert w_in.dtype == torch.float32
        assert float(w_in.abs().max()) <= 0.5 / got.dim


def _step_case(seed=0, n=40, d=16, bc=12, nc=4, pool=9):
    rng = np.random.default_rng(seed)
    w_in = rng.standard_normal((n, d)).astype(np.float32)
    w_out = rng.standard_normal((n, d)).astype(np.float32)
    center = rng.integers(0, n, bc)
    center[1] = center[0]  # collisions: two centers, a context that is
    context = rng.integers(0, n, (bc, nc))  # also a center and a pool row
    context[0, 0] = center[2]
    valid = rng.random((bc, nc)) < 0.7
    noise = rng.integers(0, n, pool)
    noise[0] = context[0, 0]
    pos = rng.standard_normal((bc, nc)).astype(np.float32)
    neg = rng.standard_normal((bc, pool)).astype(np.float32)
    return w_in, w_out, center, context, valid, noise, pos, neg


@pytest.mark.parametrize("k", range(WORLD))
def test_pooled_update_on_a_slice_matches_jax(k):
    """`pooled_update` on feature slice k of 4 against the JAX
    `_slice_update`, from the same scores."""
    w_in, w_out, center, context, valid, pool, pos, neg = _step_case(k)
    cols = slice(k * 4, (k + 1) * 4)
    cfg = w2v.SGNSConfig(negatives=5, neg_pool=len(pool))
    lr = 0.05
    ref_in, ref_out = jsg._slice_update(
        jnp.asarray(w_in[:, cols]), jnp.asarray(w_out[:, cols]), lr,
        jnp.asarray(center), jnp.asarray(context), jnp.asarray(valid),
        jnp.asarray(pool), jw2v.SGNSConfig(negatives=5, neg_pool=len(pool)),
        jnp.asarray(pos), jnp.asarray(neg))
    t_in = torch.tensor(w_in[:, cols])
    t_out = torch.tensor(w_out[:, cols])
    tsg._slice_update(t_in, t_out, torch.as_tensor(center),
                      torch.as_tensor(context), torch.as_tensor(valid),
                      torch.as_tensor(pool), lr, cfg, torch.as_tensor(pos),
                      torch.as_tensor(neg))
    np.testing.assert_allclose(t_in.numpy(), np.asarray(ref_in), **SLICE_TOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(ref_out),
                               **SLICE_TOL)


def test_partial_scores_add_up():
    w_in, w_out, center, context, _, pool, _, _ = _step_case(7)
    args = [torch.as_tensor(a) for a in (center, context, pool)]
    whole = w2v.pooled_scores(torch.tensor(w_in), torch.tensor(w_out), *args)
    parts = [w2v.pooled_scores(torch.tensor(w_in[:, c:c + 4]),
                               torch.tensor(w_out[:, c:c + 4]), *args)
             for c in range(0, 16, 4)]
    for i in range(2):
        np.testing.assert_allclose(sum(p[i] for p in parts).numpy(),
                                   whole[i].numpy(), **SCORE_TOL)


def test_preconditions_raise():
    walks = np.zeros((8, 4), np.int32)
    with pytest.raises(ValueError, match="pooled"):
        tsg.train_sgns_mesh_reference(0, walks, 10, w2v.SGNSConfig(
            dim=8, neg_pool=0), n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tsg.train_sgns_mesh_reference(0, walks, 10, w2v.SGNSConfig(
            dim=10, neg_pool=8), n_shards=4, device="cpu")


# ---------------------------------------------------------------------------
# over 4 gloo ranks
# ---------------------------------------------------------------------------


def _mesh_corpus(rows=64):
    """`tests/test_sgns_mesh.py`'s corpus and config (200 nodes)."""
    walks = np.random.default_rng(0).integers(0, 200, (rows, 12),
                                              dtype=np.int32)
    return walks, w2v.SGNSConfig(**CONFIGS["mesh_test"])


def _two_cliques():
    pairs = []
    for a in range(8):
        for b in range(a + 1, 8):
            pairs.append((a, b))
            pairs.append((a + 8, b + 8))
    pairs.append((0, 8))
    pairs = np.asarray(pairs)
    return Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=16)


CLIQUE_CFG = w2v.SGNSConfig(dim=16, window=4, negatives=5, epochs=3,
                            batch_size=2048, neg_pool=64)


def _clique_walks():
    return WalkEngine(_two_cliques(), device="cpu").walks(
        torch.Generator().manual_seed(0), 40, 12).numpy()


# the JAX test's config (1 epoch), and 40 epochs of it, over
# which the tables move far beyond the tolerance
STREAM_CASES = {
    "stream": w2v.SGNSConfig(**CONFIGS["mesh_test"]),
    "long": w2v.SGNSConfig(**dict(CONFIGS["mesh_test"], epochs=40)),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    walks, cfg = _mesh_corpus()
    cases = {name: (3, walks, 200, c) for name, c in STREAM_CASES.items()}
    # 66 rows: the last 2 are trimmed away
    cases["trim"] = (3, _mesh_corpus(66)[0], 200, cfg)
    cases["cliques"] = (1, _clique_walks(), 16, CLIQUE_CFG)
    return multihost.launch(torch_ranks.sgns_mesh_job, WORLD,
                            str(tmp_path_factory.mktemp("sgns")),
                            args=(cases,))


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_mesh_matches_reference_stream(mesh_runs, name):
    """4 ranks against the one-process replay of their sample stream (the
    JAX test's oracle and tolerance)."""
    walks, cfg = _mesh_corpus()[0], STREAM_CASES[name]
    ref = tsg.train_sgns_mesh_reference(3, walks, 200, cfg, n_shards=WORLD,
                                        device="cpu")
    got = mesh_runs[0][name]
    assert got.shape == (200, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **MESH_TOL)
    if name == "long":  # the comparison is not of two inits
        init = tsg._steps_and_init(3, walks.size, 200,
                                   tsg._cap_batch(cfg, 200), WORLD)[1]
        assert np.abs(got - init.numpy()).max() > 100 * MESH_TOL["atol"]


def test_ranks_return_one_table(mesh_runs):
    for r in mesh_runs[1:]:
        for name in ("stream", "long", "trim", "cliques"):
            np.testing.assert_array_equal(r[name], mesh_runs[0][name])


def test_walk_trim_equal_to_jax(mesh_runs):
    """66 rows over 4 shards: both packages drop the last 2 rows (the
    reference of each on 66 rows is its run on the first 64), and the mesh
    run on 66 rows is the replay on 64."""
    walks, cfg = _mesh_corpus(66)
    jcfg = jw2v.SGNSConfig(**CONFIGS["mesh_test"])
    ja = jsg.train_sgns_mesh_reference(jax.random.PRNGKey(3), walks, 200,
                                       jcfg, n_shards=WORLD)
    jb = jsg.train_sgns_mesh_reference(jax.random.PRNGKey(3), walks[:64],
                                       200, jcfg, n_shards=WORLD)
    np.testing.assert_array_equal(ja, jb)
    ta = tsg.train_sgns_mesh_reference(3, walks, 200, cfg, n_shards=WORLD,
                                       device="cpu")
    tb = tsg.train_sgns_mesh_reference(3, walks[:64], 200, cfg,
                                       n_shards=WORLD, device="cpu")
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_allclose(mesh_runs[0]["trim"], tb, **MESH_TOL)
    np.testing.assert_array_equal(mesh_runs[0]["trim"],
                                  mesh_runs[0]["stream"])


def test_mesh_embeddings_separate_cliques(mesh_runs):
    """`tests/test_sgns_mesh.py::test_mesh_embeddings_separate_cliques` on
    4 ranks: within-clique cosine > across + 0.2."""
    emb = mesh_runs[0]["cliques"]
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = e @ e.T
    intra = (sim[:8, :8].sum() - 8) / (8 * 7) / 2 + (
        sim[8:, 8:].sum() - 8) / (8 * 7) / 2
    inter = sim[:8, 8:].mean()
    assert intra > inter + 0.2, (intra, inter)


def test_generator_seed_is_one_draw():
    """A `torch.Generator` stands for the seed it draws first."""
    walks, cfg = _mesh_corpus()
    cfg = dataclasses.replace(cfg, epochs=1, batch_size=128)
    seed = int(torch.randint(0, 2**62, (1,),
                             generator=torch.Generator().manual_seed(9)))
    a = tsg.train_sgns_mesh_reference(torch.Generator().manual_seed(9),
                                      walks, 200, cfg, n_shards=2,
                                      device="cpu")
    b = tsg.train_sgns_mesh_reference(seed, walks, 200, cfg, n_shards=2,
                                      device="cpu")
    np.testing.assert_array_equal(a, b)


def test_ranks_load_no_jax(mesh_runs):
    assert [r["jax_modules"] for r in mesh_runs] == [[]] * WORLD
