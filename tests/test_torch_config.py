"""The port's configuration tree (`linkpred_tpu_torch.config`) against the JAX
package's `linkpred_tpu.config`: the same fields and defaults at every dotted
path except `twowl.chunk_epochs` (the TPU's 60 s chunking, not ported), and
the same trees or the same errors from the same override lists. Then the
mirrors of `tests/test_config.py`'s config and throughput cases."""

import dataclasses

import pytest
import torch

from linkpred_tpu import config as jconfig
from linkpred_tpu_torch import config as tconfig
from linkpred_tpu_torch.config import Config, apply_overrides
from linkpred_tpu_torch.utils.profiling import ThroughputCounter

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

UNPORTED = {"twowl.chunk_epochs"}


def _paths(node, prefix=""):
    """{dotted path: value} of every leaf field of a dataclass tree."""
    out = {}
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        path = prefix + f.name
        if dataclasses.is_dataclass(value):
            out.update(_paths(value, path + "."))
        else:
            out[path] = value
    return out


class TestConfig:
    def test_defaults(self):
        cfg = Config()
        assert cfg.twowl.epochs == 1000
        assert cfg.seal.hop == "auto"

    def test_override_nested(self):
        cfg = apply_overrides(Config(), ["twowl.epochs=500",
                                         "seal.learning_rate=0.001"])
        assert cfg.twowl.epochs == 500
        assert cfg.seal.learning_rate == pytest.approx(0.001)
        assert cfg.logistic.seed == 35  # untouched

    def test_override_bool_and_str(self):
        cfg = apply_overrides(Config(), ["logistic.negatives=two_hop"])
        assert cfg.logistic.negatives == "two_hop"

    def test_unknown_key_raises(self):
        with pytest.raises(ValueError, match="unknown config field"):
            apply_overrides(Config(), ["nope.x=1"])

    def test_top_level(self):
        cfg = apply_overrides(Config(), ["seed=42", "twowl_trials=3"])
        assert cfg.seed == 42 and cfg.twowl_trials == 3


class TestThroughput:
    def test_counter(self):
        tc = ThroughputCounter("items")
        with tc.span(100):
            pass
        assert tc.items == 100
        assert tc.rate > 0
        assert "items/s" in tc.report()


def test_trees_have_the_same_paths_and_defaults():
    jax_tree, port_tree = _paths(jconfig.Config()), _paths(tconfig.Config())
    assert set(port_tree) == set(jax_tree) - UNPORTED
    for path, value in port_tree.items():
        assert value == jax_tree[path], path
        assert type(value) is type(jax_tree[path]), path


def test_chunk_epochs_is_an_unknown_field():
    with pytest.raises(ValueError, match="unknown config field 'chunk_epochs'"):
        apply_overrides(Config(), ["twowl.chunk_epochs=16"])


OVERRIDES = {
    "nested ints and float": ["twowl.epochs=500", "seal.learning_rate=1e-3",
                              "twowl.early_stop=7"],
    "bool false": ["seal.negative_injection=false"],
    "bool yes": ["seal.negative_injection=no", "seal.negative_injection=yes"],
    "bool 0": ["seal.negative_injection=0"],
    "three levels": ["logistic.embed.subsample=0.5", "logistic.embed.dim=8"],
    "strings": ["logistic.negatives=two_hop", "paths.records_dir=/tmp/r",
                "twowl.dataset=other"],
    "hop union int": ["seal.hop=2"],
    "hop union auto": ["seal.hop=auto"],
    "data_dir from None": ["paths.data_dir=raw_data/x"],
    "top level": ["seed=42", "twowl_trials=3"],
    "later wins": ["twowl.epochs=5", "twowl.epochs=6"],
    "missing equals": ["twowl.epochs"],
    "unknown key": ["nope.x=1"],
    "unknown nested key": ["twowl.nope=1"],
    "into a leaf": ["seed.x=1"],
    "bad int": ["twowl.epochs=many"],
    "empty": [],
}


@pytest.mark.parametrize("overrides", OVERRIDES.values(), ids=OVERRIDES)
def test_apply_overrides_matches_jax(overrides):
    """Equal trees, or equal `ValueError` messages (the list of valid
    fields of `twowl` names `chunk_epochs` in the JAX package's)."""
    try:
        want = _paths(jconfig.apply_overrides(jconfig.Config(), overrides))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.apply_overrides(tconfig.Config(), overrides)
        assert str(got.value) == str(e).replace("'chunk_epochs', ", "")
        return
    got = _paths(tconfig.apply_overrides(tconfig.Config(), overrides))
    assert got == {k: v for k, v in want.items() if k not in UNPORTED}
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items() if k not in UNPORTED}
