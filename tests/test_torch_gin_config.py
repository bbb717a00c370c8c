"""The port's gin binder and argument dataclasses against the JAX package's:
every file under configs/ parses to the same bindings and macros, and every
registered argument class `make`s the same field values; an unknown
parameter and an undefined macro fail the same way in both."""
import dataclasses
from pathlib import Path

import pytest

from recsys_examples_torch.training import gin_args as t_args  # noqa: F401 (registers)
from recsys_examples_torch.utils import gin_config as tg
from recsys_examples_tpu.training import gin_args as j_args  # noqa: F401 (registers)
from recsys_examples_tpu.utils import gin_config as jg

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.gin"))
ARG_CLASSES = ("TrainerArgs", "DatasetArgs", "NetworkArgs", "OptimizerArgs",
               "DynamicEmbeddingArgs", "TensorModelParallelArgs", "RankingArgs",
               "RetrievalArgs")


def _parse(binder, path):
    binder.clear_config()
    binder.parse_config_file(str(path))
    return ({scope: binder.get_bindings(scope) for scope in binder._BINDINGS},
            dict(binder._MACROS))


def test_every_config_is_found():
    assert len(CONFIGS) >= 8


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_binds_and_makes_the_same(path):
    assert _parse(tg, path) == _parse(jg, path)
    for name in ARG_CLASSES:
        if name not in jg._BINDINGS:
            continue
        _parse(jg, path)
        want = dataclasses.asdict(jg.make(name))
        _parse(tg, path)
        got = dataclasses.asdict(tg.make(name))
        assert got == want, name


def test_include_macros_and_brackets(tmp_path):
    """`include` by relative path, %MACRO definitions and references, and a
    list spread over several lines; an override through `make`."""
    (tmp_path / "base.gin").write_text(
        "%HIDDEN = 64\nNetworkArgs.hidden_size = %HIDDEN\n"
        "RankingArgs.prediction_head_arch = [\n    32,  # first\n    1,\n]\n")
    (tmp_path / "top.gin").write_text(
        'include "base.gin"\nNetworkArgs.num_layers = 3\n'
        "RankingArgs.eval_metrics = ('AUC',)\n")
    got = []
    for binder in (tg, jg):
        binder.clear_config()
        binder.parse_config_file(str(tmp_path / "top.gin"))
        net = binder.make("NetworkArgs", num_attention_heads=8)
        rank = binder.make("RankingArgs")
        got.append((dataclasses.asdict(net), dataclasses.asdict(rank)))
    assert got[0] == got[1]
    net, rank = got[0]
    assert (net["hidden_size"], net["num_layers"], net["num_attention_heads"]) == (64, 3, 8)
    assert rank["prediction_head_arch"] == (32, 1)


@pytest.mark.parametrize("binder", [tg, jg], ids=["torch", "jax"])
def test_unknown_param_and_undefined_macro_fail_alike(binder, tmp_path):
    binder.clear_config()
    binder.parse_config_lines(["TrainerArgs.no_such_field = 1"])
    with pytest.raises(ValueError, match=r"TrainerArgs: unknown gin params \['no_such_field'\]"):
        binder.make("TrainerArgs")
    binder.clear_config()
    with pytest.raises(KeyError, match="undefined gin macro %NOPE"):
        binder.parse_config_lines(["TrainerArgs.seed = %NOPE"])
    with pytest.raises(ValueError, match="bad gin line"):
        binder.parse_config_lines(["TrainerArgs.seed"])
    binder.clear_config()


def test_registries_are_separate():
    """Each package keeps its own registry: the port's classes are its own."""
    assert tg._REGISTRY["NetworkArgs"] is t_args.NetworkArgs
    assert jg._REGISTRY["NetworkArgs"] is j_args.NetworkArgs
    assert [f.name for f in dataclasses.fields(t_args.NetworkArgs)] == \
        [f.name for f in dataclasses.fields(j_args.NetworkArgs)]
