"""The port's config loading and training command line against the JAX
package's: the YAML reader (no PyYAML) against ``yaml.safe_load`` on every
shipped config, ``normalize_model_config``, ``merge_cli``,
``RunOverrides``, and ``gligen_tpu_torch.main``'s flags against the root
``main.py``'s.  Every comparison is exact (equal Python objects)."""

import dataclasses
import glob
import os
import sys

import pytest
import yaml

from gligen_tpu import config as jconfig

from gligen_tpu_torch import config
from gligen_tpu_torch import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _root_main():
    sys.path.insert(0, REPO)
    try:
        import main as root_main
    finally:
        sys.path.pop(0)
    return root_main


def test_all_ten_configs_are_found():
    assert len(CONFIGS) == 10


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    got = config.load_yaml_config(path)
    assert got == yaml.safe_load(text)
    assert config.normalize_model_config(got) == jconfig.normalize_model_config(
        jconfig.load_yaml_config(path))


def test_anchor_and_alias_are_one_object():
    got = config.load_yaml_config(os.path.join(REPO, "configs",
                                               "GoldG+SBU+CC3M+O365_box_text_image.yaml"))
    names = got["train_dataset_names"]
    assert names["VGGrounding"] is names["Obj365Detection"]  # as PyYAML's alias
    assert names["FlickrGrounding"]["random_drop_embedding"] == "both"


@pytest.mark.parametrize("text", [
    "a: [1, 'x', \"y\", {b: 2}, []]\nc: {}",
    "a:\n  - 1\n  - 2.5\nb:\n- 3\n- x y\n- null\n- ~",
    "a: &x {p: 1, q: [true, false, yes, off]}\nb: *x\nc:\n  d: *x",
    "k: v # comment\n# full line\nz: 'a # b'\nw: \"c # d\"\n",
    "a:\nb: -1\nc: +2\nd: 0.00085\ne: .5\nf: -3.25e+2\ng: 'it''s'",
    "- 1\n- [2, 3]\n-\n  k: 3\n  l: [a, b]",
    "nested:\n  deeper:\n    deepest: 1\n  back: 2\ntop: 3",
])
def test_yaml_subset_equals_safe_load(text):
    assert config.parse_yaml(text) == yaml.safe_load(text)


def test_exponent_without_a_point_is_a_float():
    # PyYAML's YAML 1.1 resolver keeps "1e-4" a string; a learning rate
    # written so is meant as a number
    assert config.parse_yaml("lr: 1e-4") == {"lr": 1e-4}
    assert yaml.safe_load("lr: 1e-4") == {"lr": "1e-4"}


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: |\n  block", 2),
    ("a: {b: 1,\n  c: 2}", 1),
    ("a: b: c", 1),
    ("a: 012", 1),
    ("a: *nowhere", 1),
    ("a: 1\n  b: 2", 2),
    ("a: !!str 1", 1),
    ("a:\n  - 1\n  b: 2", 3),
])
def test_unsupported_yaml_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        config.parse_yaml(text)


def test_merge_cli_and_run_overrides_equal_the_jax_packages():
    base = {"a": 1, "b": {"c": 2}}
    over = {"a": None, "b": 3, "d": 4}
    assert config.merge_cli(base, over) == jconfig.merge_cli(base, over)
    assert [(f.name, f.default) for f in dataclasses.fields(config.RunOverrides)] == \
        [(f.name, f.default) for f in dataclasses.fields(jconfig.RunOverrides)]


def test_parse_args_destinations_and_defaults_equal_the_root_mains():
    want = vars(_root_main().parse_args([]))
    got = vars(tmain.parse_args([]))
    # the port adds --device (the card by default; the tests pass "cpu")
    assert got.pop("device") == "cuda"
    assert got == want
    argv = ["--batch_size", "4", "--enable_ema", "--disable_inference_in_training", "True",
            "--base_learning_rate", "1e-4", "--workers", "3", "--grounding_modality", "hed"]
    got = vars(tmain.parse_args(argv))
    got.pop("device")
    assert got == vars(_root_main().parse_args(argv))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_modality_from_config_equals_the_root_mains(path):
    cfg = config.load_yaml_config(path)
    assert tmain.modality_from_config(cfg) == _root_main().modality_from_config(cfg)


def test_multihost_raises_naming_m12(monkeypatch):
    """--multihost is ported (``tests/test_torch_parallel.py`` trains with
    it); without the launcher's environment it raises naming the missing
    variables rather than training alone."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK"):
        tmain.main(["--multihost", "--device", "cpu"])
