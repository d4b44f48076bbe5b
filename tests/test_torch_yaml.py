"""The port's stdlib YAML reader (dxmi_tpu_torch.config.parse_yaml) gives
PyYAML's safe_load results on every config the repo ships, including YAML
1.1's quirks, and raises on syntax outside its subset."""
import glob
import math
import os

import pytest
import yaml

from dxmi_tpu_torch.config import YamlSubsetError, load_yaml, parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                         recursive=True)
               + glob.glob(os.path.join(REPO, "tests", "fixtures", "*",
                                        "config.yaml")))


def test_every_config_is_found():
    assert len(FILES) == 14


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, REPO) for p in FILES])
def test_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert load_yaml(path) == want


def test_yaml11_scalars():
    """A float needs a dot in YAML 1.1: ``1e-8`` (configs/imagenet64/
    T10.yaml's lr) stays a string, ``1.0e-06`` is a float; the YAML 1.1
    booleans and nulls; quoted strings stay strings."""
    text = ("lr: 1e-8\nbeta_lr: 1.0e-06\nwd: 0.\nd: .5\nn: ~\nN: Null\n"
            "on_: yes\noff_: Off\nq: '1e-8'\nqq: \"32,16,8\"\nneg: -1\n"
            "big: 1_000\ninf: -.inf\nlst: [3, 64, 64]\nempty: []\n"
            "it: 'it''s'\nhash: \"a # b\"  # a comment\n")
    got = parse_yaml(text)
    assert got == yaml.safe_load(text)
    assert got["lr"] == "1e-8" and got["beta_lr"] == 1e-6
    assert got["inf"] == -math.inf and got["hash"] == "a # b"


def test_block_sequence_at_the_key_indent():
    text = "sampler:\n  sample_shape:\n  - 3\n  - 32\n  n: 4\ntop: null\n"
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *alias", "a: !!int 1", "a: |\n  block", "a: >\n  x",
    "a: {b: 1}", "- a: 1", "a:\n  - b: 1", "a: 0x10", "a: 010", "a: 1:30",
    "---\na: 1", "a: 1\n---\nb: 2", "a:\n  b: 1\n c: 2", "a: b: c",
    "a: [1, [2]]", "a:\n\tb: 1", "a: \"esc\\n\"", "key without colon"])
def test_unsupported_syntax_raises(text):
    with pytest.raises(YamlSubsetError):
        parse_yaml(text)
