"""The config parser (surfjax.config.parse_yaml) reads the YAML subset
the configs are written in without a YAML library; PyYAML, where
installed, is the reference it must agree with."""

import glob
import os

import pytest

from surfjax.config import parse_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))

SNIPPETS = {
    "seq_at_key_indent": "a:\n- 1\n- {x: 2}\nb: 3\n",
    "nested_items": ("c:\n  - k: 1\n    j: [1, [2, 3], {z: x}]\n"
                     "  - k: 2\n    m:\n      n: true\n"),
    "scalars": ("i: -3\nf: 1.5\ng: 2.0e-3\nt: true\nn: null\ne: ~\n"
                "s: hello world\nq: 'a # b'\nr: \"x, y\"\n"),
    "comments_and_flow_over_lines": (
        "# head\nanim: {type: orbit, frames: 8,   # tail\n"
        "       center: [0.0, 0.0, 3.0]}\n\nk: [1,\n    2]\n"),
}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_parse_like_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as fh:
        text = fh.read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippets_parse_like_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    assert parse_yaml(SNIPPETS[name]) == yaml.safe_load(SNIPPETS[name])


@pytest.mark.parametrize("text", ["a: {b: 1\n", "a: 1\n  b: 2\n",
                                  "just a line\n"])
def test_malformed_config_raises(text):
    with pytest.raises(ValueError):
        parse_yaml(text)
