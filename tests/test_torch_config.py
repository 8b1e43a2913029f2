"""The port's config reader (mrhash_tpu_torch/apps/runner_common.py::
parse_config) against yaml.safe_load, which the port does not need.

Every file in configurations/ reads to the same nested dict, with the same
types (int, float, str, list); a few lines of the subset's edge cases read
as PyYAML reads them; and lines outside the subset raise.
"""
import glob
import os

import pytest

from mrhash_tpu_torch.apps.runner_common import load_config, parse_config

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configurations", "*.cfg")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_read_as_pyyaml_reads_them(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    got = parse_config(text)
    assert got == want

    def types(d):
        return {k: types(v) if isinstance(v, dict) else
                [type(x) for x in v] if isinstance(v, list) else type(v)
                for k, v in d.items()}

    assert types(got) == types(want)
    assert load_config(path)[1] == want


def test_subset_edge_cases():
    yaml = pytest.importorskip("yaml")
    text = ("# leading comment\n"
            "a:\n"
            "    b : 1   # trailing\n"
            "    c: -2.5e+3\n"
            "    d: \"/ouster/points\"  \n"
            "    e: 'x # not a comment'\n"
            "    f: [1, 2.0, three]\n"
            "g: <path_to_dataset>\n"
            "h: ./configurations/params.json\n"
            "i: true\n"
            "j:\n"
            "k: .5\n"
            "l: []\n")
    assert parse_config(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["- a\n- b\n", "a: 1\njust words\n"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        parse_config(text)
