"""The PyTorch port's settings-file reader (`utils/yaml_settings.py`)
against PyYAML: the shipped files and a table of scalar and comment forms
give what `yaml.safe_load` gives; every form outside the subset raises and
names its line."""

import math
from pathlib import Path

import pytest
import yaml

from volume_segmantics_tpu_torch.utils import yaml_settings

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = sorted((ROOT / "volseg-settings").glob("*.yaml"))


def same(a, b):
    """Equal values of equal types (bool is not int; nan equals nan)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.name)
def test_shipped_settings_files_read_as_pyyaml_reads_them(path):
    ours = yaml_settings.load(path)
    assert same(ours, yaml.safe_load(path.read_text()))
    assert ours  # not an empty document


SCALARS = [
    "1e-6", "1.0e-6", "1.0e6", "1.5e+3", "-1.5E-3", "2.5", ".5", "1.", "0.",
    "-.inf", "+.inf", ".NaN", "0", "-3", "+7", "1_000", "12",
    "yes", "Yes", "YES", "yEs", "no", "On", "ON", "off", "true", "False",
    "TRUE", "y", "n", "~", "", "null", "Null", "NULL", "nUll",
    "'a #b'", '"a #b"', "'it''s'", '"t\\tq\\"\\u00e9\\x41"', "''", '""',
    "abc # trailing comment", "a#b", "http://host:8080/x", "/data",
    "U_Net", '"DiceLoss"  # quoted, then a comment', "two words",
    "[1, 'a', yes, 1.5, ~]", "[]", "[a, b,]", "['x, y', \"z\"]",
    "-1", "3.", "1__0",
]


@pytest.mark.parametrize("value", SCALARS)
def test_scalar_and_comment_forms_match_pyyaml(value):
    doc = (f"# a comment\nkey: {value}\n\nnested:   # trailing\n"
           f"  # indented comment\n  inner: {value}\n  other: 1\nlast: x\n")
    ours = yaml_settings.loads(doc)
    assert same(ours, yaml.safe_load(doc)), (ours, yaml.safe_load(doc))


def test_empty_document_and_keys_are_resolved():
    assert yaml_settings.loads("# only comments\n\n") is None
    doc = "2: a\nyes: b\n'q': c\n\"d d\": e\nf:\n"
    assert same(yaml_settings.loads(doc), yaml.safe_load(doc))


UNSUPPORTED = [
    ("k: &a 1", 1), ("k: *a", 1), ("k: !!str 1", 1), ("k: |\n  x", 1),
    ("k: >\n  x", 1), ("k: {a: 1}", 1), ("k: 010", 1), ("k: 0x1f", 1),
    ("k: 0b11", 1), ("k: 1:30", 1), ("k: 190:20:30.15", 1),
    ("k: 2001-12-14", 1), ("a: 1\n\tk: 1", 2), ("k:\t1", 1),
    ("---\nk: 1", 1), ("k: 1\n...\n", 2), ("%YAML 1.1\nk: 1", 1),
    ("a: 1\nk: 1\nk: 2", 3), ("k:\n- 1", 2), ("- 1", 1), ("k: a\n  b", 2),
    ("k: 'a\n  b'", 1), ("k: [a,\n b]", 1), ("k: a: b", 1), ("<<: 1", 1),
    ("k: [a, [b]]", 1), ("? k\n: 1", 1), ("k: [a: b]", 1), ("k: 'a' b", 1),
    ("k: =", 1), ("k: ,a", 1), ("k: [a, , b]", 1), ("  k: 1", 1),
    ("a:\n    b: 1\n  c: 2", 3), ("k: \"\\q\"", 1), ("just a scalar", 1),
]


@pytest.mark.parametrize("doc,line", UNSUPPORTED)
def test_unsupported_forms_raise_naming_the_line(doc, line):
    with pytest.raises(yaml_settings.YamlSubsetError,
                       match=rf"^f\.yaml, line {line}: .* is not supported"):
        yaml_settings.loads(doc, source="f.yaml")
