"""The PyTorch port's CLI parsers against the JAX package's: the same
flags, dests, defaults, metavars and help; the same stderr and exit code 2
for a wrong suffix and for a missing file."""

import ast
import re

import pytest

from volume_segmantics_tpu.utils import arg_parsing as jax_arg_parsing
from volume_segmantics_tpu_torch.utils import arg_parsing

PARSERS = ["get_2d_training_parser", "get_2d_prediction_parser"]


def actions(parser):
    return [(a.dest, a.option_strings, a.default, a.metavar, a.help, a.nargs,
             a.required) for a in parser._actions]


@pytest.mark.parametrize("name", PARSERS)
def test_same_flags_dests_defaults_and_help(name):
    ours, ref = getattr(arg_parsing, name)(), getattr(jax_arg_parsing, name)()
    assert actions(ours) == actions(ref)
    assert ours.format_help() == ref.format_help()
    assert ours.usage == ref.usage


def run(parser_name, module, argv, capsys):
    """(exit code, stderr, stdout). Both packages print the allowed
    suffixes as `tuple(set)`, whose order follows the string hash seed of
    the process that compiled the module, so the suffixes are sorted."""
    with pytest.raises(SystemExit) as exc:
        getattr(module, parser_name)().parse_args(argv)
    out = capsys.readouterr()
    err = re.sub(r"doesn't end with (\(.*?\))",
                 lambda m: f"doesn't end with {sorted(ast.literal_eval(m[1]))}",
                 out.err)
    return exc.value.code, err, out.out


def test_valid_arguments_parse_alike(tmp_path):
    for name in ("d.h5", "l.nxs", "m.pytorch"):
        (tmp_path / name).write_bytes(b"")
    cases = {
        "get_2d_training_parser": ["--data", str(tmp_path / "d.h5"), "--labels",
                                   str(tmp_path / "l.nxs"), "--data_dir", "x"],
        "get_2d_prediction_parser": [str(tmp_path / "m.pytorch"),
                                     str(tmp_path / "d.h5")],
    }
    for name, argv in cases.items():
        ours = getattr(arg_parsing, name)().parse_args(argv)
        ref = getattr(jax_arg_parsing, name)().parse_args(argv)
        assert vars(ours) == vars(ref)


@pytest.mark.parametrize("case", ["wrong_suffix", "missing_file", "no_args",
                                  "version"])
@pytest.mark.parametrize("name", PARSERS)
def test_errors_exit_2_with_the_same_stderr(name, case, tmp_path, capsys):
    (tmp_path / "m.txt").write_bytes(b"")
    (tmp_path / "m.pytorch").write_bytes(b"")
    (tmp_path / "l.h5").write_bytes(b"")
    missing = str(tmp_path / "missing.h5")
    argv = {
        ("get_2d_training_parser", "wrong_suffix"):
            ["--data", str(tmp_path / "m.txt"), "--labels", str(tmp_path / "l.h5")],
        ("get_2d_training_parser", "missing_file"):
            ["--data", missing, "--labels", str(tmp_path / "l.h5")],
        ("get_2d_prediction_parser", "wrong_suffix"):
            [str(tmp_path / "m.txt"), str(tmp_path / "l.h5")],
        ("get_2d_prediction_parser", "missing_file"):
            [str(tmp_path / "m.pytorch"), missing],
    }.get((name, case), [] if case == "no_args" else ["--version"])
    ours = run(name, arg_parsing, argv, capsys)
    ref = run(name, jax_arg_parsing, argv, capsys)
    assert ours == ref
    assert ours[0] == (0 if case == "version" else 2)
    expected = {"wrong_suffix": "Wrong filetype",
                "missing_file": "does not appear to exist",
                "no_args": "error:", "version": "version 1.0.0"}[case]
    assert expected in ours[1] + ours[2]
