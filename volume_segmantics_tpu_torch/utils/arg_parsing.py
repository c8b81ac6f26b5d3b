"""Command-line parsers for the two console entry points (port of the JAX
package's `utils/arg_parsing.py`).

The user-visible contract — flag names, metavars, help text, validation
errors and exit codes — tracks the reference CLI exactly (reference
volume_segmantics/utilities/arg_parsing.py:7-120) so scripted pipelines
port unchanged. The implementation is declarative: each argument is a spec
row, and path validation runs as a single argparse Action shared by every
file argument.
"""

import argparse
from pathlib import Path

import volume_segmantics_tpu_torch.utils.config as cfg

_VERSION = "1.0.0"

_DATA_DIR_SPEC = dict(
    metavar="Path to settings and output directory (optional)",
    type=str,
    nargs="?",
    help=(
        'path to a directory containing the "volseg-settings", data will '
        "also be output to this location"
    ),
)


class _ValidatedPath(argparse.Action):
    """argparse Action checking each value's suffix against an allow-list
    and requiring the file to exist. Errors exit with code 2 and the same
    wording the reference CLI produces."""

    def __init__(self, *args, extensions=(), **kwargs):
        super().__init__(*args, **kwargs)
        self._extensions = tuple(extensions)

    def __call__(self, parser, namespace, values, option_string=None):
        paths = values if isinstance(values, list) else [values]
        for value in paths:
            p = Path(value)
            if p.suffix not in self._extensions:
                parser.error(
                    f"Wrong filetype: file {p} doesn't end with "
                    f"{self._extensions}"
                )
            if not p.is_file():
                parser.error(f"The file {p} does not appear to exist.")
        setattr(namespace, self.dest, values)


def _base_parser(usage: str, description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=usage, description=description)
    parser.add_argument(
        "-v",
        "--version",
        action="version",
        version=f"{parser.prog} version {_VERSION}",
    )
    return parser


def _add_file_arg(parser, name, *, extensions, metavar, help, positional=False,
                  multi=False):
    flags = [name] if positional else [f"--{name}"]
    kwargs = dict(
        metavar=metavar,
        type=str,
        action=_ValidatedPath,
        extensions=extensions,
        help=help,
    )
    if multi:
        kwargs.update(nargs="+", required=True)
    parser.add_argument(*flags, **kwargs)


def get_2d_training_parser() -> argparse.ArgumentParser:
    """Parser for `model-train-2d` (reference arg_parsing.py:39-80)."""
    parser = _base_parser(
        usage=(
            "%(prog)s --data <path(s)/to/data/file(s)> --labels "
            "<path(s)/to/segmentation/file(s)> --data_dir "
            "path/to/data_directory"
        ),
        description=(
            "Train a 2d model on the 3d data and corresponding segmentation "
            "provided in the files."
        ),
    )
    _add_file_arg(
        parser,
        cfg.TRAIN_DATA_ARG,
        extensions=cfg.TRAIN_DATA_EXT,
        metavar="Path(s) to training image data volume(s)",
        help=(
            "the path(s) to file(s) containing the imaging data volume for "
            "training"
        ),
        multi=True,
    )
    _add_file_arg(
        parser,
        cfg.LABEL_DATA_ARG,
        extensions=cfg.LABEL_DATA_EXT,
        metavar="Path(s) to label volume(s)",
        help="the path(s) to file(s) containing a segmented volume for training",
        multi=True,
    )
    parser.add_argument(
        f"--{cfg.DATA_DIR_ARG}", default=Path.cwd(), **_DATA_DIR_SPEC
    )
    return parser


def get_2d_prediction_parser() -> argparse.ArgumentParser:
    """Parser for `model-predict-2d` (reference arg_parsing.py:83-120)."""
    parser = _base_parser(
        usage=(
            "%(prog)s path/to/model/file path/to/data/file "
            "[path/to/data_directory]"
        ),
        description=(
            "Predict segmentation of a 3d data volume using the 2d model "
            "provided."
        ),
    )
    _add_file_arg(
        parser,
        cfg.MODEL_PTH_ARG,
        extensions=cfg.MODEL_DATA_EXT,
        metavar="Model file path",
        help="the path to a file containing the model weights.",
        positional=True,
    )
    _add_file_arg(
        parser,
        cfg.PREDICT_DATA_ARG,
        extensions=cfg.PREDICT_DATA_EXT,
        metavar="Path to prediction data volume",
        help="the path to an HDF5 file containing the imaging data to segment",
        positional=True,
    )
    parser.add_argument(
        f"--{cfg.DATA_DIR_ARG}", default=Path.cwd(), **_DATA_DIR_SPEC
    )
    return parser
