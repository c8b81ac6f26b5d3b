#!/usr/bin/env python
"""`model-predict-2d` console entry point (port of the JAX package's
`scripts/predict_2d_model.py`).

Positional model and data paths, settings discovered under
<data_dir>/volseg-settings/, output written to the data dir as
<date>_<stem>_2d_model_vol_pred.h5 (gzip), with <...>_probs.h5 beside it
when `output_probs` is set.

    python -m volume_segmantics_tpu_torch.scripts.predict_2d_model \\
        MODEL.pytorch vol.h5 --data_dir DIR

It predicts on the GPU; `main(argv, device="cpu")` runs the plain PyTorch
path on the CPU.
"""

import logging
from datetime import date
from pathlib import Path

import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data import get_settings_data
from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
from volume_segmantics_tpu_torch.utils import get_2d_prediction_parser


def create_output_path(root_path, data_vol_path):
    """Dated output filename derived from the input volume's stem."""
    return Path(
        root_path, f"{date.today()}_{data_vol_path.stem}_2d_model_vol_pred.h5"
    )


def main(argv=None, device=None) -> None:
    """Run `model-predict-2d` with `argv` (default: the command line) on
    `device` (default: the GPU)."""
    logging.basicConfig(
        level=logging.INFO, format=cfg.LOGGING_FMT, datefmt=cfg.LOGGING_DATE_FMT
    )
    args = get_2d_prediction_parser().parse_args(argv)
    root = Path(getattr(args, cfg.DATA_DIR_ARG)).resolve()
    data_path = Path(getattr(args, cfg.PREDICT_DATA_ARG))
    settings = get_settings_data(
        root / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN, kind="prediction"
    )
    manager = VolSeg2DPredictionManager(
        getattr(args, cfg.MODEL_PTH_ARG), data_path, settings, device=device
    )
    manager.predict_volume_to_path(create_output_path(root, data_path))


if __name__ == "__main__":
    main()
