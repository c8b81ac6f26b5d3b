#!/usr/bin/env python
"""Library-API walkthrough of the PyTorch port: the calls of
`examples/library_api.py` (the surface SuRVoS2 drives, SURVEY.md §3.3-3.4)
through `volume_segmantics_tpu_torch`, in-memory numpy volumes end to end,
on the GPU unless `--device cpu` is given.

    python examples/library_api_torch.py [--device cpu] [--out-dir DIR]
"""

import argparse
from pathlib import Path

import numpy as np

from volume_segmantics_tpu_torch.data import TrainingDataSlicer, get_settings_data
from volume_segmantics_tpu_torch.model import (
    VolSeg2dTrainer,
    VolSeg2DPredictionManager,
)
from volume_segmantics_tpu_torch.utils import Quality


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and predict on (default cuda)")
    parser.add_argument("--out-dir", type=Path, default=Path("."),
                        help="where the slices and the model are written")
    parser.add_argument("--shape", type=int, nargs=3, default=(64, 128, 128),
                        metavar=("Z", "Y", "X"), help="synthetic volume shape")
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--compute-dtype", default=None,
                        help="float32 or bfloat16 (default: the package's)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    # Settings from dicts (no YAML files needed for library use).
    # kind="training" validates the dict against the typed schema up front
    # (missing/mistyped keys raise SettingsError with the full list).
    extra = {} if args.compute_dtype is None else {"compute_dtype": args.compute_dtype}
    train_settings = get_settings_data(
        {
            "data_im_dirname": "data", "seg_im_out_dirname": "seg",
            "model_output_fn": "trained_2d_model", "clip_data": False,
            "st_dev_factor": 2.575, "data_hdf5_path": "/data",
            "seg_hdf5_path": "/data", "training_axes": "All",
            "image_size": args.image_size, "downsample": False,
            "training_set_proportion": 0.8, "cuda_device": 0,
            "num_cyc_frozen": 2, "num_cyc_unfrozen": 1, "patience": 3,
            "loss_criterion": "DiceLoss", "alpha": 0.75, "beta": 0.25,
            "eval_metric": "MeanIoU", "pct_lr_inc": 0.3,
            "starting_lr": "1e-6", "end_lr": 50, "lr_find_epochs": 1,
            "lr_reduce_factor": 500, "plot_lr_graph": False,
            "model": {"type": "U_Net", "encoder_name": "resnet34",
                      "encoder_weights": None},
            **extra,
        },
        kind="training",
    )

    # Synthetic volume + labels (replace with your arrays)
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, tuple(args.shape)).astype(np.uint8)
    labels = (vol > 128).astype(np.uint8)

    # 1. Slice (in-memory arrays in, PNG slices out)
    slicer = TrainingDataSlicer(vol, labels, train_settings)
    slicer.output_data_slices(out / "ex_data", "data0")
    slicer.output_label_slices(out / "ex_seg", "seg0")

    # 2. Train
    trainer = VolSeg2dTrainer(out / "ex_data", out / "ex_seg",
                              slicer.num_seg_classes, train_settings,
                              device=args.device)
    model_out = out / "example_model.pytorch"
    trainer.train_model(model_out, 2, 3, create=True, frozen=True)
    trainer.output_loss_fig(model_out)

    # 3. Predict (returns ndarray; output_path=None skips disk)
    pred_settings = get_settings_data(
        {
            "quality": "medium", "output_probs": False, "clip_data": False,
            "st_dev_factor": 2.575, "data_hdf5_path": "/data",
            "cuda_device": 0, "downsample": False, "one_hot": False,
            "prediction_axis": "Z", **extra,
        },
        kind="prediction",
    )
    manager = VolSeg2DPredictionManager(str(model_out), vol, pred_settings,
                                        device=args.device)
    prediction = manager.predict_volume_to_path(None, Quality.MEDIUM)
    print("prediction:", prediction.shape, prediction.dtype, np.unique(prediction))
    slicer.clean_up_slices()
    return prediction


if __name__ == "__main__":
    main()
