#!/usr/bin/env python
"""`model-train-2d` console entry point (port of the JAX package's
`scripts/train_2d_model.py`).

Same flags, settings discovery under <data_dir>/volseg-settings/, dated
model filename, frozen -> unfrozen two-phase schedule, train-stats CSV,
loss plot and validation montage as the JAX CLI, from HDF5 or TIFF
volumes. The slices stay in memory: where the JAX CLI writes PNG slices
and reads them back (``slice_to_disk`` absent or true), the trainer gets
them in the order that round trip gives; PNG is lossless, so the pixels
are the same.

    python -m volume_segmantics_tpu_torch.scripts.train_2d_model \\
        --data d.h5 --labels l.h5 --data_dir DIR

It trains on the GPU; `main(argv, device="cpu")` runs the plain PyTorch
path on the CPU. On a host with k > 1 visible GPUs it trains data parallel
over all of them, as the JAX CLI trains over every device: it spawns one
rank a GPU (NCCL) and waits for them. A process that is already one rank
of a group, or joins one under `VOLSEG_TPU_DISTRIBUTED=1` (torchrun's or
the JAX runtime's variables; `parallel/mesh.py`), trains as that rank.
Rank 0 alone writes the checkpoint, the CSV and the figures.
"""

import logging
import sys
from datetime import date
from pathlib import Path

import torch
import torch.distributed as dist

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data import TrainingDataSlicer, get_settings_data
from volume_segmantics_tpu_torch.data.datasets import natsort
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
from volume_segmantics_tpu_torch.models.pretrained import (
    pretrained_weights_available,
)
from volume_segmantics_tpu_torch.parallel.mesh import (
    maybe_initialize_distributed,
    spawn_ranks,
)
from volume_segmantics_tpu_torch.utils import get_2d_training_parser
from volume_segmantics_tpu_torch.utils.device import resolve_device


def _parse_cli(argv=None):
    args = get_2d_training_parser().parse_args(argv)
    data_vols = getattr(args, cfg.TRAIN_DATA_ARG)
    label_vols = getattr(args, cfg.LABEL_DATA_ARG)
    if len(data_vols) != len(label_vols):
        logging.error(
            "Number of data volumes and number of label volumes must be equal!"
        )
        sys.exit(1)
    root = Path(getattr(args, cfg.DATA_DIR_ARG)).resolve()
    return data_vols, label_vols, root


def _slice_all_volumes(data_vols, label_vols, settings):
    """Slice every (data, label) pair in memory; returns ((data slices,
    label slices), the widest label count seen, its codes, the last
    slicer).

    With ``slice_to_disk`` absent or true the JAX CLI writes each slice to
    `data{i}_{axis}_stack_{index}.png` (labels `seg{i}_...`) and reads them
    back in natural-sort order of those paths: volume by volume, then x, y,
    z, then index. The slices are put in that order, so the trainer's split
    falls as in the JAX CLI. With ``slice_to_disk: False`` they keep the
    slicer's z, y, x order."""
    to_disk = bool(getattr(settings, "slice_to_disk", True))
    axis_enum = utils.get_training_axis(settings)
    data, labels, names = [], [], []
    max_labels, codes, slicer = 0, None, None
    for i, (data_path, label_path) in enumerate(zip(data_vols, label_vols)):
        slicer = TrainingDataSlicer(data_path, label_path, settings)
        d, l = slicer.get_slice_arrays()
        data.extend(d)
        labels.extend(l)
        names.extend(
            f"data{i}_{axis}_stack_{index}.png"
            for axis, index in utils.get_axis_index_pairs(
                slicer.data_vol.shape, axis_enum)
        )
        if slicer.num_seg_classes > max_labels:
            max_labels, codes = slicer.num_seg_classes, slicer.codes
    if to_disk:
        order = sorted(range(len(names)), key=lambda k: natsort(names[k]))
        data = [data[k] for k in order]
        labels = [labels[k] for k in order]
    return (data, labels), max_labels, codes, slicer


def _model_output_path(settings, root: Path) -> Path:
    mtype = settings.model["type"]
    mtype = mtype if isinstance(mtype, str) else mtype.name
    return root / f"{date.today()}_{mtype}_{settings.model_output_fn}.pytorch"


def resolve_training_phases(settings) -> tuple:
    """(frozen_epochs, unfrozen_epochs) for the two-phase schedule.

    The frozen phase protects PRETRAINED encoder features while the decoder
    adapts. With the opt-in setting ``skip_frozen_without_pretrained:
    True``, when the settings do not ask for ImageNet weights or the
    $VOLSEG_TPU_WEIGHTS_DIR cache has none for the encoder, the frozen
    epochs fold into the unfrozen phase rather than train a frozen random
    encoder. Default is off: both phases run as the settings give them."""
    frozen_epochs = int(settings.num_cyc_frozen)
    unfrozen_epochs = int(settings.num_cyc_unfrozen)
    if frozen_epochs > 0 and bool(
        getattr(settings, "skip_frozen_without_pretrained", False)
    ):
        encoder = settings.model.get("encoder_name", "resnet34")
        wants_pretrained = settings.model.get("encoder_weights") == "imagenet"
        if not (wants_pretrained and pretrained_weights_available(encoder)):
            logging.warning(
                f"No pretrained weights available for encoder '{encoder}' "
                f"(skip_frozen_without_pretrained is on): folding "
                f"{frozen_epochs} frozen epochs into the unfrozen phase "
                f"({frozen_epochs + unfrozen_epochs} unfrozen epochs total)."
            )
            return 0, frozen_epochs + unfrozen_epochs
    return frozen_epochs, unfrozen_epochs


def _run_training_phases(trainer, model_out: Path, settings) -> None:
    """Frozen-encoder phase (when configured) followed by fine-tuning, with
    the reference's create/warm-start semantics."""
    frozen_epochs, unfrozen_epochs = resolve_training_phases(settings)
    patience = settings.patience
    if frozen_epochs > 0:
        trainer.train_model(model_out, frozen_epochs, patience,
                            create=True, frozen=True)
    if unfrozen_epochs > 0:
        trainer.train_model(model_out, unfrozen_epochs, patience,
                            create=frozen_epochs == 0, frozen=False)


def _spawn_count(device) -> int:
    """GPUs to spawn one rank each on: all visible ones, when `device` is
    the GPU without an index and the process is no rank of a group; else
    0 (train in this process)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return 0
    if maybe_initialize_distributed(dev) or dist.is_initialized():
        return 0
    count = torch.cuda.device_count()
    return count if count > 1 else 0


def _rank_main(rank, argv) -> None:
    logging.basicConfig(
        level=logging.INFO, format=cfg.LOGGING_FMT, datefmt=cfg.LOGGING_DATE_FMT
    )
    _train(argv, "cuda")


def main(argv=None, device=None) -> None:
    """Run `model-train-2d` with `argv` (default: the command line) on
    `device` (default: the GPU; every visible GPU, a rank each)."""
    logging.basicConfig(
        level=logging.INFO, format=cfg.LOGGING_FMT, datefmt=cfg.LOGGING_DATE_FMT
    )
    _parse_cli(argv)  # argument errors end the run before any rank starts
    ranks = _spawn_count(device)
    if ranks:
        logging.info(f"Training data parallel over {ranks} GPUs.")
        spawn_ranks(_rank_main, ranks,
                    args=(sys.argv[1:] if argv is None else list(argv),),
                    backend="nccl")
        return
    _train(argv, device)


def _train(argv, device) -> None:
    data_vols, label_vols, root = _parse_cli(argv)
    settings = get_settings_data(
        root / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN, kind="training"
    )
    (data, labels), max_labels, label_codes, last_slicer = _slice_all_volumes(
        data_vols, label_vols, settings
    )
    # The slicer's label codes go into the checkpoint as {str(i): code},
    # as the JAX CLI passes them.
    codes = (
        {str(i): code for i, code in enumerate(label_codes)}
        if label_codes
        else max_labels
    )
    trainer = VolSeg2dTrainer(data, labels, codes, settings, device=device)
    model_out = _model_output_path(settings, root)
    _run_training_phases(trainer, model_out, settings)
    if trainer.mesh.rank == 0:  # one rank writes the run's files
        trainer.output_loss_fig(model_out)
        trainer.output_prediction_figure(model_out)
    last_slicer.clean_up_slices()


if __name__ == "__main__":
    main()
