"""2D segmentation trainer: LR finder, OneCycle schedule, encoder freezing,
early stopping (port of the JAX package's
`model/operations/vol_seg_2d_trainer.py`, reference
volume_segmantics/model/operations/vol_seg_2d_trainer.py:35-535).

The train step fuses augmentation, normalisation, forward, loss, backward
and AdamW (`parallel/train.py`). The learning rate is an argument of the
step, so the LR finder and OneCycle schedule only change a number.
Freezing follows the JAX package's mask: every leaf whose flax path holds
"encoder" and "conv" is frozen. Each port parameter is given the path that
`models/torch_export.variables_from_smp_state_dict` maps it to, and the
rule is applied to that path. In the ResNets every encoder module is a
`stem_conv`, `convbn*` or `conv_down`, so the whole encoder is frozen,
BatchNorm scale and bias included; EfficientNet's `bnact_*` BatchNorms and
ResNeSt's split-attention `bn0`/`bn1` stay trainable. Running statistics
still update.

With `autosave: True` each epoch writes `<output>.autosave` (model and
AdamW state, early-stopping state, the loss lists), and an interrupted run
resumes from it when its frozen flag matches. `profile_dir` records a
`torch.profiler` trace of epoch 1 of each phase as a Chrome trace.

After training it writes the train-stats CSV, the loss plot and the
validation montage as PNG files (`utils/figures.py`, `utils/png.py`: the
GPU machine has no matplotlib), their text in tEXt chunks.

In a process group (`parallel/mesh.py`: one rank a GPU) it trains data
parallel over every rank, as the JAX trainer trains over its mesh: each
rank takes its rows of every global batch and the steps are the
data-parallel ones (`parallel/train.py`). With `spatial_partitions: s`
the mesh is (world / s) data x s space, as the JAX trainer's: the s ranks
of a data row share its rows and split image height
(`parallel/spatial.py`). Rank 0's initial weights are broadcast; every
checkpoint and autosave is read by rank 0 and its bytes
broadcast, so the ranks need no shared disk; rank 0 alone writes the
checkpoint, the autosave and the profile, and `model-train-2d` has it
alone write the CSV and the figures. Every rank takes the same LR-finder
and early-stopping decisions, as they follow from the global batch's
losses. A process without a group trains on its one device.
"""

import csv
import logging
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data.dataloaders import (
    get_2d_training_dataloaders,
    to_device_batches,
)
from volume_segmantics_tpu_torch.data.losses import get_loss_fn
from volume_segmantics_tpu_torch.data.metrics import get_eval_metric_fn
from volume_segmantics_tpu_torch.data.settings_data import require_settings
from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
from volume_segmantics_tpu_torch.models.checkpoint import (
    checkpoint_from_bytes,
    save_checkpoint,
)
from volume_segmantics_tpu_torch.models.torch_export import flax_param_paths
from volume_segmantics_tpu_torch.parallel.mesh import (
    check_space,
    get_mesh,
    replicate,
)
from volume_segmantics_tpu_torch.parallel.train import (
    autocast,
    build_dp_eval_step,
    build_dp_train_step,
    make_base_optimizer,
    normalise,
)
from volume_segmantics_tpu_torch.utils import figures, png
from volume_segmantics_tpu_torch.utils.device import resolve_device
from volume_segmantics_tpu_torch.utils.early_stopping import EarlyStopping
from volume_segmantics_tpu_torch.utils.host_memory import (
    tune_malloc_for_large_buffers,
)


def frozen_parameter_names(model: torch.nn.Module,
                           model_struc_dict: dict) -> frozenset:
    """The parameters the JAX package's `_freeze_mask` freezes: those whose
    flax path holds "encoder" and "conv" (see module doc)."""
    paths = flax_param_paths(model.state_dict(), model_struc_dict)
    return frozenset(
        name for name, _ in model.named_parameters()
        if any("encoder" in n for n in paths[name])
        and any("conv" in n for n in paths[name]))


def check_spatial_partitions(settings: SimpleNamespace,
                             device: torch.device) -> int:
    """The JAX trainer's `spatial_partitions` (optional, default 1): the
    axis of its device mesh that splits image height; returned. A count
    that does not divide the device count (the ranks of the process group;
    without one, the GPUs, or 1 on the CPU) raises the JAX package's
    ValueError (its `parallel/mesh.py:get_mesh`). Above 1 every (decoder,
    encoder) pair that `create_model` builds splits its rows, at any
    `image_size`."""
    space = int(getattr(settings, "spatial_partitions", 1) or 1)
    if dist.is_initialized():
        count = dist.get_world_size()
    else:
        count = torch.cuda.device_count() if device.type == "cuda" else 1
    check_space(space, count)
    return space


class VolSeg2dTrainer:
    """Trains a 2d model and writes its loss curves and example
    predictions.

    The first two arguments are PNG slice directories (`str` or `Path`,
    the reference's workflow) or in-memory slice lists (`from_slicer`)."""

    @classmethod
    def from_slicer(cls, slicer, labels, settings, device=None):
        """A trainer on a TrainingDataSlicer's slices, in z, y, x order."""
        data_slices, label_slices = slicer.get_slice_arrays()
        return cls(data_slices, label_slices, labels, settings, device=device)

    # Keys the training flow reads without defaults.
    REQUIRED_SETTINGS = (
        "image_size", "training_set_proportion", "loss_criterion",
        "eval_metric", "starting_lr", "end_lr", "lr_find_epochs",
        "lr_reduce_factor", "patience", "model", "pct_lr_inc",
    )

    def __init__(self, image_dir_path, label_dir_path, labels: Union[int, dict],
                 settings: SimpleNamespace, device=None):
        require_settings(settings, self.REQUIRED_SETTINGS, "training")
        # Slice stacks and epoch shuffles churn large host buffers; keep
        # freed pages in-process (utils/host_memory.py).
        tune_malloc_for_large_buffers()
        device = resolve_device(device)
        self.mesh = get_mesh(device=device, space=check_spatial_partitions(
            settings, device))
        self.device = self.mesh.device
        if self.mesh.size > 1:
            space = self.mesh.space_size
            shape = (f"{self.mesh.data_size} data x {space} space" if space > 1
                     else f"{self.mesh.size} ranks")
            logging.info(f"Data-parallel training over {shape} (this is rank "
                         f"{self.mesh.rank}).")
        # One seed, four independent streams: data split and order, model
        # initialisation, on-device augmentation and dropout masks (the
        # first three are spawned as they were before the fourth).
        seed = int(getattr(settings, "seed", 0))
        data_ss, init_ss, aug_ss, drop_ss = np.random.SeedSequence(
            seed).spawn(4)
        self.training_loader, self.validation_loader = get_2d_training_dataloaders(
            image_dir_path, label_dir_path, settings, self.device,
            rng=np.random.default_rng(data_ss), mesh=self.mesh,
        )
        self._init_gen = torch.Generator().manual_seed(
            int(init_ss.generate_state(1)[0])
        )
        self._aug_gen = torch.Generator(self.device).manual_seed(
            int(aug_ss.generate_state(1)[0])
        )
        self._dropout_gen = torch.Generator(self.device).manual_seed(
            int(drop_ss.generate_state(1)[0])
        )
        self.label_no = labels if isinstance(labels, int) else len(labels)
        self.codes = labels if isinstance(labels, dict) else {}
        self.settings = settings
        # Params for learning rate finder (reference trainer :62-67)
        self.starting_lr = float(settings.starting_lr)
        self.end_lr = float(settings.end_lr)
        self.log_lr_ratio = self._calculate_log_lr_ratio()
        self.lr_find_epochs = settings.lr_find_epochs
        self.lr_reduce_factor = settings.lr_reduce_factor
        # Read and unused, as in the JAX package (its model_2d.py:94).
        self.model_device_num = int(getattr(settings, "cuda_device", 0))
        self.patience = settings.patience
        self.loss_fn = get_loss_fn(settings)
        self.eval_metric_fn = get_eval_metric_fn(settings)
        self.model_struc_dict = self._get_model_struc_dict(settings)
        self.image_size = int(settings.image_size)
        self.compute_dtype = getattr(
            torch, str(getattr(settings, "compute_dtype", cfg.COMPUTE_DTYPE))
        )
        self.augment_on_device = bool(getattr(settings, "augment", True))
        self._weight_decay = float(getattr(settings, "weight_decay", 0.01))
        self.avg_train_losses = []
        self.avg_valid_losses = []
        self.avg_eval_scores = []
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self._frozen = False
        self._train_step = None
        self._eval_step = None
        # Train steps taken; host seconds of each synchronised LR-finder step
        # (each ends reading its loss); per epoch, the seconds and steps of
        # its training loop (ending when its losses reach the host).
        self.train_steps = 0
        self.lr_find_step_seconds = []
        self.epoch_train_seconds = []
        self.epoch_train_steps = []

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------

    def _get_model_struc_dict(self, settings):
        model_struc_dict = dict(settings.model)
        model_struc_dict["type"] = utils.get_model_type(settings)
        model_struc_dict["in_channels"] = cfg.MODEL_INPUT_CHANNELS
        model_struc_dict["classes"] = self.label_no
        return model_struc_dict

    def _calculate_log_lr_ratio(self):
        return math.log(self.end_lr / self.starting_lr)

    def _create_model_and_optimiser(self, learning_rate, frozen=False):
        logging.info("Setting up the model on device.")
        self.model = create_model_on_device(
            self.device, self.model_struc_dict, generator=self._init_gen
        )
        replicate(self.model, self.mesh)
        self._freezable = frozen_parameter_names(self.model,
                                                 self.model_struc_dict)
        self._set_frozen(frozen)
        logging.info(
            f"Model has {self._count_trainable_parameters()} trainable "
            f"parameters, {self._count_parameters()} total parameters."
        )
        if frozen and not self.model.pretrained_loaded:
            logging.warning(
                "Training with a FROZEN encoder that has RANDOM weights: the "
                "frozen phase will learn poorly. Provide pretrained encoder "
                "weights via VOLSEG_TPU_WEIGHTS_DIR, or set num_cyc_frozen: 0 "
                "and train unfrozen."
            )
        logging.info("Trainer created.")

    def _set_frozen(self, frozen: bool):
        """Freeze (or unfreeze) the encoder structurally and rebuild the
        optimizer over the trainable parameters and the steps around it."""
        self._frozen = frozen
        trainable = []
        for name, p in self.model.named_parameters():
            p.requires_grad_(not (frozen and name in self._freezable))
            if p.requires_grad:
                trainable.append(p)
        self.optimizer = make_base_optimizer(trainable, self._weight_decay)
        self._train_step = build_dp_train_step(
            self.model, self.loss_fn, self.optimizer,
            num_labels=self.label_no, image_size=self.image_size,
            mesh=self.mesh, compute_dtype=self.compute_dtype,
            augment=self.augment_on_device, generator=self._aug_gen,
            dropout_generator=self._dropout_gen,
        )
        self._eval_step = build_dp_eval_step(
            self.model, self.loss_fn, self.eval_metric_fn,
            num_labels=self.label_no, mesh=self.mesh,
            compute_dtype=self.compute_dtype,
        )

    def _count_parameters(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def _count_trainable_parameters(self, frozen: Optional[bool] = None) -> int:
        """Parameters receiving updates under the freeze rule (reference
        trainer :118-119)."""
        if frozen is None:
            frozen = self._frozen
        return sum(
            p.numel() for name, p in self.model.named_parameters()
            if not (frozen and name in self._freezable)
        )

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train_model(self, output_path: Path, num_epochs: int, patience: int,
                    create: bool = True, frozen: bool = False) -> None:
        """Train for `num_epochs` with an automatically determined learning
        rate (reference trainer :163-274)."""
        # Resume (the JAX package's addition): with `autosave: True` each
        # epoch writes <output>.autosave, and an interrupted run restarts
        # after its last completed epoch, without the LR finder.
        autosave = bool(getattr(self.settings, "autosave", False))
        autosave_path = Path(f"{output_path}.autosave")
        resume = self._try_resume(autosave_path, frozen) if autosave else None
        if resume is not None:
            lr_to_use = resume["lr_to_use"]
            early_stopping = self._create_early_stopping(
                output_path, patience, best_score=resume["best_score"]
            )
            early_stopping.counter = resume["es_counter"]
            logging.info(
                f"Resuming training from autosave at epoch {resume['epoch'] + 1}."
            )
        elif create:
            self._create_model_and_optimiser(self.starting_lr, frozen=frozen)
            lr_to_use = self._run_lr_finder()
            self._create_model_and_optimiser(lr_to_use, frozen=frozen)
            early_stopping = self._create_early_stopping(output_path, patience)
        else:
            # Model already partially trained: reduce LR bounds and reload
            self.starting_lr /= self.lr_reduce_factor
            self.end_lr /= self.lr_reduce_factor
            self.log_lr_ratio = self._calculate_log_lr_ratio()
            self._load_in_model_and_optimizer(
                self.starting_lr, output_path, frozen=frozen
            )
            lr_to_use = self._run_lr_finder()
            min_loss = self._load_in_model_and_optimizer(
                self.starting_lr, output_path, frozen=frozen
            )
            early_stopping = self._create_early_stopping(
                output_path, patience, best_score=-min_loss
            )

        lr_schedule = self._create_oc_lr_schedule(num_epochs, lr_to_use)
        global_step = resume["global_step"] if resume else 0
        start_epoch = resume["epoch"] + 1 if resume else 1
        profiler = self._start_profiler()
        for epoch in range(start_epoch, num_epochs + 1):
            tic = time.perf_counter()
            logging.info(f"Epoch {epoch} of {num_epochs}")
            train_losses = []
            train = to_device_batches(self.training_loader, self.device)
            for images, masks, _ in train:
                lr = float(lr_schedule(global_step))
                train_losses.append(self._train_one_batch_async(images, masks, lr))
                global_step += 1
            # Pull the epoch's losses in one device round trip.
            train_losses = torch.stack(train_losses).cpu().numpy()
            self.epoch_train_seconds.append(time.perf_counter() - tic)
            self.epoch_train_steps.append(len(train_losses))

            valid_losses, eval_scores, valid_weights = [], [], []
            valid = to_device_batches(self.validation_loader, self.device)
            for images, masks, n_valid in valid:
                loss, score = self._eval_step(images, masks, n_valid)
                valid_losses.append(loss)
                eval_scores.append(score)
                valid_weights.append(n_valid)

            valid_losses = torch.stack(valid_losses).cpu().numpy()
            eval_scores = torch.stack(eval_scores).cpu().numpy()
            toc = time.perf_counter()
            self.avg_train_losses.append(float(np.average(train_losses)))
            # Weight per-batch validation stats by their real sample counts
            # so the padded remainder batch does not bias the epoch average.
            self.avg_valid_losses.append(
                float(np.average(valid_losses, weights=valid_weights))
            )
            self.avg_eval_scores.append(
                float(np.average(eval_scores, weights=valid_weights))
            )
            logging.info(
                f"Epoch {epoch}. Training loss: {self.avg_train_losses[-1]}, "
                f"Validation Loss: {self.avg_valid_losses[-1]}. "
                f"{self.settings.eval_metric}: {self.avg_eval_scores[-1]}"
            )
            logging.info(f"Time taken for epoch {epoch}: {toc - tic:0.2f} seconds")
            if profiler is not None and epoch == 1:
                profiler = self._stop_profiler(profiler, frozen)
            early_stopping(self.avg_valid_losses[-1], self.model,
                           self.optimizer, self.codes)
            if autosave and self._writes:
                self._write_autosave(
                    autosave_path, epoch=epoch, global_step=global_step,
                    lr_to_use=lr_to_use, early_stopping=early_stopping,
                    frozen=frozen,
                )
            if early_stopping.early_stop:
                logging.info("Early stopping")
                break
        if profiler is not None:
            self._stop_profiler(profiler, frozen)
        if autosave and self._writes and autosave_path.exists():
            autosave_path.unlink()
        self._load_in_weights(output_path)

    # ------------------------------------------------------------------
    # Autosave / resume (JAX trainer :429-484) and profiling (:345-347)
    # ------------------------------------------------------------------

    def _write_autosave(self, autosave_path, epoch, global_step, lr_to_use,
                        early_stopping, frozen):
        save_checkpoint(
            autosave_path, self.model, self.model_struc_dict, self.optimizer,
            loss_val=self.avg_valid_losses[-1], label_codes=self.codes,
            extra={
                "epoch": int(epoch),
                "global_step": int(global_step),
                "lr_to_use": float(lr_to_use),
                "best_score": float(early_stopping.best_score),
                "es_counter": int(early_stopping.counter),
                "frozen": bool(frozen),
                "avg_train_losses": [float(x) for x in self.avg_train_losses],
                "avg_valid_losses": [float(x) for x in self.avg_valid_losses],
                "avg_eval_scores": [float(x) for x in self.avg_eval_scores],
            },
        )

    @property
    def _writes(self) -> bool:
        """Whether this process writes the run's files: rank 0 alone."""
        return self.mesh.rank == 0

    def _read_checkpoint(self, path):
        """The checkpoint at `path` as rank 0 reads it, on every rank; None
        when rank 0 finds no file there."""
        path = Path(path)
        data = path.read_bytes() if self._writes and path.exists() else None
        data = self.mesh.broadcast_object(data)
        return None if data is None else checkpoint_from_bytes(data, path)

    def _try_resume(self, autosave_path, frozen):
        """Restore model, optimizer and loss lists from an epoch autosave
        of this package; returns its `extra` dict, or None to start
        afresh."""
        ckpt = self._read_checkpoint(autosave_path)
        if ckpt is None:
            return None
        extra = ckpt.get("extra")
        if not extra or bool(extra.get("frozen")) != bool(frozen):
            return None
        if "param_groups" not in ckpt["optimizer_state_dict"]:
            logging.info(f"{autosave_path} holds no AdamW state of this "
                         "package; training afresh.")
            return None
        self._create_model_and_optimiser(extra["lr_to_use"], frozen=frozen)
        self.model.load_state_dict(ckpt["model_state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.avg_train_losses = list(extra.get("avg_train_losses", []))
        self.avg_valid_losses = list(extra.get("avg_valid_losses", []))
        self.avg_eval_scores = list(extra.get("avg_eval_scores", []))
        return extra

    def _start_profiler(self):
        """A torch.profiler trace from here on when `profile_dir` is set
        (CUDA activity too on the GPU); None otherwise."""
        if not getattr(self.settings, "profile_dir", None) or not self._writes:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, frozen):
        """Stop `profiler` and write its Chrome trace into `profile_dir`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = (Path(self.settings.profile_dir)
                / f"train_{'frozen' if frozen else 'unfrozen'}_epoch1.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        logging.info(f"Saved the profile trace of epoch 1 to {path}.")

    def _train_one_batch_async(self, images, masks, lr):
        """One train step; returns the loss as a device scalar without
        waiting for it."""
        self.train_steps += 1
        return self._train_step(images, masks, lr)

    def _train_one_batch(self, images, masks, lr) -> float:
        return float(self._train_one_batch_async(images, masks, lr))

    # ------------------------------------------------------------------
    # Checkpoint load
    # ------------------------------------------------------------------

    def _load_in_model_and_optimizer(self, learning_rate, output_path,
                                     frozen=False):
        self._create_model_and_optimiser(learning_rate, frozen=frozen)
        logging.info("Loading in weights from saved checkpoint.")
        return self._load_in_weights(output_path)

    def _load_in_weights(self, output_path):
        ckpt = self._read_checkpoint(output_path)
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint at {output_path}")
        logging.info("Loading model weights.")
        self.model.load_state_dict(ckpt["model_state_dict"])
        return ckpt.get("loss_val", np.inf)

    # ------------------------------------------------------------------
    # LR finder (reference trainer :298-383)
    # ------------------------------------------------------------------

    def _run_lr_finder(self):
        logging.info("Finding learning rate for model.")
        lr_find_loss, lr_find_lr = self._lr_finder()
        lr_to_use = self._find_lr_from_graph(lr_find_loss, lr_find_lr)
        logging.info(f"LR to use {lr_to_use}")
        return lr_to_use

    def _lr_find_epochs_effective(self) -> int:
        """Finder epochs, raised so the exponential sweep covers at least
        cfg.MIN_LR_FIND_STEPS steps."""
        steps_per_epoch = max(len(self.training_loader), 1)
        need = -(-cfg.MIN_LR_FIND_STEPS // steps_per_epoch)  # ceil
        return max(self.lr_find_epochs, need)

    def _lr_exp_stepper(self, step, find_epochs=None):
        """Exponentially increase LR from starting_lr towards end_lr over
        the finder epochs (reference trainer :385-393)."""
        if find_epochs is None:
            find_epochs = self._lr_find_epochs_effective()
        total = find_epochs * max(len(self.training_loader), 1)
        return self.starting_lr * math.exp(step * self.log_lr_ratio / total)

    def _lr_finder(self, smoothing=0.05):
        lr_find_loss = []
        lr_find_lr = []
        iters = 0
        find_epochs = self._lr_find_epochs_effective()
        if find_epochs != self.lr_find_epochs:
            logging.info(
                f"Raising LR-finder epochs {self.lr_find_epochs} -> "
                f"{find_epochs} so the sweep has >= "
                f"{cfg.MIN_LR_FIND_STEPS} steps at this batch size."
            )
        total_steps = find_epochs * max(len(self.training_loader), 1)
        for _ in range(find_epochs):
            train = to_device_batches(self.training_loader, self.device)
            for images, masks, _ in train:
                lr_step = self._lr_exp_stepper(iters)
                tic = time.perf_counter()
                loss = self._train_one_batch(images, masks, lr_step)
                self.lr_find_step_seconds.append(time.perf_counter() - tic)
                lr_find_lr.append(lr_step)
                if iters == 0:
                    lr_find_loss.append(loss)
                else:
                    loss = smoothing * loss + (1 - smoothing) * lr_find_loss[-1]
                    lr_find_loss.append(loss)
                # Abort once the loss exceeds 1 past ~75% of the whole sweep.
                if loss > 1 and iters > total_steps // 1.333:
                    return lr_find_loss, lr_find_lr
                iters += 1
        return lr_find_loss, lr_find_lr

    @staticmethod
    def _find_lr_from_graph(lr_find_loss, lr_find_lr) -> float:
        """LR at the steepest loss descent / LR_DIVISOR, with a default
        fallback (reference trainer :347-383)."""
        default_min_lr = cfg.DEFAULT_MIN_LR
        losses = np.array([float(x) for x in lr_find_loss])
        try:
            gradients = np.gradient(losses)
            min_gradient = gradients.min()
            if min_gradient < 0:
                min_loss_grad_idx = gradients.argmin()
            else:
                logging.info(
                    f"Minimum gradient: {min_gradient} was positive, "
                    "returning default value instead."
                )
                return default_min_lr
        except ValueError as e:
            logging.info(f"Failed to compute gradients, returning default value. {e}")
            return default_min_lr
        min_lr = lr_find_lr[min_loss_grad_idx]
        return min_lr / cfg.LR_DIVISOR

    # ------------------------------------------------------------------
    # Schedules / early stopping
    # ------------------------------------------------------------------

    def _create_oc_lr_schedule(self, num_epochs, lr_to_use):
        """OneCycle (cosine) schedule with torch OneCycleLR defaults
        (div_factor=25, final_div_factor=1e4), reference trainer :401-408."""
        total_steps = max(num_epochs * max(len(self.training_loader), 1), 1)
        pct_start = float(self.settings.pct_lr_inc)
        initial_lr = lr_to_use / 25.0
        min_lr = initial_lr / 1e4
        warm_steps = pct_start * total_steps

        def schedule(step):
            if step < warm_steps:
                frac = step / max(warm_steps, 1.0)
                return initial_lr + (lr_to_use - initial_lr) * (
                    1 - math.cos(math.pi * frac)
                ) / 2.0
            frac = (step - warm_steps) / max(total_steps - warm_steps, 1.0)
            frac = min(frac, 1.0)
            return min_lr + (lr_to_use - min_lr) * (1 + math.cos(math.pi * frac)) / 2.0

        return schedule

    def _create_early_stopping(self, output_path, patience, best_score=None):
        return EarlyStopping(
            patience=patience,
            verbose=True,
            path=output_path,
            model_dict=self.model_struc_dict,
            best_score=best_score,
            write=self._writes,
        )

    # ------------------------------------------------------------------
    # Outputs (reference trainer :434-535)
    # ------------------------------------------------------------------

    def output_loss_fig(self, model_out_path: Path) -> None:
        """Write the loss plot, `<stem>_loss_plot.png` (training and
        validation loss by epoch, a dashed red line at the best epoch), and
        the per-epoch CSV of losses and eval scores (reference trainer
        :434-479). Under a data mesh, call it on rank 0 alone."""
        out_dir = model_out_path.parent
        stem = model_out_path.stem
        canvas, _, best = figures.loss_plot(self.avg_train_losses,
                                            self.avg_valid_losses)
        fig_path = out_dir / f"{stem}_loss_plot.png"
        logging.info(f"Saving figure of training/validation losses to {fig_path}")
        png.write(fig_path, canvas, text={
            "X label": "epochs", "Y label": "loss",
            "Legend": "Training Loss (C0), Validation Loss (C1), Early "
                      f"Stopping Checkpoint (red, dashed, epoch {best})",
        })
        # CSV column names are a de-facto contract with downstream tooling.
        # Epoch numbers are 0-based like the reference's
        # (trainer :472 `range(len(self.avg_train_losses))`).
        csv_path = out_dir / f"{stem}_train_stats.csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(("Epoch", "Train Loss", "Valid Loss", "Eval Score"))
            writer.writerows(
                zip(range(len(self.avg_train_losses)), self.avg_train_losses,
                    self.avg_valid_losses, self.avg_eval_scores)
            )

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """Labels (argmax of an eval-mode forward on the trainer's device)
        of an (N, H, W) uint8 batch."""
        x = normalise(torch.from_numpy(images).to(self.device).float() / 255.0)
        self.model.eval()
        with torch.no_grad(), autocast(self.device, self.compute_dtype):
            logits = self.model(x)
        return logits.float().argmax(dim=1).cpu().numpy()

    def output_prediction_figure(self, model_path: Path) -> None:
        """Write `<stem>_prediction_image.png`: data, ground truth and
        prediction panels of up to 4 samples of the first validation batch
        (the global batch) at native resolution, each min-max scaled
        (reference trainer :481-535). Under a data mesh, call it on rank 0
        alone."""
        images, masks, _ = next(self.validation_loader.batches(whole=True))
        predictions = self.predict_batch(images)
        n_rows = min(images.shape[0], 4)
        canvas = figures.montage(
            [(images[r], masks[r], predictions[r]) for r in range(n_rows)])
        fig_path = model_path.parent / f"{model_path.stem}_prediction_image.png"
        logging.info(f"Saving example image predictions to {fig_path}")
        png.write(fig_path, canvas, text={
            "Title": f"Predictions for {model_path.name}",
            "Columns": "Data, Ground Truth, Prediction",
        })
