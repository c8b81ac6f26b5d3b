"""Early stopping on validation loss, with best-model checkpointing (port
of the JAX package's `utils/early_stopping.py`)."""

import logging

import numpy as np

from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint


class EarlyStopping:
    """Tracks validation loss across epochs; snapshots the best model and
    flags ``early_stop`` after ``patience`` epochs without improvement."""

    def __init__(self, patience=7, verbose=False, delta=0,
                 path="checkpoint.pytorch", model_dict=None, best_score=None,
                 write: bool = True):
        # `write` False: decide alike but write nothing (the ranks of a
        # data-parallel run other than rank 0).
        self.write = write
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.path = path
        self.model_struc_dict = model_dict or {}
        self.counter = 0
        self.early_stop = False
        # Scores are negated losses; `best_score` may be seeded from a prior
        # phase's checkpoint so phase-2 patience resumes against it.
        self.best_score = best_score
        self.val_loss_min = np.inf if best_score is None else -best_score

    def _improved(self, score) -> bool:
        return self.best_score is None or score >= self.best_score + self.delta

    def __call__(self, val_loss, model, optimizer, label_codes):
        score = -val_loss
        if not self._improved(score):
            self.counter += 1
            logging.info(
                f"EarlyStopping counter: {self.counter} out of {self.patience}"
            )
            if self.counter >= self.patience:
                self.early_stop = True
            return
        self.counter = 0
        self.best_score = score
        if self.verbose:
            logging.info(
                f"Validation loss decreased ({self.val_loss_min:.6f} --> "
                f"{val_loss:.6f}).  Saving model ..."
            )
        if self.write:
            save_checkpoint(self.path, model, self.model_struc_dict, optimizer,
                            loss_val=val_loss, label_codes=label_codes)
        self.val_loss_min = val_loss
