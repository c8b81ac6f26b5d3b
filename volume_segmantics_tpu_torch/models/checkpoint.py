"""Checkpoints in the reference's torch format (reference
utilities/early_stopping.py:50-63): one `torch.save`d dict of five keys,
{model_state_dict (smp names), model_struc_dict, optimizer_state_dict,
loss_val, label_codes}. The JAX package loads these files through its
`models/checkpoint.py:load_checkpoint`."""

import logging
from pathlib import Path
from typing import Any, Dict

import torch


def save_checkpoint(path, model: torch.nn.Module, model_struc_dict: dict,
                    optimizer: torch.optim.Optimizer = None,
                    loss_val: float = float("inf"),
                    label_codes: Any = None) -> None:
    blob = {
        "model_state_dict": {
            k: v.detach().cpu() for k, v in model.state_dict().items()
        },
        "model_struc_dict": dict(model_struc_dict),
        "optimizer_state_dict": (
            optimizer.state_dict() if optimizer is not None else {}
        ),
        "loss_val": float(loss_val),
        "label_codes": label_codes if label_codes is not None else {},
    }
    torch.save(blob, Path(path))
    logging.info(f"Saved checkpoint to {path}.")


def load_checkpoint(path) -> Dict[str, Any]:
    """Load a checkpoint this package wrote, tensors on the CPU. The
    structure dict holds this package's ModelType enum, so the file is
    unpickled in full: load only files you wrote or trust."""
    if Path(path).suffix == ".vstpu":
        raise NotImplementedError(
            f"{path}: the JAX package's native .vstpu checkpoints are not "
            "ported to PyTorch yet (see ROADMAP.md)."
        )
    return torch.load(Path(path), map_location="cpu", weights_only=False)
