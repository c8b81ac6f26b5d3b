"""Checkpoint files (port of the JAX package's `models/checkpoint.py`).

One dict of five keys, as the reference saves it (reference
utilities/early_stopping.py:50-63): {model_state_dict (smp names),
model_struc_dict, optimizer_state_dict, loss_val, label_codes}, plus
`extra` in the trainer's autosaves. The port writes it with `torch.save`
and reads two formats, told apart by their first bytes as the JAX loader
does:
- a zip archive: a `torch.save` file of the port or the reference;
- `VSTPU1\\0\\0` and a flax msgpack blob: a JAX package checkpoint, whose
  {"params", "batch_stats"} tree is mapped to the port's state_dict.

The structure dict's ModelType is pickled under the reference's module
path, `volume_segmantics.utilities.base_data_utils`, as the JAX package's
torch export does, so that the reference loads the port's files; reading
maps that path (and the port's older one) to the port's enums.
"""

import enum
import io
import logging
import pickle
import sys
import types
import zipfile
from pathlib import Path
from typing import Any, Dict

import torch

from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
)
from volume_segmantics_tpu_torch.utils import base_data_utils
from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType
from volume_segmantics_tpu_torch.utils.flax_msgpack import (
    msgpack_restore,
    numpy_leaves,
)

MAGIC = b"VSTPU1\x00\x00"
REFERENCE_MODULE = "volume_segmantics.utilities.base_data_utils"
_ENUMS = ("ModelType", "Axis", "Quality")
# Module paths under which checkpoints pickle the enums: the reference's,
# and this package's own in files written before it used the reference's.
_ENUM_MODULES = (REFERENCE_MODULE, base_data_utils.__name__)


def reference_enum_module() -> types.ModuleType:
    """The module that pickle resolves the reference's enums in.

    pickle stores an enum member by its class's module and name and checks
    that the name finds the same class. Stand-in modules are installed
    under the reference's path, each only where none is there yet: the JAX
    package installs the same stubs (its `models/torch_convert.py`), and
    whichever came first serves both packages in one process."""
    parts = REFERENCE_MODULE.split(".")
    for i in range(1, len(parts) + 1):
        name = ".".join(parts[:i])
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
            if i > 1:
                setattr(sys.modules[".".join(parts[:i - 1])], parts[i - 1],
                        sys.modules[name])
    module = sys.modules[REFERENCE_MODULE]
    for cls_name in _ENUMS:
        if not hasattr(module, cls_name):
            cls = getattr(base_data_utils, cls_name)
            setattr(module, cls_name, enum.Enum(
                cls_name, {m.name: m.value for m in cls}, module=REFERENCE_MODULE,
            ))
    return module


class ReferenceUnpickler(pickle.Unpickler):
    """Resolves the reference's enums to the port's own, without the
    reference package."""

    def find_class(self, module, name):
        if module in _ENUM_MODULES and name in _ENUMS:
            return getattr(base_data_utils, name)
        return super().find_class(module, name)


# A pickle module for `torch.load(..., pickle_module=REFERENCE_PICKLE)`.
REFERENCE_PICKLE = types.ModuleType("volseg_reference_pickle")
REFERENCE_PICKLE.Unpickler = ReferenceUnpickler
REFERENCE_PICKLE.load = lambda f, **kw: ReferenceUnpickler(f, **kw).load()


def _to_reference_type(struc: dict) -> dict:
    out = dict(struc)
    t = out.get("type")
    if isinstance(t, enum.Enum):
        out["type"] = getattr(reference_enum_module(), type(t).__name__)[t.name]
    return out


def save_checkpoint(path, model: torch.nn.Module, model_struc_dict: dict,
                    optimizer: torch.optim.Optimizer = None,
                    loss_val: float = float("inf"),
                    label_codes: Any = None, extra: dict = None) -> None:
    """`torch.save` the five-key dict (and `extra` when given)."""
    blob = {
        "model_state_dict": {
            k: v.detach().cpu() for k, v in model.state_dict().items()
        },
        "model_struc_dict": _to_reference_type(model_struc_dict),
        "optimizer_state_dict": (
            optimizer.state_dict() if optimizer is not None else {}
        ),
        "loss_val": float(loss_val),
        "label_codes": label_codes if label_codes is not None else {},
    }
    if extra is not None:
        blob["extra"] = extra
    torch.save(blob, Path(path))
    logging.info(f"Saved checkpoint to {path}.")


def _load_native(data: bytes) -> Dict[str, Any]:
    """A JAX package `VSTPU1` file, its weights mapped to the port's names
    (bfloat16 ones as float32, exactly). Its optax optimizer state is not
    read: the port cannot use it. Its other leaves come back as
    `msgpack_restore` gives them: bfloat16 arrays as `torch.bfloat16`
    tensors of the same bits, chunked arrays whole."""
    blob = msgpack_restore(data[len(MAGIC):])
    struc = dict(blob["model_struc_dict"])
    if isinstance(struc.get("type"), str):
        struc["type"] = ModelType[struc["type"]]
    blob["model_struc_dict"] = struc
    blob["model_state_dict"] = smp_state_dict_from_variables(
        numpy_leaves(blob["model_state_dict"]), struc
    )
    blob["optimizer_state_dict"] = {}
    return blob


def load_checkpoint(path) -> Dict[str, Any]:
    """Load a checkpoint dict, tensors on the CPU. A torch file is unpickled
    in full: load only files you wrote or trust."""
    return checkpoint_from_bytes(Path(path).read_bytes(), path)


def checkpoint_from_bytes(data: bytes, name="checkpoint") -> Dict[str, Any]:
    """`load_checkpoint` of a file's bytes (a data-parallel trainer's ranks
    take them from rank 0); `name` is for the error message."""
    if data[:len(MAGIC)] == MAGIC:
        return _load_native(data)
    buf = io.BytesIO(data)
    if zipfile.is_zipfile(buf):
        buf.seek(0)
        return torch.load(buf, map_location="cpu", weights_only=False,
                          pickle_module=REFERENCE_PICKLE)
    raise ValueError(f"Unrecognized checkpoint format: {name}")
