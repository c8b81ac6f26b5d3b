"""Settings resolution: YAML file, plain dict, or nothing -> settings object
(port of the JAX package's `data/settings_data.py`; the YAML file is read
by the port's own reader, `utils/yaml_settings.py`, which returns what
``yaml.safe_load`` returns).

Passing ``kind="training"`` / ``kind="prediction"`` validates the mapping
against a typed dataclass (`TrainingSettings` / `PredictionSettings`), so a
missing or mistyped key fails up front instead of deep in a run.

Validation rules:
- Extra keys are tolerated and carried through unchanged.
- Numeric strings coerce to float fields (YAML 1.1 reads the shipped
  ``starting_lr: 1e-6`` as a string).
- Invalid settings loaded FROM A FILE exit(1) with a logged message (the
  CLI contract); invalid dicts raise `SettingsError` (the library contract).
"""

import dataclasses
import logging
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Union

from volume_segmantics_tpu_torch.utils import yaml_settings


class SettingsError(ValueError):
    """A settings mapping failed validation against its workflow schema."""


class _TypedSettings:
    """Shared behaviour for the workflow dataclasses: construction from an
    arbitrary mapping with full-error-list validation, pass-through of extra
    keys, and namespace-style attribute mutation."""

    @classmethod
    def from_mapping(cls, mapping: dict, source: str = "<dict>"):
        missing, badtype = [], []
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in mapping:
                try:
                    kwargs[f.name] = _coerce(mapping[f.name], f.type)
                except TypeError:
                    badtype.append(
                        f"'{f.name}' (expected {f.type.__name__}, got "
                        f"{type(mapping[f.name]).__name__}: {mapping[f.name]!r})"
                    )
            else:
                missing.append(f"'{f.name}'")
        if missing or badtype:
            parts = [f"settings {source} failed validation:"]
            if missing:
                parts.append(f"missing required key(s): {', '.join(missing)};")
            if badtype:
                parts.append(f"wrong type for key(s): {', '.join(badtype)};")
            parts.append(
                "see the shipped volseg-settings/*.yaml for the expected keys."
            )
            raise SettingsError(" ".join(parts))
        obj = cls(**kwargs)
        # Extra keys pass through untouched. They are NOT declared as typed
        # fields with defaults: code reads them via getattr(s, k, default)
        # and a materialised None would shadow the real default.
        for k, v in mapping.items():
            if k not in kwargs:
                setattr(obj, k, v)
        object.__setattr__(obj, "_source", source)
        return obj

    def __getattr__(self, name):
        src = self.__dict__.get("_source", "<settings>")
        raise AttributeError(
            f"settings {src} has no key '{name}' — add it to the settings "
            f"file or pass it in the settings dict."
        )


def _coerce(value, typ):
    """Validate/convert one YAML value to the declared field type. Raises
    TypeError on mismatch. bool is checked before int (a YAML `true` must
    not satisfy an int field and vice versa)."""
    if typ is bool:
        if isinstance(value, bool):
            return value
    elif typ is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
    elif typ is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
    elif typ is str:
        if isinstance(value, str):
            return value
    elif typ is dict:
        if isinstance(value, dict):
            return value
    else:  # unconstrained field
        return value
    raise TypeError(value)


@dataclasses.dataclass
class TrainingSettings(_TypedSettings):
    """Typed schema of the training workflow's required keys — the
    non-optional keys of volseg-settings/2d_model_train_settings.yaml."""

    data_im_dirname: str
    seg_im_out_dirname: str
    model_output_fn: str
    clip_data: bool
    st_dev_factor: float
    data_hdf5_path: str
    seg_hdf5_path: str
    training_axes: str
    image_size: int
    downsample: bool
    training_set_proportion: float
    cuda_device: int
    num_cyc_frozen: int
    num_cyc_unfrozen: int
    patience: int
    loss_criterion: str
    alpha: float
    beta: float
    eval_metric: str
    pct_lr_inc: float
    starting_lr: float
    end_lr: float
    lr_find_epochs: int
    lr_reduce_factor: float
    plot_lr_graph: bool
    model: dict


@dataclasses.dataclass
class PredictionSettings(_TypedSettings):
    """Typed schema of the prediction workflow's required keys — the
    non-optional keys of volseg-settings/2d_model_predict_settings.yaml."""

    quality: str
    output_probs: bool
    clip_data: bool
    st_dev_factor: float
    data_hdf5_path: str
    cuda_device: int
    downsample: bool
    one_hot: bool
    prediction_axis: str


_KINDS = {"training": TrainingSettings, "prediction": PredictionSettings}


def _load_yaml_settings(path: Path, kind: Optional[str]):
    logging.info(f"Loading settings from {path}")
    if not path.exists():
        logging.error("Couldn't find settings file... Exiting!")
        sys.exit(1)
    mapping = yaml_settings.load(path)
    if kind is None:
        return SimpleNamespace(**mapping)
    try:
        return _KINDS[kind].from_mapping(mapping, source=f"file {path}")
    except SettingsError as e:
        # CLI contract: a bad settings file terminates with a clear logged
        # message, matching the missing-file exit(1) behaviour above.
        logging.error(str(e))
        sys.exit(1)


def require_settings(settings, keys, context: str) -> None:
    """Raise SettingsError listing EVERY missing key, for library entry
    points fed hand-built namespaces/dicts that bypassed the typed loaders
    (the reference dies with a bare AttributeError at first deep use)."""
    missing = [k for k in keys if not hasattr(settings, k)]
    if missing:
        raise SettingsError(
            f"{context} settings are missing required key(s): "
            f"{', '.join(repr(k) for k in missing)}. Build settings with "
            f"get_settings_data(..., kind=...) to validate the full schema "
            f"up front."
        )


def get_settings_data(
    data: Union[Path, str, dict, None],
    kind: Optional[str] = None,
) -> SimpleNamespace:
    """Resolve `data` to a settings object.

    Accepts a YAML file path (Path or str), an already-assembled dict (the
    library-API route), or None (empty settings). With `kind` set to
    "training" or "prediction" the mapping is validated against the typed
    workflow schema (see module docstring); without it, the untyped
    namespace is returned."""
    if kind is not None and kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)} or None")
    if isinstance(data, (Path, str)):
        return _load_yaml_settings(Path(data), kind)
    if isinstance(data, dict):
        if kind is None:
            return SimpleNamespace(**data)
        return _KINDS[kind].from_mapping(data)
    return SimpleNamespace()
