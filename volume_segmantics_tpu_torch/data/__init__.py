__all__ = [
    "get_settings_data",
    "TrainingDataSlicer",
    "TrainingSettings",
    "PredictionSettings",
    "SettingsError",
]

from volume_segmantics_tpu_torch.data.settings_data import (
    PredictionSettings,
    SettingsError,
    TrainingSettings,
    get_settings_data,
)
from volume_segmantics_tpu_torch.data.slicers import TrainingDataSlicer
