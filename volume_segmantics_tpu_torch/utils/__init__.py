__all__ = ["get_2d_training_parser", "get_2d_prediction_parser", "Quality"]

from volume_segmantics_tpu_torch.utils.arg_parsing import (
    get_2d_prediction_parser,
    get_2d_training_parser,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import Quality
