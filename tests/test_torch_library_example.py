"""`examples/library_api_torch.py`, the port's counterpart of
`examples/library_api.py`, run in process on the CPU at a small size:
slicing, training from the PNG slice directories, the loss figure and a
MEDIUM prediction of the in-memory volume, with the slices cleaned up;
its default device is the GPU."""

import importlib.util
from pathlib import Path

import numpy as np

import volume_segmantics_tpu_torch.utils.config as cfg

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "library_api_torch.py"


def load_example():
    spec = importlib.util.spec_from_file_location("library_api_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_runs_on_the_cpu_at_a_small_size(tmp_path, monkeypatch):
    example = load_example()
    monkeypatch.setattr(cfg, "MIN_LR_FIND_STEPS", 4)
    prediction = example.main(["--device", "cpu", "--out-dir", str(tmp_path),
                               "--shape", "8", "32", "32", "--image-size", "32",
                               "--compute-dtype", "float32"])
    assert prediction.shape == (8, 32, 32) and prediction.dtype == np.uint8
    assert set(np.unique(prediction)) <= {0, 1}
    assert (tmp_path / "example_model.pytorch").exists()
    assert (tmp_path / "example_model_loss_plot.png").exists()
    assert not list((tmp_path / "ex_data").glob("*.png"))
    assert not list((tmp_path / "ex_seg").glob("*.png"))


def test_example_defaults_to_the_gpu():
    args = load_example().parse_args([])
    assert args.device == "cuda" and tuple(args.shape) == (64, 128, 128)
