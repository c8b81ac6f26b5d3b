"""The trainer's figures in the port (`utils/figures.py` through
`output_loss_fig` and `output_prediction_figure`) against the JAX
trainer's: the montage's panels (data, ground truth, and the argmax of the
JAX model's eval forward for the same weights), each scaled as matplotlib's
``imshow(cmap="gray")`` scales it; the loss plot's best-epoch line at the
JAX trainer's argmin + 1, and its CSV equal to the JAX trainer's."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

import volume_segmantics_tpu.utils.config as jax_cfg
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import (
    VolSeg2dTrainer as JaxTrainer,
)
from volume_segmantics_tpu.models.registry import create_model as jax_create_model
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
from volume_segmantics_tpu_torch.models.torch_export import (
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.utils import figures, png

from test_torch_datasets import natsorted_lists, pair, train_settings

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["uint8", "float", "binary", "labels3", "constant"])
def test_to_grey_equals_matplotlib_gray(kind):
    rng = np.random.default_rng(0)
    panel = {"uint8": rng.integers(0, 256, (9, 11)).astype(np.uint8),
             "float": rng.normal(0, 3, (9, 11)),
             "binary": rng.integers(0, 2, (9, 11)),
             "labels3": rng.integers(0, 3, (9, 11)),
             "constant": np.full((9, 11), 4)}[kind]
    norm = matplotlib.colors.Normalize()(panel.astype(np.float64))
    # The map's grey level i is i / 255 (`bytes=True` truncates 97.99999).
    want = np.rint(matplotlib.colormaps["gray"](norm)[..., 0] * 255)
    np.testing.assert_array_equal(figures.to_grey(panel), want)


def test_montage_panels_equal_jax_argmax(tmp_path):
    settings = train_settings()
    trainer = VolSeg2dTrainer(*natsorted_lists(*pair()), 2, settings,
                              device="cpu")
    trainer._create_model_and_optimiser(1e-3)
    with torch.no_grad():  # a head that gives both classes a real share
        trainer.model.segmentation_head[0].weight.mul_(40)
    images, masks, _ = next(iter(trainer.validation_loader))
    struc = dict(trainer.model_struc_dict)
    tree = variables_from_smp_state_dict(trainer.model.state_dict(), struc)
    module = jax_create_model(dict(struc, type=JaxModelType.U_NET))
    x = (images.astype(np.float32) / 255.0 - jax_cfg.IMAGENET_MEAN) / jax_cfg.IMAGENET_STD
    logits = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        tree, jnp.asarray(x)[..., None])
    ref = np.asarray(jnp.argmax(logits, axis=-1))
    assert 0.05 < ref.mean() < 0.95

    model_path = tmp_path / "m.pytorch"
    trainer.output_prediction_figure(model_path)
    path = tmp_path / "m_prediction_image.png"
    grid = png.read_grey(path)
    side = images.shape[1]
    n_rows = min(images.shape[0], 4)
    assert grid.shape == figures.panel_origin(n_rows, 3, images.shape[1:])
    for r in range(n_rows):
        for c, want in enumerate((images[r], masks[r], ref[r])):
            y, x0 = figures.panel_origin(r, c, images.shape[1:])
            np.testing.assert_array_equal(grid[y:y + side, x0:x0 + side],
                                          figures.to_grey(want), f"{r},{c}")
    assert Image.open(path).text == {"Title": "Predictions for m.pytorch",
                                     "Columns": "Data, Ground Truth, Prediction"}
    np.testing.assert_array_equal(trainer.predict_batch(images), ref)


def test_loss_plot_marks_the_jax_best_epoch_and_csv_equals_jax(tmp_path):
    train_losses = [0.91, 0.62, 0.51, 0.455, 0.47, 0.44]
    valid_losses = [0.83, 0.57, 0.52, 0.59, 0.515, 0.6]
    scores = [0.4, 0.5, 0.6, 0.55, 0.61, 0.58]
    best = int(np.argmin(valid_losses)) + 1  # JAX trainer :719
    runs = {}
    for name, cls in (("ours", VolSeg2dTrainer), ("jax", JaxTrainer)):
        stub = SimpleNamespace(avg_train_losses=train_losses,
                               avg_valid_losses=valid_losses,
                               avg_eval_scores=scores)
        (tmp_path / name).mkdir()
        cls.output_loss_fig(stub, tmp_path / name / "m.pytorch")
        runs[name] = tmp_path / name
    assert ((runs["ours"] / "m_train_stats.csv").read_text()
            == (runs["jax"] / "m_train_stats.csv").read_text())
    image = Image.open(runs["ours"] / "m_loss_plot.png")
    assert image.text["Legend"].endswith(f"epoch {best})")
    assert (image.text["X label"], image.text["Y label"]) == ("epochs", "loss")
    canvas = np.asarray(image)
    assert canvas.shape == (800, 1000, 3)
    _, axes, got_best = figures.loss_plot(train_losses, valid_losses)
    assert got_best == best == 5
    col = int(np.rint(axes.col(best)))
    red = np.all(canvas == figures.RED, axis=-1)
    rows, cols = np.nonzero(red)
    assert set(cols) == {col - 1, col}
    # Dashed: gaps of a few rows along the box's height.
    assert 0.6 < len(set(rows)) / (axes.bottom - axes.top + 1) < 0.95
    for colour, losses in ((figures.C0, train_losses), (figures.C1, valid_losses)):
        mask = np.all(canvas == colour, axis=-1)
        for epoch, loss in enumerate(losses, 1):
            if epoch == best:  # the red line is drawn over it
                continue
            y, x = int(np.rint(axes.row(loss))), int(np.rint(axes.col(epoch)))
            assert mask[y - 2:y + 3, x - 2:x + 3].any(), (colour, epoch)
