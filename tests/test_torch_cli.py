"""Both console entry points of the PyTorch port (`model-train-2d`,
`model-predict-2d`) on the CPU against the JAX package's CLIs, run in
process through `main`: the same slice stacks handed to the trainer under
both `slice_to_disk` settings, a train run that writes the CSV and a
checkpoint the JAX package loads, and a prediction equal to the JAX CLI's
at every voxel, from files the settings reader, HDF5 reader and writer of
each package exchange; and both CLIs on TIFF volumes, with the figures
`model-train-2d` writes."""

import csv
import os
import re
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import volume_segmantics_tpu.scripts.predict_2d_model as jax_predict
import volume_segmantics_tpu.scripts.train_2d_model as jax_train
import volume_segmantics_tpu_torch.scripts.predict_2d_model as predict
import volume_segmantics_tpu_torch.scripts.train_2d_model as train
from chip_smoke import write_tiff
from test_torch_predictor import write_checkpoint
from test_torch_trainer import tiny_volume
from volume_segmantics_tpu.data.dataloaders import (
    _preprocess_slice_lists as jax_preprocess_slice_lists,
)
from volume_segmantics_tpu.data.datasets import get_2d_training_dataset
from volume_segmantics_tpu.models.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from volume_segmantics_tpu_torch.data.dataloaders import _preprocess_slice_lists
from volume_segmantics_tpu_torch.utils import config as cfg
from volume_segmantics_tpu_torch.utils import hdf5

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
IMAGE_SIZE = 32


def settings_text(name, **edits):
    """A shipped settings file as text, with `key: value` lines replaced
    (or appended where the file lacks the key)."""
    text = (ROOT / "volseg-settings" / name).read_text()
    for key, value in edits.items():
        line = f"{key}: {value}"
        text, n = re.subn(rf"(?m)^{key}:.*$", line, text)
        if not n:
            text = text.rstrip("\n") + f"\n{line}\n"
    return text


def write_settings(data_dir, name, **edits):
    folder = data_dir / cfg.SETTINGS_DIR
    folder.mkdir(parents=True, exist_ok=True)
    (folder / name).write_text(settings_text(name, **edits))


def train_edits(**more):
    return dict(image_size=IMAGE_SIZE, num_cyc_frozen=1, num_cyc_unfrozen=1,
                batch_size=4, compute_dtype="float32", seed=3, **more)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two training pairs of different shapes, no side IMAGE_SIZE: one
    written by h5py (uint8, chunks=True, gzip), one by the port (uint16
    data, labels 0 and 3, so the slicer relabels them)."""
    folder = tmp_path_factory.mktemp("volumes")
    d0, l0 = tiny_volume(0, (12, 40, 48))
    d1, l1 = tiny_volume(1, (10, 36, 30))
    with h5py.File(folder / "d0.h5", "w") as f:
        f.create_dataset("/data", data=d0, chunks=True, compression="gzip")
    with h5py.File(folder / "l0.h5", "w") as f:
        f["/data"] = l0
    hdf5.write(folder / "d1.h5", d1.astype(np.uint16) * 257, chunks=(5, 9, 10))
    hdf5.write(folder / "l1.h5", l1 * 3)
    return folder


def train_argv(volumes, data_dir, pairs=(0, 1)):
    return (["--data"] + [str(volumes / f"d{i}.h5") for i in pairs]
            + ["--labels"] + [str(volumes / f"l{i}.h5") for i in pairs]
            + ["--data_dir", str(data_dir)])


class Handed(Exception):
    """Stops a CLI run at the trainer, carrying what it was handed."""


@pytest.mark.parametrize("slice_to_disk", [None, False], ids=["absent", "false"])
def test_train_cli_hands_the_trainer_the_jax_cli_stacks(
        volumes, tmp_path, monkeypatch, slice_to_disk):
    """With `slice_to_disk` absent the JAX CLI writes PNG slices and reads
    them back (`get_2d_training_dataset(...).stacked_arrays()`); with it
    false it preprocesses the slicer's lists. The port keeps the slices in
    memory and must hand its trainer the same stacks in the same order."""
    edits = train_edits() if slice_to_disk is None else train_edits(
        slice_to_disk=slice_to_disk)
    runs = {}
    for name, module in (("ours", train), ("jax", jax_train)):
        data_dir = tmp_path / name
        write_settings(data_dir, cfg.TRAIN_SETTINGS_FN, **edits)

        def record(data, labels, codes, settings, device=None, name=name):
            if name == "ours":
                stacks = _preprocess_slice_lists(data, labels, settings.image_size)
            elif isinstance(data, Path):
                stacks = get_2d_training_dataset(data, labels,
                                                 settings).stacked_arrays()
            else:
                stacks = jax_preprocess_slice_lists(data, labels, settings)
            raise Handed(stacks, codes)

        monkeypatch.setattr(module, "VolSeg2dTrainer", record)
        argv = train_argv(volumes, data_dir)
        with pytest.raises(Handed) as handed:
            if name == "ours":
                module.main(argv, device="cpu")
            else:
                monkeypatch.setattr(sys, "argv", ["model-train-2d", *argv])
                module.main()
        runs[name] = handed.value.args
    (images, masks), codes = runs["ours"]
    (ref_images, ref_masks), ref_codes = runs["jax"]
    assert images.shape == (12 + 40 + 48 + 10 + 36 + 30, IMAGE_SIZE, IMAGE_SIZE)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(masks, ref_masks)
    assert codes == ref_codes == {"0": "label_val_0", "1": "label_val_1"}
    # The two routes really order the slices differently: z, y, x in memory.
    settings = train.get_settings_data(
        tmp_path / "ours" / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN, "training")
    settings.slice_to_disk = False
    z_y_x = _preprocess_slice_lists(
        *train._slice_all_volumes([volumes / "d0.h5"], [volumes / "l0.h5"],
                                  settings)[0], IMAGE_SIZE)[0]
    assert (slice_to_disk is False) == np.array_equal(z_y_x, images[:100])


def test_train_cli_writes_the_csv_and_a_checkpoint_jax_loads(
        volumes, tmp_path, monkeypatch):
    # A short LR sweep keeps the CPU run small (the card runs the full one).
    monkeypatch.setattr(cfg, "MIN_LR_FIND_STEPS", 6)
    write_settings(tmp_path, cfg.TRAIN_SETTINGS_FN,
                   **train_edits(training_axes="Z"))
    train.main(train_argv(volumes, tmp_path, pairs=(0,)), device="cpu")
    ckpt = train._model_output_path(
        train.get_settings_data(tmp_path / cfg.SETTINGS_DIR
                                / cfg.TRAIN_SETTINGS_FN, "training"), tmp_path)
    assert ckpt.exists() and ckpt.name.endswith("_U_Net_trained_2d_model.pytorch")
    with open(tmp_path / f"{ckpt.stem}_train_stats.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Epoch", "Train Loss", "Valid Loss", "Eval Score"]
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    ref = jax_load_checkpoint(ckpt)
    assert ref["label_codes"] == {"0": "label_val_0", "1": "label_val_1"}
    assert ref["model_struc_dict"]["classes"] == 2
    assert ref["model_struc_dict"]["type"].name == "U_NET"


def run_jax_predict(argv):
    saved = sys.argv
    sys.argv = ["model-predict-2d", *argv]
    try:
        jax_predict.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("model_type,encoder", [
    pytest.param("U_Net_Plus_Plus", "resnet34", id="U_Net_Plus_Plus"),
    pytest.param("U_Net", "efficientnet-b3", id="U_Net-efficientnet-b3"),
])
def test_train_then_predict_cli_round_trip(volumes, tmp_path, monkeypatch,
                                           model_type, encoder):
    """`model-train-2d` with another decoder in the shipped file's
    `model: type:`, or another `encoder_name:`, then `model-predict-2d` on
    its checkpoint: a dated checkpoint named by the type, which the JAX
    package loads as that type and encoder, and labels equal to the JAX
    CLI's from the same file on >= 99.9% of voxels (the near-tie rule of
    test_torch_predictor.py)."""
    monkeypatch.setattr(cfg, "MIN_LR_FIND_STEPS", 6)
    write_settings(tmp_path, cfg.TRAIN_SETTINGS_FN,
                   **train_edits(training_axes="Z"))
    path = tmp_path / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN
    text = path.read_text()
    assert 'type: "U_Net"' in text and 'encoder_name: "resnet34"' in text
    path.write_text(text.replace('type: "U_Net"', f'type: "{model_type}"')
                    .replace('encoder_name: "resnet34"',
                             f'encoder_name: "{encoder}"'))
    train.main(train_argv(volumes, tmp_path, pairs=(0,)), device="cpu")
    ckpt = train._model_output_path(
        train.get_settings_data(path, "training"), tmp_path)
    assert ckpt.name.endswith(f"_{model_type}_trained_2d_model.pytorch")
    assert (tmp_path / f"{ckpt.stem}_train_stats.csv").exists()
    ref = jax_load_checkpoint(ckpt)
    assert ref["model_struc_dict"]["type"].name == model_type.upper()
    assert ref["model_struc_dict"]["encoder_name"] == encoder

    labels = {}
    for name in ("ours", "jax"):
        write_settings(tmp_path / name, cfg.PREDICTION_SETTINGS_FN,
                       compute_dtype="float32", prediction_batch_size=4,
                       data_parallel=False)
        argv = [str(ckpt), str(volumes / "d0.h5"), "--data_dir",
                str(tmp_path / name)]
        if name == "ours":
            predict.main(argv, device="cpu")
        else:
            run_jax_predict(argv)
        labels[name] = hdf5.read(predict.create_output_path(
            tmp_path / name, volumes / "d0.h5"))[0]
    assert labels["ours"].shape == (12, 40, 48)
    assert (labels["ours"] != labels["jax"]).mean() <= 1e-3


@pytest.fixture(scope="module")
def prediction_runs(tmp_path_factory):
    """The port's and the JAX package's `model-predict-2d` on one float32
    volume (h5py, chunked), from a checkpoint the port wrote, each writing
    into its own data dir; returns their two dirs and the volume."""
    folder = tmp_path_factory.mktemp("predict")
    ckpt = write_checkpoint(folder / "model.pytorch", 2)
    vol = np.random.default_rng(4).normal(100.0, 30.0, (6, 40, 24)).astype(np.float32)
    with h5py.File(folder / "vol.h5", "w") as f:
        f.create_dataset("/data", data=vol, chunks=(3, 20, 24), compression="gzip")
    edits = dict(output_probs=True, compute_dtype="float32",
                 prediction_batch_size=4, data_parallel=False)
    argv = {}
    for name in ("ours", "jax"):
        write_settings(folder / name, cfg.PREDICTION_SETTINGS_FN, **edits)
        argv[name] = [str(ckpt), str(folder / "vol.h5"), "--data_dir",
                      str(folder / name)]
    predict.main(argv["ours"], device="cpu")
    run_jax_predict(argv["jax"])
    return folder / "ours", folder / "jax", vol


def outputs(data_dir):
    path = predict.create_output_path(data_dir, Path("vol.h5"))
    return path, path.with_name(f"{path.stem}_probs.h5")


def test_predict_cli_equals_the_jax_cli_at_every_voxel(prediction_runs):
    ours_dir, jax_dir, vol = prediction_runs
    (labels_path, probs_path), (ref_labels_path, ref_probs_path) = (
        outputs(ours_dir), outputs(jax_dir))
    labels, chunks = hdf5.read(labels_path)
    ref_labels, ref_chunks = hdf5.read(ref_labels_path)
    assert labels.dtype == ref_labels.dtype == np.uint8
    assert labels.shape == vol.shape
    assert chunks == ref_chunks == (3, 20, 24)
    np.testing.assert_array_equal(labels, ref_labels)
    assert 0.05 < labels.mean() < 0.95  # both classes take a real share
    probs, _ = hdf5.read(probs_path)
    ref_probs, _ = hdf5.read(ref_probs_path)
    assert probs.dtype == ref_probs.dtype == np.float16
    step = np.spacing(np.maximum(probs, ref_probs))
    assert (np.abs(probs.astype(np.float32) - ref_probs) <= step).all()


def test_predict_cli_files_read_alike_through_h5py(prediction_runs):
    """What the port wrote reads through h5py as the JAX output does:
    gzip level 4 at /data, the input's chunking."""
    for data_dir in prediction_runs[:2]:
        for path in outputs(data_dir):
            with h5py.File(path, "r") as f:
                ds = f["/data"]
                assert (ds.compression, ds.compression_opts) == ("gzip", 4)
                assert ds.chunks == (3, 20, 24)
                np.testing.assert_array_equal(ds[()], hdf5.read(path)[0])


@pytest.mark.parametrize("module", [train, predict], ids=["train", "predict"])
def test_main_defaults_to_the_gpu_and_raises_without_one(
        module, volumes, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if module is train:
        write_settings(tmp_path, cfg.TRAIN_SETTINGS_FN, **train_edits())
        argv = train_argv(volumes, tmp_path, pairs=(1,))
    else:
        write_settings(tmp_path, cfg.PREDICTION_SETTINGS_FN)
        ckpt = write_checkpoint(tmp_path / "m.pytorch", 2)
        argv = [str(ckpt), str(volumes / "d1.h5"), "--data_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="No CUDA device"):
        module.main(argv)


def test_native_jax_checkpoints_raise_naming_the_roadmap(volumes, tmp_path):
    """`model-predict-2d` takes a JAX package `VSTPU1` model file, under
    `.vstpu` as the JAX CLI does, and predicts with it as from the same
    weights in the port's torch format; what the port's msgpack reader
    does not take (here a float8 leaf) raises naming ROADMAP."""
    import jax.numpy as jnp
    from flax import serialization

    from volume_segmantics_tpu_torch.models.checkpoint import (
        MAGIC,
        load_checkpoint,
    )
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )

    torch_file = write_checkpoint(tmp_path / "m.pytorch", 2)
    ckpt = load_checkpoint(torch_file)
    struc = dict(ckpt["model_struc_dict"], type="U_NET")
    blob = {"model_state_dict": variables_from_smp_state_dict(
                ckpt["model_state_dict"], struc),
            "model_struc_dict": struc, "optimizer_state_dict": {},
            "loss_val": 1.0, "label_codes": {}}
    (tmp_path / "m.vstpu").write_bytes(MAGIC + serialization.msgpack_serialize(blob))
    write_settings(tmp_path, cfg.PREDICTION_SETTINGS_FN, compute_dtype="float32",
                   prediction_batch_size=4)
    outs = {}
    for name in ("m.pytorch", "m.vstpu"):
        predict.main([str(tmp_path / name), str(volumes / "d1.h5"),
                      "--data_dir", str(tmp_path)], device="cpu")
        outs[name] = hdf5.read(predict.create_output_path(
            tmp_path, volumes / "d1.h5"))[0]
    np.testing.assert_array_equal(outs["m.vstpu"], outs["m.pytorch"])
    blob["model_state_dict"]["params"]["head_conv"]["bias"] = np.zeros(
        2, jnp.float8_e4m3fn)
    (tmp_path / "m.vstpu").write_bytes(MAGIC + serialization.msgpack_serialize(blob))
    with pytest.raises(NotImplementedError, match="float8_e4m3fn.*ROADMAP"):
        predict.main([str(tmp_path / "m.vstpu"), str(volumes / "d1.h5"),
                      "--data_dir", str(tmp_path)], device="cpu")


@pytest.mark.parametrize("script,argv,message", [
    ("train_2d_model", ["--data", "missing.h5", "--labels", "l.h5"],
     "does not appear to exist"),
    ("predict_2d_model", ["model.txt", "d.h5"], "Wrong filetype"),
])
def test_module_entry_points_exit_2_on_bad_arguments(tmp_path, script, argv,
                                                     message):
    (tmp_path / "l.h5").write_bytes(b"")
    (tmp_path / "d.h5").write_bytes(b"")
    (tmp_path / "model.txt").write_bytes(b"")
    r = subprocess.run(
        [sys.executable, "-m", f"volume_segmantics_tpu_torch.scripts.{script}",
         *argv], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 2, r.stderr[-2000:]
    assert message in r.stderr


def test_tiff_volumes_through_both_clis_equal_jax(volumes, prediction_runs,
                                                 tmp_path, monkeypatch):
    """`model-train-2d` on a TIFF pair (Deflate with predictor 2, and an
    uncompressed BigTIFF) hands its trainer the JAX CLI's stacks;
    `model-predict-2d` on `prediction_runs`' float32 volume as LZW TIFF
    gives the JAX CLI's labels of its HDF5 file at every voxel. (`chip_smoke.py`'s formats phase trains on such a pair to
    the end on the card, figures included.)"""
    d0 = hdf5.read(volumes / "d0.h5")[0]
    l0 = hdf5.read(volumes / "l0.h5")[0]
    write_tiff(tmp_path / "d0.tif", d0, compression="deflate", predictor=2)
    write_tiff(tmp_path / "l0.tiff", l0, bigtiff=True)
    argv = ["--data", str(tmp_path / "d0.tif"), "--labels",
            str(tmp_path / "l0.tiff")]
    runs = {}
    for name, module in (("ours", train), ("jax", jax_train)):
        data_dir = tmp_path / name
        write_settings(data_dir, cfg.TRAIN_SETTINGS_FN,
                       **train_edits(slice_to_disk=False))

        def record(data, labels, codes, settings, device=None, name=name):
            prep = (_preprocess_slice_lists(data, labels, settings.image_size)
                    if name == "ours" else
                    jax_preprocess_slice_lists(data, labels, settings))
            raise Handed(prep)

        with monkeypatch.context() as m:
            m.setattr(module, "VolSeg2dTrainer", record)
            with pytest.raises(Handed) as handed:
                if name == "ours":
                    module.main(argv + ["--data_dir", str(data_dir)], device="cpu")
                else:
                    m.setattr(sys, "argv", ["model-train-2d", *argv,
                                            "--data_dir", str(data_dir)])
                    module.main()
        runs[name] = handed.value.args[0]
    for got, ref in zip(runs["ours"], runs["jax"]):
        assert got.shape == (12 + 40 + 48, IMAGE_SIZE, IMAGE_SIZE)
        np.testing.assert_array_equal(got, ref)

    ours_dir, jax_dir, vol = prediction_runs
    write_tiff(tmp_path / "vol.tif", vol, compression="lzw")
    write_settings(tmp_path / "predict", cfg.PREDICTION_SETTINGS_FN,
                   compute_dtype="float32", prediction_batch_size=4)
    predict.main([str(ours_dir.parent / "model.pytorch"), str(tmp_path / "vol.tif"),
                  "--data_dir", str(tmp_path / "predict")], device="cpu")
    labels = hdf5.read(predict.create_output_path(tmp_path / "predict",
                                                  Path("vol.tif")))[0]
    np.testing.assert_array_equal(labels, hdf5.read(outputs(jax_dir)[0])[0])
