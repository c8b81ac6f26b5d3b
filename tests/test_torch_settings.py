"""The PyTorch port's `get_settings_data` against the JAX package's, for
the shipped files and for dicts: the same attributes, the same
`SettingsError` text and the same exit(1) cases."""

import logging
import shutil
from pathlib import Path

import pytest
import yaml

from volume_segmantics_tpu.data.settings_data import (
    SettingsError as JaxSettingsError,
)
from volume_segmantics_tpu.data.settings_data import (
    get_settings_data as jax_get_settings_data,
)
from volume_segmantics_tpu_torch.data import (
    PredictionSettings,
    SettingsError,
    TrainingSettings,
    get_settings_data,
)

ROOT = Path(__file__).resolve().parents[1]
FILES = {"training": ROOT / "volseg-settings" / "2d_model_train_settings.yaml",
         "prediction": ROOT / "volseg-settings" / "2d_model_predict_settings.yaml"}


def attributes(settings):
    return {k: v for k, v in vars(settings).items() if k != "_source"}


@pytest.mark.parametrize("name,kind", [(n, k) for n in FILES for k in (None, n)])
def test_shipped_files_give_the_same_attributes(name, kind):
    for path in (FILES[name], str(FILES[name])):
        ours, ref = get_settings_data(path, kind), jax_get_settings_data(path, kind)
        assert attributes(ours) == attributes(ref)
        assert type(ours).__name__ == type(ref).__name__
    if name == "training" and kind:
        assert ours.starting_lr == 1e-6 and isinstance(ours.starting_lr, float)
        assert isinstance(ours, TrainingSettings)


def test_dicts_and_none_give_the_same_attributes():
    mapping = yaml.safe_load(FILES["prediction"].read_text())
    mapping["extra_key"] = [1, 2]
    for kind in (None, "prediction"):
        ours = get_settings_data(dict(mapping), kind)
        ref = jax_get_settings_data(dict(mapping), kind)
        assert attributes(ours) == attributes(ref)
    assert isinstance(get_settings_data(dict(mapping), "prediction"),
                      PredictionSettings)
    assert vars(get_settings_data(None)) == vars(jax_get_settings_data(None)) == {}


BAD_DICTS = {
    "missing": dict(quality=None, one_hot=None),
    "wrong_types": dict(clip_data="yes please", cuda_device=1.5,
                        st_dev_factor="wide"),
    "bool_for_int": dict(cuda_device=True),
}


@pytest.mark.parametrize("case", list(BAD_DICTS))
def test_invalid_dicts_raise_the_same_settings_error(case):
    mapping = yaml.safe_load(FILES["prediction"].read_text())
    for key, value in BAD_DICTS[case].items():
        if value is None:
            del mapping[key]
        else:
            mapping[key] = value
    with pytest.raises(SettingsError) as ours:
        get_settings_data(dict(mapping), "prediction")
    with pytest.raises(JaxSettingsError) as ref:
        jax_get_settings_data(dict(mapping), "prediction")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="kind must be one of"):
        get_settings_data({}, "other")


def test_missing_attribute_message_names_the_source():
    ours = get_settings_data(FILES["prediction"], "prediction")
    ref = jax_get_settings_data(FILES["prediction"], "prediction")
    with pytest.raises(AttributeError) as a:
        ours.no_such_key
    with pytest.raises(AttributeError) as b:
        ref.no_such_key
    assert str(a.value) == str(b.value)


def test_exit_1_for_a_missing_or_invalid_file(tmp_path, caplog):
    cases = {"missing": tmp_path / "absent.yaml"}
    bad = tmp_path / "bad.yaml"
    shutil.copy(FILES["training"], bad)
    bad.write_text(bad.read_text().replace("image_size: 256", "image_size: big"))
    cases["invalid"] = bad
    for name, path in cases.items():
        logs = []
        for loader in (get_settings_data, jax_get_settings_data):
            caplog.clear()
            with caplog.at_level(logging.ERROR):
                with pytest.raises(SystemExit) as exc:
                    loader(path, "training")
            assert exc.value.code == 1, name
            logs.append([r.getMessage() for r in caplog.records
                         if r.levelno >= logging.ERROR])
        assert logs[0] == logs[1] and logs[0], name
