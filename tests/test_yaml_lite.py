"""The small YAML reader/writer against PyYAML on every file it must read."""

import glob
import math
import os

import numpy as np
import pytest
import yaml

from eqvio_tpu.io.yaml_lite import YAMLError, safe_dump, safe_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
RESULTS = sorted(os.path.relpath(p, ROOT)
                 for p in glob.glob(os.path.join(ROOT, "results", "**", "*.yaml"), recursive=True))


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS + RESULTS)
def test_repo_files_match_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert same(safe_load(text), yaml.safe_load(text))


def test_generator_outputs_match_pyyaml(tmp_path):
    """Every YAML file the dataset generators and the analysis write."""
    from eqvio_tpu.analysis import analyse_trajectory
    from eqvio_tpu.data import generate_asl_dataset, generate_uzhfpv_dataset

    generate_asl_dataset(str(tmp_path / "asl"), end_time=0.6, width=64, height=48,
                         frame_freq=10.0, num_points=40)
    generate_uzhfpv_dataset(str(tmp_path / "uzh"), end_time=0.6, width=64, height=48,
                            frame_freq=10.0, num_points=40)
    t = np.linspace(0, 2, 40)
    pos = np.stack([np.sin(t), np.cos(t), t], axis=1)
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (40, 1))
    res = analyse_trajectory(t, pos + 0.01, quat, t, pos, quat)
    with open(tmp_path / "results.yaml", "w") as f:
        safe_dump(res, f)
    files = [tmp_path / "asl" / "mav0" / "cam0" / "sensor.yaml",
             tmp_path / "uzh" / "camchain-imucam.yaml", tmp_path / "results.yaml"]
    for path in files:
        text = open(path).read()
        assert same(safe_load(text), yaml.safe_load(text)), path
    assert same(safe_load(open(files[2]).read()), yaml.safe_load(yaml.safe_dump(res)))


VALUES = {
    "ints": [0, -3, 12345],
    "floats": [1.5, -2.0e-05, 1e20, 3.0, float("inf"), float("-inf")],
    "strings": ["plain", "two words", "1.0", "yes", "-3", "", "a: b", "x #y", "it's",
                'say "hi"', "null", "~"],
    "mixed": [True, False, None, "end"],
    "nested": {"T": [[1.0, 0.0], [0.0, 1.0]], "empty_list": [], "empty_map": {}},
    "records": [{"name": "a", "vals": [1, 2]}, {"name": "b", "sub": {"k": 1.25}}],
    "position (m)": {"rmse": 0.0123, "nan": float("nan")},
}


def test_dump_roundtrips_and_pyyaml_agrees():
    text = safe_dump(VALUES)
    assert same(safe_load(text), VALUES)
    assert same(yaml.safe_load(text), VALUES)
    assert same(safe_load(yaml.safe_dump(VALUES)), VALUES)
    assert same(safe_load(yaml.safe_dump(VALUES, default_flow_style=True)), VALUES)


def test_dump_numpy_scalars():
    data = {"f": np.float64(0.25), "i": np.int64(7), "b": np.bool_(True)}
    assert safe_load(safe_dump(data)) == {"f": 0.25, "i": 7, "b": True}


def test_opencv_storage_and_multiline_flow():
    text = ("%YAML:1.0\n---\nK:\n   rows: 3\n   dt: d\n"
            "   data: [ 1., 0., 2.,\n       0., 1., 3. ]\n")
    # PyYAML itself refuses OpenCV's "%YAML:1.0" directive
    assert safe_load(text) == yaml.safe_load(text.split("\n", 1)[1])


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",
    "m: !!opencv-matrix\n  rows: 1\n",
    "s: |\n  block\n",
    "a: 1\n---\nb: 2\n",
    "a: 1\n   b: 2\n",
    "a: [1, 2\n",
    "a: 1\na: 2\n",
])
def test_outside_subset_raises(text):
    with pytest.raises(YAMLError, match="line"):
        safe_load(text)
