"""The port's three preprocessing CLIs (python -m
probnmn_tpu_torch.preprocess.{build_vocabulary,preprocess_questions,
extract_features}) against the JAX package's scripts/preprocess/*.py on a tiny
CLEVR annotations JSON and three tiny PNGs: the same vocabulary files, the
same token H5 datasets and attrs for a train and a test split, and
program_prefix_ids equal to JAX's native.program_prefix_ids on the fixture
programs. The features H5 (images sorted by filename, --device cpu, weights
from a torch.save of a synthesized torchvision state dict) equals the
in-memory extract_features, and without --weights-pth the loud warning is
logged."""
import json
import logging
import os
import runpy
import sys

import h5py
import numpy as np
import pytest
import torch

from probnmn_tpu.data import native as jnative
from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu_torch.data.preprocessing import program_prefix_ids, tokenize_program
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import resnet
from probnmn_tpu_torch.preprocess import build_vocabulary as port_vocab
from probnmn_tpu_torch.preprocess import extract_features as port_extract
from probnmn_tpu_torch.preprocess import preprocess_questions as port_questions

from tests.clevr_fixtures import ANSWERS, PROGRAM_TEMPLATES, PROGRAM_TOKENS, QUESTION_WORDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts", "preprocess")
BINARY = {"intersect", "union", "equal_color"}


def annotation(prefix):
    r"""A prefix-notation program as a CLEVR annotation list: functions in
    post-order, children by ``inputs`` index, ``fn[value]`` split."""
    out, tokens = [], iter(prefix)

    def build():
        token = next(tokens)
        function, _, value = token.partition("[")
        arity = 0 if function == "scene" else 2 if function in BINARY else 1
        inputs = [build() for _ in range(arity)]
        out.append({"function": function, "inputs": inputs,
                    "value_inputs": [value.rstrip("]")] if value else []})
        return len(out) - 1

    build()
    return out


QUESTIONS = [
    ("How many red cubes are there?", 0, "2"),
    ("Is there a cube; left of the red sphere?", 1, "yes"),
    ("What shape is the red thing, left of the cube?", 2, "cube"),
    ("how many things are the same size as the red cube", 0, "1"),
]


def _annotations(split):
    items = []
    for i, (question, image_index, answer) in enumerate(QUESTIONS):
        item = {"question": question, "image_index": image_index}
        if split != "test":
            item["program"] = annotation(PROGRAM_TEMPLATES[(1, 3, 5, 6)[i]])
            item["answer"] = answer
        items.append(item)
    return {"questions": items}


def _run_jax_script(name, monkeypatch, *argv):
    path = os.path.join(JAX_SCRIPTS, name)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")


@pytest.fixture
def train_json(tmp_path):
    path = tmp_path / "CLEVR_train_questions.json"
    path.write_text(json.dumps(_annotations("train")))
    return str(path)


@pytest.mark.parametrize("prefix", PROGRAM_TEMPLATES, ids=lambda p: p[0])
def test_program_prefix_ids_match_the_jax_native_path(prefix):
    tokens = {"questions": QUESTION_WORDS, "programs": PROGRAM_TOKENS, "answers": ANSWERS}
    program = annotation(prefix)
    assert tokenize_program(program) == prefix
    jax_ids = jnative.program_prefix_ids(
        program, JVocabulary(tokens, non_padded_namespaces=["answers"]))
    ids = program_prefix_ids(program, Vocabulary(tokens, non_padded_namespaces=["answers"]))
    assert ids.dtype == np.int32 and np.array_equal(ids, jax_ids)
    assert len(program_prefix_ids([], Vocabulary(tokens, non_padded_namespaces=["answers"]))) == 0


def test_vocabulary_files_are_identical(tmp_path, train_json, monkeypatch):
    jax_dir, port_dir = str(tmp_path / "jax_vocab"), str(tmp_path / "port_vocab")
    _run_jax_script("build_vocabulary.py", monkeypatch, "-c", train_json, "-o", jax_dir)
    port_vocab.main(port_vocab.parser.parse_args(["-c", train_json, "-o", port_dir]))
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert {"questions.txt", "programs.txt", "answers.txt"} <= set(names)
    for name in names:
        with open(os.path.join(jax_dir, name), "rb") as a, open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("split", ["train", "test"])
def test_token_h5_is_identical(tmp_path, train_json, monkeypatch, split):
    vocab_dir = str(tmp_path / "vocab")
    port_vocab.main(port_vocab.parser.parse_args(["-c", train_json, "-o", vocab_dir]))
    split_json = tmp_path / f"CLEVR_{split}_questions.json"
    split_json.write_text(json.dumps(_annotations(split)))
    jax_h5, port_h5 = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    argv = ["-c", str(split_json), "-v", vocab_dir, "-s", split]
    _run_jax_script("preprocess_questions.py", monkeypatch, *argv, "-o", jax_h5)
    port_questions.main(port_questions.parser.parse_args([*argv, "-o", port_h5]))
    with h5py.File(jax_h5, "r") as a, h5py.File(port_h5, "r") as b:
        assert dict(a.attrs) == dict(b.attrs) == {"split": split}
        assert sorted(a.keys()) == sorted(b.keys())
        want = {"image_indices", "questions"} | ({"programs", "answers"} if split != "test" else set())
        assert set(b.keys()) == want
        for key in a.keys():
            assert b[key].dtype == np.int64 and a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key][()], b[key][()]), key


def _write_pngs(directory):
    from PIL import Image

    os.makedirs(directory)
    rs = np.random.RandomState(5)
    for name, (w, h) in (("c.png", (48, 32)), ("a.png", (30, 20)), ("b.png", (40, 40))):
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(directory, name))


def test_features_h5_equals_in_memory_extraction(tmp_path, caplog):
    image_dir = str(tmp_path / "images")
    _write_pngs(image_dir)
    state = resnet.synthetic_torchvision_state_dict(torch.Generator().manual_seed(6))
    weights = str(tmp_path / "resnet101.pth")
    torch.save(state, weights)
    out_h5 = str(tmp_path / "features.h5")
    with caplog.at_level(logging.WARNING):
        port_extract.main(port_extract.parser.parse_args([
            "-i", image_dir, "-o", out_h5, "-s", "val", "-b", "2", "--weights-pth", weights,
            "--device", "cpu"]))
    assert "RANDOM weights" not in caplog.text

    model = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    images = np.stack([port_extract.load_image(os.path.join(image_dir, n))
                       for n in ("a.png", "b.png", "c.png")])
    want = port_extract.extract_features(model, images, batch_size=2, device="cpu")
    with h5py.File(out_h5, "r") as f:
        assert f.attrs["split"] == "val"
        got = f["features"][()]
    assert got.shape == (3, 1024, 14, 14) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_features_without_weights_warn_loudly(tmp_path, caplog):
    image_dir = str(tmp_path / "images")
    _write_pngs(image_dir)
    out_h5 = str(tmp_path / "features.h5")
    with caplog.at_level(logging.WARNING):
        port_extract.main(port_extract.parser.parse_args(
            ["-i", image_dir, "-o", out_h5, "--device", "cpu", "--gpu-ids", "1", "2",
             "--cpu-workers", "4"]))
    assert "NO --weights-pth GIVEN" in caplog.text
    with h5py.File(out_h5, "r") as f:
        assert f.attrs["split"] == "train"
        assert f["features"].shape == (3, 1024, 14, 14)
        assert np.isfinite(f["features"][()]).all()


def test_extract_cli_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    args = port_extract.parser.parse_args(["-i", str(tmp_path), "-o", str(tmp_path / "f.h5")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_extract.main(args)
    assert not os.path.exists(tmp_path / "f.h5")
