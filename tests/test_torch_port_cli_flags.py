"""The port's CLIs take the JAX CLIs' remaining flags, and its batch
iterators take ``transform=``, on the CPU.

- ``--profile-dir`` on the train CLI writes one Chrome trace of
  ``torch.profiler`` holding the window's steps, ``[start + 2, start + 2 +
  --profile-steps)`` as the JAX CLI's window, each a named range; without
  the flag nothing is written.
- ``--gpu-ids`` is ignored and ``--cpu-workers`` accepted, as the JAX CLIs
  treat them; ``--compilation-cache-dir`` roots the kernels' build cache,
  ``auto`` and ``$PROBNMN_COMPILATION_CACHE`` resolved as the JAX package
  resolves its XLA cache (``InferenceEngine(compilation_cache_dir=)``:
  tests/test_torch_port_serve_cli.py);
  ``--num-devices`` passes the flag check on the train, evaluate,
  inference and serve CLIs, and the train CLI's ``--model-parallel`` lays
  the ranks out as a (data x model) grid
  (tests/test_torch_port_mesh.py and
  tests/test_torch_port_mesh_semisupervised.py train and evaluate at 2
  ranks, tests/test_torch_port_mesh_model.py trains at 2 x 2;
  tests/test_torch_port_serving_cards.py serves over 2 cards).
- ``BatchIterator(transform=)`` and ``EpochIterator(transform=)`` give the
  JAX package's iterators' batches.
"""
import json
import os

import numpy as np
import pytest
import torch

from probnmn_tpu.data.datasets import QuestionCodingDataset as JaxQuestionCodingDataset
from probnmn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from probnmn_tpu.data.pipeline import EpochIterator as JaxEpochIterator
from probnmn_tpu.data.samplers import (
    SupervisionWeightedRandomSampler as JaxSupervisionWeightedRandomSampler,
)
from probnmn_tpu_torch import evaluate, inference, serve, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator, EpochIterator
from probnmn_tpu_torch.data.samplers import SupervisionWeightedRandomSampler
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.utils import cli_flags, compilation_cache

from tests.clevr_fixtures import build_fixture_data, make_fixture_config


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_flags"))
    build_fixture_data(root)
    config = make_fixture_config(root, "program_prior")
    path = os.path.join(root, "program_prior.yml")
    config.dump(path)
    return {"root": root, "config_path": path, "config": config}


@pytest.fixture
def build_dir(monkeypatch):
    r"""Restores the kernels' build directory after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("PROBNMN_COMPILATION_CACHE", raising=False)


def _train_args(fixture, out, *extra):
    return train.parser.parse_args([
        "--phase", "program_prior", "--config-yml", fixture["config_path"],
        "--config-override", "OPTIM.NUM_ITERATIONS", "5", "--device", "cpu",
        "--serialization-dir", out, "--checkpoint-every", "5", "--num-val-batches", "1",
        *extra])


def test_profile_dir_traces_the_window_and_nothing_without_it(fixture, tmp_path):
    trace_dir = str(tmp_path / "trace")
    train.main(_train_args(fixture, str(tmp_path / "run"), "--profile-dir", trace_dir,
                           "--profile-steps", "2"))
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(trace_dir, files[0])) as f:
        names = {event.get("name") for event in json.load(f)["traceEvents"]}
    steps = sorted(n for n in names if isinstance(n, str) and n.startswith("train_step_"))
    assert steps == ["train_step_2", "train_step_3"]
    assert any(isinstance(n, str) and n.startswith("aten::") for n in names)
    train.main(_train_args(fixture, str(tmp_path / "plain")))
    assert sorted(os.listdir(tmp_path)) == ["plain", "run", "trace"]


def test_shared_flags_are_taken_as_the_jax_clis_take_them(fixture, tmp_path, build_dir):
    cache = str(tmp_path / "kernels")
    out = str(tmp_path / "run")
    train.main(_train_args(fixture, out, "--gpu-ids", "0", "1", "--cpu-workers", "4",
                           "--num-devices", "1", "--model-parallel", "1",
                           "--compilation-cache-dir", cache))
    assert str(_build.BUILD_DIR) == cache and os.path.isdir(cache)
    assert os.path.exists(os.path.join(out, "checkpoint_4.ckpt"))
    metrics = evaluate.main(evaluate.parser.parse_args([
        "--phase", "program_prior", "--config-yml", fixture["config_path"], "--checkpoint-path",
        os.path.join(out, "checkpoint_4.ckpt"), "--device", "cpu", "--num-val-batches", "1",
        "--gpu-ids", "3", "--cpu-workers", "2", "--num-devices", "1",
        "--compilation-cache-dir", cache]))
    assert np.isfinite(metrics["program_prior"]["perplexity"])
    # train and evaluate take several devices in every phase, inference and
    # serve shard each batch over several: the flag check passes.
    for module, argv in (
            (train, ["--phase", "question_coding", "--config-yml", fixture["config_path"]]),
            (evaluate, ["--phase", "program_prior", "--config-yml", fixture["config_path"],
                        "--checkpoint-path", "x.ckpt"]),
            (inference, ["--config-yml", fixture["config_path"], "--checkpoint-path", "x.ckpt"]),
            (serve, ["--config-yml", fixture["config_path"], "--checkpoint", "x.ckpt"])):
        args = module.parser.parse_args(argv + ["--num-devices", "2"])
        assert cli_flags.apply_shared_flags(args) is None and args.num_devices == 2
        if module is not serve:
            assert module.parser.parse_args(argv).num_devices == 1
    # --model-parallel 4 over 4 devices: one data index of 4 model ranks.
    args = _train_args(fixture, out, "--num-devices", "4", "--model-parallel", "4")
    assert cli_flags.apply_shared_flags(args) is None and args.model_parallel == 4
    assert train.world_of(args, Config(fixture["config_path"])) == (1, 4)
    assert serve.parser.parse_args(["--config-yml", "c", "--checkpoint", "x"]).num_devices is None


def test_compilation_cache_resolves_as_the_jax_package(tmp_path, monkeypatch, build_dir):
    from probnmn_tpu.utils import compilation_cache as jax_cache

    assert compilation_cache.resolve_cache_dir(str(tmp_path / "a")) == str(tmp_path / "a")
    monkeypatch.setenv("PROBNMN_COMPILATION_CACHE", str(tmp_path / "env"))
    assert compilation_cache.resolve_cache_dir("auto") == str(tmp_path / "env")
    assert compilation_cache.resolve_cache_dir(None) == str(tmp_path / "env")
    monkeypatch.delenv("PROBNMN_COMPILATION_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    auto = compilation_cache.resolve_cache_dir("auto")
    assert auto == str(tmp_path / "home" / ".cache" / "probnmn_tpu_torch" / "kernels")
    # The JAX package's default sits beside it under the same ~/.cache.
    assert os.path.dirname(os.path.dirname(auto)) == os.path.dirname(os.path.dirname(
        os.path.abspath(os.path.expanduser(jax_cache._DEFAULT_DIR))))
    assert not os.path.exists(auto)
    path = cli_flags.apply_shared_flags(train.parser.parse_args(
        ["--phase", "program_prior", "--config-yml", "c", "--compilation-cache-dir", "auto"]))
    assert path == auto and os.path.isdir(auto) and _build.BUILD_DIR == type(_build.BUILD_DIR)(auto)


def test_transform_matches_the_jax_iterators(fixture):
    path = fixture["config"].DATA.TRAIN_TOKENS

    def transform(batch):
        batch = dict(batch)
        batch["question"] = batch["question"][:, ::-1].copy()
        batch["supervision"] = 1 - batch["supervision"]
        return batch

    np.random.seed(0)
    port_set = QuestionCodingDataset(path, num_supervision=12)
    np.random.seed(0)
    jax_set = JaxQuestionCodingDataset(path, num_supervision=12)
    port = iter(BatchIterator(port_set, SupervisionWeightedRandomSampler(
        port_set.get_supervision_list(), seed=3), 8, device="cpu",
        sort_descending_by="supervision", transform=transform))
    want = iter(JaxBatchIterator(jax_set, JaxSupervisionWeightedRandomSampler(
        jax_set.get_supervision_list(), seed=3), 8, transform=transform, device_put=False,
        sort_descending_by="supervision"))
    for _ in range(6):
        got, ref = next(port), next(want)
        assert got["_num_supervision"] == ref["_num_supervision"]
        for key in ("question", "program", "supervision"):
            assert isinstance(got[key], torch.Tensor)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    got = list(EpochIterator(port_set, 8, device="cpu", include_last=True, transform=transform))
    ref = list(JaxEpochIterator(jax_set, 8, transform=transform, device_put=False,
                                include_last=True))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["question"].numpy(), np.asarray(r["question"]))
