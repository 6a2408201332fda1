"""The PyTorch port stands alone: importing it loads no JAX and nothing of the
JAX package, no source file of it (or chip_smoke.py) imports them, and its
entry points refuse a CUDA device that is not there."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "probnmn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "probnmn_tpu")
# Modules each slice added; the walk below must import every one of them.
SLICE_MODULES = (
    "probnmn_tpu_torch.serving",
    "probnmn_tpu_torch.ops.kernels.seq2seq_decode",
    "probnmn_tpu_torch.ops.kernels.nmn_interpreter",
    "probnmn_tpu_torch.ops.kernels.seq2seq_train",
    "probnmn_tpu_torch.models.program_prior",
    "probnmn_tpu_torch.data.readers",
    "probnmn_tpu_torch.data.samplers",
    "probnmn_tpu_torch.data.datasets",
    "probnmn_tpu_torch.data.pipeline",
    "probnmn_tpu_torch.utils.checkpointing",
    "probnmn_tpu_torch.utils.metrics",
    "probnmn_tpu_torch.utils.observability",
    "probnmn_tpu_torch.training.optim",
    "probnmn_tpu_torch.training._trainer",
    "probnmn_tpu_torch.training.program_prior_trainer",
    "probnmn_tpu_torch.evaluators._evaluator",
    "probnmn_tpu_torch.evaluators.program_prior_evaluator",
    "probnmn_tpu_torch.train",
    "probnmn_tpu_torch.models.question_reconstructor",
    "probnmn_tpu_torch.modules.elbo",
    "probnmn_tpu_torch.training.question_coding_trainer",
    "probnmn_tpu_torch.evaluators.question_coding_evaluator",
    "probnmn_tpu_torch.training.module_training_trainer",
    "probnmn_tpu_torch.evaluators.module_training_evaluator",
    "probnmn_tpu_torch.training.joint_training_trainer",
    "probnmn_tpu_torch.evaluators.joint_training_evaluator",
    "probnmn_tpu_torch.data.mini_clevr",
    "probnmn_tpu_torch.evaluate",
    "probnmn_tpu_torch.mini_clevr_run",
    "probnmn_tpu_torch.interop",
    "probnmn_tpu_torch.utils.msgpack_format",
    "probnmn_tpu_torch.utils.torch_interop",
    "probnmn_tpu_torch.inference",
    "probnmn_tpu_torch.data.preprocessing",
    "probnmn_tpu_torch.serve",
    "probnmn_tpu_torch.models.resnet",
    "probnmn_tpu_torch.preprocess.build_vocabulary",
    "probnmn_tpu_torch.preprocess.preprocess_questions",
    "probnmn_tpu_torch.preprocess.extract_features",
    "probnmn_tpu_torch.utils.compilation_cache",
    "probnmn_tpu_torch.utils.cli_flags",
    "probnmn_tpu_torch.parallel",
    "probnmn_tpu_torch.parallel.mesh",
)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import probnmn_tpu_torch\n"
        "for m in pkgutil.walk_packages(probnmn_tpu_torch.__path__, 'probnmn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {SLICE_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len([k for k in sys.modules if k.startswith('probnmn_tpu_torch')]))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert int(proc.stdout.split()[1]) >= 40  # every submodule was imported


def test_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 40
    offending = {
        str(f.relative_to(REPO)): m
        for f in files for m in _imported_modules(f) if _forbidden(m)
    }
    assert not offending, offending


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from probnmn_tpu_torch.models import nmn, program_generator
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary
    from probnmn_tpu_torch.serving import InferenceEngine

    vocab = make_clevr_like_vocabulary()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(
            vocab, program_generator.make_spec(vocab), nmn.make_spec(vocab), {}, {},
            device="cuda",
        )


def test_cuda_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer

    config = Config(str(REPO / "configs" / "program_prior.yml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProgramPriorTrainer(config, str(tmp_path))


def test_cuda_question_coding_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer

    config = Config(str(REPO / "configs" / "question_coding_ours.yml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuestionCodingTrainer(config, str(tmp_path))


def test_cuda_module_training_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer

    config = Config(str(REPO / "configs" / "module_training.yml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModuleTrainingTrainer(config, str(tmp_path))


def test_cuda_joint_training_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer

    config = Config(str(REPO / "configs" / "joint_training_ours.yml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JointTrainingTrainer(config, str(tmp_path))
