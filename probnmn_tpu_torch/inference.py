r"""
Test-split inference CLI of the PyTorch port (counterpart of
``scripts/inference.py``; reference ``scripts/inference.py``): load the
ProgramGenerator and the NMN from a checkpoint (the port's, the JAX package's
``.ckpt`` or the reference's ``.pth``), decode a program for every test
question (sampling by default, the reference's choice at inference,
``inference.py:80``; or greedy, or beam), run the NMN and write
``{checkpoint stem}_predictions.json`` as ``[{"question_index", "answer"}]``,
one entry for every test row.

    python -m probnmn_tpu_torch.inference --config-yml checkpoints/jt/config.yml \
        --checkpoint-path checkpoints/jt/checkpoint_best.ckpt

``--device`` is ``cuda`` (the default) or ``cpu``. The JAX CLI's
``--gpu-ids``, ``--compilation-cache-dir``, ``--cpu-workers`` and
``--num-devices`` are not ported and raise.
"""
import argparse
import json
import logging
from typing import Dict, List

import numpy as np

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.pipeline import EpochIterator

NOT_PORTED = ("--gpu-ids", "--compilation-cache-dir", "--cpu-workers", "--num-devices")

parser = argparse.ArgumentParser(
    description="Run inference on the CLEVR v1.0 test split with a joint_training checkpoint "
    "(PyTorch/CUDA).")
parser.add_argument("--config-yml", required=True)
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument(
    "--checkpoint-path", required=True,
    help="A checkpoint holding program_generator and nmn: the port's, the JAX package's .ckpt "
    "or the reference's .pth (told apart by content).")
parser.add_argument(
    "--streaming-features", action="store_true",
    help="Stream test-split image features from the H5 file instead of loading it into "
    "host memory.")
parser.add_argument(
    "--decoding-strategy", default="sampling", choices=["sampling", "greedy", "beam"],
    help="'sampling' is the reference's default (reference inference.py:80); 'greedy' and "
    "'beam' are deterministic.")
parser.add_argument("--beam-size", type=int, default=4,
                    help="Beam width with --decoding-strategy beam (1 gives greedy).")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
for _flag in NOT_PORTED:
    parser.add_argument(_flag, nargs="*", default=None, help="Not ported; raises.")


def run_inference(engine, dataset, batch_size: int, output_path: str) -> List[Dict]:
    r"""Answer every row of the test ``dataset`` (``question_index``,
    ``question``, ``image``), ``batch_size`` rows a call, the last batch
    partial; write the predictions JSON to ``output_path`` and return it."""
    predictions = []
    for batch in EpochIterator(dataset, batch_size, device="cpu", include_last=True):
        answers = engine.predict(batch["question"].numpy(), batch["image"].numpy())
        for question_index, answer in zip(batch["question_index"].tolist(), answers):
            predictions.append({"question_index": int(question_index), "answer": answer})
    with open(output_path, "w") as f:
        json.dump(predictions, f)
    return predictions


def main(args):
    r"""Returns the path of the predictions JSON."""
    from probnmn_tpu_torch.data.datasets import JointTrainingDataset
    from probnmn_tpu_torch.serving import InferenceEngine

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    given = [flag for flag in NOT_PORTED if getattr(args, flag[2:].replace("-", "_")) is not None]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: not ported to the PyTorch inference CLI")
    config = Config(args.config_yml, args.config_override)
    np.random.seed(config.RANDOM_SEED)

    dataset = JointTrainingDataset(config.DATA.TEST_TOKENS, config.DATA.TEST_FEATURES,
                                   in_memory=not args.streaming_features)
    engine = InferenceEngine.from_checkpoint(
        config, args.checkpoint_path, decoding=args.decoding_strategy,
        beam_size=args.beam_size, device=args.device)
    output_path = args.checkpoint_path.rsplit(".", 1)[0] + "_predictions.json"
    predictions = run_inference(engine, dataset, config.OPTIM.BATCH_SIZE, output_path)
    logging.getLogger(__name__).info("Wrote %d predictions to %s", len(predictions), output_path)
    return output_path


if __name__ == "__main__":
    main(parser.parse_args())
