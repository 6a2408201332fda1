r"""
Build an AllenNLP-format vocabulary directory from the CLEVR v1.0 train
annotations JSON (counterpart of ``scripts/preprocess/build_vocabulary.py``;
reference ``scripts/preprocess/build_vocabulary.py``): three namespaces
(questions, programs, answers), special tokens at indices 0..3 of the padded
namespaces, answers non-padded with @@UNKNOWN@@ last.

    python -m probnmn_tpu_torch.preprocess.build_vocabulary \
        -c data/CLEVR_train_questions.json -o data/clevr_vocabulary
"""
import argparse
import json
import logging

from probnmn_tpu_torch.data.preprocessing import build_vocabulary

parser = argparse.ArgumentParser(description="Build the CLEVR vocabulary (PyTorch port).")
parser.add_argument(
    "-c", "--clevr-jsonpath", default="data/CLEVR_train_questions.json",
    help="Path to CLEVR v1.0 train annotation json file.",
)
parser.add_argument(
    "-o", "--output-dirpath", default="data/clevr_vocabulary",
    help="Path to a directory to save the vocabulary.",
)


def main(args):
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger(__name__)
    logger.info("Loading annotations json from %s...", args.clevr_jsonpath)
    with open(args.clevr_jsonpath) as f:
        clevr_json = json.load(f)["questions"]

    vocabulary = build_vocabulary(clevr_json)
    for namespace in ("questions", "programs", "answers"):
        logger.info("%s vocabulary size: %d", namespace, vocabulary.get_vocab_size(namespace))
    vocabulary.save_to_files(args.output_dirpath)
    logger.info("Wrote vocabulary to %s", args.output_dirpath)


if __name__ == "__main__":
    main(parser.parse_args())
