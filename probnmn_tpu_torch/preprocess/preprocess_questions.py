r"""
Tokenize CLEVR questions, programs and answers into a padded H5 file
(counterpart of ``scripts/preprocess/preprocess_questions.py``; reference
``scripts/preprocess/preprocess_questions.py``): programs in prefix notation
(pre-order traversal of the ``inputs`` tree), each dataset zero-padded to its
split's longest row; int64 datasets ``questions``, ``programs``, ``answers``
and ``image_indices``, attr ``split``. The test split has no programs or
answers.

    python -m probnmn_tpu_torch.preprocess.preprocess_questions \
        -c data/CLEVR_train_questions.json -v data/clevr_vocabulary \
        -o data/clevr_train_tokens.h5 -s train
"""
import argparse
import json
import logging

import numpy as np

from probnmn_tpu_torch.data.preprocessing import program_prefix_ids, tokenize_questions
from probnmn_tpu_torch.data.vocabulary import Vocabulary

parser = argparse.ArgumentParser(description="Tokenize CLEVR annotations (PyTorch port).")
parser.add_argument("-c", "--clevr-jsonpath", default="data/CLEVR_train_questions.json")
parser.add_argument("-v", "--vocab-dirpath", default="data/vocabulary")
parser.add_argument("-o", "--output-h5path", default="data/clevr_train_tokens.h5")
parser.add_argument("-s", "--split", default="train", choices=["train", "val", "test"])


def main(args):
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger(__name__)
    logger.info("Loading annotations json from %s...", args.clevr_jsonpath)
    with open(args.clevr_jsonpath) as f:
        clevr_json = json.load(f)["questions"]
    vocabulary = Vocabulary.from_files(args.vocab_dirpath)

    image_indices = np.asarray([item["image_index"] for item in clevr_json], np.int64)
    ids, lengths = tokenize_questions([item["question"] for item in clevr_json], vocabulary,
                                      max_len=128)
    questions = ids[:, : int(lengths.max())].astype(np.int64)
    if args.split != "test":
        program_rows = [program_prefix_ids(item["program"], vocabulary) for item in clevr_json]
        programs = np.zeros((len(program_rows), max(len(p) for p in program_rows)), np.int64)
        for i, row in enumerate(program_rows):
            programs[i, : len(row)] = row
        answers = np.asarray(
            [vocabulary.get_token_index(item["answer"], "answers") for item in clevr_json],
            np.int64)

    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is needed to write the tokens H5 file") from e
    with h5py.File(args.output_h5path, "w") as output_h5:
        output_h5["image_indices"] = image_indices
        output_h5["questions"] = questions
        if args.split != "test":
            output_h5["programs"] = programs
            output_h5["answers"] = answers
        output_h5.attrs["split"] = args.split
    logger.info("Wrote tokenized data to %s", args.output_h5path)


if __name__ == "__main__":
    main(parser.parse_args())
