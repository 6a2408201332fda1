r"""
CLEVR preprocessing primitives (counterpart of
``probnmn_tpu/data/preprocessing.py``; reference
``scripts/preprocess/{build_vocabulary,preprocess_questions}.py``):

- question tokenization: punctuation split with the reference's exact filters
  ("?", "." dropped; "," and ";" kept as tokens), and a batch of questions
  to padded vocabulary ids (the ids of ``probnmn_tpu/data/native.py``'s
  ``NativeTokenizer``),
- program tokenization: program list -> tree via ``inputs`` indices -> PREFIX
  notation by pre-order traversal, with value inputs folded as ``fn[value]``,
- vocabulary construction over the three namespaces with the reference's
  ordering (sorted unique tokens; answers sorted + @@UNKNOWN@@ last).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from probnmn_tpu_torch.data.vocabulary import SPECIAL_TOKENS, Vocabulary

PUNCTUATIONS: List[str] = ["?", ".", ",", ";"]


def tokenize_question(question: str) -> List[str]:
    for punctuation in PUNCTUATIONS:
        question = question.replace(punctuation, f" {punctuation}")
    return [token for token in question.split(" ") if token not in {"?", ".", ""}]


def tokenize_questions(
    questions: Sequence[str], vocabulary: Vocabulary, max_len: int = 64,
    namespace: str = "questions",
) -> Tuple[np.ndarray, np.ndarray]:
    r"""Returns (ids (n, max_len) int32 zero-padded, lengths (n,) int32); a
    length may exceed ``max_len``, and then its row is truncated."""
    rows = [tokenize_question(q) for q in questions]
    ids = np.zeros((len(rows), max_len), np.int32)
    for i, row in enumerate(rows):
        for j, token in enumerate(row[:max_len]):
            ids[i, j] = vocabulary.get_token_index(token, namespace)
    return ids, np.asarray([len(row) for row in rows], np.int32)


def program_token_name(program_token: Dict[str, Any]) -> str:
    function = program_token["function"]
    if len(program_token["value_inputs"]) > 0:
        function += "[" + ",".join(program_token["value_inputs"]) + "]"
    return function


def tokenize_program(program_list: List[Dict[str, Any]]) -> List[str]:
    r"""CLEVR program list -> prefix notation (pre-order traversal of the tree
    rooted at the LAST program token, children via ``inputs`` indices)."""
    prefix: List[str] = []

    def visit(token: Dict[str, Any]) -> None:
        prefix.append(program_token_name(token))
        for child_index in token["inputs"]:
            visit(program_list[child_index])

    visit(program_list[-1])
    return prefix


def build_vocabulary(clevr_json: List[Dict[str, Any]]) -> Vocabulary:
    r"""Build the 3-namespace vocabulary from CLEVR train annotations."""
    question_tokens: set = set()
    program_tokens: set = set()
    answers: set = set()
    for item in clevr_json:
        sequence = item["question"]
        for punctuation in PUNCTUATIONS:
            sequence = sequence.replace(punctuation, f" {punctuation}")
        # The reference's build_vocabulary.py filters {"?", "."} only, so "" stays a
        # question token (build_vocabulary.py:76).
        question_tokens |= {t for t in sequence.split(" ") if t not in {"?", "."}}
        for program_token in item.get("program", []):
            program_tokens.add(program_token_name(program_token))
        if "answer" in item:
            answers.add(item["answer"])

    return Vocabulary(
        {
            "questions": SPECIAL_TOKENS + sorted(question_tokens),
            "programs": SPECIAL_TOKENS + sorted(program_tokens),
            "answers": sorted(answers) + ["@@UNKNOWN@@"],
        },
        non_padded_namespaces=["answers"],
    )
