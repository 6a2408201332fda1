r"""
AllenNLP-compatible vocabulary with three namespaces: "questions", "programs", "answers".

Reproduces the behavioral contract of ``allennlp.data.Vocabulary`` as used by the
reference (``probnmn/models/*.py``, ``scripts/preprocess/build_vocabulary.py``):

- On-disk format: a directory with one ``<namespace>.txt`` file per namespace (one token
  per line) and a ``non_padded_namespaces.txt`` file. For *padded* namespaces the file
  starts at index 1 (``@@UNKNOWN@@`` is the first line); ``@@PADDING@@`` is implicit at
  index 0. For *non-padded* namespaces (here: "answers") tokens start at index 0 and
  there is no padding/unknown handling (the reference appends ``@@UNKNOWN@@`` as the
  last answer token explicitly).
- ``@@PADDING@@``, ``@@UNKNOWN@@``, ``@start@``, ``@end@`` occupy indices 0..3 of every
  padded namespace (reference ``seq2seq_base.py:61-65``).
"""
from __future__ import annotations

import os
from typing import Dict, List

PADDING_TOKEN = "@@PADDING@@"
UNKNOWN_TOKEN = "@@UNKNOWN@@"
START_TOKEN = "@start@"
END_TOKEN = "@end@"

SPECIAL_TOKENS: List[str] = [PADDING_TOKEN, UNKNOWN_TOKEN, START_TOKEN, END_TOKEN]

_NON_PADDED_FILE = "non_padded_namespaces.txt"


class Vocabulary:
    r"""Token <-> index mappings for a set of namespaces.

    Parameters
    ----------
    tokens_by_namespace: Dict[str, List[str]]
        Full token lists per namespace, *including* any special tokens, in index order.
    non_padded_namespaces: List[str]
        Namespaces whose index 0 is a real token (no implicit padding).
    """

    def __init__(
        self,
        tokens_by_namespace: Dict[str, List[str]],
        non_padded_namespaces: List[str] = ["answers"],
    ):
        self._non_padded = set(non_padded_namespaces)
        self._index_to_token: Dict[str, List[str]] = {}
        self._token_to_index: Dict[str, Dict[str, int]] = {}
        for namespace, tokens in tokens_by_namespace.items():
            self._index_to_token[namespace] = list(tokens)
            self._token_to_index[namespace] = {tok: i for i, tok in enumerate(tokens)}

    # ------------------------------------------------------------------ constructors ----
    @classmethod
    def from_files(cls, directory: str) -> "Vocabulary":
        r"""Load from an AllenNLP-format vocabulary directory."""
        non_padded: List[str] = []
        non_padded_path = os.path.join(directory, _NON_PADDED_FILE)
        if os.path.exists(non_padded_path):
            with open(non_padded_path) as f:
                non_padded = [line.strip() for line in f if line.strip()]

        tokens_by_namespace: Dict[str, List[str]] = {}
        for fname in sorted(os.listdir(directory)):
            if fname == _NON_PADDED_FILE or not fname.endswith(".txt"):
                continue
            namespace = fname[: -len(".txt")]
            with open(os.path.join(directory, fname)) as f:
                tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
            if namespace not in non_padded:
                # @@PADDING@@ is implicit at index 0 for padded namespaces.
                tokens = [PADDING_TOKEN] + tokens
            tokens_by_namespace[namespace] = tokens
        return cls(tokens_by_namespace, non_padded)

    def save_to_files(self, directory: str) -> None:
        r"""Write the AllenNLP-format vocabulary directory."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, _NON_PADDED_FILE), "w") as f:
            f.write("\n".join(sorted(self._non_padded)))
        for namespace, tokens in self._index_to_token.items():
            start = 0 if namespace in self._non_padded else 1  # skip implicit padding
            with open(os.path.join(directory, f"{namespace}.txt"), "w") as f:
                for token in tokens[start:]:
                    f.write(token + "\n")

    # ------------------------------------------------------------------ lookups ---------
    def get_token_index(self, token: str, namespace: str) -> int:
        mapping = self._token_to_index[namespace]
        if token in mapping:
            return mapping[token]
        if UNKNOWN_TOKEN in mapping:
            return mapping[UNKNOWN_TOKEN]
        raise KeyError(f"Token {token!r} not in non-padded namespace {namespace!r}")

    def get_token_from_index(self, index: int, namespace: str) -> str:
        return self._index_to_token[namespace][index]

    def get_vocab_size(self, namespace: str) -> int:
        return len(self._index_to_token[namespace])

    def get_index_to_token_vocabulary(self, namespace: str) -> Dict[int, str]:
        return {i: tok for i, tok in enumerate(self._index_to_token[namespace])}

    def get_token_to_index_vocabulary(self, namespace: str) -> Dict[str, int]:
        return dict(self._token_to_index[namespace])

    @property
    def namespaces(self) -> List[str]:
        return list(self._index_to_token.keys())

    def is_padded(self, namespace: str) -> bool:
        return namespace not in self._non_padded
