"""The port's question tokenizer and program preprocessing
(probnmn_tpu_torch/data/preprocessing.py) against the JAX package's on the
same questions and programs: tokenize_question, tokenize_program,
build_vocabulary, and tokenize_questions (ids and lengths) against the JAX
NativeTokenizer through both of its paths, its native library (built from
native/clevr_tokenizer.cpp with g++) and its Python one. The questions
include unknown words, questions longer than max_len and empty strings."""
import shutil

import numpy as np
import pytest

from probnmn_tpu.data import native as jnative
from probnmn_tpu.data import preprocessing as jpre
from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu_torch.data import preprocessing
from probnmn_tpu_torch.data.vocabulary import Vocabulary

from tests.clevr_fixtures import ANSWERS, PROGRAM_TOKENS, QUESTION_WORDS

QUESTIONS = [
    "How many red cubes are there?",
    "Is the big sphere; to the left of the cube, shiny?",
    "What color is it.",
    "weird-token question with OOVWORD?",
    "how many red cube ; is there a sphere left of the same size color shape",
    "",
    "?",
    "   ",
    "what.is,the;color??",
    "a red cube",
]


def _program(entries):
    return [{"function": fn, "inputs": inputs, "value_inputs": values}
            for fn, inputs, values in entries]


PROGRAMS = [
    _program([("scene", [], []), ("filter_color", [0], ["red"]), ("count", [1], [])]),
    _program([("scene", [], []), ("filter_shape", [0], ["cube"]), ("unique", [1], []),
              ("relate", [2], ["left"]), ("scene", [], []), ("filter_color", [4], ["red"]),
              ("intersect", [3, 5], []), ("exist", [6], [])]),
    _program([("scene", [], []), ("filter_color", [0], ["red"]), ("unique", [1], []),
              ("query_shape", [2], []), ("scene", [], []), ("filter_shape", [4], ["cube"]),
              ("unique", [5], []), ("query_shape", [6], []), ("equal_color", [3, 7], [])]),
    _program([("scene", [], []), ("same_size", [0], []), ("filter_size", [1], ["large", "x"]),
              ("count", [2], [])]),  # a token outside the vocabulary, two value inputs
]

TOKENS = {"questions": QUESTION_WORDS, "programs": PROGRAM_TOKENS, "answers": ANSWERS}


@pytest.fixture(scope="module")
def vocabs():
    return (JVocabulary(TOKENS, non_padded_namespaces=["answers"]),
            Vocabulary(TOKENS, non_padded_namespaces=["answers"]))


@pytest.fixture(params=["native", "python"])
def jax_path(request, monkeypatch):
    r"""The JAX tokenizer's path that the port is held to."""
    if request.param == "native":
        if shutil.which("g++") is None:
            pytest.skip("g++ is not installed, so the JAX package's native tokenizer "
                        "cannot be built here")
        assert jnative.get_library() is not None
    else:
        monkeypatch.setattr(jnative, "get_library", lambda: None)
    return request.param


def test_tokenize_question_matches_jax():
    for q in QUESTIONS:
        assert preprocessing.tokenize_question(q) == jpre.tokenize_question(q), q


def test_tokenize_program_matches_jax():
    for program in PROGRAMS:
        assert preprocessing.tokenize_program(program) == jpre.tokenize_program(program)
        assert ([preprocessing.program_token_name(t) for t in program]
                == [jpre.program_token_name(t) for t in program])


def test_build_vocabulary_matches_jax():
    annotations = [{"question": q, "program": p, "answer": a}
                   for q, p, a in zip(QUESTIONS, PROGRAMS * 3, ["yes", "2", "red", "no"] * 3)]
    annotations.append({"question": "Is there a cube?"})  # no program, no answer
    got, want = preprocessing.build_vocabulary(annotations), jpre.build_vocabulary(annotations)
    for namespace in ("questions", "programs", "answers"):
        assert (got.get_index_to_token_vocabulary(namespace)
                == want.get_index_to_token_vocabulary(namespace)), namespace
        for token in ("", "cube", "@@UNKNOWN@@", "OOVWORD"):
            if namespace != "answers" or token in want.get_index_to_token_vocabulary(namespace):
                assert (got.get_token_index(token, namespace)
                        == want.get_token_index(token, namespace)), (namespace, token)


@pytest.mark.parametrize("max_len", [4, 12, 20])
def test_tokenize_questions_matches_jax(vocabs, jax_path, max_len):
    jvocab, vocab = vocabs
    reference = jnative.NativeTokenizer(jvocab, "questions")
    assert reference.native == (jax_path == "native")
    want_ids, want_lengths = reference.tokenize_questions(QUESTIONS, max_len=max_len)
    ids, lengths = preprocessing.tokenize_questions(QUESTIONS, vocab, max_len=max_len)
    assert ids.dtype == want_ids.dtype == np.int32 and ids.shape == (len(QUESTIONS), max_len)
    assert lengths.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(lengths, want_lengths)
    unk = vocab.get_token_index("@@UNKNOWN@@", "questions")
    assert unk in ids[3]                                   # OOVWORD and weird-token
    assert lengths[5] == lengths[6] == lengths[7] == 0     # empty strings
    assert not ids[5:8].any()
    if max_len == 4:
        assert (lengths > max_len).any()                   # over-length rows truncated
