r"""
CLEVR v1.0 public constants: the closed program-function catalog (with value
inputs folded as ``fn[value]``, matching ``scripts/preprocess/build_vocabulary.py``
in the reference) and the 28 answers. Used to build realistic vocabularies for
benchmarks and tests when the real dataset is not on disk.
"""
from __future__ import annotations

from typing import List

from probnmn_tpu_torch.data.vocabulary import SPECIAL_TOKENS, Vocabulary

_COLORS = ["blue", "brown", "cyan", "gray", "green", "purple", "red", "yellow"]
_MATERIALS = ["metal", "rubber"]
_SHAPES = ["cube", "cylinder", "sphere"]
_SIZES = ["large", "small"]
_RELATIONS = ["behind", "front", "left", "right"]

# Public single source of truth for the CLEVR attribute/relation inventories
# (consumed by data/mini_clevr.py's generator + executor; the program/answer
# token catalogs below are derived from the same lists).
CLEVR_ATTRIBUTES = {
    "color": _COLORS,
    "material": _MATERIALS,
    "shape": _SHAPES,
    "size": _SIZES,
}
CLEVR_RELATIONS = list(_RELATIONS)

CLEVR_PROGRAM_FUNCTIONS: List[str] = sorted(
    ["scene", "unique", "count", "exist", "intersect", "union",
     "equal_integer", "less_than", "greater_than"]
    + [f"filter_color[{c}]" for c in _COLORS]
    + [f"filter_material[{m}]" for m in _MATERIALS]
    + [f"filter_shape[{s}]" for s in _SHAPES]
    + [f"filter_size[{s}]" for s in _SIZES]
    + [f"relate[{r}]" for r in _RELATIONS]
    + [f"query_{a}" for a in ("color", "material", "shape", "size")]
    + [f"same_{a}" for a in ("color", "material", "shape", "size")]
    + [f"equal_{a}" for a in ("color", "material", "shape", "size")]
)

CLEVR_ANSWERS: List[str] = sorted(
    [str(i) for i in range(11)] + ["yes", "no"] + _COLORS + _MATERIALS + _SHAPES + _SIZES
)

# A plausible CLEVR question-word inventory (~85 distinct words in the real data).
CLEVR_QUESTION_WORDS: List[str] = sorted(
    set(
        (
            "there is a are any other things that the same as ; what number of "
            "how many objects color material shape size it its does have do "
            "made matte rubber shiny metal metallic big large small tiny block "
            "cube blocks cubes ball sphere spheres balls cylinder cylinders "
            "object thing and or both either behind in front left right side "
            "visible another on fewer more greater less than equal is an "
            "anything else has to least most be them they all which"
        ).split()
    )
    | set(_COLORS)
)

MAX_PROGRAM_LENGTH = 26   # reference program_generator.py:34
MAX_QUESTION_LENGTH = 45  # reference question_reconstructor.py:34


def make_clevr_like_vocabulary() -> Vocabulary:
    r"""A vocabulary with the real CLEVR program/answer token inventory (question
    words approximated) — same namespace sizes as real preprocessed data."""
    return Vocabulary(
        {
            "questions": SPECIAL_TOKENS + CLEVR_QUESTION_WORDS,
            "programs": SPECIAL_TOKENS + CLEVR_PROGRAM_FUNCTIONS,
            "answers": CLEVR_ANSWERS + ["@@UNKNOWN@@"],
        },
        non_padded_namespaces=["answers"],
    )


def sample_clevr_like_programs(vocab: Vocabulary, n: int, seed: int = 0,
                               max_length: int = MAX_PROGRAM_LENGTH):
    r"""``(n, max_length)`` int32 batch of VALID prefix-notation programs with
    realistic CLEVR structure and length mix (filter chains, relates, same-X,
    query/count/exist reductions, equal-X comparisons, intersect/union) —
    the workload a CONVERGED ProgramGenerator emits, as opposed to the mostly-
    invalid token soups a random-init one samples. Used by bench.py's
    valid-program (converged-regime) measurement and perf tests.

    Grammar mirrors the real CLEVR function catalog semantics executed by the
    interpreter (reference ``nmn.py:197-238``): chains are attention->attention
    stacks closed by ``scene``; ``query_*`` (via ``unique``) produces features;
    ``equal_*`` compares two query branches; ``intersect``/``union`` merge two
    attention branches under a reduction."""
    import numpy as np

    rs = np.random.RandomState(seed)
    attn_ops = (
        [f"filter_color[{c}]" for c in _COLORS]
        + [f"filter_material[{m}]" for m in _MATERIALS]
        + [f"filter_shape[{s}]" for s in _SHAPES]
        + [f"filter_size[{s}]" for s in _SIZES]
        + [f"relate[{r}]" for r in _RELATIONS]
        + [f"same_{a}" for a in ("color", "material", "shape", "size")]
    )
    queries = [f"query_{a}" for a in ("color", "material", "shape", "size")]
    equals = [f"equal_{a}" for a in ("color", "material", "shape", "size")]

    def chain(depth):
        return [rs.choice(attn_ops) for _ in range(depth)] + ["scene"]

    def query_branch(depth):
        return [rs.choice(queries), "unique"] + chain(depth)

    def program():
        kind = rs.rand()
        if kind < 0.35:    # count/exist over one chain
            toks = [rs.choice(["count", "exist"])] + chain(rs.randint(2, 9))
        elif kind < 0.60:  # attribute query
            toks = query_branch(rs.randint(2, 9))
        elif kind < 0.80:  # comparison of two query branches
            toks = [rs.choice(equals)] + query_branch(rs.randint(2, 6)) \
                + query_branch(rs.randint(2, 6))
        else:              # set op of two chains under a reduction
            toks = [rs.choice(["count", "exist"]), rs.choice(["intersect", "union"])] \
                + chain(rs.randint(2, 6)) + chain(rs.randint(2, 6))
        return toks

    if max_length < 4:
        raise ValueError(f"max_length={max_length} cannot hold any valid program")
    out = np.zeros((n, max_length), np.int32)
    for i in range(n):
        # Regenerate rather than truncate: a chopped prefix program would be
        # invalid under the interpreter, silently turning a "converged-regime"
        # workload into the flattering early-abort one.
        toks = program()
        while len(toks) > max_length:
            toks = program()
        ids = [vocab.get_token_index(t, "programs") for t in toks]
        out[i, : len(ids)] = ids
    return out
