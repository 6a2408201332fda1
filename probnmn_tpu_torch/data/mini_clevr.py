r"""
Mini-CLEVR: a small, *learnable* synthetic CLEVR-like task for outcome-level
verification of the full 4-phase training chain (counterpart of
``probnmn_tpu/data/mini_clevr.py``; numpy only).

The real CLEVR v1.0 dataset is not needed: per-step gradient parity alone
cannot prove that the REINFORCE/ELBO *dynamics* (baseline drift, reward
scaling, the supervised/unsupervised interaction over thousands of steps —
reference ``elbo.py``, ``question_coding_trainer.py``,
``joint_training_trainer.py``) actually train a model. This module builds a
task where they demonstrably can:

- **Scenes** are sets of 3-6 objects with CLEVR attributes (8 colors,
  2 materials, 3 shapes, 2 sizes — the real inventories from
  :mod:`probnmn_tpu_torch.utils.clevr`) placed at distinct cells of the
  feature grid. Objects occupy distinct 2x2 pool blocks so count information
  provably survives the classifier's MaxPool2d(2) (reference
  ``nmn.py:75-83``).
- **Features** come from a fixed generative map: channel 0 carries presence,
  channels 1.. carry one-hot attribute blocks at the object's cell, plus small
  Gaussian noise. A stem conv can decode attributes per cell, attention
  modules can filter them, the RelateModule's dilated convs can reach across
  the grid, and the SameModule's argmax-gather cross-correlation can match
  attributes — i.e. every module in the reference zoo
  (reference ``nmn_modules.py``) has a realizable target.
- **Programs** use the real CLEVR function catalog in prefix notation
  (reference ``preprocess_questions.py:51-74``) and are guaranteed valid under
  the interpreter's reversed-prefix register machine
  (reference ``nmn.py:197-238``).
- **Answers** are computed by a ground-truth *symbolic* executor that mirrors
  the register machine exactly (scene save/reset, binary ops over
  (output, saved), unary ops over the current attention).
- **Questions** are rendered from the program by a deterministic, word-wise
  invertible template grammar over the real CLEVR question-word inventory, so
  q(z|x) (ProgramGenerator) and p(x|z) (QuestionReconstructor) both have an
  exact function to learn.

The generator functions are the JAX package's, unchanged: the same seed
gives the same arrays. :func:`make_mini_clevr` returns the train, val and
test splits in memory, as the token ids and features that
:func:`write_mini_clevr` writes in the reference H5/vocab layouts
(reference ``preprocess_questions.py:115-140``, ``build_vocabulary.py:135-149``);
:func:`phase_dataset` builds a phase's dataset from a split.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.utils.clevr import (
    CLEVR_ATTRIBUTES,
    CLEVR_RELATIONS,
    MAX_PROGRAM_LENGTH,
    MAX_QUESTION_LENGTH,
    make_clevr_like_vocabulary,
)

# The single source of truth lives in utils.clevr (the program/answer token
# catalogs are derived from the same lists, so generator, executor, and
# vocabulary can never desynchronize).
ATTRIBUTES: Dict[str, List[str]] = CLEVR_ATTRIBUTES
RELATIONS = CLEVR_RELATIONS

# Feature-map layout of the fixed generative map (presence + one-hot blocks).
FEATURE_CHANNELS = 16
_CH_PRESENCE = 0
_CH_BLOCKS = {"color": 1, "material": 9, "shape": 11, "size": 14}  # block starts


# ===================================================================== scenes
def sample_scene(rs: np.random.RandomState, height: int = 14, width: int = 14,
                 min_objects: int = 3, max_objects: int = 6) -> List[Dict]:
    r"""A list of objects with CLEVR attributes at grid cells. Objects occupy
    distinct 2x2 blocks (``(row//2, col//2)`` unique) so per-object evidence
    survives the classifier's 2x2 max-pool."""
    n = rs.randint(min_objects, max_objects + 1)
    blocks = rs.choice((height // 2) * (width // 2), size=n, replace=False)
    scene = []
    for b in blocks:
        br, bc = divmod(int(b), width // 2)
        row = br * 2 + rs.randint(2)
        col = bc * 2 + rs.randint(2)
        scene.append({
            "row": row, "col": col,
            "color": ATTRIBUTES["color"][rs.randint(8)],
            "material": ATTRIBUTES["material"][rs.randint(2)],
            "shape": ATTRIBUTES["shape"][rs.randint(3)],
            "size": ATTRIBUTES["size"][rs.randint(2)],
        })
    return scene


def render_features(scene: Sequence[Dict], rs: np.random.RandomState,
                    height: int = 14, width: int = 14,
                    noise: float = 0.02) -> np.ndarray:
    r"""The fixed generative map: ``(FEATURE_CHANNELS, H, W)`` float32, NCHW like
    the reference feature H5s (reference ``extract_features.py:119-121``)."""
    feats = (rs.randn(FEATURE_CHANNELS, height, width) * noise).astype(np.float32)
    for obj in scene:
        r, c = obj["row"], obj["col"]
        feats[_CH_PRESENCE, r, c] += 1.0
        for attr, start in _CH_BLOCKS.items():
            feats[start + ATTRIBUTES[attr].index(obj[attr]), r, c] += 1.0
    return feats


def _related(candidate: Dict, anchor: Dict, relation: str) -> bool:
    r"""CLEVR spatial relations on the grid: left/right by column,
    behind/front by row (behind = smaller row)."""
    if relation == "left":
        return candidate["col"] < anchor["col"]
    if relation == "right":
        return candidate["col"] > anchor["col"]
    if relation == "behind":
        return candidate["row"] < anchor["row"]
    if relation == "front":
        return candidate["row"] > anchor["row"]
    raise ValueError(relation)


# ============================================================ symbolic executor
class _Attn:
    __slots__ = ("ids",)

    def __init__(self, ids):
        self.ids = frozenset(ids)


class _Feat:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind = kind     # "count" | "bool" | attribute name
        self.value = value


def execute_program(tokens: Sequence[str], scene: Sequence[Dict]) -> Optional[str]:
    r"""Ground-truth answer for ``tokens`` (prefix notation) over ``scene``,
    or ``None`` when ill-defined under strict semantics.

    Mirrors the interpreter's register machine exactly (reference
    ``nmn.py:197-238``): tokens run in REVERSED order; ``scene`` saves the
    current output and resets it to the full-scene attention; binary tokens
    (intersect/union/equal*/less_than/greater_than) consume
    ``(output, saved)``; unary modules consume the current attention.
    Strictness beyond the neural semantics (used for *generation-time*
    rejection so every emitted answer is unambiguous): relate/same/query
    require exactly one attended object; counts must be <= 10.
    """
    all_ids = frozenset(range(len(scene)))
    output = None   # registers hold _Attn/_Feat/None
    saved = None

    def the_one(attn):
        (i,) = tuple(attn.ids)
        return scene[i]

    for t in reversed(list(tokens)):
        if t in ("@@PADDING@@", "@start@", "@end@", "@@UNKNOWN@@"):
            continue
        if t == "unique":
            if not isinstance(output, _Attn) or len(output.ids) != 1:
                return None
            continue
        if t == "scene":
            saved = output
            output = _Attn(all_ids)
        elif t.startswith("filter_"):
            if not isinstance(output, _Attn):
                return None
            attr, value = t[len("filter_"):].split("[")
            value = value[:-1]
            output = _Attn(i for i in output.ids if scene[i][attr] == value)
        elif t.startswith("relate["):
            if not isinstance(output, _Attn) or len(output.ids) != 1:
                return None
            anchor = the_one(output)
            relation = t[len("relate["):-1]
            output = _Attn(
                i for i in all_ids if _related(scene[i], anchor, relation)
            )
        elif t.startswith("same_"):
            if not isinstance(output, _Attn) or len(output.ids) != 1:
                return None
            (idx,) = tuple(output.ids)
            attr = t[len("same_"):]
            output = _Attn(
                i for i in all_ids - {idx} if scene[i][attr] == scene[idx][attr]
            )
        elif t == "count":
            if not isinstance(output, _Attn):
                return None
            output = _Feat("count", len(output.ids))
        elif t == "exist":
            if not isinstance(output, _Attn):
                return None
            output = _Feat("bool", len(output.ids) > 0)
        elif t.startswith("query_"):
            if not isinstance(output, _Attn) or len(output.ids) != 1:
                return None
            attr = t[len("query_"):]
            output = _Feat(attr, the_one(output)[attr])
        elif t in ("intersect", "union"):
            if not (isinstance(output, _Attn) and isinstance(saved, _Attn)):
                return None
            ids = (output.ids & saved.ids) if t == "intersect" else (output.ids | saved.ids)
            output = _Attn(ids)
        elif t.startswith("equal_") or t in ("less_than", "greater_than"):
            if not (isinstance(output, _Feat) and isinstance(saved, _Feat)):
                return None
            if t == "equal_integer" or t in ("less_than", "greater_than"):
                if output.kind != "count" or saved.kind != "count":
                    return None
                a, b = output.value, saved.value
                result = {"equal_integer": a == b, "less_than": a < b,
                          "greater_than": a > b}[t]
            else:
                attr = t[len("equal_"):]
                if output.kind != attr or saved.kind != attr:
                    return None
                result = output.value == saved.value
            output = _Feat("bool", result)
        else:
            return None

    if not isinstance(output, _Feat):
        return None   # final attention ⇒ invalid (reference nmn.py:231-232)
    if output.kind == "count":
        return str(output.value) if output.value <= 10 else None
    if output.kind == "bool":
        return "yes" if output.value else "no"
    return output.value


# ============================================================ program grammar
def _sample_chain(rs: np.random.RandomState, max_segments: int = 2,
                  max_filters: int = 3) -> List[str]:
    r"""One attention chain in prefix order, ending with ``scene``. Segments of
    1-``max_filters`` filters separated by relate/same hops (each hop requires
    the segment below it to attend exactly one object — enforced by
    generation-time rejection, not here)."""
    def segment():
        attrs = list(ATTRIBUTES)
        rs.shuffle(attrs)
        k = rs.randint(1, max_filters + 1)
        return [
            f"filter_{a}[{ATTRIBUTES[a][rs.randint(len(ATTRIBUTES[a]))]}]"
            for a in attrs[:k]
        ]

    chain = segment()
    for _ in range(rs.randint(0, max_segments)):
        if rs.rand() < 0.5:
            chain.append(f"relate[{RELATIONS[rs.randint(4)]}]")
        else:
            chain.append(f"same_{list(ATTRIBUTES)[rs.randint(4)]}")
        chain.extend(segment())
    chain.append("scene")
    return chain


def sample_program(rs: np.random.RandomState) -> List[str]:
    r"""One program (prefix notation) from the template mix: count/exist over a
    chain, attribute query, attribute-equality of two branches, set ops, and
    integer comparisons of two counts."""
    kind = rs.rand()
    if kind < 0.30:
        return [("count", "exist")[rs.randint(2)]] + _sample_chain(rs)
    if kind < 0.55:
        attr = list(ATTRIBUTES)[rs.randint(4)]
        return [f"query_{attr}", "unique"] + _sample_chain(rs)
    if kind < 0.70:
        attr = list(ATTRIBUTES)[rs.randint(4)]
        return ([f"equal_{attr}", f"query_{attr}", "unique"]
                + _sample_chain(rs, max_segments=1)
                + [f"query_{attr}", "unique"] + _sample_chain(rs, max_segments=1))
    if kind < 0.85:
        return ([("count", "exist")[rs.randint(2)],
                 ("intersect", "union")[rs.randint(2)]]
                + _sample_chain(rs, max_segments=1)
                + _sample_chain(rs, max_segments=1))
    op = ("equal_integer", "less_than", "greater_than")[rs.randint(3)]
    return ([op, "count"] + _sample_chain(rs, max_segments=1)
            + ["count"] + _sample_chain(rs, max_segments=1))


# ============================================================ question grammar
_FILTER_PREFIX = "filter_"


def _describe_chain(chain: Sequence[str]) -> List[str]:
    r"""Deterministic word rendering of a chain (minus the trailing ``scene``):
    filters become their value word (CLEVR attribute values are disjoint across
    attributes, so the mapping is invertible); relate/same become fixed
    delimiter phrases."""
    words: List[str] = []
    for t in chain:
        if t == "scene":
            continue
        if t.startswith(_FILTER_PREFIX):
            words.append(t.split("[")[1][:-1])
        elif t.startswith("relate["):
            words += [t[len("relate["):-1], "of", "the"]
        elif t.startswith("same_"):
            words += ["same", t[len("same_"):], "as", "the"]
        else:
            raise ValueError(f"not a chain token: {t}")
    return words


def _split_chains(tokens: Sequence[str], start: int) -> Tuple[List[str], int]:
    r"""Consume one chain (through its closing ``scene``) from ``tokens[start:]``."""
    for i in range(start, len(tokens)):
        if tokens[i] == "scene":
            return list(tokens[start:i + 1]), i + 1
    raise ValueError("unterminated chain")


def question_for_program(tokens: Sequence[str]) -> List[str]:
    r"""Deterministic question words for a template-grammar program. The
    mapping is a bijection (template type is identified by its frame words;
    chain words are invertible), so both q(z|x) and p(x|z) are exact functions
    a seq2seq can learn."""
    head = tokens[0]
    if head in ("count", "exist") and tokens[1] not in ("intersect", "union"):
        chain, end = _split_chains(tokens, 1)
        assert end == len(tokens)
        frame = ["how", "many"] if head == "count" else ["is", "there", "a"]
        tail = ["are", "there", ";"] if head == "count" else [";"]
        return frame + _describe_chain(chain) + tail
    if head.startswith("query_"):
        assert tokens[1] == "unique"
        chain, end = _split_chains(tokens, 2)
        assert end == len(tokens)
        return (["what", head[len("query_"):], "is", "the"]
                + _describe_chain(chain) + [";"])
    if head.startswith("equal_") and head != "equal_integer":
        attr = head[len("equal_"):]
        assert tokens[1] == f"query_{attr}" and tokens[2] == "unique"
        chain_a, end = _split_chains(tokens, 3)
        assert tokens[end] == f"query_{attr}" and tokens[end + 1] == "unique"
        chain_b, end2 = _split_chains(tokens, end + 2)
        assert end2 == len(tokens)
        return (["is", "the", attr, "of", "the"] + _describe_chain(chain_a)
                + ["the", "same", "as", "the"] + _describe_chain(chain_b) + [";"])
    if head in ("count", "exist") and tokens[1] in ("intersect", "union"):
        chain_a, end = _split_chains(tokens, 2)
        chain_b, end2 = _split_chains(tokens, end)
        assert end2 == len(tokens)
        joiner = "and" if tokens[1] == "intersect" else "or"
        if head == "count":
            return (["how", "many"] + _describe_chain(chain_a) + [joiner]
                    + _describe_chain(chain_b) + ["are", "there", ";"])
        return (["is", "there", "a"] + _describe_chain(chain_a) + [joiner]
                + _describe_chain(chain_b) + [";"])
    if head in ("equal_integer", "less_than", "greater_than"):
        assert tokens[1] == "count"
        chain_a, end = _split_chains(tokens, 2)
        assert tokens[end] == "count"
        chain_b, end2 = _split_chains(tokens, end + 1)
        assert end2 == len(tokens)
        word = {"equal_integer": "equal", "less_than": "less",
                "greater_than": "greater"}[head]
        mid = ["equal", "to"] if head == "equal_integer" else [word, "than"]
        return (["is", "the", "number", "of"] + _describe_chain(chain_a)
                + mid + ["the", "number", "of"] + _describe_chain(chain_b) + [";"])
    raise ValueError(f"unknown template head: {head}")


# =============================================================== generation
def generate_example(rs: np.random.RandomState, scene: Sequence[Dict],
                     max_tries: int = 200) -> Optional[Tuple[List[str], List[str], str]]:
    r"""(program, question_words, answer) for ``scene``, or None. Rejection
    sampling enforces strict well-definedness; binary (yes/no) answers are
    balanced by a coin flip the sample must match, and zero counts (by far the
    most likely outcome of a random filter chain) are kept only ~1/4 of the
    time so the majority-class baseline stays low (bounded tries)."""
    want_bool = "yes" if rs.rand() < 0.5 else "no"
    fallback = None
    for _ in range(max_tries):
        program = sample_program(rs)
        if len(program) > MAX_PROGRAM_LENGTH:
            continue
        answer = execute_program(program, scene)
        if answer is None:
            continue
        question = question_for_program(program)
        if len(question) > MAX_QUESTION_LENGTH:
            continue
        if answer in ("yes", "no") and answer != want_bool:
            fallback = (program, question, answer)
            continue
        if answer == "0" and rs.rand() > 0.25:
            fallback = (program, question, answer)
            continue
        return program, question, answer
    return fallback


def generate_split(seed: int, num_images: int, questions_per_image: int,
                   height: int = 14, width: int = 14):
    r"""Arrays for one split: scenes are sampled fresh per image; every emitted
    example's answer is exact under the ground-truth executor."""
    rs = np.random.RandomState(seed)
    features = np.zeros((num_images, FEATURE_CHANNELS, height, width), np.float32)
    programs: List[List[str]] = []
    questions: List[List[str]] = []
    answers: List[str] = []
    image_indices: List[int] = []
    for img in range(num_images):
        scene = sample_scene(rs, height, width)
        features[img] = render_features(scene, rs, height, width)
        made = 0
        while made < questions_per_image:
            example = generate_example(rs, scene)
            if example is None:
                # Pathological scene: re-roll it AND discard any examples
                # already emitted against the old scene — their answers would
                # otherwise silently refer to the overwritten features.
                scene = sample_scene(rs, height, width)
                features[img] = render_features(scene, rs, height, width)
                del programs[len(programs) - made:]
                del questions[len(questions) - made:]
                del answers[len(answers) - made:]
                del image_indices[len(image_indices) - made:]
                made = 0
                continue
            program, question, answer = example
            programs.append(program)
            questions.append(question)
            answers.append(answer)
            image_indices.append(img)
            made += 1
    return features, programs, questions, answers, np.asarray(image_indices)


# ============================================================ in-memory splits
SPLIT_SEED_OFFSETS = {"train": 0, "val": 1, "test": 2}


@dataclass
class MiniClevrSplit:
    r"""One split as token ids and features: (N, Lp) programs, (N, Lq)
    questions and (N,) answers (int64, each padded to the split's longest
    row), (N,) ``image_indices`` into (M, FEATURE_CHANNELS, H, W) float32
    ``features``. The test split has no programs and no answers."""

    split: str
    programs: Optional[np.ndarray]
    questions: np.ndarray
    answers: Optional[np.ndarray]
    image_indices: np.ndarray
    features: np.ndarray


def make_split(vocab: Vocabulary, split: str, num_images: int, questions_per_image: int = 2,
               seed: int = 0, height: int = 14, width: int = 14) -> MiniClevrSplit:
    r"""The ``split`` of the dataset seeded ``seed`` (its own seed is ``seed``
    plus 0, 1 or 2 for train, val or test), encoded with ``vocab``."""
    feats, programs, questions, answers, image_indices = generate_split(
        seed + SPLIT_SEED_OFFSETS[split], num_images, questions_per_image, height, width
    )
    n = len(programs)
    prog_width = max(len(p) for p in programs)
    q_width = max(len(q) for q in questions)
    prog_ids = np.zeros((n, prog_width), np.int64)
    q_ids = np.zeros((n, q_width), np.int64)
    ans_ids = np.zeros((n,), np.int64)
    for i in range(n):
        for j, t in enumerate(programs[i]):
            prog_ids[i, j] = vocab.get_token_index(t, "programs")
        for j, w in enumerate(questions[i]):
            q_ids[i, j] = vocab.get_token_index(w, "questions")
        ans_ids[i] = vocab.get_token_index(answers[i], "answers")
    assert (prog_ids[:, 0] > 1).all() and (q_ids[:, 0] > 1).all(), \
        "mini-CLEVR must never emit @@UNKNOWN@@/@@PADDING@@ leading tokens"
    test = split == "test"
    return MiniClevrSplit(split, None if test else prog_ids, q_ids, None if test else ans_ids,
                          image_indices, feats)


def make_mini_clevr(n_train_images: int = 3000, n_val_images: int = 750,
                    n_test_images: int = 250, questions_per_image: int = 2, seed: int = 0,
                    height: int = 14, width: int = 14
                    ) -> Tuple[Vocabulary, Dict[str, MiniClevrSplit]]:
    r"""The vocabulary and the train, val and test splits, in memory: the
    arrays :func:`write_mini_clevr` writes with the same arguments."""
    vocab = make_clevr_like_vocabulary()
    splits = {
        split: make_split(vocab, split, n_images, questions_per_image, seed, height, width)
        for split, n_images in (("train", n_train_images), ("val", n_val_images),
                                ("test", n_test_images))
    }
    return vocab, splits


def phase_dataset(split: MiniClevrSplit, phase: str, num_supervision: int = 699989,
                  supervision_question_max_length: int = 40):
    r"""The port's dataset of ``phase`` over ``split``. The question_coding
    and joint_training train sets draw their supervision subset from the
    global numpy seed, as their H5 constructors do: seed it first."""
    from probnmn_tpu_torch.data import datasets

    if phase == "program_prior":
        return datasets.ProgramPriorDataset.from_programs(split.programs, split=split.split)
    if phase == "question_coding":
        return datasets.QuestionCodingDataset.from_tokens(
            split.programs, split.questions, split=split.split, num_supervision=num_supervision,
            supervision_question_max_length=supervision_question_max_length)
    if phase == "module_training":
        return datasets.ModuleTrainingDataset.from_arrays(
            split.programs, split.questions, split.answers, split.image_indices, split.features,
            split=split.split)
    if phase == "joint_training":
        return datasets.JointTrainingDataset.from_arrays(
            split.programs, split.questions, split.answers, split.image_indices, split.features,
            split=split.split, num_supervision=num_supervision,
            supervision_question_max_length=supervision_question_max_length)
    raise ValueError(f"unknown phase {phase!r}")


def write_mini_clevr(root: str, n_train_images: int = 3000,
                     n_val_images: int = 750, n_test_images: int = 250,
                     questions_per_image: int = 2, seed: int = 0,
                     height: int = 14, width: int = 14) -> Vocabulary:
    r"""Write the full mini-CLEVR dataset in the reference's H5/vocab layouts
    (tokens: ``programs/questions/answers/image_indices`` + ``split`` attr,
    reference ``preprocess_questions.py:115-140``; features: ``features``
    dataset, reference ``extract_features.py:119-121``)."""
    import h5py

    os.makedirs(root, exist_ok=True)
    vocab, splits = make_mini_clevr(n_train_images, n_val_images, n_test_images,
                                    questions_per_image, seed, height, width)
    vocab.save_to_files(os.path.join(root, "vocab"))
    for split, data in splits.items():
        with h5py.File(os.path.join(root, f"{split}_tokens.h5"), "w") as f:
            f.attrs["split"] = split
            f.create_dataset("questions", data=data.questions)
            f.create_dataset("image_indices", data=data.image_indices)
            if split != "test":
                f.create_dataset("programs", data=data.programs)
                f.create_dataset("answers", data=data.answers)
        with h5py.File(os.path.join(root, f"{split}_features.h5"), "w") as f:
            f.attrs["split"] = split
            f.create_dataset("features", data=data.features)
    return vocab
