"""The port engine's host staging (InferenceEngine._stage): float32
features cast to bfloat16 on the host match ``np.asarray(x, ml_dtypes.bfloat16)``,
what the JAX engine's staging buffer holds, bit for bit on random values,
rounding ties, subnormals, overflow and +-inf. A NaN of either sign stays a
NaN, with the bits of PyTorch's host cast (``ml_dtypes`` writes the quiet NaN
of its sign; no answer depends on a NaN's bits). A float32 engine stages the features
unchanged, and a padded staging buffer's pad rows are zero even where its
memory held an earlier, fuller batch."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.serving import InferenceEngine
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary


def _bits_ml_dtypes(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, ml_dtypes.bfloat16).view(np.uint16)


def _engine(compute_dtype):
    vocab = make_clevr_like_vocabulary()
    pg_spec = program_generator.make_spec(vocab)
    nmn_spec = nmn.make_spec(vocab)
    for k, v in dict(feature_channels=12, height=6, width=6, module_channels=8,
                     class_projection_channels=16, classifier_linear_size=10).items():
        setattr(nmn_spec, k, v)
    gen = torch.Generator().manual_seed(0)
    pg_spec = dataclasses.replace(pg_spec, input_size=16, hidden_size=16)
    pg = program_generator.init_params(gen, pg_spec)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    return InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params, batch_size=16,
                           device="cpu", compute_dtype=compute_dtype)


@pytest.fixture(scope="module")
def engine():
    return _engine("bfloat16")


def _bits_port(engine, x: np.ndarray) -> np.ndarray:
    r"""``x`` staged by ``engine`` as the features of one batch; its bits."""
    size = 12 * 6 * 6
    rows = -(-x.size // size)
    feats = np.zeros(rows * size, np.float32)
    feats[:x.size] = x.reshape(-1)
    q = np.ones((rows, 3), np.int64)
    _, images = engine._stage([q], [feats.reshape(rows, 12, 6, 6)], rows)
    assert images.dtype == torch.bfloat16
    return images.view(torch.int16).numpy().view(np.uint16).reshape(-1)[:x.size].reshape(x.shape)


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


EDGES = {
    "ties to even": _from_bits([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF, 0x3F807FFF]),
    "subnormals": np.concatenate([_from_bits([0x00000001, 0x80000001, 0x00008000, 0x00018000,
                                              0x007FFFFF, 0x807FFFFF, 0x00007FFF]),
                                  np.float32([1e-40, -1e-40, 1e-45, 1.17e-38])]),
    "overflow and infinities": np.float32([3.4e38, -3.4e38, 3.39e38, np.inf, -np.inf, 0.0,
                                           -0.0, 65504.0]),
}
NAN = {"NaN of either sign": _from_bits([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                                         0x7FFFFFFF, 0x7FA00000])}


@pytest.mark.parametrize("name", sorted(EDGES) + sorted(NAN))
def test_host_cast_matches_ml_dtypes_on_edges(engine, name):
    if name in EDGES:
        x = EDGES[name]
        np.testing.assert_array_equal(_bits_port(engine, x), _bits_ml_dtypes(x))
        return
    # NaN bits follow PyTorch's host cast (0xFFFF from its vectorized x86 cast),
    # not ml_dtypes' quiet NaN of each sign: every NaN stays a NaN.
    x = NAN[name]
    bits = _bits_port(engine, x)
    assert ((bits & 0x7F80) == 0x7F80).all() and ((bits & 0x007F) != 0).all(), bits
    np.testing.assert_array_equal(
        bits, torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_host_cast_matches_ml_dtypes_on_random_values(engine, scale):
    rs = np.random.RandomState(int(scale * 1000) % 97)
    x = (rs.randn(4, 12, 6, 6) * scale).astype(np.float32)
    np.testing.assert_array_equal(_bits_port(engine, x), _bits_ml_dtypes(x))


def test_host_cast_keeps_float32():
    x = np.random.RandomState(0).randn(3, 12, 6, 6).astype(np.float32)
    _, images = _engine("float32")._stage([np.ones((3, 5), np.int64)], [x], 4)
    assert images.dtype == torch.float32
    np.testing.assert_array_equal(images[:3].numpy(), x)
    assert not images[3:].any()


def test_staging_buffer_pad_rows_are_zero(engine):
    rs = np.random.RandomState(1)
    q = rs.randint(4, 40, (16, 9)).astype(np.int64)
    im = rs.randn(16, 12, 6, 6).astype(np.float32)
    full_q, full_im = engine._stage([q], [im], 16)
    assert full_im.dtype == torch.bfloat16
    np.testing.assert_array_equal(full_q.numpy(), q)
    np.testing.assert_array_equal(full_im.view(torch.int16).numpy().view(np.uint16),
                                  _bits_ml_dtypes(im))
    del full_q, full_im  # its memory may come back for the next batch
    # Two groups of 3 and 2 into a buffer of 16: written in order, the rest zero.
    part_q, part_im = engine._stage([q[:3], q[5:7]], [im[:3], im[5:7]], 16)
    np.testing.assert_array_equal(part_q[:5].numpy(), np.concatenate([q[:3], q[5:7]]))
    np.testing.assert_array_equal(part_im[:5].view(torch.int16).numpy().view(np.uint16),
                                  _bits_ml_dtypes(np.concatenate([im[:3], im[5:7]])))
    assert not part_q[5:].any() and not part_im[5:].float().any()


def test_staging_refuses_malformed_groups_before_writing(engine):
    rs = np.random.RandomState(2)
    q = rs.randint(4, 40, (2, 9)).astype(np.int64)
    im = rs.randn(2, 12, 6, 6).astype(np.float32)
    with pytest.raises(ValueError, match="question tokens"):
        engine._stage([q, np.full((1, 9), 10 ** 6)], [im, im[:1]], 4)
    with pytest.raises(ValueError, match="images"):
        engine._stage([q], [im[:, :, :5]], 4)
    with pytest.raises(ValueError, match="do not fit"):
        engine._stage([q, q, q], [im, im, im], 4)
