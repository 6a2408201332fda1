"""K6's weight-gradient stage in the port, in float32 on the CPU.

``weight_grad_plain`` (what ``weight_grad_kernel`` runs for CPU tensors, and
what the CUDA kernels are held against on the card) takes a workspace of
(input, g_z) entries, each tagged with its target and dilation, to dw3 (S3,
9, C, C) and dwc (Sc, 2, C, C):

- against the JAX package: per target, the sum over its entries of
  ``jax.vjp`` of ``probnmn_tpu/ops/gconv.py::conv3x3`` (``conv1x1`` for
  compare's two halves) with respect to the weight, at each entry's
  dilation (1, 2, 4, 8), within 1e-5 of the sum of |products|;
- on skewed tags (one target with 128 entries, some with one, several with
  none, unwritten entries between), against float64 sums: empty targets
  exactly 0;
- two calls give the same bits;
- ``weight_grad_plan``'s work list: every entry lands in exactly one chunk of
  its target, chunks keep the entries' (example, step) order, a target's
  chunks and partial slots are consecutive, and the chunking depends on the
  entries alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.ops import gconv as jgconv
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    WEIGHT_GRAD_CHUNKS,
    WEIGHT_GRAD_MIN_CHUNK,
    weight_grad_chunk,
    weight_grad_kernel,
    weight_grad_plain,
    weight_grad_plan,
)

# float32 sums of the same products in another order than JAX's (or a
# float64 sum): the error is a few ulps of the sum of |products|.
TOL = 1e-5


def _workspace(rs, tags, s3, sc, h, w, c):
    r"""Random entries for these tags: 3x3 entries at dilations 1, 2, 4, 8,
    1x1 entries (compare's halves, tags s3 ..) at dilation 0."""
    n_targets = s3 + 2 * sc
    tags = np.asarray(tags, np.int32)
    dil = np.where(tags < s3, rs.choice([1, 2, 4, 8], tags.size), 0).astype(np.int32)
    dil[tags >= n_targets] = 0
    inp = rs.randn(tags.size, h * w, c).astype(np.float32)
    g = rs.randn(tags.size, h * w, c).astype(np.float32)
    return inp, g, tags, dil


def _torch(inp, g, tags, dil):
    return (torch.from_numpy(inp), torch.from_numpy(g), torch.from_numpy(tags),
            torch.from_numpy(dil))


def _float64(inp, g, tags, dil, s3, sc, h, w):
    r"""dw (S3 + 2 Sc, 9, C, C) and the sum of |products| there, in float64."""
    n_targets, c = s3 + 2 * sc, inp.shape[-1]
    want = np.zeros((n_targets, 9, c, c))
    scale = np.zeros_like(want)
    x = np.pad(inp.astype(np.float64).reshape(-1, h, w, c), ((0, 0), (8, 8), (8, 8), (0, 0)))
    gz = g.astype(np.float64).reshape(-1, h, w, c)
    for e, t in enumerate(tags):
        if t >= n_targets:
            continue
        d = int(dil[e])
        shifts = [(0, 0, 0)] if d == 0 else [(k, (k // 3 - 1) * d, (k % 3 - 1) * d) for k in range(9)]
        for tap, dy, dx in shifts:
            xs = x[e, 8 + dy:8 + dy + h, 8 + dx:8 + dx + w]
            want[t, tap] += np.einsum("hwi,hwo->io", xs, gz[e])
            scale[t, tap] += np.einsum("hwi,hwo->io", np.abs(xs), np.abs(gz[e]))
    return want, scale


def _split(dw, s3, sc):
    c = dw.shape[-1]
    return dw[:s3], dw[s3:, 0].reshape(sc, 2, c, c)


def _rel_err(got, want, scale):
    r"""Per target: max |got - want| over the largest sum of |products| there."""
    err = np.abs(np.asarray(got, np.float64) - want).reshape(len(want), -1).max(1)
    top = scale.reshape(len(scale), -1).max(1)
    return float((err / np.maximum(top, 1e-300)).max())


@pytest.mark.parametrize("h, w", [(6, 6), (10, 10), (5, 7)])
def test_weight_grad_plain_matches_jax_vjp(h, w):
    s3, sc, c = 4, 1, 8
    rs = np.random.RandomState(h * 31 + w)
    tags = np.concatenate([rs.randint(0, s3 + 2 * sc, 24), [s3 + 2 * sc] * 3])
    rs.shuffle(tags)
    inp, g, tags, dil = _workspace(rs, tags, s3, sc, h, w, c)
    dw3, dwc = weight_grad_plain(*_torch(inp, g, tags, dil), s3, sc, h, w)

    # JAX: the weight's cotangent of each target's convs, one vjp per
    # (target, dilation) over its entries (a batch sums their products).
    want = np.zeros((s3 + 2 * sc, 9, c, c), np.float32)
    w3 = jnp.zeros((3, 3, c, c), jnp.float32)
    w1 = jnp.zeros((c, c), jnp.float32)
    bias = jnp.zeros((c,), jnp.float32)
    for t in range(s3 + 2 * sc):
        for d in np.unique(dil[tags == t]):
            rows = (tags == t) & (dil == d)
            x = jnp.asarray(inp[rows].reshape(-1, h, w, c))
            gz = jnp.asarray(g[rows].reshape(-1, h, w, c))
            if t < s3:
                _, vjp = jax.vjp(lambda k: jgconv.conv3x3(x, k, bias, dilation=int(d)), w3)
                want[t] += np.asarray(vjp(gz)[0]).reshape(9, c, c)
            else:
                _, vjp = jax.vjp(lambda k: jgconv.conv1x1(x, k, bias), w1)
                want[t, 0] += np.asarray(vjp(gz)[0])
    _, scale = _float64(inp, g, tags, dil, s3, sc, h, w)
    want3, wantc = _split(want, s3, sc)
    scale3, scalec = _split(scale, s3, sc)
    assert _rel_err(dw3.numpy(), want3, scale3) <= TOL
    assert _rel_err(dwc.numpy().reshape(2 * sc, 1, c, c), wantc.reshape(2 * sc, 1, c, c),
                    scalec.reshape(2 * sc, 1, c, c)) <= TOL


def test_weight_grad_skewed_tags():
    r"""One target with 128 entries (eight chunks, summed by the second
    pass), targets with one entry, targets with none, unwritten entries
    between them: within TOL of float64 sums, and empty targets exactly 0."""
    s3, sc, h, w, c = 7, 2, 6, 6, 8
    n_targets = s3 + 2 * sc
    tags = [2] * 128 + [0, 5, s3 + 1, s3 + 3] + [n_targets] * 6
    rs = np.random.RandomState(11)
    rs.shuffle(tags)
    inp, g, tags, dil = _workspace(rs, tags, s3, sc, h, w, c)
    plan = weight_grad_plan(torch.from_numpy(tags), n_targets)
    assert int(plan["target_chunks"][2]) == 128 // plan["chunk"] > 1
    dw3, dwc = weight_grad_plain(*_torch(inp, g, tags, dil), s3, sc, h, w)
    want, scale = _float64(inp, g, tags, dil, s3, sc, h, w)
    got = np.concatenate([dw3.numpy(), np.pad(dwc.numpy().reshape(2 * sc, 1, c, c),
                                              ((0, 0), (0, 8), (0, 0), (0, 0)))])
    assert _rel_err(got, want, scale) <= TOL
    for t in sorted(set(range(n_targets)) - set(tags.tolist())):
        assert not got[t].any(), t  # exactly 0.0, not merely small
    assert dw3.dtype == dwc.dtype == torch.float32
    assert dw3.shape == (s3, 9, c, c) and dwc.shape == (sc, 2, c, c)


def test_weight_grad_is_deterministic():
    s3, sc, h, w, c = 5, 1, 6, 6, 8
    rs = np.random.RandomState(5)
    tags = rs.choice(s3 + 2 * sc + 1, 90, p=[0.5, 0.2, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03])
    ws = _torch(*_workspace(rs, tags, s3, sc, h, w, c))
    first = weight_grad_plain(*ws, s3, sc, h, w)
    again = weight_grad_kernel(*ws, s3, sc, h, w)  # a CPU workspace runs the plain version
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_weight_grad_chunk_depends_on_the_entry_count_alone():
    assert weight_grad_chunk(1) == WEIGHT_GRAD_MIN_CHUNK
    assert weight_grad_chunk(WEIGHT_GRAD_MIN_CHUNK * WEIGHT_GRAD_CHUNKS) == WEIGHT_GRAD_MIN_CHUNK
    assert weight_grad_chunk(1891) == 30 and weight_grad_chunk(3781) == 60
    for n in (1, 100, 1891, 3781, 10000):
        assert n // weight_grad_chunk(n) <= WEIGHT_GRAD_CHUNKS


@pytest.mark.parametrize("case", ["uniform", "skewed", "one_target", "sparse"])
def test_weight_grad_plan_work_list(case):
    r"""Every entry with a real tag in exactly one chunk of its target, the
    chunks in (example, step) order; a target's chunks and slots
    consecutive; the bounds on chunks and slots hold; and the same tags,
    relabelled or with other values on unwritten entries, give chunks of
    the same size."""
    rs = np.random.RandomState(["uniform", "skewed", "one_target", "sparse"].index(case))
    n_targets = 13
    if case == "uniform":
        tags = rs.randint(0, n_targets, 500)
    elif case == "skewed":
        tags = rs.choice(n_targets, 700, p=rs.dirichlet(np.full(n_targets, 0.2)))
    elif case == "one_target":
        tags = np.full(300, 4)
    else:
        tags = np.where(rs.rand(200) < 0.7, n_targets, rs.randint(0, n_targets, 200))
    tags = tags.astype(np.int32)
    plan = weight_grad_plan(torch.from_numpy(tags), n_targets)
    chunk, n_chunks = plan["chunk"], plan["n_chunks"]
    assert chunk == weight_grad_chunk(tags.size)
    order = plan["order"].numpy()
    target, first = plan["chunk_target"].numpy(), plan["chunk_first"].numpy()
    count, slot = plan["chunk_count"].numpy(), plan["chunk_slot"].numpy()
    chunks, target_slot = plan["target_chunks"].numpy(), plan["target_slot"].numpy()
    assert target.shape == (n_chunks,) and n_chunks == tags.size // chunk + min(tags.size, n_targets)

    seen = np.zeros(tags.size, np.int64)
    live = np.flatnonzero(target < n_targets)
    assert (live == np.arange(live.size)).all()  # live chunks first, then only padding
    assert (count[live.size:] == 0).all() and (slot[live.size:] == -1).all()
    slots = []
    for t in range(n_targets):
        mine = np.flatnonzero(target == t)
        assert mine.size == chunks[t] == -(-int((tags == t).sum()) // chunk)
        if mine.size:
            assert (np.diff(mine) == 1).all()  # a target's chunks are consecutive
        entries = np.concatenate([order[first[j]:first[j] + count[j]] for j in mine] or [[]])
        entries = entries.astype(np.int64)
        assert (tags[entries] == t).all()
        assert (np.diff(entries) > 0).all()  # (example, step) order: the order the sweep wrote
        assert entries.size == (tags == t).sum()
        seen[entries] += 1
        assert (count[mine[:-1]] == chunk).all() and (0 < count[mine]).all()
        if mine.size == 1:
            assert slot[mine[0]] == -1  # a target's only chunk is written in place
        elif mine.size:
            assert (slot[mine] == target_slot[t] + np.arange(mine.size)).all()
            slots.extend(slot[mine].tolist())
    assert (seen == (tags < n_targets)).all()  # every real entry in exactly one chunk
    assert sorted(slots) == list(range(len(slots))) and len(slots) <= plan["n_slots"]

    relabelled = np.where(tags < n_targets, (tags + 5) % n_targets, n_targets).astype(np.int32)
    relabelled[tags >= n_targets] = n_targets + 3  # any tag past the targets is no entry
    again = weight_grad_plan(torch.from_numpy(relabelled), n_targets)
    assert again["chunk"] == chunk and again["n_chunks"] == n_chunks
    assert again["n_slots"] == plan["n_slots"]
    assert sorted(again["target_chunks"].tolist()) == sorted(chunks.tolist())
