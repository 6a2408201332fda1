"""Inter-layer LSTM dropout in the port against the JAX package's, in float32
on the CPU.

The JAX package draws one keep mask per layer below the top with
``jax.random.bernoulli(fold_in(dropout_rng, layer), 1 - p, (B, T, H))``
(``probnmn_tpu/ops/rnn.py::lstm_encode``), ``dropout_rng`` being
``fold_in(rng, 991)`` in ``program_prior_forward(train=True)`` and
``fold_in(rng, 997)`` in ``seq2seq_forward(train=True)``. These tests draw
the same masks from the same keys and hand them to the port as
``dropout_masks``:

- the plain ``lstm_encode`` with masks gives JAX's outputs and final states
  within 1e-5 (padded and all-pad rows, 2 and 3 layers);
- ``fused_lm_loss`` and ``fused_tf_loss`` (both modes) on CPU tensors, the
  plain versions of K3 and K4 with masks, give the ``train=True`` losses
  within 1e-5 and every gradient leaf within 5e-6 of ``jax.grad``
  (tests/test_torch_port_program_prior.py's and
  tests/test_torch_port_question_coding.py's tolerances);
- the two passes of the port's free-running PG (K1's plain version samples
  z, K4's REINFORCE pass scores it) under one mask give JAX's single
  ``seq2seq_forward(..., None, "sampling", rng, train=True)``: the same z,
  the loss within 1e-5, the gradients within 5e-6; a mask drawn anew for the
  second pass misses JAX's loss, and the trainers hand K1 and K4 the same
  mask;
- three program_prior trainer steps with DROPOUT 0.25 on two layers equal
  the JAX trainer's on the masks its keys draw (tests/test_torch_port_training.py's
  tolerances), and the four phases train and evaluate through the CLI with
  DROPOUT on every seq2seq model and the prior and the bfloat16 Adam moment.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import program_prior as jprior
from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.ops import rnn as jrnn
from probnmn_tpu.training.program_prior_trainer import (
    ProgramPriorTrainer as JaxProgramPriorTrainer,
)
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.models import program_prior, seq2seq
from probnmn_tpu_torch.ops import rnn
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import sampling_forward_with_noise
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_lm_loss,
    fused_tf_loss,
    lm_grads_plain,
    tf_grads_plain,
)
from probnmn_tpu_torch.training import program_prior_trainer, question_coding_trainer
from probnmn_tpu_torch.training._trainer import copy_into
from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY, QuestionCodingTrainer
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests.clevr_fixtures import build_fixture_data, make_fixture_config

LOSS_ATOL = 1e-5
GRAD_ATOL = 5e-6
P = 0.3
SIZES = dict(source_vocab_size=30, target_vocab_size=20, input_size=24, hidden_size=32,
             num_layers=3, max_decoding_steps=10, dropout=P)
JSPEC, SPEC = jseq2seq.Seq2SeqSpec(**SIZES), seq2seq.Seq2SeqSpec(**SIZES)
PRIOR_SIZES = dict(vocab_size=40, input_size=24, hidden_size=32, num_layers=3, dropout=P)
JPRIOR, PRIOR = jprior.ProgramPriorSpec(**PRIOR_SIZES), program_prior.ProgramPriorSpec(**PRIOR_SIZES)
BATCH, LS, LT = 9, 12, 10


def jax_masks(dropout_rng, p, num_layers, batch, steps, hidden):
    r"""The keep masks ``probnmn_tpu/ops/rnn.py::lstm_encode`` draws from
    ``dropout_rng``, stacked (L-1, B, T, H), as a bool tensor."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.bernoulli(jax.random.fold_in(dropout_rng, layer), 1.0 - p,
                                        (batch, steps, hidden)))
        for layer in range(num_layers - 1)]))


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def _assert_trees_close(got, want, atol):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_leaves(_to_numpy(got))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"gradient mismatch at {jax.tree_util.keystr(path)}")


def _right_padded(rs, batch, length, vocab):
    tok = rs.randint(4, vocab, (batch, length))
    tok = tok * (np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1)))
    tok[0] = rs.randint(4, vocab, length)  # full length
    tok[1] = 0                             # all padding
    return tok.astype(np.int32)


# ------------------------------------------------------------------ the plain LSTM
@pytest.mark.parametrize("num_layers", [2, 3])
def test_lstm_encode_with_masks_matches_jax(num_layers):
    B, T, D, H = 7, 9, 20, 32
    rs = np.random.RandomState(num_layers)
    jp = jrnn.init_lstm_params(jax.random.PRNGKey(num_layers), D, H, num_layers)
    tp = interop.program_prior_from_jax(_to_numpy(jp))
    x = rs.randn(B, T, D).astype(np.float32)
    lens = rs.randint(1, T + 1, B)
    lens[0], lens[1] = T, 0
    mask = np.arange(T)[None, :] < lens[:, None]
    rng = jax.random.PRNGKey(10 + num_layers)
    want_out, want_finals = jrnn.lstm_encode(jp, jnp.asarray(x), jnp.asarray(mask), dropout=P,
                                             dropout_rng=rng)
    masks = jax_masks(rng, P, num_layers, B, T, H)
    assert masks.shape == (num_layers - 1, B, T, H) and masks.dtype == torch.bool
    got_out, got_finals = rnn.lstm_encode(tp, torch.from_numpy(x), torch.from_numpy(mask),
                                          dropout_masks=masks, dropout=P)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    for (gh, gc), (wh, wc) in zip(got_finals, want_finals):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5, rtol=0)
    assert not np.allclose(got_out[0].numpy(), rnn.lstm_encode(
        tp, torch.from_numpy(x), torch.from_numpy(mask))[0][0].numpy(), atol=1e-3)
    assert float(got_out[1].abs().max()) == 0.0  # the all-pad row stays zero
    with pytest.raises(ValueError, match="dropout masks"):
        rnn.lstm_encode(tp, torch.from_numpy(x), torch.from_numpy(mask),
                        dropout_masks=masks[:, :, :T - 1], dropout=P)


def test_drawn_masks_keep_one_minus_p():
    gen = torch.Generator().manual_seed(0)
    masks = rnn.draw_dropout_masks(gen, 0.2, 3, 64, 20, 32)
    assert masks.shape == (2, 64, 20, 32) and masks.dtype == torch.bool
    assert abs(float(masks.float().mean()) - 0.8) < 0.01
    assert rnn.draw_dropout_masks(gen, 0.0, 3, 64, 20, 32) is None
    assert rnn.draw_dropout_masks(gen, 0.2, 1, 64, 20, 32) is None
    assert rnn.draw_dropout_masks(gen, 0.2, 2, 0, 20, 32) is None
    with pytest.raises(ValueError, match="dropout"):
        rnn.draw_dropout_masks(gen, 1.0, 2, 4, 5, 6)


# ------------------------------------------------------------------ K3 and K4, plain
def test_program_prior_train_forward_matches_jax():
    jp = jprior.init_program_prior_params(jax.random.PRNGKey(0), JPRIOR)
    tp = interop.program_prior_from_jax(_to_numpy(jp))
    tok = _right_padded(np.random.RandomState(0), BATCH, LT, PRIOR.vocab_size)
    rng = jax.random.PRNGKey(3)
    masks = jax_masks(jax.random.fold_in(rng, 991), P, 3, BATCH, LT + 2, PRIOR.hidden_size)
    assert program_prior.lm_dropout_masks(torch.Generator(), PRIOR,
                                          torch.from_numpy(tok)).shape == masks.shape

    def jax_loss(p):
        return jprior.program_prior_forward(p, JPRIOR, jnp.asarray(tok), rng, train=True)["loss"]

    want = np.asarray(jax_loss(jp))
    got = fused_lm_loss(tp, PRIOR, torch.from_numpy(tok), masks)
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_ATOL, rtol=0)
    eval_loss = fused_lm_loss(tp, PRIOR, torch.from_numpy(tok))
    assert not np.allclose(eval_loss.numpy(), want, atol=1e-3)  # the masks matter
    w = np.random.RandomState(1).rand(BATCH).astype(np.float32)
    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_loss(p)).sum())(jp)
    plain = lm_grads_plain(tp, PRIOR, torch.from_numpy(tok), torch.from_numpy(w), masks)
    _assert_trees_close(plain, jgrad, GRAD_ATOL)


@pytest.mark.parametrize("reinforce_norm", [False, True], ids=["ce", "reinforce"])
def test_teacher_forced_train_forward_matches_jax(reinforce_norm):
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(1), JSPEC)
    tp = interop.program_generator_from_jax(_to_numpy(jp))
    rs = np.random.RandomState(2)
    src = _right_padded(rs, BATCH, LS, SPEC.source_vocab_size)
    tgt = _right_padded(rs, BATCH, LT, SPEC.target_vocab_size)
    rng = jax.random.PRNGKey(4)
    masks = jax_masks(jax.random.fold_in(rng, 997), P, 3, BATCH, LS + 1, SPEC.hidden_size)
    assert seq2seq.encoder_dropout_masks(torch.Generator(), SPEC,
                                         torch.from_numpy(src)).shape == masks.shape
    if reinforce_norm:
        # A trimmed z: the JAX free-running loss at z is the teacher-forced
        # logprob of z fed as [start, z[:-1]], which JAX computes here as the
        # masked sum of the chosen tokens' logprobs, length-normalized.
        def jax_loss(p):
            targets = jnp.concatenate([jnp.full((BATCH, 1), SPEC.start_index), jnp.asarray(tgt)], 1)
            out = jseq2seq.seq2seq_forward(p, JSPEC, jnp.asarray(src), jnp.asarray(tgt),
                                           "sampling", rng, train=True)
            logp = jax.nn.log_softmax(out["logits"][:, :LT], -1)
            chosen = jnp.take_along_axis(logp, targets[:, 1:, None], -1)[..., 0]
            keep = (jnp.asarray(tgt) != SPEC.pad_index).astype(jnp.float32)
            return -(chosen * keep).sum(1) / (keep.sum(1) + 1e-12)
    else:
        def jax_loss(p):
            return jseq2seq.seq2seq_forward(p, JSPEC, jnp.asarray(src), jnp.asarray(tgt),
                                            "sampling", rng, train=True)["loss"]
    want = np.asarray(jax_loss(jp))
    src_t, tgt_t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    got = fused_tf_loss(tp, SPEC, src_t, tgt_t, reinforce_norm, masks)
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_ATOL, rtol=0)
    w = np.random.RandomState(5).rand(BATCH).astype(np.float32)
    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_loss(p)).sum())(jp)
    plain = tf_grads_plain(tp, SPEC, src_t, tgt_t, torch.from_numpy(w), reinforce_norm, masks)
    _assert_trees_close(plain, jgrad, GRAD_ATOL)


# ------------------------------------------------------------------ the two passes share a mask
def test_sample_then_reinforce_shares_one_mask_as_jax_does():
    r"""JAX samples z and takes its loss in one ``seq2seq_forward`` call with
    one encoder mask; the port samples with K1's plain version and scores z
    with K4's in REINFORCE mode, both under that mask."""
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(2), JSPEC)
    tp = interop.program_generator_from_jax(_to_numpy(jp))
    src = _right_padded(np.random.RandomState(3), BATCH, LS, SPEC.source_vocab_size)
    rng = jax.random.PRNGKey(6)
    T, V = SPEC.max_decoding_steps, SPEC.target_vocab_size

    def jax_free(p):
        return jseq2seq.seq2seq_forward(p, JSPEC, jnp.asarray(src), None, "sampling", rng,
                                        train=True)

    want = jax_free(jp)
    # JAX's categorical draw: argmax(gumbel(fold_in(rng, t)) + logits).
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(rng, t), (BATCH, V), jnp.float32)) for t in range(T)]))
    masks = jax_masks(jax.random.fold_in(rng, 997), P, 3, BATCH, LS + 1, SPEC.hidden_size)
    src_t = torch.from_numpy(src).long()
    sampled = sampling_forward_with_noise(tp, SPEC, src_t, noise, dropout_masks=masks)
    z = sampled["predictions"]
    np.testing.assert_array_equal(z.numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(sampled["loss"].numpy(), np.asarray(want["loss"]),
                               atol=LOSS_ATOL, rtol=0)
    second = fused_tf_loss(tp, SPEC, src_t, z, True, masks)
    np.testing.assert_allclose(second.numpy(), np.asarray(want["loss"]), atol=LOSS_ATOL, rtol=0)
    w = np.random.RandomState(7).rand(BATCH).astype(np.float32)
    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_free(p)["loss"]).sum())(jp)
    plain = tf_grads_plain(tp, SPEC, src_t, z, torch.from_numpy(w), True, masks)
    _assert_trees_close(plain, jgrad, GRAD_ATOL)
    # The trap: a mask drawn anew for the scoring pass gives another loss.
    fresh = seq2seq.encoder_dropout_masks(torch.Generator().manual_seed(1), SPEC, src_t)
    other = fused_tf_loss(tp, SPEC, src_t, z, True, fresh)
    assert np.abs(other.numpy() - np.asarray(want["loss"])).max() > 10 * LOSS_ATOL


# ------------------------------------------------------------------ the trainers
@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_dropout"))
    build_fixture_data(root)
    return root


def _dropout_overrides(p=0.25):
    out = []
    for model in ("PROGRAM_PRIOR", "PROGRAM_GENERATOR", "QUESTION_RECONSTRUCTOR"):
        out += [f"{model}.NUM_LAYERS", 2, f"{model}.DROPOUT", p]
    return out


def test_program_prior_trainer_with_dropout_matches_the_jax_trainer(fixture, tmp_path,
                                                                     monkeypatch):
    jax_config = make_fixture_config(fixture, "program_prior", _dropout_overrides())
    path = str(tmp_path / "program_prior.yml")
    jax_config.dump(path)
    np.random.seed(0)
    jax_trainer = JaxProgramPriorTrainer(jax_config, str(tmp_path / "jax"))
    port = ProgramPriorTrainer(Config(path), str(tmp_path / "port"), device="cpu",
                               writer=RecordingWriter())
    copy_into(port.params["program_prior"], interop.program_prior_from_jax(
        _to_numpy(jax_trainer.params["program_prior"])))
    spec = port.spec
    assert spec.dropout == 0.25 and spec.num_layers == 2
    drawn = []

    def jax_step_masks(gen, spec_, programs):
        # The key the JAX trainer's next step takes: split(self._rng)[1].
        _, sub = jax.random.split(jax_trainer._rng)
        drawn.append(jax_masks(jax.random.fold_in(sub, 991), spec_.dropout, spec_.num_layers,
                               programs.shape[0], programs.shape[1] + 2, spec_.hidden_size))
        return drawn[-1]

    monkeypatch.setattr(program_prior_trainer, "lm_dropout_masks", jax_step_masks)
    jax_losses, port_losses, grads = [], [], []
    for iteration in range(3):
        port_losses.append(port.step(iteration)["loss"])
        jax_losses.append(float(jax_trainer._do_iteration(next(jax_trainer._batches))["loss"]))
        grads.append(jax.tree_util.tree_leaves(_to_numpy(jax.tree_util.tree_map(
            lambda t: t.grad, port.params["program_prior"]))))
    assert len(drawn) == 3 and not torch.equal(drawn[0], drawn[1])
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL, rtol=0)
    want = jax.tree_util.tree_leaves(_to_numpy(jax_trainer.params["program_prior"]))
    got = jax.tree_util.tree_leaves(_to_numpy(port.params["program_prior"]))
    for i, (g, w) in enumerate(zip(got, want)):
        smooth = np.min([np.abs(step[i]) for step in grads], axis=0) > 1e-5
        np.testing.assert_allclose(g[smooth], w[smooth], atol=2e-5, rtol=0)
        np.testing.assert_allclose(g, w, atol=2 * 0.01 * 3, rtol=0)


def test_question_coding_hands_k1_and_the_reinforce_pass_one_mask(fixture, tmp_path,
                                                                   monkeypatch):
    r"""The trainer's step: the mask K1 samples under is the very tensor the
    REINFORCE pass over the same rows takes; the other passes take theirs."""
    config = make_fixture_config(fixture, "question_coding", _dropout_overrides())
    prior_config = make_fixture_config(fixture, "program_prior", _dropout_overrides())
    ckpt = config.CHECKPOINTS.PROGRAM_PRIOR
    prior = ProgramPriorTrainer(prior_config, str(tmp_path / "prior"), device="cpu",
                                writer=RecordingWriter())
    prior._checkpoint_manager.step(0, prior._checkpointables())
    shutil.copy(str(tmp_path / "prior" / "checkpoint_0.ckpt"), ckpt)
    trainer = QuestionCodingTrainer(config, str(tmp_path / "qc"), device="cpu",
                                    writer=RecordingWriter())
    seen = {"k1": [], "k4": []}
    real_k1 = question_coding_trainer.fused_sampling_forward
    real_k4 = question_coding_trainer.fused_tf_loss

    def k1(*args, dropout_masks=None, **kwargs):
        seen["k1"].append(dropout_masks)
        return real_k1(*args, dropout_masks=dropout_masks, **kwargs)

    def k4(params, spec, src, tgt, reinforce_norm=False, dropout_masks=None):
        seen["k4"].append((reinforce_norm, tuple(src.shape), dropout_masks))
        return real_k4(params, spec, src, tgt, reinforce_norm, dropout_masks)

    monkeypatch.setattr(question_coding_trainer, "fused_sampling_forward", k1)
    monkeypatch.setattr(question_coding_trainer, "fused_tf_loss", k4)
    batch = None
    real_masks = trainer.draw_dropout_masks

    def draw(b):
        nonlocal batch
        batch = b
        return real_masks(b)

    monkeypatch.setattr(trainer, "draw_dropout_masks", draw)
    logs = trainer.step(0)
    assert np.isfinite(logs["loss"]["program_generation_gt"])
    n_sup = batch[COUNT_KEY]
    n_unsup = batch["question"].shape[0] - n_sup
    assert 0 < n_sup < batch["question"].shape[0]
    (k1_masks,) = seen["k1"]
    assert k1_masks is not None and k1_masks.shape[1] == n_unsup
    reinforce = [m for r, _, m in seen["k4"] if r]
    assert len(reinforce) == 1 and reinforce[0] is k1_masks
    others = [m for r, _, m in seen["k4"] if not r]
    assert len(others) == 3 and all(m is not None and m is not k1_masks for m in others)
    assert sorted(m.shape[1] for m in others) == sorted([n_sup, n_sup, n_unsup])


def test_four_phases_train_and_evaluate_with_dropout(fixture, tmp_path):
    r"""The train CLI on the CPU for each phase in turn, every LSTM model at
    two layers with DROPOUT 0.25 and Adam's first moment in bfloat16, each
    phase's best checkpoint the next phases' frozen input; then the
    evaluate CLI on the last."""
    from probnmn_tpu_torch import evaluate

    feeds = {"program_prior": "PROGRAM_PRIOR", "question_coding": "QUESTION_CODING",
             "module_training": "MODULE_TRAINING"}
    root = str(tmp_path)
    for phase in ("program_prior", "question_coding", "module_training", "joint_training"):
        overrides = _dropout_overrides() + ["OPTIM.ADAM_MU_DTYPE", "bfloat16"]
        for name, key in feeds.items():
            overrides += [f"CHECKPOINTS.{key}", os.path.join(root, f"{name}.ckpt")]
        config = make_fixture_config(fixture, phase, overrides)
        path = os.path.join(root, f"{phase}.yml")
        config.dump(path)
        out = os.path.join(root, phase)
        train.main(train.parser.parse_args([
            "--phase", phase, "--config-yml", path, "--config-override",
            "OPTIM.NUM_ITERATIONS", "2", "--device", "cpu", "--serialization-dir", out,
            "--checkpoint-every", "2", "--num-val-batches", "1"]))
        best = os.path.join(out, "checkpoint_best.ckpt")
        assert os.path.exists(best), phase
        if phase in feeds:
            shutil.copy(best, os.path.join(root, f"{phase}.ckpt"))
    metrics = evaluate.main(evaluate.parser.parse_args([
        "--phase", "joint_training", "--config-yml", path, "--checkpoint-path", best,
        "--device", "cpu", "--num-val-batches", "1"]))
    assert np.isfinite(metrics["nmn"]["answer_accuracy"])
