"""The port's question_coding phase against the JAX package's, in float32 on the CPU.

- ``fused_tf_loss`` on CPU tensors (the plain versions of kernels K4f/K4b)
  gives the loss of JAX ``fused_tf_loss`` run in interpret mode and of JAX
  ``seq2seq_forward`` within 1e-5 in both modes, and every gradient leaf
  under a random per-example cotangent within 5e-6 of ``jax.grad``
  (tests/test_seq2seq_train_pallas.py's tolerance), on batches with an
  all-pad source row, full-length rows, trimmed z rows that are all pad and
  z rows with no @end@.
- ``QuestionCodingTrainer.question_coding_objective`` at a shared z equals a
  JAX composition of the same pieces (the JAX trainer's loss function over
  the full batch with supervision masks): the loss, every log, the new
  baseline and every gradient leaf.
- Three steps of the OBJECTIVE ``baseline`` trainer equal the JAX
  trainer's on tests/clevr_fixtures.py (losses within 1e-5; parameters as
  in tests/test_torch_port_training.py); the evaluator equals the JAX
  evaluator; the data path, the metrics and the ELBO functions equal their
  JAX counterparts; the CLI runs with ``--device cpu``."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.datasets import QuestionCodingDataset as JaxQuestionCodingDataset
from probnmn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from probnmn_tpu.data.samplers import (
    SupervisionWeightedRandomSampler as JaxSupervisionWeightedRandomSampler,
)
from probnmn_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from probnmn_tpu.evaluators.question_coding_evaluator import (
    QuestionCodingEvaluator as JaxQuestionCodingEvaluator,
)
from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.models.program_prior import ProgramPriorSpec as JaxProgramPriorSpec
from probnmn_tpu.models.program_prior import init_program_prior_params, program_prior_forward
from probnmn_tpu.modules import elbo as jelbo
from probnmn_tpu.ops.pallas.seq2seq_train import fused_tf_loss as jax_fused_tf_loss
from probnmn_tpu.training.question_coding_trainer import (
    QuestionCodingTrainer as JaxQuestionCodingTrainer,
)
from probnmn_tpu.utils import metrics as jmetrics
from probnmn_tpu.utils import torch_interop as jax_torch_interop
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator
from probnmn_tpu_torch.data.samplers import SupervisionWeightedRandomSampler
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
from probnmn_tpu_torch.models import seq2seq
from probnmn_tpu_torch.modules import elbo
from probnmn_tpu_torch.ops.kernels import seq2seq_train
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_tf_loss,
    pack_tf_weights,
    tf_forward_cuda,
    tf_grads_plain,
    tf_loss_plain,
    tf_param_leaves,
    tf_params_from_leaves,
)
from probnmn_tpu_torch.training._trainer import copy_into
from probnmn_tpu_torch.training.question_coding_trainer import (
    COUNT_KEY,
    QuestionCodingTrainer,
    load_frozen_prior,
)
from probnmn_tpu_torch.utils import metrics
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests import ref_checkpoints
from tests.clevr_fixtures import build_fixture_data, make_fixture_config

LOSS_ATOL = 1e-5
GRAD_ATOL = 5e-6
SIZES = dict(source_vocab_size=30, target_vocab_size=20, input_size=64, hidden_size=64,
             num_layers=2, max_decoding_steps=10)
JSPEC, SPEC = jseq2seq.Seq2SeqSpec(**SIZES), seq2seq.Seq2SeqSpec(**SIZES)
BATCH, LS, LT = 10, 12, 10


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def _params(seed):
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(seed), JSPEC)
    return jp, interop.program_generator_from_jax(_to_numpy(jp))


def _right_padded(rs, batch, length, vocab):
    tok = rs.randint(4, vocab, (batch, length))
    return tok * (np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1)))


def _batch(seed, reinforce_norm):
    r"""Sources with a full-length and an all-pad row. CE targets with a
    full-length row; REINFORCE targets are trimmed z rows: some end with
    @end@, one trimmed to all pad (@end@ came first), one with no @end@."""
    rs = np.random.RandomState(seed)
    src = _right_padded(rs, BATCH, LS, SPEC.source_vocab_size)
    src[0] = rs.randint(4, SPEC.source_vocab_size, LS)
    src[1] = 0
    tgt = _right_padded(rs, BATCH, LT, SPEC.target_vocab_size)
    tgt[2] = rs.randint(4, SPEC.target_vocab_size, LT)
    if reinforce_norm:
        lens = (tgt != 0).sum(1)
        for b in range(3, BATCH):
            if lens[b] < LT:
                tgt[b, lens[b]] = SPEC.end_index
        tgt[4] = 0
    return src.astype(np.int32), tgt.astype(np.int32)


def _assert_trees_close(got, want, atol, scale=False):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        w, g = np.asarray(w), np.asarray(g)
        tol = atol * max(1.0, float(np.abs(w).max())) if scale else atol
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"mismatch at {jax.tree_util.keystr(path)}")


# ------------------------------------------------------------------ K4's plain version
@pytest.mark.parametrize("reinforce_norm", [False, True], ids=["ce", "reinforce"])
def test_tf_loss_and_grads_match_jax(reinforce_norm):
    jp, tp = _params(0)
    src, tgt = _batch(1, reinforce_norm)
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    tsrc, ttgt = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    want = np.asarray(jax_fused_tf_loss(jp, JSPEC, jsrc, jtgt, reinforce_norm, jnp.float32, 4, True))
    got = fused_tf_loss(tp, SPEC, tsrc, ttgt, reinforce_norm).numpy()
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert np.isfinite(got).all()
    if reinforce_norm:
        assert got[4] == 0.0  # the all-pad z row
    else:
        xla = jseq2seq.seq2seq_forward(jp, JSPEC, jsrc, jtgt, jseq2seq.GREEDY)["loss"]
        np.testing.assert_allclose(got, np.asarray(xla), atol=LOSS_ATOL, rtol=0)

    w = np.random.RandomState(2).rand(BATCH).astype(np.float32) + 0.5
    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_fused_tf_loss(
        p, JSPEC, jsrc, jtgt, reinforce_norm, jnp.float32, 4, True)).sum())(jp)
    plain = tf_grads_plain(tp, SPEC, tsrc, ttgt, torch.from_numpy(w), reinforce_norm)
    _assert_trees_close(_to_numpy(plain), jgrad, GRAD_ATOL)


def test_reinforce_mode_is_the_free_running_loss_at_z():
    r"""Sampling is a stop-gradient: at the z JAX's free-running decode drew,
    REINFORCE mode gives its loss and its gradients."""
    jp, tp = _params(3)
    src, _ = _batch(3, False)
    rng = jax.random.PRNGKey(42)
    out = jseq2seq.seq2seq_forward(jp, JSPEC, jnp.asarray(src), None, jseq2seq.SAMPLING, rng)
    z = np.array(out["predictions"])
    tsrc, tz = torch.from_numpy(src).long(), torch.from_numpy(z).long()
    np.testing.assert_allclose(tf_loss_plain(tp, SPEC, tsrc, tz, True).numpy(),
                               np.asarray(out["loss"]), atol=LOSS_ATOL, rtol=0)
    jgrad = jax.grad(lambda p: jseq2seq.seq2seq_forward(
        p, JSPEC, jnp.asarray(src), None, jseq2seq.SAMPLING, rng)["loss"].mean())(jp)
    plain = tf_grads_plain(tp, SPEC, tsrc, tz, torch.full((BATCH,), 1.0 / BATCH), True)
    _assert_trees_close(_to_numpy(plain), jgrad, GRAD_ATOL)


def test_teacher_forced_outputs_match_jax():
    jp, tp = _params(4)
    src, tgt = _batch(4, False)
    want = jseq2seq.seq2seq_forward(jp, JSPEC, jnp.asarray(src), jnp.asarray(tgt), jseq2seq.GREEDY)
    got = seq2seq.seq2seq_forward(tp, SPEC, torch.from_numpy(src).long(), seq2seq.GREEDY,
                                  target_tokens=torch.from_numpy(tgt).long())
    for key in ("predictions", "relevant_targets", "relevant_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("loss", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=LOSS_ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got["loss"].numpy(), tf_loss_plain(
        tp, SPEC, torch.from_numpy(src).long(), torch.from_numpy(tgt).long()).numpy(), atol=0)
    with pytest.raises(ValueError, match="greedy"):
        seq2seq.seq2seq_forward(tp, SPEC, torch.from_numpy(src).long(), seq2seq.SAMPLING,
                                noise=torch.zeros(LT + 1, BATCH, SPEC.target_vocab_size),
                                target_tokens=torch.from_numpy(tgt).long())


def test_fused_tf_loss_function_keeps_the_leaf_order(monkeypatch):
    r"""``_FusedTFLoss`` on CPU tensors with its two launchers swapped for the
    plain versions (K4f keeping its residuals, K4b starting from them):
    autograd hands every leaf its own gradient."""
    _, tp = _params(5)
    src, tgt = (torch.from_numpy(a).long() for a in _batch(5, True))

    def forward(packed, spec, s, t, r, keep=False, dropout_masks=None):
        loss = tf_loss_plain(tp, spec, s, t, r, dropout_masks).detach()
        return (loss, (spec, s, t, r)) if keep else loss

    monkeypatch.setattr(seq2seq_train, "tf_forward_cuda", forward)
    monkeypatch.setattr(seq2seq_train, "tf_backward_cuda",
                        lambda res, d: tf_grads_plain(tp, res[0], res[1], res[2], d, res[3]))
    leaves = [p.detach().clone().requires_grad_(True) for p in tf_param_leaves(tp)]
    dloss = torch.from_numpy(np.random.RandomState(5).rand(BATCH).astype(np.float32))
    loss = seq2seq_train._FusedTFLoss.apply(SPEC, True, True, src, tgt, None, *leaves)
    (loss * dloss).sum().backward()
    want = tf_param_leaves(tf_grads_plain(tp, SPEC, src, tgt, dloss, True))
    assert len(leaves) == len(want) == 2 + 4 * SPEC.num_layers + 4 + 2
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_pack_tf_weights_layout():
    _, tp = _params(6)
    packed = pack_tf_weights(tp, SPEC)
    H, D = SPEC.hidden_size, SPEC.input_size
    cell = tp["decoder_cell"]
    assert torch.equal(packed["dec_w"][:, :H], cell["w_ih"][:, :H])
    assert torch.equal(packed["dec_w"][:, H:], cell["w_hh"])
    assert torch.equal(packed["dec_wx"], cell["w_ih"][:, H:])
    assert torch.equal(packed["dec_bias"], cell["b_ih"] + cell["b_hh"])
    assert packed["enc_wih"].shape == (4 * H * (D + (SPEC.num_layers - 1) * H),)
    assert torch.equal(packed["enc_whh"][1], tp["encoder"][1]["w_hh"])
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in packed.values())
    leaves = tf_param_leaves(tp)
    assert all(a is b for a, b in zip(tf_param_leaves(tf_params_from_leaves(leaves)), leaves))


def test_cuda_wrappers_refuse_cpu_tensors_and_dropout():
    r"""The CUDA wrapper refuses CPU tensors. Dropout, once refused, now
    trains: with masks ``fused_tf_loss`` is JAX's teacher-forced
    ``train=True`` loss under the masks its key draws; without them
    (evaluation) it is the plain loss, whatever the spec's rate."""
    jp, tp = _params(7)
    src, tgt = (torch.from_numpy(a).long() for a in _batch(7, False))
    with pytest.raises(ValueError, match="CUDA"):
        tf_forward_cuda(pack_tf_weights(tp, SPEC), SPEC, src, tgt)
    jspec = jseq2seq.Seq2SeqSpec(**dict(SIZES, dropout=0.1))
    dropout_spec = seq2seq.Seq2SeqSpec(**dict(SIZES, dropout=0.1))
    rng = jax.random.PRNGKey(7)
    drop_rng = jax.random.fold_in(rng, 997)
    masks = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(drop_rng, layer), 0.9, (BATCH, LS + 1, SPEC.hidden_size)))
        for layer in range(SPEC.num_layers - 1)]))
    want = jseq2seq.seq2seq_forward(jp, jspec, jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy()),
                                    "sampling", rng, train=True)["loss"]
    np.testing.assert_allclose(fused_tf_loss(tp, dropout_spec, src, tgt, dropout_masks=masks)
                               .numpy(), np.asarray(want), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(fused_tf_loss(tp, dropout_spec, src, tgt).numpy(),
                               fused_tf_loss(tp, SPEC, src, tgt).numpy(), atol=0, rtol=0)


# ------------------------------------------------------------------ ELBO and metrics
@pytest.mark.parametrize("mask_kind", ["none", "partial", "empty"])
def test_elbo_functions_match_jax(mask_kind):
    rs = np.random.RandomState(8)
    gen, rec, prior = (rs.randn(7).astype(np.float32) - 2.0 for _ in range(3))
    mask = {"none": None, "partial": (rs.rand(7) > 0.4).astype(np.float32),
            "empty": np.zeros(7, np.float32)}[mask_kind]
    t = torch.from_numpy
    want_reward = jelbo.question_coding_reward(rec, gen, prior, 0.1)
    got_reward = elbo.question_coding_reward(t(rec), t(gen), t(prior), 0.1)
    np.testing.assert_allclose(got_reward.numpy(), np.asarray(want_reward), atol=1e-6)
    want_diag, want_baseline = jelbo.elbo_with_reinforce(
        jnp.asarray(gen), jnp.asarray(rec), jnp.asarray(want_reward), jnp.float32(0.7), 0.1, 0.99,
        mask=None if mask is None else jnp.asarray(mask))
    # The port sums over the subset's rows and divides by its count.
    rows = np.arange(7) if mask is None else np.flatnonzero(mask)
    got_elbo, sums = elbo.elbo_rows(t(gen[rows]), t(rec[rows]), got_reward[rows],
                                    torch.tensor(0.7), 0.1)
    got_baseline = elbo.baseline_update(torch.tensor(0.7), sums["centered_reward"], len(rows),
                                        0.99)
    for key in ("reconstruction_likelihood", "kl_divergence", "elbo", "reinforce_reward"):
        np.testing.assert_allclose(float(elbo.mean_over(sums[key], len(rows))),
                                   np.asarray(want_diag[key]), atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got_elbo.numpy(), np.asarray(want_diag["elbo_per_example"])[rows],
                               atol=1e-5)
    np.testing.assert_allclose(float(got_baseline), float(want_baseline), atol=1e-6)
    if mask_kind == "empty":  # an empty subset: means of 0, the baseline holds
        assert float(got_baseline) == pytest.approx(0.7)
        assert float(elbo.mean_over(sums["elbo"], 0)) == 0.0
    answering = rs.randn(7).astype(np.float32)
    np.testing.assert_allclose(
        elbo.joint_training_reward(t(rec), t(gen), t(prior), t(answering), 0.1, 2.0).numpy(),
        np.asarray(jelbo.joint_training_reward(rec, gen, prior, answering, 0.1, 2.0)), atol=1e-6)


def test_seq2seq_metrics_match_jax(tmp_path):
    from tests.clevr_fixtures import build_vocab

    build_vocab(str(tmp_path))
    port_vocab = Vocabulary.from_files(str(tmp_path))
    jax_vocab = JaxVocabulary.from_files(str(tmp_path))
    rs = np.random.RandomState(9)
    vocab_size = port_vocab.get_vocab_size("questions")
    for _ in range(3):
        pred = rs.randint(0, vocab_size, (6, 9))
        gold = _right_padded(rs, 6, 9, vocab_size)
        pred[0] = gold[0]
        mask = (gold != 0).astype(np.int64)
        pairs = [(metrics.BleuScore(), jmetrics.BleuScore(), (pred, gold)),
                 (metrics.SequenceAccuracy(), jmetrics.SequenceAccuracy(), (pred[:, None], gold, mask)),
                 (metrics.UnigramRecall(), jmetrics.UnigramRecall(), (pred[:, None], gold, mask)),
                 (metrics.SemanticQuestionReconstructionAccuracy(port_vocab),
                  jmetrics.SemanticQuestionReconstructionAccuracy(jax_vocab), (pred[:, None], gold, mask))]
        for got, want, args in pairs:
            got(*args)
            want(*args)
            assert got.get_metric() == want.get_metric(), type(got).__name__


# ------------------------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def qc(tmp_path_factory):
    r"""Fixture data, and one frozen prior saved twice: as the JAX package's
    msgpack checkpoint (for the JAX trainer) and as the port's."""
    root = str(tmp_path_factory.mktemp("qc_port"))
    build_fixture_data(root)
    prior_spec = JaxProgramPriorSpec(
        vocab_size=Vocabulary.from_files(os.path.join(root, "vocab")).get_vocab_size("programs"),
        input_size=16, hidden_size=12, num_layers=1)
    prior = init_program_prior_params(jax.random.PRNGKey(11), prior_spec)
    jax_save_objects(os.path.join(root, "program_prior_best.ckpt"), {"program_prior": prior})
    port_prior = os.path.join(root, "program_prior_port.ckpt")
    save_objects(port_prior, {"program_prior": interop.program_prior_from_jax(_to_numpy(prior))})

    def configs(objective, *extra):
        jax_config = make_fixture_config(root, "question_coding", ["OBJECTIVE", objective, *extra])
        path = os.path.join(root, f"qc_{objective}_{len(extra)}.yml")
        jax_config.dump(path)
        return jax_config, Config(path, ["CHECKPOINTS.PROGRAM_PRIOR", port_prior]), path

    return {"root": root, "configs": configs, "prior": prior, "prior_spec": prior_spec,
            "port_prior": port_prior}


def _port_trainer(config, directory):
    np.random.seed(config.RANDOM_SEED)  # the supervision subset, as the CLI seeds it
    return QuestionCodingTrainer(config, directory, device="cpu", writer=RecordingWriter())


def _flat(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(_to_numpy(tree))[0]}


def _jax_objective(jparams, pg_spec, qr_spec, prior, prior_spec, batch, z_full, baseline, c):
    r"""The JAX trainer's loss function (its full-batch path: supervision
    masks over the whole batch), with the passes through interpret-mode
    ``fused_tf_loss`` and z given."""
    q, prog = jnp.asarray(batch["question"]), jnp.asarray(batch["program"])
    sup = jnp.asarray(batch["supervision"]).astype(jnp.float32)
    z = jnp.asarray(z_full)

    def tf(p, spec, s, t, reinforce=False):
        return jax_fused_tf_loss(p, spec, s, t, reinforce, jnp.float32, 4, True)

    def loss_fn(p):
        pg_loss_sup = jelbo.masked_mean(tf(p["program_generator"], pg_spec, q, prog), sup)
        qr_loss_sup = jelbo.masked_mean(tf(p["question_reconstructor"], qr_spec, prog, q), sup)
        logs = {"loss": {"question_reconstruction_gt": qr_loss_sup,
                         "program_generation_gt": pg_loss_sup}}
        gen = -tf(p["program_generator"], pg_spec, q, z, True)
        rec = -tf(p["question_reconstructor"], qr_spec, z, q)
        log_prior = -program_prior_forward(prior, prior_spec, z, jax.random.PRNGKey(0))["loss"]
        reward = jelbo.question_coding_reward(rec, gen, log_prior, c.BETA)
        diagnostics, new_baseline = jelbo.elbo_with_reinforce(
            gen, rec, reward, baseline, c.BETA, c.DELTA, mask=1.0 - sup)
        elbo_value = diagnostics.pop("elbo")
        diagnostics.pop("elbo_per_example")
        logs["elbo"] = dict(diagnostics, elbo=elbo_value)
        return -elbo_value + c.ALPHA * (qr_loss_sup + pg_loss_sup), (new_baseline, logs)

    return jax.value_and_grad(loss_fn, has_aux=True)(jparams)


def test_objective_at_a_shared_z_matches_the_jax_composition(qc, tmp_path):
    _, config, _ = qc["configs"]("ours", "PROGRAM_GENERATOR.HIDDEN_SIZE", 16,
                                 "QUESTION_RECONSTRUCTOR.HIDDEN_SIZE", 16)
    trainer = _port_trainer(config, str(tmp_path))
    batch = next(trainer._batches)
    n_sup = batch[COUNT_KEY]
    assert 0 < n_sup < config.OPTIM.BATCH_SIZE
    assert batch["supervision"][:n_sup].all() and not batch["supervision"][n_sup:].any()
    z = trainer.sample_programs(batch["question"][n_sup:])
    z[0] = 0  # @end@ came first: trimmed to all pad
    baseline = torch.tensor(0.25)
    params = trainer.params
    total, new_baseline, logs = trainer.question_coding_objective(params, batch, z, baseline)
    total.backward()

    z_full = np.zeros((config.OPTIM.BATCH_SIZE, z.shape[1]), np.int64)
    z_full[n_sup:] = z.numpy()
    jparams = jax.tree_util.tree_map(jnp.asarray, _to_numpy(params))
    np_batch = {k: v.numpy() for k, v in batch.items() if not k.startswith("_")}
    (want_total, (want_baseline, want_logs)), want_grads = _jax_objective(
        jparams, *_jax_specs(trainer), qc["prior"], qc["prior_spec"], np_batch, z_full,
        jnp.float32(0.25), config)
    np.testing.assert_allclose(float(total.detach()), float(want_total), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(float(new_baseline), float(want_baseline), atol=1e-5)
    assert float(new_baseline) != 0.25
    for group, values in want_logs.items():
        assert sorted(logs[group]) == sorted(values)
        for key, value in values.items():
            np.testing.assert_allclose(float(logs[group][key]), float(value), atol=1e-5,
                                       err_msg=f"{group}/{key}")
    grads = jax.tree_util.tree_map(lambda t: t.grad, params)
    _assert_trees_close(_to_numpy(grads), want_grads, 1e-5, scale=True)


def _jax_specs(trainer):
    def convert(spec):
        return jseq2seq.Seq2SeqSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})

    return convert(trainer.pg_spec), convert(trainer.qr_spec)


def test_objective_with_an_empty_subset(qc, tmp_path):
    r"""All-supervised: the ELBO terms are 0 and the baseline holds. All
    unsupervised: the supervised means are 0 and the ELBO still trains."""
    _, config, _ = qc["configs"]("ours")
    trainer = _port_trainer(config, str(tmp_path))
    batch = next(trainer._batches)
    baseline = torch.tensor(0.5)
    all_sup = dict(batch, **{COUNT_KEY: len(batch["question"])})
    total, new_baseline, logs = trainer.question_coding_objective(
        trainer.params, all_sup, None, baseline)
    assert float(new_baseline) == 0.5
    assert all(float(v) == 0.0 for v in logs["elbo"].values())
    assert float(total) == pytest.approx(
        config.ALPHA * sum(float(v) for v in logs["loss"].values()), rel=1e-6)
    none_sup = dict(batch, **{COUNT_KEY: 0})
    z = trainer.sample_programs(batch["question"])
    total, new_baseline, logs = trainer.question_coding_objective(
        trainer.params, none_sup, z, baseline)
    assert all(float(v) == 0.0 for v in logs["loss"].values())
    assert float(new_baseline) != 0.5 and np.isfinite(float(total))
    total.backward()
    assert all(p.grad is not None for p in tf_param_leaves(trainer.params["program_generator"]))


@pytest.fixture(scope="module")
def baseline_runs(qc, tmp_path_factory):
    r"""The JAX and the port trainer, OBJECTIVE baseline, from the same
    parameters and sampler seed, three steps each on the same batches."""
    jax_config, config, _ = qc["configs"]("baseline")
    np.random.seed(0)
    jax_trainer = JaxQuestionCodingTrainer(jax_config, str(tmp_path_factory.mktemp("jax_qc")))
    port = _port_trainer(config, str(tmp_path_factory.mktemp("port_qc")))
    for name in ("program_generator", "question_reconstructor"):
        copy_into(port.params[name], interop.program_generator_from_jax(
            _to_numpy(jax_trainer.params[name])))
    jax_logs, port_logs, grads = [], [], []
    for iteration in range(3):
        jax_logs.append(jax.tree_util.tree_map(float, jax_trainer._do_iteration(
            next(jax_trainer._batches))))
        jax_trainer._iteration = iteration
        port_logs.append(port.step(iteration))
        grads.append(_flat(jax.tree_util.tree_map(lambda t: t.grad, port.params)))
    return dict(jax_config=jax_config, config=config, jax_trainer=jax_trainer, port=port,
                jax_logs=jax_logs, port_logs=port_logs, grads=grads)


def test_three_baseline_steps_match_the_jax_trainer(baseline_runs):
    for got, want in zip(baseline_runs["port_logs"], baseline_runs["jax_logs"]):
        assert sorted(got) == sorted(want) == ["loss"]
        for key, value in want["loss"].items():
            np.testing.assert_allclose(got["loss"][key], value, atol=LOSS_ATOL, rtol=0, err_msg=key)
    assert float(baseline_runs["port"].baseline) == 0.0
    want = _flat(baseline_runs["jax_trainer"].params)
    got = _flat(baseline_runs["port"].params)
    assert sorted(got) == sorted(want)
    lr, steps = baseline_runs["config"].OPTIM.LR_INITIAL, 3
    compared = 0
    for key, w in want.items():
        # As in tests/test_torch_port_training.py: within 2e-5 where every
        # step's |g| exceeds 1e-5, and within 2 lr a step elsewhere.
        smooth = np.min([np.abs(g[key]) for g in baseline_runs["grads"]], axis=0) > 1e-5
        np.testing.assert_allclose(got[key][smooth], w[smooth], atol=2e-5, rtol=0, err_msg=key)
        np.testing.assert_allclose(got[key], w, atol=2 * lr * steps, rtol=0, err_msg=key)
        compared += int(smooth.sum())
    # About four of each 8-row batch are supervised, so rows of the
    # embeddings that no token of them reads stay under the floor.
    assert compared > 0.6 * sum(w.size for w in want.values())


def test_evaluator_matches_the_jax_evaluator(baseline_runs):
    port, jax_trainer = baseline_runs["port"], baseline_runs["jax_trainer"]
    for name in ("program_generator", "question_reconstructor"):
        copy_into(port.params[name], interop.question_reconstructor_from_jax(
            _to_numpy(jax_trainer.params[name])))
    want = JaxQuestionCodingEvaluator(baseline_runs["jax_config"], jax_trainer).evaluate(
        num_batches=2)
    got = QuestionCodingEvaluator(baseline_runs["config"], port).evaluate(num_batches=2)
    assert sorted(got) == sorted(want)
    for model, values in want.items():
        assert sorted(got[model]) == sorted(values) == [
            "BLEU", "perplexity", "sequence_accuracy", "word_error_rate"]
        for key, value in values.items():
            np.testing.assert_allclose(got[model][key], value, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{model}/{key}")
    port.after_validation(got, 2)
    assert port.learning_rate == pytest.approx(baseline_runs["config"].OPTIM.LR_INITIAL)


def test_ours_steps_move_the_baseline_and_resume(qc, tmp_path):
    _, config, _ = qc["configs"]("ours")
    trainer = _port_trainer(config, str(tmp_path))
    baselines = [float(trainer.baseline)]
    for iteration in range(3):
        logs = trainer.step(iteration)
        assert sorted(logs) == ["elbo", "loss"]
        assert sorted(logs["elbo"]) == ["elbo", "kl_divergence", "reconstruction_likelihood",
                                        "reinforce_reward"]
        assert all(np.isfinite(v) for group in logs.values() for v in group.values())
        baselines.append(float(trainer.baseline))
    assert baselines[-1] != baselines[0]
    assert trainer.baseline.dtype == torch.float32 and trainer.baseline.dim() == 0
    val = QuestionCodingEvaluator(config, trainer).evaluate(num_batches=1)
    trainer.after_validation(val, 2)
    resumed = _port_trainer(config, str(tmp_path))
    resumed.load_checkpoint(str(tmp_path / "checkpoint_2.ckpt"))
    assert resumed.iteration == 2 and float(resumed.baseline) == baselines[-1]
    for key, value in _flat(trainer.params).items():
        np.testing.assert_array_equal(_flat(resumed.params)[key], value)


def test_prior_checkpoint_must_be_the_ports(qc, tmp_path):
    r"""The frozen prior loads from a checkpoint in each of the three formats:
    the port's and the JAX package's ``.ckpt`` equal to the JAX params, a
    reference ``.pth`` equal to the JAX package's port of it."""
    from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec

    prior_spec = ProgramPriorSpec(**{f: getattr(qc["prior_spec"], f)
                                     for f in qc["prior_spec"].__dataclass_fields__})
    for path in (qc["port_prior"], os.path.join(qc["root"], "program_prior_best.ckpt")):
        params = load_frozen_prior(path, prior_spec, torch.device("cpu"))
        _assert_trees_close(_to_numpy(params), qc["prior"], 0.0)
    spec = qc["prior_spec"]
    pth = str(tmp_path / "x.pth")
    ref_checkpoints.save_reference_pth(pth, {"program_prior": ref_checkpoints.make_prior_state(
        spec.vocab_size, spec.input_size, spec.hidden_size, spec.num_layers, 7)})
    params = load_frozen_prior(pth, prior_spec, torch.device("cpu"))
    ported = jax_torch_interop.load_reference_checkpoint(pth, {"program_prior": spec}, None)
    _assert_trees_close(_to_numpy(params), ported["program_prior"], 0.0)


def test_data_path_matches_jax(qc):
    jax_config, _, _ = qc["configs"]("ours")
    path = jax_config.DATA.TRAIN_TOKENS
    np.random.seed(0)
    port_set = QuestionCodingDataset(path, 12, 10)
    np.random.seed(0)
    jax_set = JaxQuestionCodingDataset(path, 12, 10)
    supervision = port_set.get_supervision_list()
    np.testing.assert_array_equal(supervision, jax_set.get_supervision_list())
    assert supervision.sum() == 12 and port_set.split == "train" and len(port_set) == 40
    np.random.seed(0)
    memory = QuestionCodingDataset.from_tokens(port_set._programs, port_set._questions,
                                               num_supervision=12,
                                               supervision_question_max_length=10)
    np.testing.assert_array_equal(memory.get_supervision_list(), supervision)

    port_sampler = SupervisionWeightedRandomSampler(supervision, seed=1)
    jax_sampler = JaxSupervisionWeightedRandomSampler(supervision, seed=1)
    for _ in range(2):
        np.testing.assert_array_equal(port_sampler.epoch(), jax_sampler.epoch())
    port_batches = iter(BatchIterator(port_set, SupervisionWeightedRandomSampler(supervision, 2),
                                      8, device="cpu", sort_descending_by="supervision"))
    jax_batches = iter(JaxBatchIterator(jax_set, JaxSupervisionWeightedRandomSampler(supervision, 2),
                                        8, device_put=False, sort_descending_by="supervision"))
    for _ in range(7):
        got, want = next(port_batches), next(jax_batches)
        assert sorted(got) == sorted(want)
        assert isinstance(got[COUNT_KEY], int) and got[COUNT_KEY] == want[COUNT_KEY]
        for key in ("program", "question", "supervision"):
            assert isinstance(got[key], torch.Tensor)
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    bad = QuestionCodingDataset.from_tokens(port_set._programs, port_set._questions + 100,
                                            split="val")
    with pytest.raises(ValueError, match="val question 0"):
        bad.check_tokens(100, 50)


def test_train_cli_runs_question_coding_on_the_cpu(qc, tmp_path):
    _, _, config_path = qc["configs"]("ours")
    out = str(tmp_path / "cli_qc")
    args = train.parser.parse_args([
        "--phase", "question_coding", "--config-yml", config_path,
        "--config-override", "OPTIM.NUM_ITERATIONS", "2",
        "CHECKPOINTS.PROGRAM_PRIOR", qc["port_prior"],
        "--device", "cpu", "--serialization-dir", out,
        "--checkpoint-every", "2", "--num-val-batches", "1",
    ])
    train.main(args)
    assert sorted(os.listdir(out))[:3] == ["checkpoint_1.ckpt", "checkpoint_best.ckpt",
                                           "config.yml"]
    assert train.parser.parse_args(["--phase", "question_coding", "--config-yml", "x"]).device == "cuda"
