"""The NMN training forward's stem (``models/nmn.py::training_stem``): the
stem the trainers run, with cuDNN held to its deterministic algorithms
through the convs' forward and backward so that a float32 training step
repeats bit for bit on the card (``tools/nmn_step_repeat.py``). On the CPU
it must be ``apply_stem`` exactly: the same values and gradients, bit for
bit, and the global flag set only while its convs run."""
import pytest
import torch

from probnmn_tpu_torch.models import nmn

STEM_KEYS = ("w1", "b1", "w2", "b2")


def _inputs(seed, features_grad):
    gen = torch.Generator().manual_seed(seed)
    params = {"w1": torch.randn(6, 5, 3, 3, generator=gen), "b1": torch.randn(6, generator=gen),
              "w2": torch.randn(4, 6, 3, 3, generator=gen), "b2": torch.randn(4, generator=gen)}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    features = torch.randn(3, 7, 6, 5, generator=gen).requires_grad_(features_grad)
    return params, features


@pytest.mark.parametrize("features_grad", [False, True], ids=["params", "params_and_features"])
def test_training_stem_is_apply_stem_bit_for_bit(features_grad):
    params, features = _inputs(0, features_grad)
    cot = torch.randn(3, 7, 6, 4, generator=torch.Generator().manual_seed(1))
    leaves = [params[k] for k in STEM_KEYS] + ([features] if features_grad else [])
    want = nmn.apply_stem(params, features)
    want_grads = torch.autograd.grad(want, leaves, cot)
    got = nmn.training_stem(params, features)
    got_grads = torch.autograd.grad(got, leaves, cot)
    assert torch.equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(got_grads, want_grads))
    with torch.no_grad():
        assert torch.equal(nmn.training_stem(params, features), want)


def test_training_stem_holds_the_flag_through_forward_and_backward(monkeypatch):
    r"""``cudnn.deterministic`` reads True while the convs run, forward and
    backward, and its old value once the stem is done."""
    seen = []
    plain = nmn.apply_stem

    def recording(params, features):
        seen.append(("forward", torch.backends.cudnn.deterministic))
        out = plain(params, features)
        out.register_hook(lambda g: seen.append(("backward", torch.backends.cudnn.deterministic)))
        return out

    monkeypatch.setattr(nmn, "apply_stem", recording)
    assert torch.backends.cudnn.deterministic is False
    params, features = _inputs(2, True)
    out = nmn.training_stem(params, features)
    assert torch.backends.cudnn.deterministic is False
    out.sum().backward()
    assert torch.backends.cudnn.deterministic is False
    assert seen == [("forward", True), ("backward", True)]
    assert all(params[k].grad is not None for k in STEM_KEYS) and features.grad is not None
