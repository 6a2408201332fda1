"""The port's ResNet-101 stage-3 extractor (probnmn_tpu_torch/models/resnet.py)
and its image normalization (probnmn_tpu_torch/preprocess/extract_features.py)
against the JAX package's, on the CPU, in float32.

The port pads every 3x3 conv 1 pixel on each side, as the reference's
torchvision resnet101 does; the JAX extractor's _conv_bn pads its two stride-2
3x3 convs (0, 1) on an even input (padding="SAME"). A test pins that
difference, and the whole extractor is held to a forward written here from
JAX's own _conv_bn with the reference's padding at those two convs. Small
images (2 x 64 x 64) at the full depth of 30 blocks; JAX runs eagerly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probnmn_tpu.models import resnet as jresnet
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import resnet
from probnmn_tpu_torch.preprocess import extract_features as port_extract

TOL = 1e-4  # of max |f|


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def _nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def _jax_reference_forward(params, images_nhwc):
    r"""JAX's extractor with the reference's padding: JAX's own _conv_bn at
    every conv, with padding (1, 1) at the stride-2 3x3 convs."""
    x = jax.lax.conv_general_dilated(
        images_nhwc, params["conv1"]["w"], (2, 2), ((3, 3), (3, 3)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    x = jax.nn.relu(x * params["conv1"]["bn"]["scale"] + params["conv1"]["bn"]["shift"])
    x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                              ((0, 0), (1, 1), (1, 1), (0, 0)))
    for stage, (_, _, _, stride) in zip(params["layers"], jresnet.STAGES):
        for i, block in enumerate(stage):
            s = stride if i == 0 else 1
            padding = ((1, 1), (1, 1)) if s == 2 else "SAME"
            out = jax.nn.relu(jresnet._conv_bn(block["conv1"], x))
            out = jax.nn.relu(jresnet._conv_bn(block["conv2"], out, stride=s, padding=padding))
            out = jresnet._conv_bn(block["conv3"], out)
            identity = (jresnet._conv_bn(block["downsample"], x, stride=s)
                        if "downsample" in block else x)
            x = jax.nn.relu(out + identity)
    return x


@pytest.fixture(scope="module")
def state():
    return resnet.synthetic_torchvision_state_dict(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(1)
    return rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)


def _normalized(images_uint8):
    return port_extract.normalize_images(torch.from_numpy(images_uint8))


def _conv_bn_modules(stride, seed=0):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(5, 7, 3, stride=stride, padding=1, bias=False)
    bn = torch.nn.BatchNorm2d(7)
    bn.running_mean.normal_()
    bn.running_var.uniform_(0.5, 2.0)
    bn.weight.data.normal_()
    bn.bias.data.normal_()
    bn.eval()
    state = {"conv.weight": conv.weight.detach(), "bn.weight": bn.weight.detach(),
             "bn.bias": bn.bias.detach(), "bn.running_mean": bn.running_mean,
             "bn.running_var": bn.running_var}
    return conv, bn, state


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_matches_torch_conv2d_and_batchnorm(stride):
    conv, bn, state = _conv_bn_modules(stride)
    port = resnet.ConvBN(resnet._port_conv(state, "conv", "bn"), stride, padding=1)
    x = torch.randn(2, 5, 8, 8)
    with torch.no_grad():
        expected = bn(conv(x))
    got = port(x)
    assert got.shape == expected.shape
    torch.testing.assert_close(got, expected, rtol=0, atol=1e-5)


def test_jax_strided_conv_bn_pads_zero_then_one():
    r"""The fault of the JAX package against the reference: its stride-2 3x3
    _conv_bn pads (0, 1) on an even input, where torchvision pads (1, 1)."""
    conv, bn, state = _conv_bn_modules(2, seed=1)
    x = torch.randn(2, 5, 8, 8)
    got = _nchw(jresnet._conv_bn(jresnet._port_conv(state, "conv", "bn"), _nhwc(x.numpy()),
                                 stride=2))
    with torch.no_grad():
        zero_one = bn(F.conv2d(F.pad(x, (0, 1, 0, 1)), conv.weight, stride=2)).numpy()
        reference = bn(conv(x)).numpy()
    np.testing.assert_allclose(got, zero_one, rtol=0, atol=1e-5)
    scale = np.abs(reference).max()
    assert np.abs(got - reference).max() > 1e-2 * scale


def test_extractor_matches_the_reference_padded_jax_forward(state, images):
    port = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    got = port(_normalized(images))
    jparams = jresnet.params_from_torch_state_dict({k: v.numpy() for k, v in state.items()})
    want = _nchw(_jax_reference_forward(jparams, _nhwc(_normalized(images).numpy())))
    assert got.shape == (2, 1024, 4, 4) and got.dtype == torch.float32
    assert got.is_contiguous()
    scale = np.abs(want).max()
    assert 1.0 < scale < 100.0  # the synthesized statistics keep activations O(1-10)
    assert np.abs(got.numpy() - want).max() <= TOL * scale


def test_extractor_from_jax_init_params(images):
    jparams = jresnet.init_resnet101_stage3_params(jax.random.PRNGKey(0))
    port = resnet.ResNet101Stage3(interop.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    x = _normalized(images)
    got = port(x).numpy()
    want = _nchw(_jax_reference_forward(jparams, _nhwc(x.numpy())))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale


def test_the_port_differs_from_the_jax_extractor_only_by_padding(state, images):
    r"""JAX's own resnet101_stage3 (padding (0, 1)) and the port (padding (1,
    1)) on the same weights differ far beyond the tolerance."""
    jparams = jresnet.params_from_torch_state_dict({k: v.numpy() for k, v in state.items()})
    x = _normalized(images)
    jax_features = _nchw(jresnet.resnet101_stage3(jparams, _nhwc(x.numpy())))
    port = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))(x).numpy()
    scale = np.abs(jax_features).max()
    assert np.abs(port - jax_features).max() > 100 * TOL * scale


def test_state_dict_extra_keys_are_ignored(state):
    assert any(k.startswith("layer4.") for k in state)
    assert "fc.weight" in state and "bn1.num_batches_tracked" in state
    stage3 = {k: v for k, v in state.items()
              if not k.startswith(("layer4.", "fc.")) and not k.endswith("num_batches_tracked")}
    full = resnet.params_from_torch_state_dict(state)
    cut = resnet.params_from_torch_state_dict(stage3)
    as_numpy = resnet.params_from_torch_state_dict({k: v.numpy() for k, v in stage3.items()})
    leaves = jax.tree_util.tree_leaves
    assert len(leaves(full)) == len(leaves(cut)) == len(leaves(as_numpy))
    for a, b, c in zip(leaves(full), leaves(cut), leaves(as_numpy)):
        assert torch.equal(a, b) and torch.equal(a, c)
    n_conv = sum(v.numel() for k, v in stage3.items() if v.dim() == 4)
    assert n_conv == 27_452_608


def test_params_fold_as_the_jax_package_does(state):
    port = resnet.params_from_torch_state_dict(state)
    jparams = jresnet.params_from_torch_state_dict({k: v.numpy() for k, v in state.items()})
    mine = jax.tree_util.tree_leaves(port)
    theirs = jax.tree_util.tree_leaves(interop.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    assert len(mine) == len(theirs) == 3 + 30 * 9 + 3 * 3  # w, scale, shift of 103 convs
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)


def test_init_params_shapes_and_scale():
    params = resnet.init_resnet101_stage3_params(torch.Generator().manual_seed(0))
    jparams = jresnet.init_resnet101_stage3_params(jax.random.PRNGKey(0))
    ported = interop.resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    mine, theirs = jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(ported)
    assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in theirs]
    w = params["layers"][2][5]["conv2"]["w"]
    assert w.shape == (256, 256, 3, 3)
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 2e-3
    again = resnet.init_resnet101_stage3_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(mine, jax.tree_util.tree_leaves(again)))


def test_full_size_output_and_cpu_forwards_not_counted(state):
    model = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    before = resnet.ResNet101Stage3.launches
    images = np.random.RandomState(2).randint(0, 256, (1, 224, 224, 3)).astype(np.uint8)
    features = port_extract.extract_features(model, images, device="cpu")
    assert features.shape == (1, 1024, 14, 14) and features.dtype == np.float32
    assert features.flags["C_CONTIGUOUS"] and np.isfinite(features).all()
    assert resnet.ResNet101Stage3.launches == before


def test_partial_last_batch_equals_a_full_batch(state):
    model = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    images = np.random.RandomState(3).randint(0, 256, (5, 48, 48, 3)).astype(np.uint8)
    in_threes = port_extract.extract_features(model, images, batch_size=3, device="cpu")
    at_once = port_extract.extract_features(model, images, batch_size=5, device="cpu")
    scale = np.abs(at_once).max()
    assert np.abs(in_threes - at_once).max() <= TOL * scale


def test_normalized_images_match_the_jax_script(tmp_path):
    from PIL import Image

    from scripts.preprocess import extract_features as jax_extract

    assert resnet.IMAGE_STD[2] == np.float32(0.224)
    assert np.array_equal(resnet.IMAGE_STD, jresnet.IMAGE_STD)
    assert np.array_equal(resnet.IMAGE_MEAN, jresnet.IMAGE_MEAN)
    rs = np.random.RandomState(4)
    for i, (w, h) in enumerate([(480, 320), (224, 224), (31, 17)]):
        path = str(tmp_path / f"image_{i}.png")
        mode = "RGBA" if i == 2 else "RGB"
        Image.fromarray(rs.randint(0, 256, (h, w, len(mode))).astype(np.uint8), mode).save(path)
        uint8 = port_extract.load_image(path)
        assert uint8.shape == (224, 224, 3) and uint8.dtype == np.uint8
        got = _normalized(uint8[None])[0].permute(1, 2, 0).numpy()
        want = jax_extract.load_image(path)
        assert want.dtype == np.float32
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= ulp).all()


def test_extract_features_asks_for_cuda_by_default(state):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    model = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    images = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_extract.extract_features(model, images)


def test_extract_features_refuses_float_images(state):
    model = resnet.ResNet101Stage3(resnet.params_from_torch_state_dict(state))
    with pytest.raises(ValueError, match="uint8"):
        port_extract.extract_features(model, np.zeros((1, 32, 32, 3), np.float32), device="cpu")
