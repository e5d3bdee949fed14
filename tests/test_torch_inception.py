"""The port's Inception-v3 (`models/inception_v3.py`) against the JAX
package's, on the same seeded random weights in torchvision's names
(`random_inception_state`, numpy): to the JAX side through its
`torch_to_flax`, to the port by `load_state_dict(strict=True)`.

Tolerances: pool3 features within 1e-5 * max|feature| (f32 rounding of
the network's ~20 sequential convolutions, each summing up to 3,456
products, relative ~1e-6 apiece; measured 3e-7 at 299²);
`preprocess_for_inception` within the resize bound of
`tests/test_torch_resize.py`, 5e-5, over the smallest ImageNet std (0.224).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.io.convert import torch_to_flax
from synt_isic_tpu.models.inception_v3 import InceptionV3 as JaxInceptionV3
from synt_isic_tpu.models.inception_v3 import preprocess_for_inception as jax_preprocess
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.io.pth import save_checkpoint
from synt_isic_tpu_torch.models.inception_v3 import (InceptionV3,
                                                     expected_inception_state_shapes,
                                                     load_inception_params,
                                                     preprocess_for_inception,
                                                     random_inception_state)

from tests.torch_port_fixtures import one_thread  # noqa: F401  (autouse)

FEATURE_TOL = 1e-5
PREPROCESS_TOL = 5e-5 / 0.224
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def state():
    return random_inception_state(0)


@pytest.fixture(scope="module")
def port_model(state):
    model = InceptionV3()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model.eval()


def test_manifest_matches_module_and_param_count():
    manifest = expected_inception_state_shapes()
    module = {k: tuple(v.shape) for k, v in InceptionV3().state_dict().items()}
    assert module == manifest
    n = sum(int(np.prod(s)) for s in manifest.values())
    assert 23_700_000 < n < 24_000_000


@pytest.mark.parametrize("size", [299, 75])
def test_pool3_features_match_jax(state, port_model, size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    x = ((x + 1) / 2 - IMAGENET_MEAN) / IMAGENET_STD
    model = JaxInceptionV3()
    want = np.asarray(jax.jit(lambda p, z: model.apply(
        {"params": p}, z, method=model.pool3_features))(torch_to_flax(state), jnp.asarray(x)))
    with torch.no_grad():
        got = port_model.pool3_features(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL * np.abs(want).max())


@pytest.mark.parametrize("size", [128, 384])
def test_preprocess_for_inception_matches_jax(size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = preprocess_for_inception(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREPROCESS_TOL)


def test_load_drops_aux_and_counters_and_refuses_other_files(state, tmp_path):
    """A torchvision file carries the aux head and, from a trained model,
    BatchNorm's `num_batches_tracked`: both are dropped and the rest loads
    strictly; a file of another architecture is refused, naming what is
    wrong."""
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    full["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    full["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(7)
    save_checkpoint(full, str(tmp_path / "inception_v3.pth"))
    model = load_inception_params(str(tmp_path / "inception_v3.pth"))
    assert torch.equal(model.Mixed_7c.branch_pool.conv.weight,
                       torch.from_numpy(state["Mixed_7c.branch_pool.conv.weight"]))
    save_checkpoint({"conv.weight": torch.zeros(3, 3)}, str(tmp_path / "other.pth"))
    with pytest.raises(ValueError, match="not a torchvision inception_v3 state dict"):
        load_inception_params(str(tmp_path / "other.pth"))
    wrong = dict(full)
    wrong["Mixed_6b.branch7x7_2.conv.weight"] = torch.zeros(128, 128, 7, 1)
    save_checkpoint(wrong, str(tmp_path / "wrong.pth"))
    with pytest.raises(ValueError, match="shape mismatch: Mixed_6b.branch7x7_2"):
        load_inception_params(str(tmp_path / "wrong.pth"))


def test_weights_carry_across_both_ways(state, port_model):
    """`state_dict_from_jax` keeps torchvision's numbered branch names
    (`branch5x5_1`, `branch7x7x3_4`, ...): the JAX package's tree of the
    torchvision weights comes back key for key and loads strictly, and the
    port's own weights go to the JAX side onto its model's tree."""
    tree = torch_to_flax(state)
    back = state_dict_from_jax(tree)
    assert set(back) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    InceptionV3().load_state_dict(back, strict=True)

    ported = torch_to_flax({k: v.numpy() for k, v in port_model.state_dict().items()})
    shapes = jax.eval_shape(JaxInceptionV3().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))["params"]
    assert (jax.tree_util.tree_structure(ported)
            == jax.tree_util.tree_structure(shapes))
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(ported),
                                                 jax.tree_util.tree_leaves(shapes)))
