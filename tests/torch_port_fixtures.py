"""Shared inputs for the tests that hold the PyTorch port against the JAX
package: the tiny UNet config in both packages (unconditional, and
class-conditional with three classes plus the null row), a seeded random
parameter set in the JAX package's own tree layout (shapes from
`jax.eval_shape` of its `init_unet_params`, values from numpy, so no
compile is spent on initialisation), the JAX package's fast-math
attention on seeded inputs, computed once per process, and the same for
the lesion classifier's ResNet-18 with a switch that shrinks both
packages' classifier input."""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.models.unet2d import UNet2DConfig as JaxUNet2DConfig
from synt_isic_tpu.models.unet2d import init_unet_params
from synt_isic_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.parallel.mesh import create_mesh

from tests.torch_oracle.unet2d_torch import tiny_config

_TINY = {k: v for k, v in tiny_config().items()
         if k not in ("in_channels", "out_channels")}
TINY_JAX = JaxUNet2DConfig(**_TINY)
TINY = UNet2DConfig(**_TINY)
COND_CLASSES = ("MEL", "NV", "VASC")
TINY_COND_JAX = JaxUNet2DConfig(**_TINY, num_class_embeds=len(COND_CLASSES) + 1)
TINY_COND = UNet2DConfig(**_TINY, num_class_embeds=len(COND_CLASSES) + 1)


def jax_params(config: JaxUNet2DConfig = TINY_JAX, seed: int = 0):
    """Random parameters for `config` as the JAX model lays them out:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), biases and
    embeddings ~ N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: init_unet_params(
        JaxUNet2D(config=config), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        z = rng.normal(size=leaf.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(params, config: UNet2DConfig = TINY, **kw) -> UNet2D:
    """The port's UNet2D with `params` (a JAX tree) carried over."""
    model = UNet2D(config, **kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a module's tiny tensors (active in the
    modules that import it): on a host whose cores are all busy, more
    threads only spin."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tp_mesh():
    """A 1 x 2 ('data', 'model') mesh of CPU repeats: tensor parallelism.
    Every surface takes it and gives its data-only (or no-mesh) result: the
    sampling walks channel-shard the UNet over the row, the rest replicate
    over 'model'."""
    return create_mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def attention_inputs(shape, seed: int):
    """q, k, v ~ N(0, 1) in f32 from numpy, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@functools.cache
def jax_fast_attention(shape, seed: int, token_minor: bool) -> np.ndarray:
    """The JAX package's Pallas fast-math forward (interpret mode, as its
    own tests run it on the CPU) on `attention_inputs(shape, seed)`, f32;
    cached, so the tests that read it share one compile and one run."""
    q, k, v = (jnp.asarray(z) for z in attention_inputs(shape, seed))
    return np.asarray(jax_fused_attention(q, k, v, interpret=True, fast_math=True,
                                          token_minor=token_minor))


# -- the lesion classifier (ResNet-18) ------------------------------------------------

@functools.cache
def _resnet_shapes(num_classes: int):
    """The JAX ResNet-18's parameter shapes (traced at a small input: they
    do not depend on the image size)."""
    from synt_isic_tpu.models.resnet18 import ResNet18, ResNet18Config

    model = ResNet18(config=ResNet18Config(num_classes=num_classes))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 32, 32, 3)))["params"])


def jax_resnet_params(num_classes: int = 8, seed: int = 0):
    """Random ResNet-18 parameters in the JAX package's tree layout, from
    numpy: kernels ~ N(0, 1/fan_in), BatchNorm scales ~ 1 + N(0, 0.1^2),
    variances ~ U(0.5, 1.5), biases and means ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)
        z = rng.normal(size=leaf.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, _resnet_shapes(num_classes))


def port_resnet(params, num_classes: int = 8):
    """The port's ResNet18 with `params` (a JAX tree) carried over."""
    from synt_isic_tpu_torch.models.resnet18 import ResNet18, ResNet18Config

    model = ResNet18(ResNet18Config(num_classes=num_classes))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


@contextlib.contextmanager
def classifier_input(size: int):
    """Both packages' classifiers resize their input to `size` in place of
    224 (the module-level `preprocess_for_classifier`, which both look up
    at call time), so a whole-network test stays small."""
    import synt_isic_tpu.models.classifier as jax_clf
    import synt_isic_tpu_torch.models.classifier as port_clf

    from synt_isic_tpu.xai import gradcam as jax_gradcam

    patch = pytest.MonkeyPatch()
    for module in (jax_clf, port_clf):
        patch.setattr(module, "preprocess_for_classifier",
                      functools.partial(module.preprocess_for_classifier, size=size))
    try:
        yield
    finally:
        patch.undo()
        # the JAX Grad-CAM keeps its compiled (shrunk-input) functions by
        # model id: none may outlive the patch
        jax_gradcam._CACHE.clear()


@contextlib.contextmanager
def small_classifiers(size: int = 64):
    """`classifier_input(size)` with the JAX side at full f32 matmul
    precision, for a whole test module."""
    with classifier_input(size), jax.default_matmul_precision("highest"):
        yield


def classifier_pair(num_classes: int = 8, seed: int = 0):
    """(the JAX package's LesionClassifier, the port's on the CPU) with the
    same random weights."""
    from synt_isic_tpu.models.classifier import LesionClassifier as JaxLesionClassifier
    from synt_isic_tpu_torch.models.classifier import LesionClassifier

    params = jax_resnet_params(num_classes, seed)
    return (JaxLesionClassifier(params, num_classes=num_classes),
            LesionClassifier(port_resnet(params, num_classes), device="cpu"))
