"""The port's CNN zoo beyond ResNet (autodist_tpu_torch.models: vgg,
densenet, inception, and the image classifier's SmallCNN) against the JAX
package's flax models: with the same weights and a batch from one seed, the
f32 loss and every gradient, as tests/test_torch_vision_models.py holds
ResNet, with its helper and tolerances: an even image size, where every
stride-2 "SAME" op pads asymmetrically, and an odd one (Inception's 75 px,
the smallest its stem and both grid reductions take).
"""

import numpy as np
import pytest
import torch

from autodist_tpu_torch.models import densenet, inception, layers, vgg
from test_torch_vision_models import _assert_matches_jax


def test_vgg16_matches_jax():
    import jax.numpy as jnp
    from autodist_tpu.models import vgg as jvgg
    tmodel = vgg.VGG16(10, torch.float32, image_size=33)
    _assert_matches_jax(jvgg.make_loss_fn(jvgg.VGG16(num_classes=10, dtype=jnp.float32)),
                        vgg.make_loss_fn(tmodel), tmodel, jvgg.synthetic_batch(10, 2, 33))


@pytest.mark.parametrize("size", [64, 33])
def test_densenet_matches_jax(size):
    import jax.numpy as jnp
    from autodist_tpu.models import densenet as jdensenet
    small = dict(num_classes=10, block_sizes=(2, 2), growth_rate=8, init_features=16,
                 norm_groups=4)
    cfg = jdensenet.DenseNet121Config(**small, dtype=jnp.float32)
    tmodel = densenet.DenseNet(densenet.DenseNet121Config(**small, dtype=torch.float32))
    _assert_matches_jax(jdensenet.make_loss_fn(jdensenet.DenseNet(cfg)),
                        densenet.make_loss_fn(tmodel), tmodel,
                        jdensenet.synthetic_batch(cfg, 2, size))


def test_inception_matches_jax():
    """One block of each repeated kind (every block type) at an odd 75 px,
    the smallest side the stem and both grid reductions take."""
    import jax.numpy as jnp
    from autodist_tpu.models import inception as jinception
    small = dict(num_classes=10, norm_groups=4, repeats=(1, 1, 1))
    cfg = jinception.InceptionV3Config(**small, dtype=jnp.float32)
    tmodel = inception.InceptionV3(inception.InceptionV3Config(**small, dtype=torch.float32))
    _assert_matches_jax(jinception.make_loss_fn(jinception.InceptionV3(cfg)),
                        inception.make_loss_fn(tmodel), tmodel,
                        jinception.synthetic_batch(cfg, 2, 75))


def test_small_cnn_matches_jax():
    import jax
    import jax.numpy as jnp
    import examples.image_classifier as jexample
    from autodist_tpu_torch.examples.image_classifier import SmallCNN
    jmodel = jexample.SmallCNN()

    def jloss(p, batch):
        logp = jax.nn.log_softmax(jmodel.apply({"params": p}, batch["images"]))
        return -jnp.take_along_axis(logp, batch["labels"][:, None], axis=-1).mean()

    tmodel = SmallCNN()

    def tloss(p, batch):
        logp = torch.log_softmax(layers.apply(tmodel, p, batch["images"]), dim=-1)
        return -logp.gather(-1, batch["labels"].long()[:, None]).mean()

    rng = np.random.RandomState(0)
    batch = {"images": rng.randn(4, 28, 28, 1).astype(np.float32),
             "labels": rng.randint(0, 10, (4,)).astype(np.int32)}
    _assert_matches_jax(jloss, tloss, tmodel, batch)
