"""``generate_img2img(images, prompts, strength, seed)`` of the port held
seed for seed against the reference's own
``Text2ImagePipeline._img2img_impl`` (CLIP, the encoder at
``split(PRNGKey(seed))[0]``, the noise at ``[1]``, the configured kind's
schedule tail, the VAE) on the same seeded trees, on the CPU at
``test_config()`` sizes: uint8 images within 2 levels (mean 0.5).
"""

import numpy as np
import pytest

from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

from _torch_port_img2img import PROMPTS, reference_img2img, reference_trees
from _torch_port_img2img import configs as _configs
from _torch_port_img2img import images as _images


@pytest.fixture(scope="module")
def img2img_trees():
    """Seeded reference trees of CLIP, the UNet, the decoder and the
    encoder at test_config() sizes."""
    return reference_trees()


@pytest.mark.parametrize("kind", ["ddim", "euler", "dpmpp_2m"])
@pytest.mark.parametrize("strength,seed", [(0.6, 0), (0.3, 7), (1.0, 3)])
def test_generate_img2img_matches_reference(img2img_trees, kind, strength,
                                            seed):
    """Seed for seed: the port's ``generate_img2img`` within 2 uint8
    levels (mean 0.5) of the reference's, under each sampler kind (10
    steps: strengths 0.3, 0.6 and 1.0 run tails of 3, 6 and 10)."""
    ref_cfg, cfg = _configs(kind=kind, num_steps=10)
    images = _images(107 + seed)
    ref, k = reference_img2img(ref_cfg, img2img_trees, images, PROMPTS,
                                strength, seed)
    pipe = Text2ImagePipeline(
        cfg, device="cpu",
        state_dicts={k_: from_jax(k_, v) for k_, v in img2img_trees.items()})
    got = pipe.generate_img2img(images, PROMPTS, strength, seed)
    assert got.shape == ref.shape == images.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2 and diff.mean() <= 0.5, (diff.max(), diff.mean())
    assert pipe.last_decoded_finite
    assert set(pipe.last_stage_seconds) == {"encode", "denoise", "vae"}
    # another seed draws another encoder sample and noise
    other = pipe.generate_img2img(images, PROMPTS, strength, seed + 1)
    assert not np.array_equal(other, got)
