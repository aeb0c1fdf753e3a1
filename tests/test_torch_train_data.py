"""The port's training data path and losses against the JAX package on the
CPU: ``SupervisedDataset`` items and the ``Collator``'s arrays on
``make_fake_scene`` + ``make_fake_annotations`` + ``FakeTokenizer`` (equal),
the depth PNG reader (bit-identical to the JAX package's), the LM losses,
plain and chunked (within 1e-5 relative), and ``forward_hidden`` with
rematerialization (tiny model, f32, within 1e-4)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.native import load_depth_png as jax_load_depth_png
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import load_depth_png
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
USED = ("vision", "projector", "image_newline", "llm")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    jset = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    tset = tds.SupervisedDataset(ann, FakeTokenizer(), port_config(dc),
                                 image_processor=TSigLipImageProcessor(
                                     size=(56, 56)))
    jcol = jds.Collator(CFG, jds.CollatorConfig(max_len=160,
                                                frames_upbound=2))
    tcol = tds.Collator(TCFG, tds.CollatorConfig(max_len=160,
                                                 frames_upbound=2))
    return root, jset, tset, jcol, tcol


def test_dataset_items_match_jax(data):
    _, jset, tset, _, _ = data
    assert len(tset) == len(jset) == 2
    assert tset.task_lengths == jset.task_lengths
    for i in range(2):
        j, t = jset[i], tset[i]
        assert set(t) == set(j)
        for key in ("input_ids", "labels", "images", "world_coords",
                    "objects", "video_size"):
            np.testing.assert_array_equal(np.asarray(t[key]),
                                          np.asarray(j[key]), err_msg=key)


def test_collator_arrays_match_jax(data):
    _, jset, tset, jcol, tcol = data
    jout = jcol([jset[0], jset[1]])
    tout = tcol([tset[0], tset[1]])
    assert set(tout) == set(jout)
    for key, want in jout.items():
        np.testing.assert_array_equal(np.asarray(tout[key]),
                                      np.asarray(want), err_msg=key)
        assert np.asarray(tout[key]).dtype == np.asarray(want).dtype, key


def test_collator_raises_on_inputs_it_does_not_run(data):
    _, _, tset, _, tcol = data
    # a grounding sample collates (tests/test_torch_ground_train.py holds
    # its arrays against JAX's), and so does a batch of 2D images
    # (tests/test_torch_image_training.py); a batch mixing images and
    # videos raises, as the JAX collator's assertion does
    grounded = tcol([dict(tset[0], box_label=[1])])
    assert grounded["box_label_hot"][0, 1] == 1.0
    image = {k: tset[0][k] for k in ("input_ids", "labels")}
    image["image_tiles"] = np.zeros((1, 3, 56, 56), np.float32)
    # one view: its 4x4 patches and, under spatial_unpad, one newline
    assert tcol([image])["vision_valid"].sum() == 17
    with pytest.raises(ValueError, match="mixed image/video"):
        tcol([tset[0], image])


def test_depth_png_is_the_jax_packages(data):
    root = data[0]
    d = os.path.join(root, "scannet", "posed_images", "scene0000_00")
    for name in ("00000.png", "00001.png"):
        got = load_depth_png(os.path.join(d, name))
        want = jax_load_depth_png(os.path.join(d, name))
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [8, 36, 64])
def test_lm_losses_match_jax(chunk):
    """Plain and chunked LM loss against JAX; a chunk of 8 does not divide
    the 36 shifted targets. The chunked loss's gradients equal the plain
    loss's."""
    rng = np.random.default_rng(chunk)
    B, L, D, V = 2, 37, 16, 50
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    head = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    labels = rng.integers(0, V, size=(B, L)).astype(np.int64)
    labels[0, :9] = -100
    labels[1, 20:] = -100
    jparams = {"llm": {"lm_head": jnp.asarray(head)}}
    jlabels = jnp.asarray(labels, jnp.int32)
    jplain = jlv.language_model_loss(jnp.asarray(hidden) @ jnp.asarray(head),
                                     jlabels)
    jchunk = jlv.chunked_language_model_loss(jparams, jnp.asarray(hidden),
                                             jlabels, chunk=chunk)
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    tl = torch.from_numpy(labels)
    plain = tlv.language_model_loss(th @ tw, tl)
    chunked = tlv.chunked_language_model_loss({"llm": {"lm_head": tw}}, th,
                                              tl, chunk=chunk)
    for got, want in ((plain, jplain), (chunked, jchunk), (chunked, jplain)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    g_plain = torch.autograd.grad(plain, (th, tw))
    g_chunk = torch.autograd.grad(chunked, (th, tw))
    for a, b in zip(g_chunk, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_forward_hidden_with_remat_matches_jax(data):
    _, jset, _, jcol, _ = data
    arrays = jcol([jset[0], jset[1]])
    full = jlv.init_model(jax.random.PRNGKey(0), CFG)
    jparams = {k: full[k] for k in USED}
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()
                          if k in jlv.Batch._fields and v is not None})
    jh, _ = jlv.forward_hidden(jparams, CFG, jbatch, remat=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), TCFG,
                              device="cpu")
    th, _ = tlv.forward_hidden(tparams, TCFG, to_batch(arrays, "cpu"),
                               remat=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-4)
