"""PyTorch port vs the JAX package: fused geometry (plain version of kernel
B1), sin3d position embedding and the bilinear token pool, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video3d_tpu.kernels import fused_geometry as jfg
from video3d_tpu.ops import geometry as jgeo
from video3d_tpu.ops.pos_embed import sin3d_position_embedding as jax_sin3d
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import fused_geometry as tfg
from video3d_tpu_torch.ops import geometry as tgeo
from video3d_tpu_torch.ops.pos_embed import sin3d_position_embedding

torch.set_num_threads(1)

# voxel ids are integers: both sides round the same f32 values, which may
# sit on opposite sides of a .5 boundary after different summation orders
MAX_ID_MISMATCH = 1e-3
COORD_ATOL = 1e-4     # metres, f32 reduction-order differences
F32_ATOL = 1e-5


def geometry_inputs(V, H, W, seed=0):
    rng = np.random.default_rng(seed)
    depths = rng.integers(200, 8000, size=(V, H, W)).astype(np.int32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 0.9 * W
    intr[0, 2], intr[1, 2] = W / 2 - 0.5, H / 2 + 0.3
    rot, _ = np.linalg.qr(rng.normal(size=(V, 3, 3)))
    poses = np.zeros((V, 4, 4), np.float32)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = rng.uniform(-2, 2, (V, 3))
    poses[:, 3, 3] = 1.0
    return depths, intr, poses


GEOMETRY_SHAPES = [(2, 96, 128, 56, 2), (3, 120, 160, 84, 6)]


@pytest.mark.parametrize("V,H,W,crop,grid", GEOMETRY_SHAPES)
def test_voxel_ids_match_jax(V, H, W, crop, grid):
    depths, intr, poses = geometry_inputs(V, H, W)
    before = dict(_build.LAUNCHES)
    got = tfg.fused_patch_voxel_coords(torch.from_numpy(depths),
                                       torch.from_numpy(intr),
                                       torch.from_numpy(poses),
                                       crop=crop, grid=grid).numpy()
    assert _build.LAUNCHES == before          # the CPU runs the plain path
    assert got.shape == (V, grid, grid, 3)
    jargs = (jnp.asarray(depths), jnp.asarray(intr), jnp.asarray(poses))
    for ref in (jfg.fused_patch_voxel_coords(*jargs, crop=crop, grid=grid,
                                             interpret=True),
                jfg.reference_patch_voxel_coords(*jargs, crop=crop,
                                                 grid=grid)):
        diff = np.abs(got - np.asarray(ref))
        assert (diff > 0).mean() <= MAX_ID_MISMATCH
        assert diff.max() <= 1


@pytest.mark.parametrize("V,H,W,crop,grid", GEOMETRY_SHAPES)
def test_world_coords_match_jax(V, H, W, crop, grid):
    depths, intr, poses = geometry_inputs(V, H, W, seed=1)
    got = tfg.fused_patch_voxel_coords(torch.from_numpy(depths),
                                       torch.from_numpy(intr),
                                       torch.from_numpy(poses), crop=crop,
                                       grid=grid, discretize=False).numpy()
    jargs = (jnp.asarray(depths), jnp.asarray(intr), jnp.asarray(poses))
    for ref in (jfg.fused_patch_voxel_coords(*jargs, crop=crop, grid=grid,
                                             discretize=False,
                                             interpret=True),
                jfg.reference_patch_voxel_coords(*jargs, crop=crop,
                                                 grid=grid,
                                                 discretize=False)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=COORD_ATOL)


@pytest.mark.parametrize("H,W,crop,grid", [(480, 640, 384, 14),
                                            (240, 320, 224, 16),
                                            (120, 160, 84, 6)])
def test_source_maps_match_jax(H, W, crop, grid):
    """The plan's source maps, a host mirror of the int32 formula the
    kernel evaluates per block (fused_geometry.cu: the kernel's own tables
    are checked only through its output, by the cuda tests), against JAX
    ``_src_maps`` and the plain resize's indices."""
    plan = tfg.geometry_plan(H, W, crop, grid)
    rows, cols = plan.source_maps()
    assert rows.dtype == cols.dtype == torch.int32
    jrows, jcols = jfg._src_maps(H, W, crop)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    # the plain version's resize_nearest + center_crop pick the same pixels
    idx = torch.arange(H * W, dtype=torch.float32).reshape(1, H, W, 1)
    picked = tgeo.center_crop(tgeo.resize_nearest(idx, (crop, plan.new_w)),
                              (crop, crop))[0, ..., 0].long()
    np.testing.assert_array_equal(
        picked.numpy(), (rows[:, None].long() * W + cols[None, :]).numpy())
    assert plan.patch * grid <= crop and plan.left >= 0


@pytest.mark.parametrize("H,W,crop,grid", [
    (96, 128, 100, 2),            # crop taller than the image
    (96, 128, 56, 57),            # patches of no pixel
    (46341, 8, 46341, 1),         # crop x H past int32
    (40000, 60000, 2048, 8)])     # a pixel's offset in its frame past int32
def test_geometry_plan_refuses_what_the_kernel_does_not_take(H, W, crop,
                                                             grid):
    with pytest.raises(ValueError):
        tfg.geometry_plan(H, W, crop, grid)


def test_unproject_resize_crop_match_jax():
    depths, intr, poses = geometry_inputs(2, 24, 32, seed=2)
    wc = tgeo.unproject(torch.from_numpy(intr), torch.from_numpy(poses),
                        torch.from_numpy(depths))
    wc = tgeo.center_crop(tgeo.resize_nearest(wc, (14, 18)), (14, 14))
    jwc = jgeo.unproject(jnp.asarray(intr), jnp.asarray(poses),
                         jnp.asarray(depths))
    jwc = jgeo.center_crop(jgeo.resize_nearest(jwc, (14, 18)), (14, 14))
    np.testing.assert_allclose(wc.numpy(), np.asarray(jwc), rtol=1e-6,
                               atol=F32_ATOL)


@pytest.mark.parametrize("D", [64, 100, 3584])
def test_sin3d_matches_jax(D):
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 301, size=(2, 40, 3)).astype(np.float32)
    coords[0, :5] += rng.uniform(0, 1, (5, 3)).astype(np.float32)
    got = sin3d_position_embedding(torch.from_numpy(coords), D).numpy()
    ref = np.asarray(jax_sin3d(jnp.asarray(coords), D))
    assert got.shape == (2, 40, D)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("side,stride", [(27, 2), (4, 2), (5, 3)])
def test_pool_2d_tokens_matches_jax(side, stride):
    x = np.random.default_rng(4).normal(size=(3, side * side, 16)) \
        .astype(np.float32)
    got = tgeo.pool_2d_tokens(torch.from_numpy(x), side, stride).numpy()
    ref = np.asarray(jgeo.pool_2d_tokens(jnp.asarray(x), side, stride))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_off_cpu_tensor_without_kernel_raises():
    """A non-CPU tensor never falls back to the plain version."""
    depths = torch.zeros((1, 96, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfg.fused_patch_voxel_coords(depths, torch.eye(4),
                                     torch.eye(4)[None], crop=56, grid=2)
