"""The port's geometry (`uvhand_tpu_torch/geometry`) against the JAX package,
on random batches from a numpy seed. Tolerances are float32 rounding of
different operation orders: 1e-5 absolute for unit-scale quantities, 1e-6
for meter-scale MANO/object coordinates (values ~0.1 m)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvhand_tpu.geometry import camera as jcam
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobj
from uvhand_tpu.geometry import rigid as jrigid
from uvhand_tpu.geometry import rotations as jrot
from uvhand_tpu_torch.geometry import camera, mano, objects, rigid, rotations


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_rotations(rng):
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:4] *= 1e-8  # the small-angle Taylor branch
    _close(rotations.axis_angle_to_quaternion(_t(aa)), jrot.axis_angle_to_quaternion(jnp.asarray(aa)), 1e-6)
    _close(rotations.axis_angle_to_matrix(_t(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa)), 1e-6)
    rad = rng.normal(size=(16,)).astype(np.float32)
    axis = np.array([0.0, 0.0, -1.0], np.float32)
    _close(rotations.rotate_about_axis(_t(rad), _t(axis)),
           jrot.rotate_about_axis(jnp.asarray(rad), jnp.asarray(axis)), 1e-6)


def test_camera(rng):
    wp = rng.normal(size=(8, 3)).astype(np.float32)
    wp[:, 0] = np.abs(wp[:, 0]) + 0.05  # some below the 0.1 scale clamp
    f = np.full(8, 1000.0, np.float32)
    _close(camera.weak_perspective_to_perspective(_t(wp), _t(f), 224.0),
           jcam.weak_perspective_to_perspective(jnp.asarray(wp), jnp.asarray(f), 224.0), 1e-3)
    cam_t = rng.normal(size=(8, 3)).astype(np.float32) + np.array([0, 0, 2], np.float32)
    _close(camera.perspective_to_weak_perspective(_t(cam_t), _t(f), 224.0),
           jcam.perspective_to_weak_perspective(jnp.asarray(cam_t), jnp.asarray(f), 224.0), 1e-5)
    K = np.tile(np.array([[1000, 0, 112], [0, 1000, 112], [0, 0, 1]], np.float32), (8, 1, 1))
    pts = rng.normal(size=(8, 21, 3)).astype(np.float32) * 0.1 + np.array([0, 0, 0.6], np.float32)
    _close(camera.project2d(_t(K), _t(pts)), jcam.project2d(jnp.asarray(K), jnp.asarray(pts)), 1e-3)
    kp = rng.uniform(0, 224, size=(8, 16, 2)).astype(np.float32)
    _close(camera.normalize_kp2d(_t(kp), 224.0), jcam.normalize_kp2d(jnp.asarray(kp), 224.0), 1e-6)
    _close(camera.unnormalize_kp2d(_t(kp / 224), 224.0), jcam.unnormalize_kp2d(jnp.asarray(kp / 224), 224.0), 1e-4)


def test_rigid(rng):
    from scipy.spatial.transform import Rotation

    A = rng.normal(size=(16, 16, 3)).astype(np.float32) * 0.05
    R = Rotation.from_rotvec(rng.normal(size=(16, 3))).as_matrix().astype(np.float32)
    t = rng.normal(size=(16, 3, 1)).astype(np.float32) * 0.1
    B = np.einsum("bij,bnj->bni", R, A) + t.transpose(0, 2, 1)
    B = (B + rng.normal(size=B.shape) * 1e-3).astype(np.float32)  # not exactly rigid
    B[-1] = -A[-1]  # a reflection: the SVD branch with det fix
    R_o, t_o = rigid.solve_rigid_transform(_t(A), _t(B))
    R_j, t_j = jrigid.solve_rigid_transform(jnp.asarray(A), jnp.asarray(B))
    _close(R_o, R_j, 1e-5)
    _close(t_o, t_j, 1e-6)
    np.testing.assert_allclose(np.linalg.det(R_o.numpy()), 1.0, atol=1e-5)
    pts = rng.normal(size=(16, 21, 3)).astype(np.float32)
    _close(rigid.rigid_transform_batch(_t(pts), R_o, t_o),
           jrigid.rigid_transform_batch(jnp.asarray(pts), R_j, t_j), 1e-5)


@pytest.mark.parametrize("is_rhand", [True, False])
def test_mano_forward(rng, is_rhand):
    seed = 0 if is_rhand else 1
    m_t = mano.synthetic_mano(seed, is_rhand, device="cpu")
    m_j = jmano.synthetic_mano(seed, is_rhand)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "hands_mean"):
        np.testing.assert_array_equal(getattr(m_t, name).numpy(), np.asarray(getattr(m_j, name)))
    pose = rng.normal(size=(6, 48)).astype(np.float32) * 0.3
    beta = rng.normal(size=(6, 10)).astype(np.float32)
    v_t, j_t = mano.mano_forward(m_t, _t(pose[:, :3]), _t(pose[:, 3:]), _t(beta))
    v_j, j_j = jmano.mano_forward(m_j, jnp.asarray(pose[:, :3]), jnp.asarray(pose[:, 3:]),
                                  jnp.asarray(beta))
    assert v_t.shape == (6, 778, 3) and j_t.shape == (6, 21, 3)
    _close(v_t, v_j, 1e-6)
    _close(j_t, j_j, 1e-6)


def test_object_forward(rng):
    b_t = objects.synthetic_object_bank(2, device="cpu")
    b_j = jobj.synthetic_object_bank(2)
    assert b_t.names == b_j.names
    for name in ("v", "mask", "v_len", "v_sub", "parts_ids", "parts_sub_ids", "bbox_top",
                 "bbox_bottom", "kp_top", "kp_bottom", "diameter"):
        np.testing.assert_array_equal(getattr(b_t, name).numpy(), np.asarray(getattr(b_j, name)))
    B = 7
    rad = np.abs(rng.normal(size=(B,))).astype(np.float32)
    rot = rng.normal(size=(B, 3)).astype(np.float32) * 0.5
    idx = rng.integers(0, 11, size=B).astype(np.int32)
    out_t = objects.object_forward(b_t, _t(rad), _t(rot), _t(idx))
    out_j = jobj.object_forward(b_j, jnp.asarray(rad), jnp.asarray(rot), jnp.asarray(idx))
    for k in ("v", "v_sub", "bbox3d", "kp3d"):
        _close(out_t[k], out_j[k], 1e-6)
    for k in ("mask", "v_len", "parts_ids", "parts_sub_ids", "diameter"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
