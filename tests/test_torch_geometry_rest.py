"""The rest of the port's module surface against the JAX package, on the CPU:
the rotations, camera, rigid, MANO, object and AIK functions the earlier
slices left out, the penetration loss with its gradient, the preprocessing
copy, the tools and the `.pth` import surface of `train/convert.py`.

Tolerances: 1e-5 absolute on unit-scale float32 results (rotations, AIK
poses, normals, the loss and its gradient); 1e-4 on millimetre-scale AIK
joints (1e-2 for the IK round trip, whose twist is unobservable); numpy
copies (preprocessing, tools, OBJ reading, index
reorderings) bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.data import preprocessing as jpp
from uvhand_tpu.geometry import aik as jaik
from uvhand_tpu.geometry import camera as jcam
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobj
from uvhand_tpu.geometry import rigid as jrigid
from uvhand_tpu.geometry import rotations as jrot
from uvhand_tpu.losses import penetration as jpen
from uvhand_tpu.models.backbones.resnet import convert_torchvision_resnet50 as jconvert_r50
from uvhand_tpu.utils import tools as jtools
from uvhand_tpu_torch.data import preprocessing as pp
from uvhand_tpu_torch.geometry import aik, camera, mano, objects, rigid, rotations
from uvhand_tpu_torch.losses import penetration
from uvhand_tpu_torch.models.backbones.resnet import ResNet50
from uvhand_tpu_torch.train import convert
from uvhand_tpu_torch.utils import tools


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, ref, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(15)


def branch_matrices():
    """Rotations for which each of the four Shepperd candidates is the best
    conditioned: a small angle (w), and angles near pi about x, y and z."""
    aa = np.array([[0.1, -0.2, 0.05], [3.0, 0.2, -0.1], [0.1, 3.0, 0.2], [-0.2, 0.1, 3.0]],
                  np.float32)
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))


def test_matrix_to_quaternion_takes_every_branch_as_jax():
    mats = branch_matrices()
    m00, m11, m22 = mats[:, 0, 0], mats[:, 1, 1], mats[:, 2, 2]
    q_abs = np.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                      1 - m00 - m11 + m22], -1)
    assert sorted(np.argmax(q_abs, -1).tolist()) == [0, 1, 2, 3]
    _close(rotations.matrix_to_quaternion(_t(mats)), jrot.matrix_to_quaternion(mats), 1e-6)
    _close(rotations.matrix_to_axis_angle(_t(mats)), jrot.matrix_to_axis_angle(mats), 1e-5)


def test_rotation_conversions_as_jax(rng):
    aa = rng.normal(size=(32, 3)).astype(np.float32)
    aa[:2] *= 1e-8  # the small-angle Taylor branch
    q = rng.normal(size=(32, 4)).astype(np.float32)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    mats = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    d6 = rng.normal(size=(32, 6)).astype(np.float32)
    euler = rng.normal(size=(32, 3)).astype(np.float32)
    pairs = [
        (rotations.standardize_quaternion(_t(q)), jrot.standardize_quaternion(q)),
        (rotations.quaternion_multiply(_t(q), _t(q[::-1].copy())),
         jrot.quaternion_multiply(q, q[::-1])),
        (rotations.quaternion_invert(_t(q)), jrot.quaternion_invert(jnp.asarray(q))),
        (rotations.quaternion_apply(_t(q), _t(p)), jrot.quaternion_apply(q, p)),
        (rotations.quaternion_to_axis_angle(_t(q)), jrot.quaternion_to_axis_angle(q)),
        (rotations.matrix_to_quaternion(_t(mats)), jrot.matrix_to_quaternion(mats)),
        (rotations.matrix_to_axis_angle(_t(mats)), jrot.matrix_to_axis_angle(mats)),
        (rotations.rotation_6d_to_matrix(_t(d6)), jrot.rotation_6d_to_matrix(d6)),
        (rotations.matrix_to_rotation_6d(_t(mats)), jrot.matrix_to_rotation_6d(mats)),
        (rotations._sqrt_positive_part(_t(q)), jrot._sqrt_positive_part(q)),
        (rotations.one_hot(torch.tensor([2, 0, 3]), 4, torch.float32),
         jrot.jax_one_hot(jnp.asarray([2, 0, 3]), 4, jnp.float32)),
    ]
    for conv in ("XYZ", "ZYX", "YXZ"):
        pairs.append((rotations.euler_angles_to_matrix(_t(euler), conv),
                      jrot.euler_angles_to_matrix(euler, conv)))
    for ours, ref in pairs:
        _close(ours, ref, 1e-5)


def test_camera_helpers_as_jax(rng):
    wp = np.abs(rng.normal(size=(8, 3))).astype(np.float32) + 0.2
    _close(camera.get_default_cam_t(1000.0, 224), jcam.get_default_cam_t(1000.0, 224), 1e-4)
    _close(camera.perspective_from_weak(_t(wp), 1000.0, 224),
           jcam.perspective_from_weak(wp, 1000.0, 224), 1e-4)
    S = (rng.normal(size=(4, 21, 3)) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    t_true = np.array([0.05, -0.02, 0.3], np.float32)
    P = S + t_true
    uv = (P[..., :2] / P[..., 2:] * 600.0 + [112.0, 112.0]).astype(np.float32)
    conf = rng.uniform(0.5, 1.0, size=(4, 21)).astype(np.float32)
    ours = camera.estimate_translation(_t(S), _t(uv), _t(conf), (600.0, 600.0), (224, 224))
    _close(ours, jcam.estimate_translation(S, uv, conf, (600.0, 600.0), (224, 224)), 1e-4)
    _close(ours, np.broadcast_to(t_true, (4, 3)), 1e-3)
    eye = rng.normal(size=(5, 3)).astype(np.float32)
    _close(camera.look_at(_t(eye)), jcam.look_at(eye), 1e-5)
    _close(camera.look_at(_t(eye), at=[0.1, 0.2, 0.3], up=[0.0, 1.0, 0.0]),
           jcam.look_at(eye, at=[0.1, 0.2, 0.3], up=[0.0, 1.0, 0.0]), 1e-5)
    u, v = rng.uniform(size=6).astype(np.float32), rng.uniform(size=6).astype(np.float32)
    _close(camera.to_sphere(_t(u), _t(v)), jcam.to_sphere(u, v), 1e-5)
    cam_r = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(6, 3)),
                                                             jnp.float32)))
    body = rng.normal(size=(6, 3)).astype(np.float32) * 0.5
    for rotate_x in (False, True):
        _close(camera.rectify_pose(_t(cam_r), _t(body), rotate_x),
               jcam.rectify_pose(cam_r, body, rotate_x), 1e-5)
    _close(camera.get_coord_maps(56), jcam.get_coord_maps(56), 0)
    _close(camera.weak_perspective_intrinsics(1000.0, 224),
           jcam.weak_perspective_intrinsics(1000.0, 224), 0)


@pytest.mark.parametrize("radius", [1.0, (0.5, 2.0)], ids=["fixed", "drawn"])
def test_sample_pose_on_sphere_with_jaxs_uniforms(radius):
    """The port draws from a torch.Generator; given the three uniforms JAX
    draws from its key, it makes JAX's pose."""
    key = jax.random.PRNGKey(7)
    ku, kv, kr = jax.random.split(key, 3)
    uniforms = [float(jax.random.uniform(k, ())) for k in (ku, kv, kr)]
    kw = dict(range_u=(0.1, 0.4), range_v=(0.2, 0.9), radius=radius)
    ref = jcam.sample_pose_on_sphere(key, **kw)
    _close(camera.sample_pose_on_sphere(uniforms=uniforms, **kw), ref, 1e-5)
    drawn = camera.sample_pose_on_sphere(torch.Generator().manual_seed(0), **kw)
    assert drawn.shape == (3, 4) and torch.isfinite(drawn).all()
    np.testing.assert_allclose(np.linalg.det(drawn[:, :3].numpy()), 1.0, atol=1e-5)


def test_rigid_mano_and_object_helpers_as_jax(rng, tmp_path):
    pts = rng.normal(size=(3, 7, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, :] += rng.normal(size=(3, 3, 4)).astype(np.float32) * 0.1
    T[:, 3, :3] = rng.normal(size=(3, 3)).astype(np.float32) * 0.01
    _close(rigid.to_homo(_t(pts)), jrigid.to_homo(pts), 0)
    _close(rigid.transform_points(_t(T), _t(pts)), jrigid.transform_points(T, pts), 1e-5)

    j21 = rng.normal(size=(2, 21, 3)).astype(np.float32)
    _close(mano.reorder_joints_manopth(_t(j21)), jmano.reorder_joints_manopth(j21), 0)
    v3d = rng.normal(size=(2, 778, 3)).astype(np.float32)
    faces = rng.integers(0, 778, size=(30, 3)).astype(np.int32)
    for is_rhand in (True, False):
        ours, of = mano.seal_mano_mesh(_t(v3d), faces, is_rhand)
        ref, rf = jmano.seal_mano_mesh(jnp.asarray(v3d), faces, is_rhand)
        _close(ours, ref, 1e-6)
        np.testing.assert_array_equal(of, rf)
    D = rng.uniform(size=(195, 778)).astype(np.float32) / 778
    _close(mano.decimate_verts(_t(v3d), _t(D)), jmano.decimate_verts(jnp.asarray(v3d), D), 1e-5)

    obj = tmp_path / "mesh.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv 0.5 0.5 1\n"
                   "f 1/1 2/2 3/3 4/4\nf 1 2 5\nf 3//1 4//2 5//3\n")
    for a, b in zip(objects._load_obj_mesh(str(obj)), jobj._load_obj_mesh(str(obj))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bank, jbank = objects.synthetic_object_bank(2, device="cpu"), jobj.synthetic_object_bank(2)
    np.testing.assert_array_equal(bank.f, jbank.f)
    np.testing.assert_array_equal(bank.f_len, jbank.f_len)
    idx = np.array([3, 0, 7], np.int32)
    ours, ref = objects.object_template(bank, _t(idx)), jobj.object_template(jbank, idx)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _close(ours[k], ref[k], 0)


def test_adaptive_ik_as_jax_and_its_round_trip(rng):
    pose = (rng.normal(size=(6, 48)) * 0.3).astype(np.float32)
    for side in ("right", "left"):
        joints = aik.aik_fk(_t(pose), side=side)
        _close(joints, jaik.aik_fk(jnp.asarray(pose), side=side), 1e-4)
        ours = aik.adaptive_ik(joints, side=side)
        ref = jaik.adaptive_ik(jnp.asarray(joints.numpy()), side=side)
        _close(ours, ref, 1e-4)
        # the IK recovers joints whose FK lands back on the input (twist aside)
        _close(aik.aik_fk(ours, side=side), joints, 1e-2)


def _penetration_case(rng):
    """A closed cube "hand" of 8 vertices and an object of 40 points, some
    inside it, a padded tail masked out."""
    verts = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                      [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]],
                     np.int32)
    hand = (verts[None] * [[[1.0]], [[1.3]]] + rng.normal(size=(2, 8, 3)) * 0.05).astype(
        np.float32)
    obj = (rng.normal(size=(2, 40, 3)) * 1.2).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[:, 35:] = 0
    return faces, hand, obj, mask, np.ones(2, np.float32), np.array([1.0, 1.0], np.float32)


def test_penetration_loss_and_gradient_as_jax(rng):
    faces, hand, obj, mask, valid, hvalid = _penetration_case(rng)
    _close(penetration.vertex_normals(_t(hand), _t(faces)),
           jpen.vertex_normals(jnp.asarray(hand), jnp.asarray(faces)), 1e-5)
    d, i = penetration.nearest_hand_for_object(_t(obj), _t(hand))
    jd, ji = jpen.nearest_hand_for_object(jnp.asarray(obj), jnp.asarray(hand))
    _close(d, jd, 1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))

    h, o = _t(hand).requires_grad_(True), _t(obj).requires_grad_(True)
    loss = penetration.penetration_loss(_t(faces), h, o, _t(mask), _t(valid), _t(hvalid))
    loss.backward()
    ref, (gh, go) = jax.value_and_grad(
        lambda hv, ov: jpen.penetration_loss(jnp.asarray(faces), hv, ov, mask, valid, hvalid),
        argnums=(0, 1))(jnp.asarray(hand), jnp.asarray(obj))
    assert float(ref) > 0  # some object points are inside
    _close(loss.detach(), ref, 1e-5 * max(1.0, abs(float(ref))))
    _close(h.grad, gh, 1e-5 * max(1.0, float(np.abs(gh).max())))
    _close(o.grad, go, 1e-5 * max(1.0, float(np.abs(go).max())))


def _raw_seq(rng, F=3, V=3):
    from scipy.spatial.transform import Rotation as SR

    def w2c():
        m = np.eye(4)
        m[:3, :3] = SR.from_rotvec(rng.normal(size=3) * 0.2).as_matrix()
        m[:3, 3] = [0.1, 0.0, 2.0]
        return m

    seq_world = {k: rng.normal(size=(F, n, 3)) * 0.1 for k, n in
                 (("joints.right", 21), ("joints.left", 21), ("kp3d", 32), ("bbox3d", 16))}
    seq_world.update(rot_r=rng.normal(size=(F, 3)) * 0.3, rot_l=rng.normal(size=(F, 3)) * 0.3)
    K = np.array([[600.0, 0, 420], [0, 600.0, 300], [0, 0, 1]])
    return (seq_world, [w2c() for _ in range(V - 1)], [K] * (V - 1),
            np.stack([w2c() for _ in range(F)]), np.tile(K, (F, 1, 1)))


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_preprocessing_is_the_jax_packages_bit_for_bit(rng, tmp_path):
    pts, w2c = rng.normal(size=(5, 3)), np.tile(np.eye(4), (2, 1, 1))
    w2c[:, :3, 3] = [[0.1, 0.2, 1.5], [0.0, -0.1, 2.0]]
    _equal_trees(pp.world_to_cam(pts, w2c), jpp.world_to_cam(pts, w2c))
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    _equal_trees(pp.project(pts + [0, 0, 5], K), jpp.project(pts + [0, 0, 5], K))
    kp = rng.uniform(0, 800, size=(3, 21, 2))
    _equal_trees(pp.compute_crop_bbox(kp, (840, 600)), jpp.compute_crop_bbox(kp, (840, 600)))
    seq = _raw_seq(rng)
    params = {"pose_r": rng.normal(size=(3, 45)).astype(np.float32)}
    sizes = [[840, 600]] * 3
    _equal_trees(pp.process_sequence(*seq, params, sizes),
                 jpp.process_sequence(*seq, params, sizes))
    names, dd = [], {}
    for sid in ("s01", "s05", "s06"):
        dd[f"{sid}/box_use_01"] = {"x": 1}
        names += [f"./images/{sid}/box_use_01/{v}/{f:05d}.jpg" for v in (0, 1) for f in (0, 1)]
    for setup in ("p1", "p2"):
        ours, ref = pp.build_splits(dd, names, setup), jpp.build_splits(dd, names, setup)
        _equal_trees(ours, ref)
        pp.sanity_check_splits(ours)
        pp.save_splits(ours, str(tmp_path / "ours"), setup)
        jpp.save_splits(ref, str(tmp_path / "ref"), setup)
        for split in ("train", "val", "test"):
            f = f"{setup}_{split}.npy"
            assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    bad = {"train": {"imgnames": ["a"]}, "val": {"imgnames": ["a"]}, "test": {"imgnames": []}}
    with pytest.raises(AssertionError, match="train/val overlap"):
        pp.sanity_check_splits(bad)


def test_tools_and_the_pth_surface(rng, tmp_path):
    loss_out = {"loss": 3.5, "loss_ce": 1.0, "loss/cd": torch.tensor(0.25),
                "loss/mano/pose/r": 0.5, "loss/mano/beta/l": 0.125, "loss/penetr": 2.0,
                "acc/h": 0.3, "acc/o": 0.7}
    for mode in ("baseline", "dino", "smoothnet", "other"):
        for rnd in (False, True):
            ref = jtools.create_loss_dict(0.0, {k: float(v) for k, v in loss_out.items()},
                                          rnd, mode)
            assert tools.create_loss_dict(0.0, loss_out, rnd, mode) == ref
    stats = {"cdev/ho": 1.5, "aae": 2.0, "mdev/h": 3.0, "extra": 9.0}
    assert tools.create_arctic_score_dict(stats) == jtools.create_arctic_score_dict(stats)
    for path in ("exps/run/12", "exps/run/checkpoint0007.pth", "exps/x/", "none"):
        assert tools.extract_epoch(path) == jtools.extract_epoch(path)

    # torchvision's resnet50 names (the port's ResNet carries them) plus the
    # classifier and the BatchNorm counters torchvision has
    tv = {k: torch.as_tensor(rng.normal(size=v.shape), dtype=torch.float32)
          for k, v in ResNet50().state_dict().items()}
    tv.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
               "bn1.num_batches_tracked": torch.tensor(0)})
    ours = convert.convert_torchvision_resnet50(tv)
    ref = jconvert_r50(tv)["params"]
    assert len(ours) == len(tv) - 3
    for name, value in ours.items():
        parts = name[len("backbone.0.body."):].split(".")
        if parts[0].startswith("layer"):
            node = ref[f"{parts[0]}_{parts[1]}"]
            leaf, kind = parts[2:-1], parts[-1]
            node = node[{"downsample.0": "down_conv", "downsample.1": "down_bn"}.get(
                ".".join(leaf), leaf[0])]
        else:
            node, kind = ref[parts[0]], parts[1]
        jax_leaf = np.asarray(node[{"weight": "kernel" if value.dim() == 4 else "scale",
                                    "bias": "bias", "running_mean": "mean",
                                    "running_var": "var"}[kind]])
        if value.dim() == 4:
            jax_leaf = jax_leaf.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(value.numpy(), jax_leaf, err_msg=name)

    sd = {"a.weight": torch.ones(2, 3), "b.bias": torch.arange(3.0)}
    torch.save({"model": sd, "optimizer": {}, "epoch": 4}, tmp_path / "ref.pth")
    torch.save(sd, tmp_path / "bare.pth")
    for name in ("ref.pth", "bare.pth"):
        got = convert.load_torch_checkpoint(str(tmp_path / name))
        assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
